// The RMSNorm forward's plan (rms_norm.cu): the body a row width takes,
// its block, the rows a block and the grid.  Plain C++ with no CUDA in
// it, so the host compiler alone can build it; ptt_rms_norm_plan reports
// it.  The backward's bodies size their blocks with the same helpers.
#pragma once

namespace ptt_rms {

constexpr int kRowsThreads = 512;   // the rows bodies' widest block
constexpr int kFwdRV = 4;           // the forward's rows a block x vectors
constexpr int kFwdMaxV = 2;         // the forward rows body's vectors a thread

// threads of a rows body for V vectors (of VW elements) a thread
inline int rows_threads(int H, int VW, int V) {
  const int per = (H / VW + V - 1) / V;
  return (per + 31) / 32 * 32;
}

// threads of a body that walks a row with a block of <= 256 threads
inline int block_threads(int H, bool vec, int N) {
  const int work = vec ? H / N : H;
  int threads = ((work + 31) / 32) * 32;
  return threads < 32 ? 32 : (threads > 256 ? 256 : threads);
}

struct FwdPlan {
  int V;            // vectors of a row a thread; 0: the wide body
  int threads;      // a block
  int R;            // rows a block: one batch, one barrier
  long long blocks;
};

// The body rows of H elements of `elem` bytes take: V (0: the wide body)
// and the block's threads; vec: the 16-byte path (H a multiple of 16 /
// elem, every pointer aligned).  False: no body takes the shape.
inline bool fwd_body(int H, int elem, bool vec, int* V, int* threads) {
  const int N = 16 / elem;
  const int VW = vec ? N : 1;
  if (H <= 0 || (vec && H % N)) return false;
  for (int v = 1; v <= kFwdMaxV; v *= 2) {
    *threads = rows_threads(H, VW, v);
    if (*threads <= kRowsThreads) {
      *V = v;
      return true;
    }
  }
  *V = 0;
  *threads = block_threads(H, vec, N);
  return true;
}

// The forward's plan over `rows` rows: the body, R rows a block and the
// grid.  One row a block while the rows fit on the card at once (per_sm
// blocks of the one-row body an SM, on `sms` SMs): the shortest chain.
// Past that kFwdRV / V rows a block, so a thread keeps 4 vectors of x in
// flight.  The wide body takes a row a block.
inline bool fwd_plan(int H, int elem, bool vec, long long rows, int sms,
                     int per_sm, FwdPlan* p) {
  int V = 0, threads = 0;
  if (!fwd_body(H, elem, vec, &V, &threads)) return false;
  const int R =
      V == 0 || rows <= static_cast<long long>(per_sm) * sms ? 1 : kFwdRV / V;
  *p = {V, threads, R, (rows + R - 1) / R};
  return true;
}

}  // namespace ptt_rms
