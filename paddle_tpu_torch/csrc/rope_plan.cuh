// The RoPE kernel's plan (rope.cu): how the (row, head, pair) work of a
// launch is cut among threads.  Plain C++ with no CUDA in it, so the
// host compiler alone can build it; ptt_rope_plan reports it.
//
// A thread owns VW consecutive rotation pairs of a row (VW = 16 bytes of
// x: 8 bf16/fp16, 4 fp32; 1 on the scalar path), so P = (d / 2) / VW
// threads cover a head, and loads its cos/sin columns once.  It then
// walks the row's heads j, j + J, j + 2J, ... (q heads, then k heads),
// issuing the loads of U heads before it forms the first one's outputs.
// J, the head splits of a row, is the least power of two that gives the
// launch kThreadsPerSm threads an SM, at most the heads; U is kUnroll,
// or 2 or 1 when a split holds fewer heads.
//
// Little's law: 3.35 TB/s over ~1.5 us of latency under load is ~5 MB in
// flight, ~38 KB an SM.  A thread has kUnroll * 2 * 16 = 128 bytes of x
// in flight (cos/sin come once), so 400 threads an SM keep ~50 KB there.
// Blocks of kThreads; at most kBlocksPerSm blocks an SM, and a
// grid-stride loop takes any further work.
#pragma once

namespace ptt_rotary {

constexpr int kThreads = 128;        // a block
constexpr int kUnroll = 4;           // heads loaded before any is formed
constexpr int kThreadsPerSm = 400;   // Little's law, above
constexpr int kBlocksPerSm = 16;     // the grid's cap: 2048 threads an SM

struct Plan {
  int VW;           // rotation pairs a thread (a 16-byte vector, or 1)
  int P;            // threads a head: (d / 2) / VW
  int J;            // head splits a row (a power of two)
  int U;            // heads loaded before any is formed: 4, 2 or 1
  int threads;      // a block
  long long blocks;
};

// rows of `heads` (q and k) heads of d elements of `elem` bytes on a card
// of `sms` SMs; vec: the 16-byte path (d / 2 a multiple of VW, every
// pointer 16-byte aligned).
inline Plan plan(int elem, int d, bool vec, long long rows, long long heads,
                 int sms) {
  Plan p;
  p.VW = vec ? 16 / elem : 1;
  p.P = (d / 2) / p.VW;
  const long long want = static_cast<long long>(kThreadsPerSm) * sms;
  long long J = 1;
  while (2 * J <= heads && rows * p.P * J < want) J *= 2;
  p.J = static_cast<int>(J);
  const long long per = (heads + J - 1) / J;   // heads of a split
  p.U = per >= kUnroll ? kUnroll : (per >= 2 ? 2 : 1);
  p.threads = kThreads;
  const long long units = rows * p.P * J;
  const long long blocks = (units + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(kBlocksPerSm) * sms;
  p.blocks = blocks < cap ? blocks : cap;
  return p;
}

}  // namespace ptt_rotary
