// The cross-entropy rows kernel's plan (cross_entropy.cu): the body a
// row of V fp32 logits takes, its vector width, its block and its
// cluster.  Plain C++ with no CUDA in it, so the host compiler alone can
// build it; ptt_ce_rows_plan reports it.
//
// A thread holds kElems logits of a row in registers: N = kElems / VW
// vectors of VW logits (16 bytes, 8 bytes, or one logit: the widest that
// V and the operands' addresses allow).  A row is cut into slices of at
// most kMaxThreads * N vectors:
//   * one slice: the rows body, one block a row of the fewest warps that
//     hold it;
//   * 2-8 slices: the cluster body, a thread-block cluster of that many
//     blocks a row, each holding one slice (the last the shortest), the
//     blocks of equal width;
//   * more: the wide body, the first design, one block of kWideThreads
//     a row that reads the row three times.
// Nothing here depends on the card: a block is one row (or a slice of
// one), so the grid is rows x cluster and the block scheduler fills the
// SMs; the output dtype enters only through the addresses' alignment.
#pragma once

namespace ptt_ce {

constexpr int kElems = 32;          // logits a thread holds
constexpr int kMaxThreads = 512;    // a block of the rows / cluster bodies
constexpr int kMaxCluster = 8;      // blocks a row (the portable limit)
constexpr int kWideThreads = 256;   // a block of the wide body

enum Body { kRows = 0, kCluster = 1, kWide = 2 };

struct Plan {
  int body;
  int VW;           // logits a vector: 4, 2 or 1
  int threads;      // a block
  int cluster;      // blocks a row (1: the rows and wide bodies)
  long long slice;  // vectors a block (0: the wide body)
  long long blocks;
};

// The widest vector (4, 2 or 1 logits) that a row of V logits takes when
// the operands' addresses allow `align` (4, 2 or 1): every row then
// starts on a vector.
inline int vec_width(long long V, int align) {
  for (int w = 4; w > 1; w /= 2)
    if (align >= w && V % w == 0) return w;
  return 1;
}

// The plan of `rows` rows of V logits; false: no body takes the shape.
inline bool plan(long long V, long long rows, int align, Plan* p) {
  if (V <= 0 || V > 0x7fffffffLL || rows <= 0 || rows > 0x7fffffffLL)
    return false;
  const int VW = vec_width(V, align);
  const long long vecs = V / VW;
  const long long warp_cap = 32LL * (kElems / VW);   // vectors a warp holds
  const long long block_cap = kMaxThreads / 32 * warp_cap;
  const long long c = (vecs + block_cap - 1) / block_cap;
  if (c > kMaxCluster) {
    *p = {kWide, 1, kWideThreads, 1, 0, rows};
    return true;
  }
  const long long slice = (vecs + c - 1) / c;
  const int warps = static_cast<int>((slice + warp_cap - 1) / warp_cap);
  if (rows * c > 0x7fffffffLL) return false;
  *p = {c == 1 ? kRows : kCluster, VW, 32 * warps, static_cast<int>(c),
        slice, rows * c};
  return true;
}

}  // namespace ptt_ce
