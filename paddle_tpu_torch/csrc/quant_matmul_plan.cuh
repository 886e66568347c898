// The plan of quant_matmul's decode body (quant_matmul.cu): whether the
// body takes a shape, how many blocks of a cluster split its K tiles, and
// how many weight stages each block keeps in flight.  Plain C++ with no
// CUDA in it, so the host compiler alone can build it;
// ptt_quant_matmul_plan reports it.
//
// The plan comes from shapes and the card's SM count alone (no read of
// device memory on the host, so a launch can be captured in a CUDA graph).
// A block owns kCols weight columns and walks `per` = ceil(n_k / splits)
// stages of kTileRows packed weight rows (8 KB, int8 and int4 alike).
// With `xtma` (x 16-byte aligned, K % 8 == 0, int4 halves of whole boxes)
// each stage also holds x's box of its K rows (1 or 2 KB a nibble half);
// otherwise the block stages its whole share of x once in shared memory.
// An int4 stage also holds its group scale rows (scale_rows a half, of the
// block's 128 columns); int4 groups that are not a multiple of 16 are not
// this body's (a 16-row k step would straddle two groups).
//
// The split over K is the fewest blocks of a cluster (a power of two, at
// most kMaxSplits, the portable cluster size) that give the card at least
// kMinBlocks / 2 blocks an SM: fewer leave SMs without a block, and more
// only add cluster reductions and pipeline fills (every split timed on
// the H100 at Llama-2-7B's and 13B's decode shapes: PERF.md).  A split
// is never empty, and a staged x share stays within kXBytesMax; past that
// (K over ~40k at M = 16, x not by TMA) the shape is not this body's.
//
// In-flight bytes by Little's law: 3.35 TB/s x ~1.5 us of latency over
// 132 SMs is ~38 KB an SM; a block keeps `stages` = kInFlightStages /
// (its SM's blocks, up to kBlocksPerSM, the launch bounds) stages (at
// least 3, at most 8) of 8 KB of weight in flight, so an SM holds 64-72
// KB in flight whatever the number of blocks it runs; never more stages
// than the block's walk (but 3), nor more than a block's shared memory.
#pragma once

namespace ptt_qm {

constexpr int kCols = 128;            // weight columns a block
constexpr int kTileRows = 64;         // packed weight rows a stage
constexpr int kStageBytes = kCols * kTileRows;
constexpr int kMaxRows = 16;          // rows of x the decode body takes
constexpr int kMaxSplits = 8;
constexpr int kMinBlocks = 3;         // half-blocks an SM the split aims at
constexpr int kBlocksPerSM = 3;       // the kernel's launch bounds
constexpr int kInFlightStages = 8;    // stages in flight an SM
constexpr int kMinStages = 3;
constexpr int kMaxStages = 8;
constexpr int kXBytesMax = 160 * 1024;
constexpr int kSmemSlack = 1024;      // aligning the ring to 1024 bytes
constexpr int kSmemMax = 232448;      // a block's opt-in limit (H100)

struct Plan {
  int body;     // 1: the decode body; 0: not this body's shape
  int splits;   // blocks of a cluster over K (grid x)
  int stages;   // weight stages in a block's ring
  int smem;     // dynamic shared memory a block, bytes
};

inline int cdiv(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

// Bytes of x's share of a block that walks `per` stages, staged once: a
// box of 8 or 16 rows x 128 bytes a stage and nibble half.
inline int x_bytes(int M, bool int4, int per) {
  return (int4 ? 2 : 1) * per * (M > 8 ? 16 : 8) * 128;
}

// Group scale rows of an int4 stage, each half: 1 for groups of whole
// stages (group % 64 == 0), 2 for group % 32 == 0, 4 for group % 16 == 0
// (a 16-row k step never straddles two groups); 0 for int8.
inline int scale_rows(bool int4, int group) {
  if (!int4) return 0;
  return group % 64 == 0 ? 1 : group % 32 == 0 ? 2 : 4;
}

// Bytes of a stage (a multiple of 1024, the weight box's alignment): the
// weight box, with xtma x's box(es) of XR = 8 or 16 rows x 128 bytes, and
// the scale rows of both halves (`selem` bytes a scale).
inline int stage_bytes(int M, bool int4, bool xtma, int srows, int selem) {
  const int b = kStageBytes +
                (xtma ? (int4 ? 2 : 1) * (M > 8 ? 16 : 8) * 128 : 0) +
                2 * srows * kCols * selem;
  return (b + 1023) / 1024 * 1024;
}

// Shared memory of a block that walks `per` stages: the ring, x's share
// (without xtma) and two mbarriers a stage.
inline int smem_bytes(int M, bool int4, bool xtma, int srows, int selem,
                      int per, int stages) {
  return kSmemSlack + stages * stage_bytes(M, int4, xtma, srows, selem) +
         (xtma ? 0 : x_bytes(M, int4, per)) + 16 * stages;
}

// x [M, K] (bf16/fp16) times a weight of K (int8) or K/2 (int4) packed
// rows and N columns (int4 scales in groups of `group` rows, `selem` bytes
// a scale), x by TMA or staged (`xtma`), on a card with `sms`
// multiprocessors.
inline Plan plan(int M, int K, int N, bool int4, int group, int selem,
                 bool xtma, int sms) {
  Plan p = {0, 0, 0, 0};
  if (M < 1 || M > kMaxRows || K < 1 || N < 1 || sms < 1 ||
      (int4 && (group <= 0 || group % 16)))
    return p;
  const int srows = scale_rows(int4, group);
  const int n_k = cdiv(int4 ? K / 2 : K, kTileRows);
  const long long cols = cdiv(N, kCols);
  for (int s = 1; s <= kMaxSplits; s *= 2) {
    const int per = cdiv(n_k, s);
    if (s > n_k || static_cast<long long>(s - 1) * per >= n_k) break;
    if (!xtma && x_bytes(M, int4, per) > kXBytesMax) continue;
    const long long blocks = cols * s;
    if (s < kMaxSplits && 2 * blocks < kMinBlocks * sms &&
        s * 2 <= n_k && static_cast<long long>(s * 2 - 1) *
                                cdiv(n_k, s * 2) < n_k)
      continue;     // too few blocks, and a larger split can be had
    const long long slots = static_cast<long long>(kBlocksPerSM) * sms;
    const int on_sm = cdiv(blocks < slots ? blocks : slots, sms);
    int stages = cdiv(kInFlightStages, on_sm);
    if (stages > kMaxStages) stages = kMaxStages;
    if (stages > per) stages = per;
    if (stages < kMinStages) stages = kMinStages;
    while (stages > kMinStages &&
           smem_bytes(M, int4, xtma, srows, selem, per, stages) > kSmemMax)
      --stages;
    p = {1, s, stages, smem_bytes(M, int4, xtma, srows, selem, per, stages)};
    break;
  }
  return p;
}

}  // namespace ptt_qm
