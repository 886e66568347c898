// Shared pieces of the flash kernels: flash_attention.cu (the bf16 /
// fp16 bodies and the C entry points) and flash_attention_f32.cu (the
// fp32 bodies, in a translation unit of their own so that the two
// compile in parallel): constants, the key-tile walk, the online
// softmax and the saved statistics that both kinds of body share, the
// launch shape, and the fp32 launchers the entry points call.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"
#include "hopper.cuh"

namespace ptt {
namespace flash {

using namespace ptt::sm90;

constexpr float kNegInf = -1e30f;    // flash_attention.py NEG_INF
constexpr int kSmemMax = 232448;     // H100 opt-in limit per block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;


// Number of key tiles a block of query rows [q0, q0 + rows) reads: every
// tile unless causal; under causal the tiles up to the last row's last
// live key (j <= i + off, off = sk - sq), none when no row has one.
// `full` (a row of the block may have no live key: the reference then
// weighs every key alike) walks every tile too.
__device__ __forceinline__ int live_key_tiles(int q0, int rows, int sq,
                                              int sk, int bk, int causal,
                                              int off, bool full) {
  const int all = (sk + bk - 1) / bk;
  if (!causal || full) return all;
  const int last = min(q0 + rows, sq) - 1 + off;
  return last < 0 ? 0 : min(all, last / bk + 1);
}

// The live keys of a key-bias row (ops/flash_attention.py::_key_range):
// [first, end) spans every key whose bias is above -1e30 (a dead key's
// is -1e30: a bool mask's padding, an additive one's at or below it; a
// finite bias such as -1e9 is live), first >= end for a row with none.
// `range` holds each row's (sk - first, end), (0, 0) for none, row b at
// 2 b (bstride 0: one row for every batch).
struct KeyRange {
  int first, end;
  // whether every row whose causal frontier (its last live key) is at or
  // past `frontier` has a live key (without causal: every row)
  __device__ __forceinline__ bool all_live(int causal, int frontier) const {
    return first < end && (!causal || frontier >= first);
  }
  // the key tiles of bk keys [tile0, tile_end) that hold the live keys
  __device__ __forceinline__ int tile0(int bk) const { return first / bk; }
  __device__ __forceinline__ int tile_end(int bk) const {
    return (end + bk - 1) / bk;
  }
};

__device__ __forceinline__ KeyRange key_range(const int* range, int b,
                                              int bstride, int sk) {
  const int2 r = reinterpret_cast<const int2*>(range)[bstride ? b : 0];
  return {sk - r.x, r.y};
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}


// Online softmax of one key tile for the rows r0 and r0 + 8 of a thread:
// s holds the raw scores q.k (the wgmma accumulator layout) and becomes
// p = exp2(s * sc - m) in place, sc = scale * log2 e; m and l are the
// running max (base-2 units) and sum; returns the factors that rescale
// the rows' earlier output.  `rl` is r0 + sk - sq, the last live key of
// row r0 under causal.  A key past sk weighs 0.  MASK bodies take
// sc = scale and keep natural units: the logit x = s * scale + bias (the
// tile's key bias `sb`, in shared memory), p = exp2((x - m) log2 e); a
// key that causal masks takes the logit -1e30, as a -1e30 bias gives: a
// row with no other key weighs them alike, and any live key outweighs
// them all.  EDGE 0 / 1: whether the tile is cut, known where the caller
// branched on `edge` once (no test inside the element loop); 2: `edge`
// tested in it.
template <int BK, bool MASK, int EDGE = 2>
__device__ __forceinline__ float2 softmax_tile(float* s, float& m0, float& m1,
                                               float& l0, float& l1, int k0,
                                               int sk, int rl, int t,
                                               float sc, bool edge,
                                               int causal, const float* sb) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x;
      if constexpr (MASK)
        x = fmaf(s[4 * j + e], sc, sb[8 * j + 2 * t + (e & 1)]);
      else
        x = s[4 * j + e] * sc;
      if (EDGE == 1 || (EDGE == 2 && edge)) {   // only on the tiles they cut
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        if constexpr (MASK) {
          if (key >= sk)
            x = -INFINITY;
          else if (causal && key > rl + 8 * (e >> 1))
            x = kNegInf;
        } else if (key >= sk || (causal && key > rl + 8 * (e >> 1))) {
          x = -INFINITY;
        }
      }
      s[4 * j + e] = x;
      if (e < 2)
        mx0 = fmaxf(mx0, x);
      else
        mx1 = fmaxf(mx1, x);
    }
  const float n0 = fmaxf(m0, quad_max(mx0));
  const float n1 = fmaxf(m1, quad_max(mx1));
  // a row with every key so far masked keeps p = 0 (no inf - inf)
  const float b0 = n0 == -INFINITY ? 0.f : n0;
  const float b1 = n1 == -INFINITY ? 0.f : n1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[4 * j + e] - (e < 2 ? b0 : b1);
      const float p = exp2_ftz(MASK ? x * kLog2e : x);
      s[4 * j + e] = p;
      if (e < 2)
        ps0 += p;
      else
        ps1 += p;
    }
  const float a0 = MASK ? exp2_ftz((m0 - b0) * kLog2e) : exp2_ftz(m0 - b0);
  const float a1 = MASK ? exp2_ftz((m1 - b1) * kLog2e) : exp2_ftz(m1 - b1);
  l0 = l0 * a0 + ps0;
  l1 = l1 * a1 + ps1;
  m0 = n0;
  m1 = n1;
  return make_float2(a0, a1);
}

// Save a row's statistics from its running max m and sum l: the
// natural-log lse from m in base-2 units; MASK bodies (m in natural
// units) the pair (m, log l), m = +inf marking a row whose every key is
// masked
template <bool MASK>
__device__ __forceinline__ void save_stats(float* lse, long long row, float m,
                                           float l) {
  if constexpr (MASK)
    reinterpret_cast<float2*>(lse)[row] =
        make_float2(m <= 0.5f * kNegInf ? INFINITY : m, log2f(l) * kLn2);
  else
    lse[row] = (m + log2f(l)) * kLn2;
}

template <typename K>
int opt_in(K kernel, size_t smem) {
  if (smem > static_cast<size_t>(kSmemMax))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax));
}

struct Shape {
  int B, sq, sk, h, hk, d;
  float scale;
  int causal;
  const float* bias;   // [B or 1, bstride] fp32 key bias, or nullptr
  const int* range;    // [B or 1, 2] its live keys (key_range), or nullptr
  int bstride;
};

inline int blocks(int n, int rows) { return (n + rows - 1) / rows; }

// the width of head dim d's shared-memory tiles: the next multiple of 64
constexpr int body_width(int d) { return (d + 63) / 64 * 64; }

// The width the bf16 / fp16 products of head dim d run over when it is
// not a multiple of 64: d rounded up to 16 where that is 16, 48, 80 or
// 160 (the bodies of flash_attention_narrow.cu), else 0 (the body of
// width body_width(d) takes d)
constexpr int narrow_width(int d) {
  const int w = (d + 15) / 16 * 16;
  return w == 16 || w == 48 || w == 80 || w == 160 ? w : 0;
}

// The narrow forward's key tile where one tile holds every key and the
// call takes no key bias (sk <= 80: the SD UNet's 77-token context): no
// tile of dead keys is scored, weighed or summed, and the bits are those
// of the longer tile (its dead keys add exact zeros) where that too was
// one tile
constexpr int kShortKeys = 80;

inline bool short_keys(const Shape& s) {
  return !s.bias && s.sk <= kShortKeys;
}

// The narrow bf16 (`bf16`) or fp16 bodies, with the key bias or without:
// the forward, and the backward's two launches; 0 or a CUDA error.
int fwd_narrow(const Shape& s, bool bf16, const void* q, const void* k,
               const void* v, void* out, void* lse, cudaStream_t st);
int bwd_narrow(const Shape& s, bool bf16, const void* q, const void* k,
               const void* v, const void* out, const void* dout,
               const void* lse, void* delta, void* dq, void* dk, void* dv,
               cudaStream_t st);


// The fp32 bodies of width `width` (64, 128, 192 or 256), with the key
// bias or without (flash_attention_f32.cu): the forward, and the
// backward's two launches (dq with delta, then dk/dv); 0 or a CUDA error.
int fwd_f32(const Shape& s, int width, bool mask, const float* q,
            const float* k, const float* v, float* out, float* lse,
            cudaStream_t st);
int bwd_f32(const Shape& s, int width, bool mask, const float* q,
            const float* k, const float* v, const float* out,
            const float* dout, const float* lse, float* delta, float* dq,
            float* dk, float* dv, cudaStream_t st);

}  // namespace flash
}  // namespace ptt
