// Weight-only quantized matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel
// paddle_tpu/ops/pallas/quant_matmul.py::quant_matmul (:58), bodies
// _kernel_int8 (:36) and _kernel_int4 (:45): out [M, N] = x [M, K] @
// dequant(qw), summed in fp32 and rounded to x's dtype T.
//   int8: qw [K, N] int8, scales [N] (per output channel);
//   int4: qw [K/2, N] int8, packed row r holding row r in its low nibble
//         and row r + K/2 in its high nibble (paddle_tpu/ops/__init__.py
//         pack_int4 :423), scales [K/group, N] (group divides K/2).
// Scales are of the weight's storage dtype S (fp32, bf16 or fp16).  Each
// weight element is dequantized as __fmul_rn((float)q, (float)s) and
// rounded to T — the plain version's q_f32 * s_f32 cast to x.dtype — so
// the weights match it bit for bit and only the order of the sums
// differs.  int4 nibbles unpack as unpack_int4 (:444): the byte is
// sign-extended, low = ((p & 15) ^ 8) - 8, high = p >> 4 (arithmetic).
//
// What bounds it on the H100: at decode (M = 8 slots) bytes — the packed
// weight is everything (int8 K*N bytes, int4 K*N/2 plus the group
// scales), ~5 us for a 4096 x 4096 int8 weight at 3.35 TB/s; at the
// admission chunks (M = 256 = 8 slots x 32 tokens) operations: 2 M K N
// bf16 FLOP, 8.7 us at [4096, 4096] against 5 us of bytes.  The weight
// stays at its packed width in device memory; no dequantized copy is
// ever written.  Four bodies, chosen by shape alone (the wrapper,
// ops/quant_matmul.py, asks `_takes_wgmma` first, then the decode plan
// of ptt_quant_matmul_plan; `rows` 0 or the wgmma body's row tile):
//
//   * decode body — bf16/fp16 x with M <= 16 (any K, N % 16 == 0, int4
//     groups a multiple of 16, x at any alignment; with x not by TMA, a
//     block's share of x must fit 160 KB: K up to ~40k at M = 16).  A GEMV bound by
//     bytes (16 flops a weight byte at M = 8, far under the ~295 where the
//     tensor cores become the limit), in practice by the dequantizing
//     instructions as much as by the stream:
//       - swap-AB on mma.sync m16n8k16: out^T = W^T x^T.  The dequantized
//         weight is the A operand, built in registers straight from the
//         raw bytes in the ring (dequant_k16, shared with the wgmma body:
//         PRMT, exact subtract, __fmul_rn, cvt2; nib_pair for int4 with
//         scales of x's dtype; int8 with bf16 scales one exact fma a
//         weight, frag_fma), a thread's rows g and g + 8 the adjacent
//         columns n, n + 1 (one 16-bit shared load a K row).  x^T is the
//         B operand, n = 8: M = 8 fills it, M <= 16 takes two n8 tiles;
//         no padded rows, and no dequantized tile in shared memory.
//       - a block owns 128 weight columns; warp 8 streams its K tiles
//         through a ring of `stages` (3-8) on full / empty mbarriers, a
//         stage one TMA box of the packed weight (64 rows x 128 columns,
//         8 KB, 128-byte swizzle, edges zero-filled: int4 rows are packed
//         rows, so its ring holds as many weight bytes as int8's), x's
//         box(es) of the same K rows (int4: columns k.. and K/2 + k..;
//         for x 16-byte aligned with K % 8 == 0), and for int4 the
//         group scale rows, on the stages where a group starts (each loaded once, off the weights'
//         critical path).  In-flight bytes by Little's law: 3.35 TB/s x
//         ~1.5 us over 132 SMs is ~38 KB an SM; the plan keeps 8 weight
//         stages (64 KB) in flight an SM, split among its blocks.
//       - warps 0-7 (x not by TMA: after staging the block's share of x
//         once, in the same swizzled layout, with 16-byte loads realigned
//         in registers) walk the ring: per 16-row k step, dequantize, two
//         32-bit loads of x per n8 tile, mma; each warp releases a stage.
//       - K split over a thread-block cluster of `splits` (1, 2, 4, 8)
//         blocks, reduced on chip: each block pushes its fp32 partials
//         to the owner of its warp's columns (distributed shared memory)
//         and the owner sums them in rank order, rounds once and stores.
//         One launch, no fp32 partials in device memory, bit-identical
//         launches.  The library owns the plan (csrc/quant_matmul_plan.cuh:
//         splits and stages from the shapes and the SM count).
//   * wgmma body — bf16/fp16 x with M > 16, K % 8 == 0 (x's rows are
//     16-byte strides for TMA), x 16-byte aligned, and for int4 a group
//     that is a multiple of 64.  Built for the admission chunk:
//       - swap-AB: out^T = W^T x^T.  The dequantized weight is the A
//         operand of `wgmma ... m64nBMk16` from registers and x^T the B
//         operand, K-major, straight from x's rows as TMA lays them
//         (128-byte swizzle); M is wgmma's N: BM = 128 or 256 rows a
//         block (`rows`), one block row per BM rows of M.  A block owns
//         a strip of 128 weight columns and all its BM rows, so each
//         strip is dequantized once per block.
//       - warp specialisation, three warpgroups: one thread of warpgroup
//         0 streams the K tiles through TMA into a ring of 4 stages (3
//         for int4 at BM = 256) on full/empty mbarriers: the x box
//         [BM, 64] (int4: two boxes, columns 64t.. and K/2 + 64t..) and
//         the packed weight box [64 rows, 128 columns] (128-byte
//         swizzle, edges zero-filled).  Warpgroups 1 and 2 own 64
//         weight columns each: a thread's A rows g and g + 8 are the
//         ADJACENT columns n, n + 1, so it reads both from one 16-bit
//         shared load per K row and stores both outputs as one 32-bit
//         word.
//       - the dequant stage overlaps the products: a consumer turns tile
//         i into A fragments in registers (bytes re-biased into fp32
//         mantissas with PRMT, an exact subtract, __fmul_rn by the
//         scale, one cvt.rn to a T pair), then issues tile i's wgmmas;
//         two A buffers keep tile i-1's products in flight while tile
//         i is dequantized.  int4: one 64-row tile feeds 8 k-steps, the
//         low nibbles against the first x box, the high against the
//         second, each half under one group scale row; with scales of
//         x's dtype the nibbles are biased into T pairs and multiplied
//         by the scale pair (q * s is exact before that one rounding).
//       - splits over K as a thread-block cluster of `splits` (1-4)
//         blocks along grid x, so that N = 4096 still fills the 132
//         SMs; ops/quant_matmul.py `_schedule` picks (rows, splits)
//         from a cost model over the clusters the card holds at once
//         (`ptt_quant_matmul_clusters`).  The blocks reduce in
//         distributed shared memory: after a cluster barrier each
//         pushes its fp32 partials of every share of the tile to the
//         share's owner, and after a second one the owner sums them in
//         rank order (deterministic), rounds once and stores.  No fp32
//         partials reach device memory, and it is one launch.
//     What is left between it and the card: each block reads its x row
//     tile from L2 once per 128-column strip, and a cluster's reduction
//     costs several us a wave, so the model avoids splits where the
//     waves allow; TMA multicast of x across a cluster along N is
//     untried.
//   * mma.sync body — every other bf16/fp16 shape (M > 16 that TMA
//     cannot take; M <= 16 with an int4 group that is not a multiple of
//     16, or whose x share overflows the decode plan):
//       - grid (N/128, M/BM, splits): a block owns 128 output columns
//         and BM rows, and walks its split's share of the K tiles.
//         N/128 column blocks alone are 32 at N = 4096, so K is split
//         (fp32 partials [splits, M, N], summed by a second launch)
//         until ~4 blocks per SM exist — the wrapper picks `splits`
//         (ops/quant_matmul.py::_splits).
//       - a K tile is 64 logical rows.  int8: rows 64t..64t+63.  int4:
//         the 32 packed rows 32t..32t+31, whose low nibbles are logical
//         rows 32t.. and whose high nibbles are rows K/2+32t..; the x
//         tile takes the same two column ranges, so both formats feed
//         one product.
//       - each thread loads 16 bytes of a weight row along N (16 int8 or
//         32 int4 values; a warp reads four 128-byte rows), the next
//         tile's bytes are in flight in registers while the current tile
//         is dequantized and multiplied.
//       - the tile is dequantized into shared memory as T, and 8 warps
//         run mma.sync m16n8k16 (fp32 accumulate), each on 16 columns
//         and all BM = 64 rows.
//   * fp32 activations: a CUDA-core kernel, one column a thread, 8 rows
//     a block, the x tile in shared memory (split over K as above).
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "quant_matmul_plan.cuh"

namespace {

constexpr int kBN = 128;      // output columns per block
constexpr int kBK = 64;       // logical K rows per tile
constexpr int kThreads = 256; // mma kernel: 8 warps
constexpr int kSimtRows = 8;  // fp32 kernel: rows per block

// 16 consecutive scales starting at s[off] (16-byte aligned) as floats
template <typename S>
__device__ __forceinline__ void load_scales16(const S* __restrict__ s,
                                              long long off, float* f) {
  constexpr int V = ptt::Vec<S>::N;
#pragma unroll
  for (int u = 0; u < 16; u += V) ptt::load_vec(s + off + u, f + u);
}

template <typename T>
__device__ __forceinline__ uint32_t pack_raw(T lo, T hi) {
  unsigned short a, b;
  memcpy(&a, &lo, 2);
  memcpy(&b, &hi, 2);
  return static_cast<uint32_t>(a) | (static_cast<uint32_t>(b) << 16);
}

// 16 dequantized values (q[u] * s[u], each rounded to T) into dst,
// 16-byte aligned: two vector stores
template <typename T>
__device__ __forceinline__ void store_dequant16(T* dst, const float* q,
                                                const float* s) {
  alignas(16) T v[16];
#pragma unroll
  for (int u = 0; u < 16; ++u) v[u] = ptt::from_f<T>(__fmul_rn(q[u], s[u]));
  reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(v)[0];
  reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(v)[1];
}

template <typename T>
__device__ __forceinline__ void store_zero16(T* dst) {
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  reinterpret_cast<uint4*>(dst)[0] = z;
  reinterpret_cast<uint4*>(dst)[1] = z;
}

// logical column i (0..63) of K tile t: its row of K, or -1 past the end
template <bool INT4>
__device__ __forceinline__ int tile_row(int t, int i, int K) {
  if (INT4) {
    const int Kh = K / 2;
    const int r = t * 32 + (i & 31);
    if (r >= Kh) return -1;
    return i < 32 ? r : Kh + r;
  }
  const int k = t * kBK + i;
  return k < K ? k : -1;
}

// Tensor-core kernel for T = bf16 / fp16: BM = 64 rows a block.
template <typename T, typename S, bool INT4>
__global__ void __launch_bounds__(kThreads) quant_matmul_mma_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ qw,
    const S* __restrict__ sc, T* __restrict__ out, float* __restrict__ part,
    int M, int K, int N, int group, int per_split) {
  constexpr int MT = 4;
  constexpr int BM = 16 * MT;
  constexpr int AS = kBK + 8;   // row strides in T, rows stay 16-byte
  constexpr int WS = kBN + 8;   // aligned and fragment loads spread
  __shared__ __align__(16) T As[BM * AS];
  __shared__ __align__(16) T Ws[kBK * WS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int n_k = (K + kBK - 1) / kBK;
  const int t_begin = blockIdx.z * per_split;
  const int t_end = min(n_k, t_begin + per_split);
  const int Kh = K / 2;

  // this thread's weight chunk: 16 columns, rows wr and wr + 32 (int8)
  // or packed row wr (int4) of every tile
  const int chunk = tid & 7;
  const int wr = tid >> 3;
  const int n = n0 + chunk * 16;
  const bool col_ok = n < N;
  float s8[16];
  if (!INT4 && col_ok) load_scales16(sc, n, s8);

  auto load_w = [&](int t, uint4* raw) {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    if (INT4) {
      const int r = t * 32 + wr;
      raw[0] = (col_ok && r < Kh)
          ? __ldg(reinterpret_cast<const uint4*>(
                qw + static_cast<long long>(r) * N + n))
          : z;
      raw[1] = z;
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = t * kBK + wr + 32 * j;
        raw[j] = (col_ok && k < K)
            ? __ldg(reinterpret_cast<const uint4*>(
                  qw + static_cast<long long>(k) * N + n))
            : z;
      }
    }
  };

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  uint4 cur[2], nxt[2];
  if (t_begin < t_end) load_w(t_begin, cur);
  for (int t = t_begin; t < t_end; ++t) {
    if (t + 1 < t_end) load_w(t + 1, nxt);
    // x tile [BM, 64] in the tile's logical column order
    for (int e = tid; e < BM * kBK; e += kThreads) {
      const int mm = e / kBK;
      const int i = e - mm * kBK;
      const int k = tile_row<INT4>(t, i, K);
      const int m = m0 + mm;
      As[mm * AS + i] = (k >= 0 && m < M)
          ? x[static_cast<long long>(m) * K + k] : ptt::from_f<T>(0.f);
    }
    // dequantize this thread's 16 bytes into the weight tile
    if (INT4) {
      const int r = t * 32 + wr;
      T* lo_dst = Ws + wr * WS + chunk * 16;
      T* hi_dst = Ws + (wr + 32) * WS + chunk * 16;
      if (col_ok && r < Kh) {
        const int8_t* b = reinterpret_cast<const int8_t*>(&cur[0]);
        float lo[16], hi[16], slo[16], shi[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int p = b[u];
          lo[u] = static_cast<float>(((p & 15) ^ 8) - 8);
          hi[u] = static_cast<float>(p >> 4);
        }
        load_scales16(sc, static_cast<long long>(r / group) * N + n, slo);
        load_scales16(sc, static_cast<long long>((Kh + r) / group) * N + n,
                      shi);
        store_dequant16(lo_dst, lo, slo);
        store_dequant16(hi_dst, hi, shi);
      } else {
        store_zero16(lo_dst);
        store_zero16(hi_dst);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int rr = wr + 32 * j;
        T* dst = Ws + rr * WS + chunk * 16;
        if (col_ok && t * kBK + rr < K) {
          const int8_t* b = reinterpret_cast<const int8_t*>(&cur[j]);
          float q[16];
#pragma unroll
          for (int u = 0; u < 16; ++u) q[u] = static_cast<float>(b[u]);
          store_dequant16(dst, q, s8);
        } else {
          store_zero16(dst);
        }
      }
    }
    __syncthreads();
    // warp `warp` owns tile columns warp*16 .. warp*16+15 (two n8 tiles)
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t bf[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const T* wc = Ws + (ks * 16 + 2 * t4) * WS + warp * 16 + nt * 8 + g;
        bf[nt][0] = pack_raw<T>(wc[0], wc[WS]);
        bf[nt][1] = pack_raw<T>(wc[8 * WS], wc[9 * WS]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const T* ar = As + (mt * 16 + g) * AS + ks * 16 + 2 * t4;
        const uint32_t af[4] = {ptt::ld32(ar), ptt::ld32(ar + 8 * AS),
                                ptt::ld32(ar + 8), ptt::ld32(ar + 8 * AS + 8)};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          ptt::mma_16816<T>(acc[mt][nt], af, bf[nt]);
      }
    }
    __syncthreads();
    cur[0] = nxt[0];
    cur[1] = nxt[1];
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + mt * 16 + g + ((e & 2) ? 8 : 0);
        const int nn = n0 + warp * 16 + nt * 8 + 2 * t4 + (e & 1);
        if (m >= M || nn >= N) continue;
        const long long o = static_cast<long long>(m) * N + nn;
        if (part == nullptr)
          out[o] = ptt::from_f<T>(acc[mt][nt][e]);
        else
          part[static_cast<long long>(blockIdx.z) * M * N + o] =
              acc[mt][nt][e];
      }
}

// CUDA-core kernel for fp32 activations: thread = one column, block = 8
// rows, the x tile [8, 64] in shared memory.
template <typename S, bool INT4>
__global__ void __launch_bounds__(kBN) quant_matmul_simt_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ qw,
    const S* __restrict__ sc, float* __restrict__ out,
    float* __restrict__ part, int M, int K, int N, int group,
    int per_split) {
  __shared__ float Xs[kSimtRows][kBK];
  const int tid = threadIdx.x;
  const int n = blockIdx.x * kBN + tid;
  const int m0 = blockIdx.y * kSimtRows;
  const int n_k = (K + kBK - 1) / kBK;
  const int t_begin = blockIdx.z * per_split;
  const int t_end = min(n_k, t_begin + per_split);
  const int Kh = K / 2;
  const bool col_ok = n < N;
  const float s8 = (!INT4 && col_ok) ? ptt::to_f(sc[n]) : 0.f;
  float acc[kSimtRows];
#pragma unroll
  for (int m = 0; m < kSimtRows; ++m) acc[m] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    for (int e = tid; e < kSimtRows * kBK; e += kBN) {
      const int mm = e / kBK;
      const int i = e - mm * kBK;
      const int k = tile_row<INT4>(t, i, K);
      const int m = m0 + mm;
      Xs[mm][i] = (k >= 0 && m < M) ? x[static_cast<long long>(m) * K + k]
                                    : 0.f;
    }
    __syncthreads();
    if (col_ok) {
      if (INT4) {
        for (int i = 0; i < 32; ++i) {
          const int r = t * 32 + i;
          if (r >= Kh) break;
          const int p = qw[static_cast<long long>(r) * N + n];
          const float wl = __fmul_rn(
              static_cast<float>(((p & 15) ^ 8) - 8),
              ptt::to_f(sc[static_cast<long long>(r / group) * N + n]));
          const float wh = __fmul_rn(
              static_cast<float>(p >> 4),
              ptt::to_f(sc[static_cast<long long>((Kh + r) / group) * N + n]));
#pragma unroll
          for (int m = 0; m < kSimtRows; ++m)
            acc[m] = fmaf(Xs[m][i + 32], wh, fmaf(Xs[m][i], wl, acc[m]));
        }
      } else {
        for (int i = 0; i < kBK; ++i) {
          const int k = t * kBK + i;
          if (k >= K) break;
          const float w = __fmul_rn(
              static_cast<float>(qw[static_cast<long long>(k) * N + n]), s8);
#pragma unroll
          for (int m = 0; m < kSimtRows; ++m) acc[m] = fmaf(Xs[m][i], w, acc[m]);
        }
      }
    }
    __syncthreads();
  }
  if (!col_ok) return;
#pragma unroll
  for (int mm = 0; mm < kSimtRows; ++mm) {
    const int m = m0 + mm;
    if (m >= M) break;
    const long long o = static_cast<long long>(m) * N + n;
    if (part == nullptr)
      out[o] = acc[mm];
    else
      part[static_cast<long long>(blockIdx.z) * M * N + o] = acc[mm];
  }
}

// out[i] = sum over the splits of part[s][i], rounded to T
template <typename T>
__global__ void quant_matmul_reduce(const float* __restrict__ part,
                                    T* __restrict__ out, long long MN,
                                    int splits) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < MN; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < splits; ++s) a += part[s * MN + i];
    out[i] = ptt::from_f<T>(a);
  }
}

template <typename T, typename S, bool INT4>
int launch(cudaStream_t st, const void* x, const void* qw, const void* sc,
           void* out, void* part, int M, int K, int N, int group,
           int splits, int per) {
  const unsigned gx = static_cast<unsigned>((N + kBN - 1) / kBN);
  if constexpr (std::is_same<T, float>::value) {
    const dim3 grid(gx, static_cast<unsigned>((M + kSimtRows - 1) / kSimtRows),
                    static_cast<unsigned>(splits));
    quant_matmul_simt_kernel<S, INT4><<<grid, kBN, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(qw),
        static_cast<const S*>(sc), static_cast<float*>(out),
        static_cast<float*>(part), M, K, N, group, per);
  } else {
    const dim3 grid(gx, static_cast<unsigned>((M + 63) / 64),
                    static_cast<unsigned>(splits));
    quant_matmul_mma_kernel<T, S, INT4><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const int8_t*>(qw),
        static_cast<const S*>(sc), static_cast<T*>(out),
        static_cast<float*>(part), M, K, N, group, per);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return static_cast<int>(err);
  const long long MN = static_cast<long long>(M) * N;
  const long long want = (MN + 255) / 256;
  const unsigned blocks = static_cast<unsigned>(want < 1056 ? want : 1056);
  quant_matmul_reduce<T><<<blocks, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<T*>(out), MN, splits);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// wgmma body (bf16 / fp16 x, the admission chunks)
// ---------------------------------------------------------------------------
using namespace ptt::sm90;

constexpr int kWgThreads = 384;    // warpgroup 0 loads, 1 and 2 compute
constexpr int kWgConsumers = 256;  // consumer threads (a stage's arrivals)
constexpr int kWgBN = 128;         // weight columns per block
constexpr int kWgKT = 64;          // packed weight rows per K tile
constexpr int kMaxSplits = 4;      // blocks of a cluster over K
// weight formats: int8; int4 dequantized in fp32; int4 with scales of x's
// dtype, dequantized in T pairs; int8 with bf16 scales, each weight one
// fma (the decode body)
enum Fmt { kInt8 = 0, kInt4 = 1, kInt4Pairs = 2, kInt8Fma = 3 };
constexpr int kSmemMax = ptt_qm::kSmemMax;   // opt-in limit per block

// Bytes of the cluster reduction's landing area in a block's ring: for
// `splits` blocks, each block's share of the J accumulator groups (four
// floats a consumer thread) from every rank, at an odd stride of float4s
// so neighbouring threads fall on other banks; the most over the sizes.
constexpr int red_bytes(int J) {
  int most = 0;
  for (int s = 2; s <= kMaxSplits; ++s) {
    const int b = s * kWgConsumers * (((J + s - 1) / s) | 1) * 16;
    most = b > most ? b : most;
  }
  return most;
}

template <bool INT4, int BM>
struct WgCfg {
  static constexpr int kXBox = BM * 128;             // [BM, 64] of x
  static constexpr int kX = (INT4 ? 2 : 1) * kXBox;
  static constexpr int kW = kWgKT * kWgBN;           // packed weight bytes
  static constexpr int kStage = kX + kW;
  static constexpr int NS = (INT4 && BM == 256) ? 3 : 4;
  static constexpr int kRing = NS * kStage;
  static_assert(red_bytes(BM / 8) <= kRing,
                "the cluster reduction reuses the ring");
  static constexpr size_t kSmem = kRing + 8 * 2 * NS + 1024;
  static_assert(kSmem <= kSmemMax, "shared memory");
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ uint32_t lds16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// two scales s[i], s[i + 1] (i even) of storage dtype sd as floats
__device__ __forceinline__ float2 load_scale2(const void* s, long long i,
                                              int sd) {
  if (sd == ptt::kF32)
    return __ldg(reinterpret_cast<const float2*>(
        static_cast<const float*>(s) + i));
  const uint32_t u = __ldg(reinterpret_cast<const unsigned int*>(
      static_cast<const uint16_t*>(s) + i));
  const uint16_t lo = static_cast<uint16_t>(u), hi = static_cast<uint16_t>(
                                                     u >> 16);
  if (sd == ptt::kBF16)
    return make_float2(__bfloat162float(__ushort_as_bfloat16(lo)),
                       __bfloat162float(__ushort_as_bfloat16(hi)));
  return make_float2(__half2float(__ushort_as_half(lo)),
                     __half2float(__ushort_as_half(hi)));
}

// (lo, hi) rounded to T as one 32-bit word, lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t cvt2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t cvt2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t cvt2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// byte i of w, which holds a code plus `bias` (0..255), as the exact
// float of the code: the byte becomes the low mantissa bits of 2^23
template <int I>
__device__ __forceinline__ float code_of(uint32_t w, float bias) {
  return __int_as_float(static_cast<int>(__byte_perm(w, 0x4B000000u,
                                                     0x7650 + I))) -
         (8388608.f + bias);
}

// T pairs: the bias word whose lanes hold 2^7 (bf16) or 2^10 (fp16), so
// that OR-ing a nibble m + 8 (0..15) into a lane's mantissa gives the
// exact value base + m + 8, and the pair (base + 8, base + 8)
template <typename T>
struct Pair;
template <>
struct Pair<__nv_bfloat16> {
  using V = __nv_bfloat162;
  static constexpr uint32_t kBias = 0x43004300u;     // 128, 128
  static constexpr uint32_t kBase8 = 0x43084308u;    // 136, 136
};
template <>
struct Pair<__half> {
  using V = __half2;
  static constexpr uint32_t kBias = 0x64006400u;     // 1024, 1024
  static constexpr uint32_t kBase8 = 0x64086408u;    // 1032, 1032
};

template <typename T>
__device__ __forceinline__ typename Pair<T>::V as_pair(uint32_t u) {
  return *reinterpret_cast<const typename Pair<T>::V*>(&u);
}

// Nibbles of bytes 0 and 2 of w (low nibbles, or high ones for HI) as the
// int4 codes q in a T pair, times the pair s2: the code is exact in T,
// and q * s (at most 4 + 11 significant bits) is exact before the pair
// multiply rounds it once, as the fp32 product rounded to T would be.
template <typename T, bool HI>
__device__ __forceinline__ uint32_t nib_pair(uint32_t w, uint32_t s2) {
  const uint32_t m = ((HI ? w >> 4 : w) & 0x000F000Fu) ^ 0x00080008u;
  const typename Pair<T>::V q = __hsub2(as_pair<T>(m | Pair<T>::kBias),
                                        as_pair<T>(Pair<T>::kBase8));
  const typename Pair<T>::V r = __hmul2(q, as_pair<T>(s2));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// One A fragment pair from four biased codes e0..e3 = W[k][n],
// W[k + 1][n], W[k][n + 1], W[k + 1][n + 1]: rows n and n + 1 at k, k + 1,
// each weight q * s rounded once to T (s: the scales of columns n, n + 1).
template <typename T>
__device__ __forceinline__ void frag_pair(uint32_t w, float bias, float2 s,
                                          uint32_t& row_n, uint32_t& row_n1) {
  row_n = cvt2<T>(__fmul_rn(code_of<0>(w, bias), s.x),
                  __fmul_rn(code_of<1>(w, bias), s.x));
  row_n1 = cvt2<T>(__fmul_rn(code_of<2>(w, bias), s.y),
                   __fmul_rn(code_of<3>(w, bias), s.y));
}

// frag_pair for int8 codes biased by 128 under one bf16 scale a column (s:
// columns n, n + 1): with s's 8 significant bits, (2^23 + 128) s is exact
// in fp32, so one fma of the biased code's float 2^23 + q + 128 gives
// (2^23 + q + 128) s - (2^23 + 128) s = q s exactly, the value that
// __fmul_rn(q, s) gives, before the one rounding to T.
template <typename T>
__device__ __forceinline__ void frag_fma(uint32_t w, float2 s,
                                         uint32_t& row_n, uint32_t& row_n1) {
  const float cx = s.x * 8388736.f, cy = s.y * 8388736.f;
  const auto raw = [w](int sel) {
    return __int_as_float(static_cast<int>(__byte_perm(w, 0x4B000000u,
                                                       sel)));
  };
  row_n = cvt2<T>(fmaf(raw(0x7650), s.x, -cx), fmaf(raw(0x7651), s.x, -cx));
  row_n1 = cvt2<T>(fmaf(raw(0x7652), s.y, -cy), fmaf(raw(0x7653), s.y, -cy));
}

// k step kk (K rows 16 kk .. 16 kk + 15) of a K tile of the packed weight
// in shared memory (`wt`: [64 rows][128 bytes], 128-byte swizzle) as this
// thread's A fragments: columns n, n + 1 (rows g, g + 8 of its warp's A
// slice), K rows 16 kk + {2t, 2t + 1, 2t + 8, 2t + 9}.  off_e / off_o:
// the swizzled byte offset of the thread's two columns in a row r with
// r % 8 == 2t / 2t + 1.  int8: a[0..3] (scales lo, columns n, n + 1);
// int4: a[0..3] from the low nibbles (lo), h[0..3] from the high ones
// (hi), the k step within one group.  kInt4Pairs works in T pairs; the
// other formats dequantize in fp32.
template <typename T, int FMT>
__device__ __forceinline__ void dequant_k16(const uint8_t* wt, int kk, int t,
                                            int off_e, int off_o, float2 lo,
                                            float2 hi, uint32_t* a,
                                            uint32_t* h) {
  const uint8_t* r = wt + (16 * kk + 2 * t) * 128;
  const uint32_t u0 = lds16(r + off_e), u1 = lds16(r + 128 + off_o);
  const uint32_t u2 = lds16(r + 1024 + off_e);
  const uint32_t u3 = lds16(r + 1152 + off_o);
  if (FMT == kInt4Pairs) {
    // bytes 0 and 2: W[k][n], W[k + 1][n] (column n), or column n + 1
    const uint32_t p0 = __byte_perm(u0, u1, 0x0400);
    const uint32_t p1 = __byte_perm(u0, u1, 0x0501);
    const uint32_t p8 = __byte_perm(u2, u3, 0x0400);
    const uint32_t p9 = __byte_perm(u2, u3, 0x0501);
    // (s, s) of column n and of n + 1, exact in T
    const uint32_t sn = cvt2<T>(lo.x, lo.x), sn1 = cvt2<T>(lo.y, lo.y);
    const uint32_t hn = cvt2<T>(hi.x, hi.x), hn1 = cvt2<T>(hi.y, hi.y);
    a[0] = nib_pair<T, false>(p0, sn);
    a[1] = nib_pair<T, false>(p1, sn1);
    a[2] = nib_pair<T, false>(p8, sn);
    a[3] = nib_pair<T, false>(p9, sn1);
    h[0] = nib_pair<T, true>(p0, hn);
    h[1] = nib_pair<T, true>(p1, hn1);
    h[2] = nib_pair<T, true>(p8, hn);
    h[3] = nib_pair<T, true>(p9, hn1);
    return;
  }
  // bytes W[k][n], W[k + 1][n], W[k][n + 1], W[k + 1][n + 1]
  const uint32_t w0 = __byte_perm(u0, u1, 0x5140);
  const uint32_t w8 = __byte_perm(u2, u3, 0x5140);
  if (FMT == kInt4) {
    // nibble + 8 in each byte: low = ((p & 15) ^ 8), high likewise of
    // p >> 4 (sign-extension and ^ 8 - 8 agree on a nibble)
    const uint32_t l0 = (w0 & 0x0F0F0F0Fu) ^ 0x08080808u;
    const uint32_t l8 = (w8 & 0x0F0F0F0Fu) ^ 0x08080808u;
    const uint32_t h0 = ((w0 >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
    const uint32_t h8 = ((w8 >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
    frag_pair<T>(l0, 8.f, lo, a[0], a[1]);
    frag_pair<T>(l8, 8.f, lo, a[2], a[3]);
    frag_pair<T>(h0, 8.f, hi, h[0], h[1]);
    frag_pair<T>(h8, 8.f, hi, h[2], h[3]);
  } else if (FMT == kInt8Fma) {
    frag_fma<T>(w0 ^ 0x80808080u, lo, a[0], a[1]);
    frag_fma<T>(w8 ^ 0x80808080u, lo, a[2], a[3]);
  } else {
    frag_pair<T>(w0 ^ 0x80808080u, 128.f, lo, a[0], a[1]);
    frag_pair<T>(w8 ^ 0x80808080u, 128.f, lo, a[2], a[3]);
  }
}

// Dequantize one K tile (64 packed rows) into this thread's A fragments,
// one k step at a time (dequant_k16): int8 a[0..3]; int4 a[0..3] from
// the low nibbles (scales s_lo), a[4..7] from the high ones (s_hi).
template <typename T, int FMT>
__device__ __forceinline__ void dequant_tile(const uint8_t* wt, int t,
                                             int off_e, int off_o,
                                             float2 s_lo, float2 s_hi,
                                             uint32_t (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    dequant_k16<T, FMT>(wt, kk, t, off_e, off_o, s_lo, s_hi, a[kk],
                        FMT == kInt8 ? nullptr : a[kk + 4]);
}

// out[m][n], out[m][n + 1] from D rows (n, n + 1) at column m = 8j + 2t
// (lo) and m + 1 (hi): v = (D[n][m], D[n][m + 1], D[n + 1][m],
// D[n + 1][m + 1]), the accumulator order
template <typename T>
__device__ __forceinline__ void store_pairs(T* out, long long N, int M,
                                            int m, int n, bool col_ok,
                                            float4 v) {
  if (!col_ok) return;
  if (m < M)
    *reinterpret_cast<uint32_t*>(out + m * N + n) = cvt2<T>(v.x, v.z);
  if (m + 1 < M)
    *reinterpret_cast<uint32_t*>(out + (m + 1) * N + n) = cvt2<T>(v.y, v.w);
}

// A consumer thread's walk over its split's K tiles: wait for tile i's
// stage, dequantize it into A fragments, issue its wgmmas, free it.
// int8 scales are the thread's two columns' (read once); int4 ones are
// tile i's two group rows, the next tile's read while this one is
// dequantized.
template <typename T, int FMT, int BM>
struct WgTiles {
  static constexpr bool INT4 = FMT != kInt8;
  using C = WgCfg<INT4, BM>;
  static constexpr int KS = INT4 ? 8 : 4;   // k-steps of 16 a K tile
  uint8_t* ring;
  uint64_t* full;
  uint64_t* empty;
  const void* sc;
  int sd, N, group, Kh, t0, n_t, n, t, off_e, off_o;
  float2 s_lo = make_float2(0.f, 0.f), s_hi = make_float2(0.f, 0.f);

  __device__ __forceinline__ void group_scales(int i) {
    const int k = (t0 + min(i, n_t - 1)) * kWgKT;
    s_lo = load_scale2(sc, static_cast<long long>(k / group) * N + n, sd);
    s_hi = load_scale2(sc, static_cast<long long>((Kh + k) / group) * N + n,
                       sd);
  }

  __device__ __forceinline__ void first_scales() {
    if (INT4)
      group_scales(0);
    else
      s_lo = load_scale2(sc, n, sd);
  }

  __device__ __forceinline__ void dequant(int i, uint32_t (*a)[4]) {
    const int st = i % C::NS;
    const float2 lo = s_lo, hi = s_hi;
    if (INT4 && n < N) group_scales(i + 1);
    mbar_wait(full + st, (i / C::NS) & 1);
    dequant_tile<T, FMT>(ring + st * C::kStage + C::kX, t, off_e, off_o,
                         lo, hi, a);
  }

  __device__ __forceinline__ void issue(int i, uint32_t (*a)[4],
                                        float* acc) {
    const uint32_t xs = smem_u32(ring + (i % C::NS) * C::kStage);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      Wgmma<T, BM>::rsk(acc, a[kk], kdesc(xs, BM, kk), 1);
    wgmma_commit();
  }

  __device__ __forceinline__ void release(int i) {
    mbar_arrive(empty + i % C::NS);
  }
};

template <typename T, int FMT, int BM>
__global__ void __launch_bounds__(kWgThreads, 1) quant_matmul_wgmma(
    const __grid_constant__ CUtensorMap mx,
    const __grid_constant__ CUtensorMap mw, const void* __restrict__ sc,
    int sd, T* __restrict__ out, int M, int K, int N, int group, int n_k,
    int per) {
  constexpr bool INT4 = FMT != kInt8;
  using C = WgCfg<INT4, BM>;
  constexpr int NS = C::NS;
  constexpr int KS = WgTiles<T, FMT, BM>::KS;
  extern __shared__ __align__(1024) uint8_t qm_tiles[];
  uint8_t* const ring = align1024(qm_tiles);
  uint64_t* const full = reinterpret_cast<uint64_t*>(ring + C::kRing);
  uint64_t* const empty = full + NS;
  const int splits = gridDim.x, rank = blockIdx.x;
  const int n0 = blockIdx.y * kWgBN, m0 = blockIdx.z * BM;
  const int t0 = rank * per;
  const int n_t = max(0, min(n_k, t0 + per) - t0);
  const int Kh = K / 2;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kWgConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // -- producer --------------------------------------------------------
    reg_dealloc<24>();
    if (threadIdx.x == 0) {
      for (int i = 0; i < n_t; ++i) {
        const int st = i % NS;
        mbar_wait(empty + st, ((i / NS) & 1) ^ 1);
        mbar_expect_tx(full + st, C::kStage);
        uint8_t* const s = ring + st * C::kStage;
        const int k = (t0 + i) * kWgKT;
        tma_load_2d(s, &mx, full + st, k, m0);
        if (INT4) tma_load_2d(s + C::kXBox, &mx, full + st, Kh + k, m0);
        tma_load_2d(s + C::kX, &mw, full + st, n0, k);
      }
    }
    if (splits > 1) {       // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
  } else {
    // -- consumers: 64 weight columns each, all BM rows ---------------------
    reg_alloc<240>();
    const int c = threadIdx.x / 128 - 1;
    const int tw = threadIdx.x & 127;
    const int w = tw >> 5, lane = tw & 31, g = lane >> 2, t = lane & 3;
    const int nl = c * 64 + 16 * w + 2 * g;     // A rows g, g + 8
    const int n = n0 + nl;
    const bool col_ok = n < N;
    const int chunk = nl >> 4;
    const int off_e = ((chunk ^ (2 * t)) << 4) + 2 * g;
    const int off_o = ((chunk ^ (2 * t + 1)) << 4) + 2 * g;
    float acc[BM / 2];
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
    uint32_t a0[KS][4], a1[KS][4];
    WgTiles<T, FMT, BM> tl{ring, full, empty, sc, sd, N, group, Kh, t0,
                           n_t, n, t, off_e, off_o};
    if (col_ok && n_t > 0) tl.first_scales();
    // tile i's products run while tile i + 1 is dequantized into the
    // other A buffer: two tiles' products are in flight from the second
    // tile on, the older one retired before its buffer is rewritten.  The
    // two-tile prologue is unconditional so that ptxas sees the same
    // groups in flight on every path into the loop (a conditional one
    // made it serialize the wgmmas, C7513).
    if (n_t >= 2) {
      tl.dequant(0, a0);
      tl.issue(0, a0, acc);
      tl.dequant(1, a1);
      tl.issue(1, a1, acc);
      int i = 2;
      for (; i + 1 < n_t; i += 2) {
        wgmma_wait<1>();
        tl.release(i - 2);
        tl.dequant(i, a0);
        tl.issue(i, a0, acc);
        wgmma_wait<1>();
        tl.release(i - 1);
        tl.dequant(i + 1, a1);
        tl.issue(i + 1, a1, acc);
      }
      if (i < n_t) {
        wgmma_wait<1>();
        tl.release(i - 2);
        tl.dequant(i, a0);
        tl.issue(i, a0, acc);
      }
      wgmma_wait<0>();
      fence_regs<BM / 2>(acc);
    } else if (n_t == 1) {
      tl.dequant(0, a0);
      tl.issue(0, a0, acc);
      wgmma_wait<0>();
      fence_regs<BM / 2>(acc);
    }
    // accumulator 4j + e is D[n + (e >> 1)][8j + 2t + (e & 1)]
    if (splits == 1) {
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
        store_pairs<T>(out, N, M, m0 + 8 * j + 2 * t, n, col_ok,
                       make_float4(acc[4 * j], acc[4 * j + 1],
                                   acc[4 * j + 2], acc[4 * j + 3]));
    } else {
      // reduce-scatter over the cluster: block r owns the r-th share of
      // j; once every block's products are done (the first barrier),
      // each pushes its partial of every j to the j's owner (posted
      // stores into the owner's ring), and after the second barrier the
      // owner sums the partials in rank order (deterministic)
      constexpr int J = BM / 8;
      const int ct = c * 128 + tw;
      const int stride = ((J + splits - 1) / splits) | 1;  // float4s, odd
      const uint32_t buf = smem_u32(ring);
      cluster_sync();
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int owner = ((j + 1) * splits - 1) / J;
        const int jl = j - owner * J / splits;
        const int slot = (rank * kWgConsumers + ct) * stride + jl;
        st_cluster_f4(map_rank(buf + slot * 16, owner),
                      make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                                  acc[4 * j + 3]));
      }
      cluster_sync();
      const float4* part = reinterpret_cast<const float4*>(ring);
      const int jb = rank * J / splits, je = (rank + 1) * J / splits;
      for (int j = jb; j < je; ++j) {
        float4 s = part[ct * stride + j - jb];
        for (int q = 1; q < splits; ++q) {
          const float4 v = part[(q * kWgConsumers + ct) * stride + j - jb];
          s.x += v.x;
          s.y += v.y;
          s.z += v.z;
          s.w += v.w;
        }
        store_pairs<T>(out, N, M, m0 + 8 * j + 2 * t, n, col_ok, s);
      }
    }
  }
}

template <typename K>
int opt_in(K kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <typename T, int FMT, int BM>
int launch_wgmma(cudaStream_t st, const void* x, const void* qw,
                 const void* sc, int sd, void* out, int M, int K, int N,
                 int group, int splits) {
  constexpr bool INT4 = FMT != kInt8;
  using C = WgCfg<INT4, BM>;
  const auto kernel = quant_matmul_wgmma<T, FMT, BM>;
  static const int rc_opt = opt_in(kernel, C::kSmem);
  if (rc_opt) return rc_opt;
  const int Kp = INT4 ? K / 2 : K;       // packed weight rows
  int n_k = (Kp + kWgKT - 1) / kWgKT;
  int per = (n_k + splits - 1) / splits;
  if (splits > n_k || (splits - 1) * per >= n_k)
    return static_cast<int>(cudaErrorInvalidValue);   // an empty split
  CUtensorMap mx, mw;
  if (!map_2d(&mx, x, 2, K, M, 2ll * K, 64, BM) ||
      !map_2d(&mw, qw, 1, N, Kp, N, kWgBN, kWgKT))
    return static_cast<int>(cudaErrorInvalidValue);
  T* out_t = static_cast<T*>(out);
  void* args[] = {&mx, &mw, &sc, &sd, &out_t, &M, &K, &N, &group, &n_k,
                  &per};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(splits),
                     static_cast<unsigned>((N + kWgBN - 1) / kWgBN),
                     static_cast<unsigned>((M + BM - 1) / BM));
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelExC(
      &cfg, reinterpret_cast<const void*>(kernel), args);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// clusters of `splits` blocks of the wgmma body that the card holds at
// once (a block takes one SM's shared memory), or a negative CUDA error
template <bool INT4, int BM>
int max_clusters(int splits) {
  using C = WgCfg<INT4, BM>;
  const auto kernel =
      quant_matmul_wgmma<__nv_bfloat16, INT4 ? kInt4 : kInt8, BM>;
  static const int rc_opt = opt_in(kernel, C::kSmem);
  if (rc_opt) return -rc_opt;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(splits), 1, 1);
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      &n, reinterpret_cast<const void*>(kernel), &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// the wgmma body for x of dtype T with `rows` (128 or 256) rows a block
template <typename T>
int dispatch_wgmma(cudaStream_t st, int int4, int rows, const void* x,
                   const void* qw, const void* sc, int sd, void* out, int M,
                   int K, int N, int group, int splits) {
  const bool pairs = sd == (std::is_same<T, __half>::value ? ptt::kF16
                                                           : ptt::kBF16);
#define PTT_QM_LAUNCH(FMT)                                                  \
  return rows == 128 ? launch_wgmma<T, FMT, 128>(st, x, qw, sc, sd, out, M,  \
                                                 K, N, group, splits)        \
                     : launch_wgmma<T, FMT, 256>(st, x, qw, sc, sd, out, M,  \
                                                 K, N, group, splits)
  if (!int4) PTT_QM_LAUNCH(kInt8);
  if (pairs) PTT_QM_LAUNCH(kInt4Pairs);
  PTT_QM_LAUNCH(kInt4);
#undef PTT_QM_LAUNCH
}

// ---------------------------------------------------------------------------
// decode body (bf16 / fp16 x, M <= 16)
// ---------------------------------------------------------------------------
constexpr int kDecThreads = 288;     // warps 0-7 compute, warp 8 loads
constexpr int kDecConsumers = 256;
constexpr int kDecWarps = kDecConsumers / 32;   // a stage's releases
constexpr int kDecStage = ptt_qm::kStageBytes;
static_assert(ptt_qm::kCols == kWgBN && ptt_qm::kTileRows == kWgKT,
              "the decode stage is the wgmma body's weight box");

// x[m][k0 .. k0 + 7] from a pointer of any 2-byte alignment as four
// words of element pairs, elements past `valid` zero: one 16-byte load of
// the aligned segment that holds the first element, and a second one
// where the elements run into the next segment; every segment read holds
// at least one element of x, so no read leaves x's 16-byte segments.
template <typename T>
__device__ __forceinline__ void load_x8(const T* p, int valid, uint32_t* w) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint4* seg = reinterpret_cast<const uint4*>(a & ~uintptr_t{15});
  const int sh = static_cast<int>(a & 15);    // even
  const uint4 lo = __ldg(seg);
  const uint4 hi = sh + 2 * valid > 16 ? __ldg(seg + 1)
                                       : make_uint4(0u, 0u, 0u, 0u);
  const uint32_t u[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int q = sh >> 2;
  uint32_t v[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    v[i] = q == 0 ? u[i] : q == 1 ? u[i + 1] : q == 2 ? u[i + 2] : u[i + 3];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t word = __funnelshift_r(v[i], v[i + 1], (sh & 2) * 8);
    w[i] = word & (2 * i + 1 < valid ? 0xFFFFFFFFu
                                     : 2 * i < valid ? 0x0000FFFFu : 0u);
  }
}

// x's share of a block in shared memory, laid out as TMA would land it:
// for tile i of the block's walk and nibble half h (int4: x columns k..
// and K/2 + k..; int8: one), a box of XR = 8 NT rows x 64 columns, row r's
// 16-byte chunk c at c ^ (r % 8) (128-byte swizzle).  Rows past M and
// columns past the half (`lim`: K, or K/2 for each half of int4) are zero.
// A thread moves one 16-byte chunk (8 columns of a row) at a time, loaded
// with 16-byte loads realigned in registers (load_x8), four in flight.
template <typename T>
__device__ __forceinline__ void stage_x(uint8_t* xs, const T* x, int M, int K,
                                        int kb, int n_t, int XR, int halves,
                                        int lim, int off_hi) {
  const int chunks = n_t * halves * XR * 8;   // 16-byte chunks in all
  constexpr int kInFlight = 4;
  for (int base = threadIdx.x; base < chunks;
       base += kInFlight * kDecConsumers) {
    uint32_t w[kInFlight][4];
#pragma unroll
    for (int b = 0; b < kInFlight; ++b) {
      const int c = base + b * kDecConsumers;
      // chunk c: column chunk cc of row r of box (tile i, half h)
      const int r = c % XR, cc = (c / XR) % 8, box = c / (XR * 8);
      const int i = box / halves, h = box % halves;
      const int rel = kb + i * kWgKT + 8 * cc;
      const int valid = (c < chunks && r < M) ? min(8, lim - rel) : 0;
      w[b][0] = w[b][1] = w[b][2] = w[b][3] = 0u;
      if (valid > 0)
        load_x8(x + static_cast<long long>(r) * K + h * off_hi + rel, valid,
                w[b]);
    }
#pragma unroll
    for (int b = 0; b < kInFlight; ++b) {
      const int c = base + b * kDecConsumers;
      if (c >= chunks) break;
      const int r = c % XR, cc = (c / XR) % 8, box = c / (XR * 8);
      *reinterpret_cast<uint4*>(xs + box * XR * 128 + r * 128 +
                                ((cc ^ (r & 7)) << 4)) =
          make_uint4(w[b][0], w[b][1], w[b][2], w[b][3]);
    }
  }
}

// two scales (columns n, n + 1) of storage dtype sd from shared memory
__device__ __forceinline__ float2 lds_scale2(const uint8_t* p, int sd) {
  if (sd == ptt::kF32) return *reinterpret_cast<const float2*>(p);
  const uint32_t u = ptt::ld32(p);
  const uint16_t lo = static_cast<uint16_t>(u), hi = static_cast<uint16_t>(
                                                     u >> 16);
  if (sd == ptt::kBF16)
    return make_float2(__bfloat162float(__ushort_as_bfloat16(lo)),
                       __bfloat162float(__ushort_as_bfloat16(hi)));
  return make_float2(__half2float(__ushort_as_half(lo)),
                     __half2float(__ushort_as_half(hi)));
}

// B fragments (b0, b1) of x for a k step from a swizzled x box (XR rows
// of 128 bytes, row r's 16-byte chunk c at c ^ (r % 8)): lane 4g + t
// takes x[8 nt + g][16 kk + 2t, + 1] and [.. + 8, + 9], at byte `off` =
// (8 nt + g) 128 + 4t + ((2 kk ^ g) << 4) and at off ^ 16
__device__ __forceinline__ void load_b(const uint8_t* xbox, int off,
                                       uint32_t* b) {
  b[0] = ptt::ld32(xbox + off);
  b[1] = ptt::ld32(xbox + (off ^ 16));
}

// The decode body: out^T [N, M] = W^T [N, K] . x^T [K, M] on mma.sync
// m16n8k16, the dequantized weight the A operand (16 columns a warp, rows
// g and g + 8 the adjacent columns n, n + 1), x^T the B operand (n8 = 8
// rows of x a tile, one or two tiles).  Grid (splits, N / 128): a cluster
// of `splits` blocks over K owns 128 columns; warp 8 streams the block's
// `n_t` K tiles through a ring of `stages` TMA stages of `sb` bytes on
// full / empty mbarriers: the packed weight box (64 rows x 128 columns,
// 8 KB); with `xtma` (x_by_tma) x's box (XR = 8 NT rows x 64 columns;
// int4 two, columns k.. and K/2 + k..); for int4 (GPT scale rows a stage,
// groups a multiple of 16) the tile's group scale rows of both halves, on
// the stages where a group starts (so each is loaded once).  Without
// `xtma`, warps 0-7 first stage x's share of the block once (stage_x).
// Then they dequantize each stage straight from the ring into A
// fragments.
template <typename T, int FMT, int GPT>
__global__ void __launch_bounds__(kDecThreads, ptt_qm::kBlocksPerSM)
    quant_matmul_decode(const __grid_constant__ CUtensorMap mw,
                        const __grid_constant__ CUtensorMap mx,
                        const __grid_constant__ CUtensorMap ms,
                        const T* __restrict__ x, const void* __restrict__ sc,
                        int sd, T* __restrict__ out, int M, int K, int N,
                        int group, int n_k, int per, int stages, int sb,
                        int xtma) {
  constexpr bool INT4 = FMT == kInt4 || FMT == kInt4Pairs;
  static_assert(INT4 == (GPT > 0), "int4 takes its scales by the ring");
  constexpr int halves = INT4 ? 2 : 1;
  extern __shared__ __align__(1024) uint8_t qd_smem[];
  uint8_t* const ring = align1024(qd_smem);
  const int splits = gridDim.x, rank = blockIdx.x;
  const int n0 = blockIdx.y * kWgBN;
  const int t0 = rank * per;
  const int n_t = min(n_k, t0 + per) - t0;    // >= 1: no split is empty
  const int Kh = K / 2;
  const int NT = M > 8 ? 2 : 1;
  const int xbox = 8 * NT * 128;              // bytes of one x box
  const int sc_off = kDecStage + (xtma ? halves * xbox : 0);
  const int sbox = GPT * kWgBN * (sd == ptt::kF32 ? 4 : 2);   // scale box
  uint8_t* const xs = ring + stages * sb;     // x's staged share
  uint64_t* const full = reinterpret_cast<uint64_t*>(
      xs + (xtma ? 0 : per * halves * xbox));
  uint64_t* const empty = full + stages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kDecWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kDecConsumers) {
    // -- producer: the block's K tiles, `stages` in flight ----------------
    if (threadIdx.x == kDecConsumers) {
      // gk: the tile's first packed row within its group (GPT 1)
      for (int i = 0, st = 0, phase = 0, gk = GPT == 1 ? t0 * kWgKT % group
                                                    : 0;
           i < n_t; ++i) {
        const int k = (t0 + i) * kWgKT;
        uint8_t* const stage = ring + st * sb;
        const bool scales = INT4 && (GPT > 1 || i == 0 || gk == 0);
        if (GPT == 1 && (gk += kWgKT) == group) gk = 0;
        mbar_wait(empty + st, phase ^ 1);
        mbar_expect_tx(full + st, sc_off + (scales ? 2 * sbox : 0));
        tma_load_2d(stage, &mw, full + st, n0, k);
        if (xtma) {
          tma_load_2d(stage + kDecStage, &mx, full + st, k, 0);
          if (INT4)
            tma_load_2d(stage + kDecStage + xbox, &mx, full + st, Kh + k, 0);
        }
        if (scales) {
          tma_load_2d(stage + sc_off, &ms, full + st, n0, k / group);
          tma_load_2d(stage + sc_off + sbox, &ms, full + st, n0,
                      (Kh + k) / group);
        }
        if (++st == stages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
    if (splits > 1) {       // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // -- consumers -----------------------------------------------------------
  if (!xtma) {
    stage_x<T>(xs, x, M, K, t0 * kWgKT, n_t, 8 * NT, halves, INT4 ? Kh : K,
               Kh);
    named_sync(1);
  }
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n = n0 + 16 * w + 2 * g;           // A rows g, g + 8
  const bool col_ok = n < N;
  const int off_e = ((w ^ (2 * t)) << 4) + 2 * g;
  const int off_o = ((w ^ (2 * t + 1)) << 4) + 2 * g;
  float acc[2][4] = {};
  const float2 zero = make_float2(0.f, 0.f);
  const float2 s8 = (!INT4 && col_ok) ? load_scale2(sc, n, sd) : zero;
  int boff[4];      // load_b's offsets of the four k steps (tile nt 0)
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    boff[kk] = g * 128 + 4 * t + (((2 * kk) ^ g) << 4);
  // int4 group scale rows of the tile (or held from the stage its group
  // started in), both halves; with scales of x's dtype (T pairs) their
  // dtype is T's
  constexpr int R = GPT > 0 ? GPT : 1;
  const int ssd = FMT == kInt4Pairs
                      ? (std::is_same<T, __half>::value ? ptt::kF16
                                                        : ptt::kBF16)
                      : sd;
  float2 slo[R], shi[R];

  for (int i = 0, st = 0, phase = 0, gk = INT4 ? t0 * kWgKT % group : 0;
       i < n_t; ++i) {
    const int pm = gk;                // the tile's first packed row % group
    if (INT4)
      for (gk += kWgKT; gk >= group;) gk -= group;
    mbar_wait(full + st, phase);
    const uint8_t* wt = ring + st * sb;
    // x's box(es) of the tile: in the stage, or in the staged share
    const uint8_t* xt = xtma ? wt + kDecStage : xs + i * halves * xbox;
    if (INT4 && (GPT > 1 || i == 0 || pm == 0)) {
      const int e = ssd == ptt::kF32 ? 4 : 2;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const uint8_t* r = wt + sc_off + (q * kWgBN + 16 * w + 2 * g) * e;
        slo[q] = lds_scale2(r, ssd);
        shi[q] = lds_scale2(r + sbox, ssd);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float2 lo = s8, hi = zero;
      if (INT4) {
        // the k step's group row within the stage's box: (pm + 16 kk) /
        // group, picked without indexing the arrays (registers, not stack)
        lo = slo[0];
        hi = shi[0];
#pragma unroll
        for (int q = 1; q < R; ++q)
          if (pm + 16 * kk >= q * group) {
            lo = slo[q];
            hi = shi[q];
          }
      }
      uint32_t a[4], h[4];
      dequant_k16<T, FMT>(wt, kk, t, off_e, off_o, lo, hi, a, h);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        if (nt == 1 && NT == 1) break;
        uint32_t b[2];
        load_b(xt, boff[kk] + 1024 * nt, b);
        ptt::mma_16816<T>(acc[nt], a, b);
        if (INT4) {
          load_b(xt + xbox, boff[kk] + 1024 * nt, b);
          ptt::mma_16816<T>(acc[nt], h, b);
        }
      }
    }
    // one release a warp, once all its lanes' reads of the stage are done
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
    if (++st == stages) {
      st = 0;
      phase ^= 1;
    }
  }
  // accumulator e of tile nt is D[n + (e >> 1)][8 nt + 2t + (e & 1)]
  if (splits == 1) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      if (nt < NT)
        store_pairs<T>(out, N, M, 8 * nt + 2 * t, n, col_ok,
                       make_float4(acc[nt][0], acc[nt][1], acc[nt][2],
                                   acc[nt][3]));
    return;
  }
  // reduce-scatter over the cluster: rank r owns warps [r, r + 1) * 8 /
  // splits' columns; once every block's products are done (the ring is
  // free), each pushes its partials to the owner of its warp's columns,
  // and after the second barrier the owner sums them in rank order
  // (deterministic), rounds once and stores
  const int wpo = 8 / splits;                  // warps an owner
  const int owner = w / wpo, wl = w % wpo;
  const uint32_t buf = smem_u32(ring);
  cluster_sync();
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
    if (nt < NT)
      st_cluster_f4(map_rank(buf + (((rank * wpo + wl) * 32 + lane) * 2 + nt)
                                       * 16,
                             owner),
                    make_float4(acc[nt][0], acc[nt][1], acc[nt][2],
                                acc[nt][3]));
  cluster_sync();
  if (owner != rank) return;
  const float4* part = reinterpret_cast<const float4*>(ring);
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    if (nt >= NT) break;
    float4 v = part[(wl * 32 + lane) * 2 + nt];
    for (int q = 1; q < splits; ++q) {
      const float4 u = part[((q * wpo + wl) * 32 + lane) * 2 + nt];
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    store_pairs<T>(out, N, M, 8 * nt + 2 * t, n, col_ok, v);
  }
}

// whether x reaches the decode body through TMA (the ring) rather than
// the staging prologue: rows of 16-byte strides from a 16-byte aligned
// start, and for int4 a nibble half of whole 64-column boxes
inline bool x_by_tma(const void* x, int K, int int4) {
  return ptt::aligned16(x) && K % 8 == 0 && (!int4 || (K / 2) % 64 == 0);
}

template <typename T, int FMT, int GPT>
int launch_decode(cudaStream_t st, const ptt_qm::Plan& p, const void* x,
                  const void* qw, const void* sc, int sd, void* out, int M,
                  int K, int N, int group, int xtma) {
  constexpr bool INT4 = FMT == kInt4 || FMT == kInt4Pairs;
  const auto kernel = quant_matmul_decode<T, FMT, GPT>;
  static const int rc_opt = opt_in(kernel, kSmemMax);
  if (rc_opt) return rc_opt;
  const int Kp = INT4 ? K / 2 : K;
  int n_k = ptt_qm::cdiv(Kp, kWgKT);
  int per = ptt_qm::cdiv(n_k, p.splits);
  int stages = p.stages;
  const int selem = sd == ptt::kF32 ? 4 : 2;
  int sb = ptt_qm::stage_bytes(M, INT4, xtma, GPT, selem);
  CUtensorMap mw, mx = {}, ms = {};
  if (!map_2d(&mw, qw, 1, N, Kp, N, kWgBN, kWgKT) ||
      (xtma && !map_2d(&mx, x, 2, K, M, 2ll * K, 64, M > 8 ? 16 : 8)) ||
      (INT4 &&
       !map_2d_rows(&ms, sc, selem, N, K / group,
                    static_cast<long long>(N) * selem, kWgBN, GPT)))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* x_t = static_cast<const T*>(x);
  T* out_t = static_cast<T*>(out);
  void* args[] = {&mw, &mx, &ms, &x_t, &sc, &sd, &out_t, &M, &K, &N,
                  &group, &n_k, &per, &stages, &sb, &xtma};
  cudaLaunchConfig_t cfg = {};
  const unsigned cols = static_cast<unsigned>(ptt_qm::cdiv(N, kWgBN));
  const unsigned sp = static_cast<unsigned>(p.splits);
  cfg.gridDim = dim3(sp, cols, 1);
  cfg.blockDim = dim3(kDecThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = sp;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelExC(
      &cfg, reinterpret_cast<const void*>(kernel), args);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// the decode body for x of dtype T: int8; int4 by its group (a multiple
// of 16; GPT = ptt_qm::scale_rows, scale rows a stage), in T pairs where
// the scales are of x's dtype
template <typename T>
int dispatch_decode(cudaStream_t st, const ptt_qm::Plan& p, int int4,
                    const void* x, const void* qw, const void* sc, int sd,
                    void* out, int M, int K, int N, int group, int xtma) {
  if (!int4)
    return sd == ptt::kBF16
               ? launch_decode<T, kInt8Fma, 0>(st, p, x, qw, sc, sd, out, M,
                                               K, N, 0, xtma)
               : launch_decode<T, kInt8, 0>(st, p, x, qw, sc, sd, out, M, K,
                                            N, 0, xtma);
  const bool pairs = sd == (std::is_same<T, __half>::value ? ptt::kF16
                                                           : ptt::kBF16);
  const int gpt = ptt_qm::scale_rows(true, group);
#define PTT_QM_DEC(FMT)                                                     \
  return gpt == 1 ? launch_decode<T, FMT, 1>(st, p, x, qw, sc, sd, out, M,  \
                                             K, N, group, xtma)             \
       : gpt == 2 ? launch_decode<T, FMT, 2>(st, p, x, qw, sc, sd, out, M,  \
                                             K, N, group, xtma)             \
                  : launch_decode<T, FMT, 4>(st, p, x, qw, sc, sd, out, M,  \
                                             K, N, group, xtma)
  if (pairs) PTT_QM_DEC(kInt4Pairs);
  PTT_QM_DEC(kInt4);
#undef PTT_QM_DEC
}

}  // namespace

// x [M, K] (dtype), qw int8 [K, N] (int4 == 0) or [K/2, N] (int4 == 1),
// scales [N] or [K/group, N] (scale_dtype), out [M, N] (dtype); all
// contiguous, qw and scales 16-byte aligned, N % 16 == 0.
//   rows == 0, bf16/fp16 x and a shape the decode plan takes (M <= 16,
//     ptt_quant_matmul_plan's body 1): the decode body, one launch, no
//     scratch (`part` null), its split the plan's (`splits` must be 0).
//   rows == 0, any other shape: the mma.sync / CUDA-core bodies.  splits
//     > 1 divides the K tiles among that many blocks per output tile,
//     whose fp32 sums go to part [splits, M, N] and are added by a second
//     launch; splits == 1 writes `out` directly and takes no scratch.
//   rows == 128 or 256: the wgmma body with blocks of that many rows of x
//     (bf16/fp16 x 16-byte aligned, K % 8 == 0, int4 group % 64 == 0);
//     `splits` (1-4, none of them empty) is the cluster size over K,
//     reduced in shared memory: `part` must be null.
extern "C" int ptt_quant_matmul(int device, int dtype, int scale_dtype,
                                int int4, int group, const void* x,
                                const void* qw, const void* scales, void* out,
                                void* part, int M, int K, int N, int splits,
                                int rows, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M <= 0 || K <= 0 || N <= 0 || N % 16 || splits < 0 ||
      splits > 65535 || (M + 15) / 16 > 65535 || !ptt::aligned16(qw) ||
      !ptt::aligned16(scales) ||
      (int4 && (K % 2 || group <= 0 || (K / 2) % group)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!rows && (dtype == ptt::kBF16 || dtype == ptt::kF16) &&
      M <= ptt_qm::kMaxRows) {
    const int sms = ptt::sm_count(device);
    if (sms < 0) return -sms;
    const bool xtma = x_by_tma(x, K, int4);
    const int selem = scale_dtype == ptt::kF32 ? 4 : 2;
    const ptt_qm::Plan p =
        ptt_qm::plan(M, K, N, int4 != 0, group, selem, xtma, sms);
    if (p.body) {
      if (splits || part != nullptr || scale_dtype < ptt::kF32 ||
          scale_dtype > ptt::kF16)
        return static_cast<int>(cudaErrorInvalidValue);
      return dtype == ptt::kBF16
                 ? dispatch_decode<__nv_bfloat16>(st, p, int4, x, qw, scales,
                                                  scale_dtype, out, M, K, N,
                                                  group, xtma)
                 : dispatch_decode<__half>(st, p, int4, x, qw, scales,
                                           scale_dtype, out, M, K, N, group,
                                           xtma);
    }
  }
  if (splits == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows) {
    if (part != nullptr || splits > kMaxSplits || K % 8 ||
        !ptt::aligned16(x) || (int4 && group % 64) ||
        (rows != 128 && rows != 256) || scale_dtype < ptt::kF32 ||
        scale_dtype > ptt::kF16)
      return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == ptt::kBF16)
      return dispatch_wgmma<__nv_bfloat16>(st, int4, rows, x, qw, scales,
                                           scale_dtype, out, M, K, N, group,
                                           splits);
    if (dtype == ptt::kF16)
      return dispatch_wgmma<__half>(st, int4, rows, x, qw, scales,
                                    scale_dtype, out, M, K, N, group, splits);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (splits > 1 && part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_k = (K + kBK - 1) / kBK;
  const int per = (n_k + splits - 1) / splits;
  void* part_or_null = splits > 1 ? part : nullptr;
  PTT_DISPATCH(dtype, T, {
    PTT_DISPATCH(scale_dtype, S, {
      return int4 ? launch<T, S, true>(st, x, qw, scales, out, part_or_null,
                                       M, K, N, group, splits, per)
                  : launch<T, S, false>(st, x, qw, scales, out, part_or_null,
                                        M, K, N, group, splits, per);
    });
  });
  return static_cast<int>(cudaErrorInvalidValue);
}

// The decode plan of x [M, K] of 16-bit dtype at `x` (only its alignment
// is read) times a weight of N columns (int8, or int4 when int4 != 0, in
// groups of `group` rows) with scales of `scale_dtype`, on `device`
// (csrc/quant_matmul_plan.cuh: shapes and the card's SM count):
// out[0..4] = body (1: the decode body takes the shape), splits, stages,
// dynamic shared memory bytes, and whether x comes by TMA.
extern "C" int ptt_quant_matmul_plan(int device, const void* x, int M, int K,
                                     int N, int int4, int group,
                                     int scale_dtype, int* out) {
  const int sms = ptt::sm_count(device);
  if (sms < 0) return -sms;
  const bool xtma = x_by_tma(x, K, int4);
  const ptt_qm::Plan p =
      ptt_qm::plan(M, K, N, int4 != 0, group, scale_dtype == ptt::kF32 ? 4 : 2,
                   xtma, sms);
  out[0] = p.body;
  out[1] = p.splits;
  out[2] = p.stages;
  out[3] = p.smem;
  out[4] = xtma;
  return 0;
}

// The wgmma body's clusters of `splits` (1-4) blocks over K that fit on
// the card at once, for blocks of `rows` (128 or 256) rows of x and the
// weight format: what ops/quant_matmul.py::_schedule sizes its waves by.
// Negative: a CUDA error.
extern "C" int ptt_quant_matmul_clusters(int device, int int4, int rows,
                                         int splits) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if ((rows != 128 && rows != 256) || splits <= 0 || splits > kMaxSplits)
    return -static_cast<int>(cudaErrorInvalidValue);
  if (int4)
    return rows == 128 ? max_clusters<true, 128>(splits)
                       : max_clusters<true, 256>(splits);
  return rows == 128 ? max_clusters<false, 128>(splits)
                     : max_clusters<false, 256>(splits);
}
