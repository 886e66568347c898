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
// admission chunks (M = 256) the bf16 operations come near the ridge.
// The design keeps the weight at its packed width in device memory and
// never writes a dequantized copy:
//   * grid (N/128, M/BM, splits): a block owns 128 output columns and BM
//     rows, and walks its split's share of the K tiles.  N/128 column
//     blocks alone are 32 at N = 4096, so K is split (fp32 partials
//     [splits, M, N], summed by a second launch) until ~4 blocks per SM
//     exist — the wrapper picks `splits` (ops/quant_matmul.py::_splits).
//   * a K tile is 64 logical rows.  int8: rows 64t..64t+63.  int4: the
//     32 packed rows 32t..32t+31, whose low nibbles are logical rows
//     32t.. and whose high nibbles are rows K/2+32t..; the x tile takes
//     the same two column ranges, so both formats feed one product.
//   * each thread loads 16 bytes of a weight row along N (16 int8 or 32
//     int4 values; a warp reads four 128-byte rows), the next tile's
//     bytes are in flight in registers while the current tile is
//     dequantized and multiplied.
//   * bf16/fp16: the tile is dequantized into shared memory as T, and 8
//     warps run mma.sync m16n8k16 (fp32 accumulate), each on 16 columns
//     and all BM rows; BM is 16 (M padded to 16, the decode shape) or 64.
//   * fp32 activations: a CUDA-core kernel, one column a thread, 8 rows
//     a block, the x tile in shared memory.
// cp.async/TMA pipelines, wgmma and a persistent schedule are later work.
#include <type_traits>

#include "common.cuh"

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

// Tensor-core kernel for T = bf16 / fp16; BM = 16 * MT rows a block.
template <typename T, typename S, bool INT4, int MT>
__global__ void __launch_bounds__(kThreads) quant_matmul_mma_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ qw,
    const S* __restrict__ sc, T* __restrict__ out, float* __restrict__ part,
    int M, int K, int N, int group, int per_split) {
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
    if (M <= 16) {
      const dim3 grid(gx, static_cast<unsigned>((M + 15) / 16),
                      static_cast<unsigned>(splits));
      quant_matmul_mma_kernel<T, S, INT4, 1><<<grid, kThreads, 0, st>>>(
          static_cast<const T*>(x), static_cast<const int8_t*>(qw),
          static_cast<const S*>(sc), static_cast<T*>(out),
          static_cast<float*>(part), M, K, N, group, per);
    } else {
      const dim3 grid(gx, static_cast<unsigned>((M + 63) / 64),
                      static_cast<unsigned>(splits));
      quant_matmul_mma_kernel<T, S, INT4, 4><<<grid, kThreads, 0, st>>>(
          static_cast<const T*>(x), static_cast<const int8_t*>(qw),
          static_cast<const S*>(sc), static_cast<T*>(out),
          static_cast<float*>(part), M, K, N, group, per);
    }
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

}  // namespace

// x [M, K] (dtype), qw int8 [K, N] (int4 == 0) or [K/2, N] (int4 == 1),
// scales [N] or [K/group, N] (scale_dtype), out [M, N] (dtype); all
// contiguous, qw and scales 16-byte aligned, N % 16 == 0.  splits > 1
// divides the K tiles among that many blocks per output tile, whose fp32
// sums go to part [splits, M, N] and are added by a second launch;
// splits == 1 writes `out` directly and takes no scratch.
extern "C" int ptt_quant_matmul(int device, int dtype, int scale_dtype,
                                int int4, int group, const void* x,
                                const void* qw, const void* scales, void* out,
                                void* part, int M, int K, int N, int splits,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M <= 0 || K <= 0 || N <= 0 || N % 16 || splits <= 0 ||
      splits > 65535 || (M + 15) / 16 > 65535 ||
      (splits > 1 && part == nullptr) || !ptt::aligned16(qw) ||
      !ptt::aligned16(scales) ||
      (int4 && (K % 2 || group <= 0 || (K / 2) % group)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_k = (K + kBK - 1) / kBK;
  const int per = (n_k + splits - 1) / splits;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
