// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py::
// flash_attention (:816): forward _fwd_kernel (:482) and its _small /
// _1b twins, backward _bwd_dq_kernel (:585) and _bwd_dkv_kernel (:630).
//   out = softmax(q.k^T * scale [causal]) . v,   lse = m + log(l)
// q [B, sq, h, d], k/v [B, sk, hk, d] (h % hk == 0, query head hq reads
// kv head hq / (h / hk), `_kv_head_map` :64), addressed in that layout
// through strides: none of the TPU wrapper's transposes to [b*h, s, d].
// Causal masking is top-left aligned (key <= query row), as the TPU
// kernel's; the caller refuses causal with sq != sk.  fp32 softmax with
// NEG_INF masking; p is rounded to the operand type before P.V (:518),
// ds and p before their products in the backward (:618, :664, :670).
//
// What bounds it on the H100: operations.  At the training shape
// (q [4, 2048, 20, 128], kv [4, 2048, 4, 128], bf16, causal) the forward
// does 4*b*h*s^2*d/2 = 8.6e10 FLOP, 0.087 ms at 989 TFLOP/s, against
// ~0.03 ms for its bytes; the backward ~2.5x the forward.
//
// Design.  The TPU's sequential grid over K blocks becomes a loop inside
// the block; no state crosses blocks, so there are no atomics and the
// result is deterministic.
//   * bf16/fp16, head_dim 64 or 128: tensor cores (mma.sync m16n8k16,
//     fp32 accumulate) in the FlashAttention-2 register layout.  Each
//     warp owns 16 rows; the S fragments become the A operand of the
//     next product without leaving registers.
//       fwd: one block per (64 query rows, q head, batch), walking the
//            live 64-key tiles with an online softmax.
//       dq:  one block per (64 query rows, q head, batch), walking the
//            live 32-key tiles.
//       dkv: one block per (64 keys, kv head, batch); it walks every
//            query head of its GQA group and the live 32-row query tiles,
//            accumulating dk and dv in registers (the TPU kernel's
//            accumulation over t = (g, qi), :717-741).
//   * fp32: the same three walks on CUDA cores (one lane per key, the
//     warp reduces with shuffles).
//   * ragged edges: rows past sq and keys past sk are masked in the
//     kernel (the TPU kernel needs a power-of-two block dividing s).
// wgmma, TMA / cp.async pipelining and causal load balancing are later
// work.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;    // flash_attention.py NEG_INF
constexpr int kSmemMax = 232448;     // H100 opt-in limit per block

template <typename T>
__device__ __forceinline__ uint32_t ld_pair(const T* lo, const T* hi) {
  unsigned short a, b;
  memcpy(&a, lo, 2);
  memcpy(&b, hi, 2);
  return static_cast<uint32_t>(a) | (static_cast<uint32_t>(b) << 16);
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return ptt::to_f(ptt::from_f<T>(x));
}

// Copy rows [r0, r0 + rows) of a [*, stride]-strided matrix of width D
// into shared memory [rows][ld] (T), zero past `limit` rows.
template <typename T, int D>
__device__ __forceinline__ void tile_to_smem(const T* __restrict__ base,
                                             long long stride, int r0,
                                             int rows, int limit, T* dst,
                                             int ld) {
  constexpr int N = ptt::Vec<T>::N;
  for (int e = threadIdx.x; e < rows * (D / N); e += blockDim.x) {
    const int t = e / (D / N);
    const int i = (e - t * (D / N)) * N;
    uint4 val = {0u, 0u, 0u, 0u};
    if (r0 + t < limit)
      val = __ldg(reinterpret_cast<const uint4*>(base + (r0 + t) * stride + i));
    *reinterpret_cast<uint4*>(dst + t * ld + i) = val;
  }
}

// the same into fp32 shared memory
template <typename T, int D>
__device__ __forceinline__ void tile_to_smem_f(const T* __restrict__ base,
                                               long long stride, int r0,
                                               int rows, int limit,
                                               float* dst, int ld) {
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int t = e / D;
    const int i = e - t * D;
    dst[t * ld + i] =
        r0 + t < limit ? ptt::to_f(base[(r0 + t) * stride + i]) : 0.f;
  }
}

// number of key tiles a block of query rows [q0, q0 + rows) reads
__device__ __forceinline__ int live_key_tiles(int q0, int rows, int sq,
                                              int sk, int bk, int causal) {
  const int all = (sk + bk - 1) / bk;
  if (!causal) return all;
  const int last = min(q0 + rows, sq) - 1;
  return min(all, last / bk + 1);
}

// ---------------------------------------------------------------------------
// tensor-core kernels (bf16 / fp16)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(128) flash_fwd_mma(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int sq, int sk, int h,
    int hk, float scale, int causal) {
  constexpr int BQ = 64, BK = 64, KS = D + 8, VS = BK + 8;
  constexpr int N = ptt::Vec<T>::N;
  __shared__ uint4 smem[(BK * KS + D * VS) * sizeof(T) / 16];
  T* Ks = reinterpret_cast<T*>(smem);   // [BK][D + 8]
  T* Vt = Ks + BK * KS;                 // [D][BK + 8], V transposed
  const int q0 = blockIdx.x * BQ, hq = blockIdx.y, b = blockIdx.z;
  const int kvh = hq / (h / hk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long long qstr = static_cast<long long>(h) * D;
  const long long kstr = static_cast<long long>(hk) * D;
  const T* qb = q + (static_cast<long long>(b) * sq * h + hq) * D;
  const T* kb = k + (static_cast<long long>(b) * sk * hk + kvh) * D;
  const T* vb = v + (static_cast<long long>(b) * sk * hk + kvh) * D;
  const int ra = q0 + warp * 16 + g, rb = ra + 8;
  const bool active = q0 + warp * 16 < sq;

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) {
      const int r = (reg & 1) ? rb : ra;
      const int col = ks * 16 + 2 * t4 + ((reg & 2) ? 8 : 0);
      qf[ks][reg] = r < sq ? ptt::ld32(qb + r * qstr + col) : 0u;
    }
  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float ma = kNegInf, mb = kNegInf, la = 0.f, lb = 0.f;

  const int n_kt = live_key_tiles(q0, BQ, sq, sk, BK, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    tile_to_smem<T, D>(kb, kstr, k0, BK, sk, Ks, KS);
    // consecutive threads take consecutive keys, so the transposed
    // stores of a warp land in distinct shared-memory words
    for (int e = threadIdx.x; e < BK * (D / N); e += blockDim.x) {
      const int t = e % BK;
      const int i = (e / BK) * N;
      uint4 vv = {0u, 0u, 0u, 0u};
      if (k0 + t < sk)
        vv = __ldg(reinterpret_cast<const uint4*>(vb + (k0 + t) * kstr + i));
      const T* ve = reinterpret_cast<const T*>(&vv);
#pragma unroll
      for (int u = 0; u < N; ++u) Vt[(i + u) * VS + t] = ve[u];
    }
    __syncthreads();
    if (active) {
      float s[BK / 8][4];
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
          const T* kr = Ks + (nt * 8 + g) * KS + ks * 16 + 2 * t4;
          const uint32_t bf[2] = {ptt::ld32(kr), ptt::ld32(kr + 8)};
          ptt::mma_16816<T>(s[nt], qf[ks], bf);
        }
      float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + nt * 8 + 2 * t4 + (e & 1);
          const int row = e < 2 ? ra : rb;
          const bool ok = key < sk && (!causal || key <= row);
          s[nt][e] = ok ? s[nt][e] * scale : -INFINITY;
          if (e < 2)
            mxa = fmaxf(mxa, s[nt][e]);
          else
            mxb = fmaxf(mxb, s[nt][e]);
        }
      // the four lanes of a quad hold one row's scores
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, x));
        mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, x));
      }
      const float na = fmaxf(ma, mxa), nb = fmaxf(mb, mxb);
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[nt][e];
          const float p = x == -INFINITY ? 0.f : expf(x - (e < 2 ? na : nb));
          s[nt][e] = p;
          if (e < 2)
            sa += p;
          else
            sb += p;
        }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        sa += __shfl_xor_sync(0xffffffffu, sa, x);
        sb += __shfl_xor_sync(0xffffffffu, sb, x);
      }
      const float aa = expf(ma - na), ab = expf(mb - nb);
      la = la * aa + sa;
      lb = lb * ab + sb;
      ma = na;
      mb = nb;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        o[nt][0] *= aa;
        o[nt][1] *= aa;
        o[nt][2] *= ab;
        o[nt][3] *= ab;
      }
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        const uint32_t pf[4] = {ptt::pack2<T>(s[2 * j][0], s[2 * j][1]),
                                ptt::pack2<T>(s[2 * j][2], s[2 * j][3]),
                                ptt::pack2<T>(s[2 * j + 1][0], s[2 * j + 1][1]),
                                ptt::pack2<T>(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          const T* vr = Vt + (nt * 8 + g) * VS + j * 16 + 2 * t4;
          const uint32_t bf[2] = {ptt::ld32(vr), ptt::ld32(vr + 8)};
          ptt::mma_16816<T>(o[nt], pf, bf);
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
  T* ob = out + (static_cast<long long>(b) * sq * h + hq) * D;
  float* lrow = lse + (static_cast<long long>(b) * h + hq) * sq;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    if (r >= sq) continue;
    const float l = fmaxf(half ? lb : la, 1e-30f);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(ob + r * qstr + nt * 8 + 2 * t4) =
          ptt::pack2<T>(o[nt][2 * half] / l, o[nt][2 * half + 1] / l);
    if (t4 == 0) lrow[r] = (half ? mb : ma) + logf(l);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(128) flash_dq_mma(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int sq, int sk,
    int h, int hk, float scale, int causal) {
  constexpr int BQ = 64, BK = 32, KS = D + 8;
  __shared__ uint4 smem[2 * BK * KS * sizeof(T) / 16];
  T* Ks = reinterpret_cast<T*>(smem);   // [BK][D + 8]
  T* Vs = Ks + BK * KS;                 // [BK][D + 8]
  const int q0 = blockIdx.x * BQ, hq = blockIdx.y, b = blockIdx.z;
  const int kvh = hq / (h / hk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long long qstr = static_cast<long long>(h) * D;
  const long long kstr = static_cast<long long>(hk) * D;
  const long long qoff = (static_cast<long long>(b) * sq * h + hq) * D;
  const T* kb = k + (static_cast<long long>(b) * sk * hk + kvh) * D;
  const T* vb = v + (static_cast<long long>(b) * sk * hk + kvh) * D;
  const long long soff = (static_cast<long long>(b) * h + hq) * sq;
  const int ra = q0 + warp * 16 + g, rb = ra + 8;
  const bool active = q0 + warp * 16 < sq;

  uint32_t qf[D / 16][4], of[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) {
      const int r = (reg & 1) ? rb : ra;
      const long long at = qoff + r * qstr + ks * 16 + 2 * t4 + ((reg & 2) ? 8 : 0);
      qf[ks][reg] = r < sq ? ptt::ld32(q + at) : 0u;
      of[ks][reg] = r < sq ? ptt::ld32(dout + at) : 0u;
    }
  const float lsa = ra < sq ? lse[soff + ra] : 0.f;
  const float lsb = rb < sq ? lse[soff + rb] : 0.f;
  const float dla = ra < sq ? delta[soff + ra] : 0.f;
  const float dlb = rb < sq ? delta[soff + rb] : 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  const int n_kt = live_key_tiles(q0, BQ, sq, sk, BK, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    tile_to_smem<T, D>(kb, kstr, k0, BK, sk, Ks, KS);
    tile_to_smem<T, D>(vb, kstr, k0, BK, sk, Vs, KS);
    __syncthreads();
    if (active) {
      float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
          const T* kr = Ks + (nt * 8 + g) * KS + ks * 16 + 2 * t4;
          const uint32_t kf[2] = {ptt::ld32(kr), ptt::ld32(kr + 8)};
          ptt::mma_16816<T>(s[nt], qf[ks], kf);
          const T* vr = Vs + (nt * 8 + g) * KS + ks * 16 + 2 * t4;
          const uint32_t vf[2] = {ptt::ld32(vr), ptt::ld32(vr + 8)};
          ptt::mma_16816<T>(dp[nt], of[ks], vf);
        }
      // s becomes ds = p * (dp - delta) * scale
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + nt * 8 + 2 * t4 + (e & 1);
          const int row = e < 2 ? ra : rb;
          const bool ok = row < sq && key < sk && (!causal || key <= row);
          const float p = ok ? expf(s[nt][e] * scale - (e < 2 ? lsa : lsb)) : 0.f;
          s[nt][e] = p * (dp[nt][e] - (e < 2 ? dla : dlb)) * scale;
        }
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        const uint32_t af[4] = {ptt::pack2<T>(s[2 * j][0], s[2 * j][1]),
                                ptt::pack2<T>(s[2 * j][2], s[2 * j][3]),
                                ptt::pack2<T>(s[2 * j + 1][0], s[2 * j + 1][1]),
                                ptt::pack2<T>(s[2 * j + 1][2], s[2 * j + 1][3])};
        const T* k_lo = Ks + (j * 16 + 2 * t4) * KS + g;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          const T* kc = k_lo + nt * 8;
          const uint32_t bf[2] = {ld_pair(kc, kc + KS),
                                  ld_pair(kc + 8 * KS, kc + 9 * KS)};
          ptt::mma_16816<T>(acc[nt], af, bf);
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    if (r >= sq) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(dq + qoff + r * qstr + nt * 8 + 2 * t4) =
          ptt::pack2<T>(acc[nt][2 * half], acc[nt][2 * half + 1]);
  }
}

template <typename T, int D>
constexpr size_t dkv_mma_smem() {
  return sizeof(T) * (2 * 64 + 2 * 32) * (D + 8) + 2 * 32 * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(128) flash_dkv_mma(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int sq, int sk, int h, int hk, float scale, int causal) {
  constexpr int BKV = 64, BQ = 32, KS = D + 8;
  extern __shared__ uint4 fa_smem[];
  T* Ks = reinterpret_cast<T*>(fa_smem);   // [BKV][D + 8]
  T* Vs = Ks + BKV * KS;                     // [BKV][D + 8]
  T* Qs = Vs + BKV * KS;                     // [BQ][D + 8]
  T* Os = Qs + BQ * KS;                      // [BQ][D + 8], dO
  float* Ls = reinterpret_cast<float*>(Os + BQ * KS);   // [BQ] lse
  float* Ds = Ls + BQ;                                  // [BQ] delta
  const int k0 = blockIdx.x * BKV, kvh = blockIdx.y, b = blockIdx.z;
  const int group = h / hk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long long qstr = static_cast<long long>(h) * D;
  const long long kstr = static_cast<long long>(hk) * D;
  const long long koff = (static_cast<long long>(b) * sk * hk + kvh) * D;
  tile_to_smem<T, D>(k + koff, kstr, k0, BKV, sk, Ks, KS);
  tile_to_smem<T, D>(v + koff, kstr, k0, BKV, sk, Vs, KS);
  const int kw = k0 + warp * 16;             // this warp's first key
  const int ka = kw + g, kb = ka + 8;
  const T* kr = Ks + (warp * 16 + g) * KS + 2 * t4;
  const T* vr = Vs + (warp * 16 + g) * KS + 2 * t4;
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nt][e] = dva[nt][e] = 0.f;

  const int qt0 = causal ? k0 / BQ : 0;
  const int n_qt = (sq + BQ - 1) / BQ;
  for (int gi = 0; gi < group; ++gi) {
    const int hq = kvh * group + gi;
    const long long qoff = (static_cast<long long>(b) * sq * h + hq) * D;
    const long long soff = (static_cast<long long>(b) * h + hq) * sq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();   // the previous tile's readers are done
      tile_to_smem<T, D>(q + qoff, qstr, q0, BQ, sq, Qs, KS);
      tile_to_smem<T, D>(dout + qoff, qstr, q0, BQ, sq, Os, KS);
      for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
        Ls[i] = q0 + i < sq ? lse[soff + q0 + i] : 0.f;
        Ds[i] = q0 + i < sq ? delta[soff + q0 + i] : 0.f;
      }
      __syncthreads();
      if (kw >= sk || (causal && kw > q0 + BQ - 1)) continue;
      float st[BQ / 8][4], dpt[BQ / 8][4];   // S^T and dP^T: keys x rows
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int c = ks * 16;
        const uint32_t ak[4] = {ptt::ld32(kr + c), ptt::ld32(kr + 8 * KS + c),
                                ptt::ld32(kr + c + 8),
                                ptt::ld32(kr + 8 * KS + c + 8)};
        const uint32_t av[4] = {ptt::ld32(vr + c), ptt::ld32(vr + 8 * KS + c),
                                ptt::ld32(vr + c + 8),
                                ptt::ld32(vr + 8 * KS + c + 8)};
#pragma unroll
        for (int nt = 0; nt < BQ / 8; ++nt) {
          const T* qr = Qs + (nt * 8 + g) * KS + c + 2 * t4;
          const uint32_t bq[2] = {ptt::ld32(qr), ptt::ld32(qr + 8)};
          ptt::mma_16816<T>(st[nt], ak, bq);
          const T* orr = Os + (nt * 8 + g) * KS + c + 2 * t4;
          const uint32_t bo[2] = {ptt::ld32(orr), ptt::ld32(orr + 8)};
          ptt::mma_16816<T>(dpt[nt], av, bo);
        }
      }
      // st becomes p, dpt becomes ds
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = e < 2 ? ka : kb;
          const int qi = nt * 8 + 2 * t4 + (e & 1);
          const int row = q0 + qi;
          const bool ok = row < sq && key < sk && (!causal || row >= key);
          const float p = ok ? expf(st[nt][e] * scale - Ls[qi]) : 0.f;
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - Ds[qi]) * scale;
        }
#pragma unroll
      for (int j = 0; j < BQ / 16; ++j) {
        const uint32_t pf[4] = {ptt::pack2<T>(st[2 * j][0], st[2 * j][1]),
                                ptt::pack2<T>(st[2 * j][2], st[2 * j][3]),
                                ptt::pack2<T>(st[2 * j + 1][0], st[2 * j + 1][1]),
                                ptt::pack2<T>(st[2 * j + 1][2], st[2 * j + 1][3])};
        const uint32_t sf[4] = {ptt::pack2<T>(dpt[2 * j][0], dpt[2 * j][1]),
                                ptt::pack2<T>(dpt[2 * j][2], dpt[2 * j][3]),
                                ptt::pack2<T>(dpt[2 * j + 1][0], dpt[2 * j + 1][1]),
                                ptt::pack2<T>(dpt[2 * j + 1][2], dpt[2 * j + 1][3])};
        const int r0 = (j * 16 + 2 * t4) * KS + g;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          const T* oc = Os + r0 + nt * 8;
          const uint32_t bo[2] = {ld_pair(oc, oc + KS),
                                  ld_pair(oc + 8 * KS, oc + 9 * KS)};
          ptt::mma_16816<T>(dva[nt], pf, bo);
          const T* qc = Qs + r0 + nt * 8;
          const uint32_t bq[2] = {ld_pair(qc, qc + KS),
                                  ld_pair(qc + 8 * KS, qc + 9 * KS)};
          ptt::mma_16816<T>(dka[nt], sf, bq);
        }
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? kb : ka;
    if (key >= sk) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const long long at = koff + key * kstr + nt * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(dk + at) =
          ptt::pack2<T>(dka[nt][2 * half], dka[nt][2 * half + 1]);
      *reinterpret_cast<uint32_t*>(dv + at) =
          ptt::pack2<T>(dva[nt][2 * half], dva[nt][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA-core kernels (fp32; written for any T)
// ---------------------------------------------------------------------------
constexpr int kRowsSimt = 16;   // query rows per block (4 per warp)
constexpr int kKeysSimt = 32;   // keys per tile (one per lane)

template <int D>
constexpr size_t fwd_simt_smem() {
  return sizeof(float) * (kRowsSimt * D + kKeysSimt * (D + 1) + kKeysSimt * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(128) flash_fwd_simt(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int sq, int sk, int h,
    int hk, float scale, int causal) {
  constexpr int RQ = kRowsSimt, BK = kKeysSimt, KP = D + 1, C = D / 32;
  extern __shared__ uint4 fa_smem[];
  float* Qs = reinterpret_cast<float*>(fa_smem);   // [RQ][D]
  float* Ks = Qs + RQ * D;                          // [BK][D + 1]
  float* Vs = Ks + BK * KP;                         // [BK][D]
  const int q0 = blockIdx.x * RQ, hq = blockIdx.y, b = blockIdx.z;
  const int kvh = hq / (h / hk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long qstr = static_cast<long long>(h) * D;
  const long long kstr = static_cast<long long>(hk) * D;
  const long long qoff = (static_cast<long long>(b) * sq * h + hq) * D;
  const long long koff = (static_cast<long long>(b) * sk * hk + kvh) * D;
  tile_to_smem_f<T, D>(q + qoff, qstr, q0, RQ, sq, Qs, D);
  float m[4], l[4], acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }
  const int n_kt = live_key_tiles(q0, RQ, sq, sk, BK, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    tile_to_smem_f<T, D>(k + koff, kstr, k0, BK, sk, Ks, KP);
    tile_to_smem_f<T, D>(v + koff, kstr, k0, BK, sk, Vs, D);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = warp * 4 + i;
      const int r = q0 + qi;
      if (r >= sq) continue;   // warp-uniform
      const int key = k0 + lane;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(Qs[qi * D + d], Ks[lane * KP + d], s);
      const bool ok = key < sk && (!causal || key <= r);
      s = ok ? s * scale : -INFINITY;
      const float nm = fmaxf(m[i], ptt::warp_max(s));
      const float p = ok ? expf(s - nm) : 0.f;
      const float alpha = expf(m[i] - nm);
      l[i] = l[i] * alpha + ptt::warp_sum(p);
      m[i] = nm;
      const float pr = round_to<T>(p);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
      for (int j = 0; j < BK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pr, j);
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[i][c] = fmaf(pj, Vs[j * D + lane + 32 * c], acc[i][c]);
      }
    }
  }
  float* lrow = lse + (static_cast<long long>(b) * h + hq) * sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + warp * 4 + i;
    if (r >= sq) continue;
    const float lv = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < C; ++c)
      out[qoff + r * qstr + lane + 32 * c] = ptt::from_f<T>(acc[i][c] / lv);
    if (lane == 0) lrow[r] = m[i] + logf(lv);
  }
}

template <int D>
constexpr size_t dq_simt_smem() {
  return sizeof(float) * (2 * kRowsSimt * D + 2 * kKeysSimt * (D + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(128) flash_dq_simt(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int sq, int sk,
    int h, int hk, float scale, int causal) {
  constexpr int RQ = kRowsSimt, BK = kKeysSimt, KP = D + 1, C = D / 32;
  extern __shared__ uint4 fa_smem[];
  float* Qs = reinterpret_cast<float*>(fa_smem);   // [RQ][D]
  float* Os = Qs + RQ * D;                          // [RQ][D], dO
  float* Ks = Os + RQ * D;                          // [BK][D + 1]
  float* Vs = Ks + BK * KP;                         // [BK][D + 1]
  const int q0 = blockIdx.x * RQ, hq = blockIdx.y, b = blockIdx.z;
  const int kvh = hq / (h / hk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long qstr = static_cast<long long>(h) * D;
  const long long kstr = static_cast<long long>(hk) * D;
  const long long qoff = (static_cast<long long>(b) * sq * h + hq) * D;
  const long long koff = (static_cast<long long>(b) * sk * hk + kvh) * D;
  const long long soff = (static_cast<long long>(b) * h + hq) * sq;
  tile_to_smem_f<T, D>(q + qoff, qstr, q0, RQ, sq, Qs, D);
  tile_to_smem_f<T, D>(dout + qoff, qstr, q0, RQ, sq, Os, D);
  float acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  const int n_kt = live_key_tiles(q0, RQ, sq, sk, BK, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    tile_to_smem_f<T, D>(k + koff, kstr, k0, BK, sk, Ks, KP);
    tile_to_smem_f<T, D>(v + koff, kstr, k0, BK, sk, Vs, KP);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = warp * 4 + i;
      const int r = q0 + qi;
      if (r >= sq) continue;   // warp-uniform
      const int key = k0 + lane;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s = fmaf(Qs[qi * D + d], Ks[lane * KP + d], s);
        dp = fmaf(Os[qi * D + d], Vs[lane * KP + d], dp);
      }
      const bool ok = key < sk && (!causal || key <= r);
      const float p = ok ? expf(s * scale - lse[soff + r]) : 0.f;
      const float ds = round_to<T>(p * (dp - delta[soff + r]) * scale);
      for (int j = 0; j < BK; ++j) {
        const float dj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[i][c] = fmaf(dj, Ks[j * KP + lane + 32 * c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + warp * 4 + i;
    if (r >= sq) continue;
#pragma unroll
    for (int c = 0; c < C; ++c)
      dq[qoff + r * qstr + lane + 32 * c] = ptt::from_f<T>(acc[i][c]);
  }
}

template <int D>
constexpr size_t dkv_simt_smem() {
  return sizeof(float) * (4 * 32 * (D + 1) + 2 * 32 * 33 + 2 * 32);
}

template <typename T, int D>
__global__ void __launch_bounds__(128) flash_dkv_simt(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int sq, int sk, int h, int hk, float scale, int causal) {
  constexpr int BKV = 32, BQ = 32, KP = D + 1, C = D / 4;
  extern __shared__ uint4 fa_smem[];
  float* Ks = reinterpret_cast<float*>(fa_smem);   // [BKV][D + 1]
  float* Vs = Ks + BKV * KP;                        // [BKV][D + 1]
  float* Qs = Vs + BKV * KP;                        // [BQ][D + 1]
  float* Os = Qs + BQ * KP;                         // [BQ][D + 1], dO
  float* Ps = Os + BQ * KP;                         // [BQ][33] rounded p
  float* Ss = Ps + BQ * 33;                         // [BQ][33] rounded ds
  float* Ls = Ss + BQ * 33;                         // [BQ]
  float* Dl = Ls + BQ;                              // [BQ]
  const int k0 = blockIdx.x * BKV, kvh = blockIdx.y, b = blockIdx.z;
  const int group = h / hk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long qstr = static_cast<long long>(h) * D;
  const long long kstr = static_cast<long long>(hk) * D;
  const long long koff = (static_cast<long long>(b) * sk * hk + kvh) * D;
  tile_to_smem_f<T, D>(k + koff, kstr, k0, BKV, sk, Ks, KP);
  tile_to_smem_f<T, D>(v + koff, kstr, k0, BKV, sk, Vs, KP);
  const int key = k0 + lane;
  // lane owns key `lane`; warp w owns columns w, w + 4, w + 8, ...
  float dka[C], dva[C];
#pragma unroll
  for (int c = 0; c < C; ++c) dka[c] = dva[c] = 0.f;
  const int qt0 = causal ? k0 / BQ : 0;
  const int n_qt = (sq + BQ - 1) / BQ;
  for (int gi = 0; gi < group; ++gi) {
    const int hq = kvh * group + gi;
    const long long qoff = (static_cast<long long>(b) * sq * h + hq) * D;
    const long long soff = (static_cast<long long>(b) * h + hq) * sq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();
      tile_to_smem_f<T, D>(q + qoff, qstr, q0, BQ, sq, Qs, KP);
      tile_to_smem_f<T, D>(dout + qoff, qstr, q0, BQ, sq, Os, KP);
      for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
        Ls[i] = q0 + i < sq ? lse[soff + q0 + i] : 0.f;
        Dl[i] = q0 + i < sq ? delta[soff + q0 + i] : 0.f;
      }
      __syncthreads();
      for (int qi = warp; qi < BQ; qi += 4) {
        const int row = q0 + qi;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s = fmaf(Qs[qi * KP + d], Ks[lane * KP + d], s);
          dp = fmaf(Os[qi * KP + d], Vs[lane * KP + d], dp);
        }
        const bool ok = row < sq && key < sk && (!causal || row >= key);
        const float p = ok ? expf(s * scale - Ls[qi]) : 0.f;
        Ps[qi * 33 + lane] = round_to<T>(p);
        Ss[qi * 33 + lane] = round_to<T>(p * (dp - Dl[qi]) * scale);
      }
      __syncthreads();
      for (int qi = 0; qi < BQ; ++qi) {
        const float pv = Ps[qi * 33 + lane];
        const float sv = Ss[qi * 33 + lane];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          dva[c] = fmaf(pv, Os[qi * KP + warp + 4 * c], dva[c]);
          dka[c] = fmaf(sv, Qs[qi * KP + warp + 4 * c], dka[c]);
        }
      }
    }
  }
  if (key >= sk) return;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const long long at = koff + key * kstr + warp + 4 * c;
    dk[at] = ptt::from_f<T>(dka[c]);
    dv[at] = ptt::from_f<T>(dva[c]);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
template <typename K>
int opt_in(K kernel, size_t smem) {
  if (smem > static_cast<size_t>(kSmemMax))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax));
}

struct Shape {
  int B, sq, sk, h, hk;
  float scale;
  int causal;
};

template <typename T, int D>
int fwd(const Shape& s, const void* q, const void* k, const void* v,
        void* out, void* lse, cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value) {
    const size_t smem = fwd_simt_smem<D>();
    static int rc_opt = opt_in(flash_fwd_simt<T, D>, smem);
    if (rc_opt) return rc_opt;
    const dim3 grid((s.sq + kRowsSimt - 1) / kRowsSimt, s.h, s.B);
    flash_fwd_simt<T, D><<<grid, 128, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out),
        static_cast<float*>(lse), s.sq, s.sk, s.h, s.hk, s.scale, s.causal);
  } else {
    const dim3 grid((s.sq + 63) / 64, s.h, s.B);
    flash_fwd_mma<T, D><<<grid, 128, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out),
        static_cast<float*>(lse), s.sq, s.sk, s.h, s.hk, s.scale, s.causal);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int bwd(const Shape& s, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* delta, void* dq,
        void* dk, void* dv, cudaStream_t st) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* o_ = static_cast<const T*>(dout);
  const float* l_ = static_cast<const float*>(lse);
  const float* d_ = static_cast<const float*>(delta);
  if constexpr (std::is_same<T, float>::value) {
    const size_t smem_q = dq_simt_smem<D>(), smem_kv = dkv_simt_smem<D>();
    static int rc_q = opt_in(flash_dq_simt<T, D>, smem_q);
    static int rc_kv = opt_in(flash_dkv_simt<T, D>, smem_kv);
    if (rc_q) return rc_q;
    if (rc_kv) return rc_kv;
    const dim3 gq((s.sq + kRowsSimt - 1) / kRowsSimt, s.h, s.B);
    flash_dq_simt<T, D><<<gq, 128, smem_q, st>>>(
        q_, k_, v_, o_, l_, d_, static_cast<T*>(dq), s.sq, s.sk, s.h, s.hk,
        s.scale, s.causal);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc) return rc;
    const dim3 gkv((s.sk + 31) / 32, s.hk, s.B);
    flash_dkv_simt<T, D><<<gkv, 128, smem_kv, st>>>(
        q_, k_, v_, o_, l_, d_, static_cast<T*>(dk), static_cast<T*>(dv),
        s.sq, s.sk, s.h, s.hk, s.scale, s.causal);
  } else {
    const size_t smem_kv = dkv_mma_smem<T, D>();
    static int rc_kv = opt_in(flash_dkv_mma<T, D>, smem_kv);
    if (rc_kv) return rc_kv;
    const dim3 gq((s.sq + 63) / 64, s.h, s.B);
    flash_dq_mma<T, D><<<gq, 128, 0, st>>>(q_, k_, v_, o_, l_, d_,
                                           static_cast<T*>(dq), s.sq, s.sk,
                                           s.h, s.hk, s.scale, s.causal);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc) return rc;
    const dim3 gkv((s.sk + 63) / 64, s.hk, s.B);
    flash_dkv_mma<T, D><<<gkv, 128, smem_kv, st>>>(
        q_, k_, v_, o_, l_, d_, static_cast<T*>(dk), static_cast<T*>(dv),
        s.sq, s.sk, s.h, s.hk, s.scale, s.causal);
  }
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int sq, int sk, int h, int hk, int d) {
  return B <= 0 || B > 65535 || sq <= 0 || sk <= 0 || h <= 0 || h > 65535 ||
         hk <= 0 || h % hk || (d != 64 && d != 128);
}

}  // namespace

// q [B, sq, h, d], k/v [B, sk, hk, d], out like q, lse [B, h, sq] fp32;
// all contiguous and 16-byte aligned, one dtype; d is 64 or 128.
extern "C" int ptt_flash_fwd(int device, int dtype, const void* q,
                             const void* k, const void* v, void* out,
                             void* lse, int B, int sq, int sk, int h, int hk,
                             int d, float scale, int causal, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bad_shape(B, sq, sk, h, hk, d) || !ptt::aligned16(q) ||
      !ptt::aligned16(k) || !ptt::aligned16(v) || !ptt::aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{B, sq, sk, h, hk, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH(dtype, T, {
    return d == 64 ? fwd<T, 64>(s, q, k, v, out, lse, st)
                   : fwd<T, 128>(s, q, k, v, out, lse, st);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}

// dout like q; lse and delta = rowsum(dout * out) [B, h, sq] fp32; dq
// like q, dk/dv like k.  Two launches: dq, then dk/dv.
extern "C" int ptt_flash_bwd(int device, int dtype, const void* q,
                             const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dq,
                             void* dk, void* dv, int B, int sq, int sk, int h,
                             int hk, int d, float scale, int causal,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bad_shape(B, sq, sk, h, hk, d) || !ptt::aligned16(q) ||
      !ptt::aligned16(k) || !ptt::aligned16(v) || !ptt::aligned16(dout) ||
      !ptt::aligned16(dq) || !ptt::aligned16(dk) || !ptt::aligned16(dv))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{B, sq, sk, h, hk, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH(dtype, T, {
    return d == 64
               ? bwd<T, 64>(s, q, k, v, dout, lse, delta, dq, dk, dv, st)
               : bwd<T, 128>(s, q, k, v, dout, lse, delta, dq, dk, dv, st);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}
