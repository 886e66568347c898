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
// ~0.03 ms for its bytes; the backward 2.5x the forward (five products
// of the same size), and these kernels issue seven (S and dP are
// recomputed by both backward kernels so that no sum crosses blocks).
//
// Design.  The TPU's sequential grid over K blocks becomes a loop inside
// the block; no state crosses blocks, so there are no atomics and the
// result is deterministic.
//   * bf16/fp16, head_dim 64 or 128: Hopper warp specialisation.  A
//     block is three warpgroups.  Warpgroup 0 gives up its registers
//     (setmaxnreg) and one thread of it streams the tiles with TMA
//     (4-D tensor maps over [B, s, heads, d], boxes of 64 columns with
//     128-byte swizzle, rows past s zero-filled) into a ring of shared-
//     memory stages guarded by full/empty mbarriers.  Warpgroups 1 and
//     2 each own 64 rows and run the products as wgmma: QK^T-like
//     products from shared memory with both operands K-major, the
//     second product of each step with its A operand (p or ds, rounded
//     to the operand type) straight from the accumulator registers and
//     B read in place as an MN-major operand (V, K, Q or dO: no
//     transposes).  Softmax in base 2 (scale * log2 e folded into one
//     multiply, one MUFU ex2 an element); lse converted to natural-log
//     units once.  The causal and ragged-edge masks run only on the
//     tiles they cut.
//       fwd: one block per (128 query rows, q head, batch), walking the
//            live 128-key tiles through a 2-stage K/V ring (K and V
//            stages freed on barriers of their own).  Tile j's QK^T and
//            tile j-1's PV are in flight together and tile j's softmax
//            runs under the PV; the two warpgroups take turns to issue
//            (named barriers), so one's softmax also runs under the
//            other's products.
//       dq:  one block per (128 query rows, q head, batch); its
//            prologue computes delta = rowsum(dO.O) in fp32 for its rows
//            and writes it for dkv; it walks the live 64-key tiles:
//            S = QK^T, dP = dO.V^T, dQ += dS.K.
//       dkv: one block per (128 keys, kv head, batch); it walks every
//            query head of its GQA group and the live 64-row query
//            tiles (a 3-stage ring of Q, dO, lse and delta; lse and
//            delta through 1-D tensor maps), with S^T = K.Q^T,
//            dP^T = V.dO^T, dV += P^T.dO and dK += dS^T.Q, the dK and dV
//            accumulators in registers over the whole walk (the TPU
//            kernel's accumulation over t = (g, qi), :717-741).
//     Causal grids launch heaviest first: the last query tiles (fwd,
//     dq) and the first key tiles (dkv) get the lowest block indices.
//     What is left between these kernels and the card: the forward's
//     exp and softmax instructions per product (it reaches ~1/3 of the
//     tensor peak where the backward, with more products per exp,
//     reaches ~1/2), each block's unhidden prologue (Q and the first K
//     tile) and epilogue, and in the backward no overlap of a tile's
//     elementwise work with the next tile's products; dkv has one block
//     per 128 keys and kv head, too few to fill the card at short
//     sequences and few kv heads.
//   * fp32: the same three walks on CUDA cores (one lane per key, the
//     warp reduces with shuffles), delta from a small kernel of its own.
//   * ragged edges: rows past sq and keys past sk are masked in the
//     kernel (the TPU kernel needs a power-of-two block dividing s).
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace ptt::sm90;

constexpr float kNegInf = -1e30f;    // flash_attention.py NEG_INF
constexpr int kSmemMax = 232448;     // H100 opt-in limit per block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return ptt::to_f(ptt::from_f<T>(x));
}

// Copy rows [r0, r0 + rows) of a [*, stride]-strided matrix of width D
// into fp32 shared memory [rows][ld], zero past `limit` rows.
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
constexpr int kThreads = 384;     // warpgroup 0 loads, 1 and 2 compute
constexpr int kConsumers = 256;   // arrivals that free a ring stage

// the first 1024-byte boundary at or after p (a swizzled tile's alignment)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// A operand of the kk-th k step from accumulators s in the wgmma layout
template <typename T>
__device__ __forceinline__ void to_a(const float* s, int kk, uint32_t* a) {
  a[0] = ptt::pack2<T>(s[8 * kk], s[8 * kk + 1]);
  a[1] = ptt::pack2<T>(s[8 * kk + 2], s[8 * kk + 3]);
  a[2] = ptt::pack2<T>(s[8 * kk + 4], s[8 * kk + 5]);
  a[3] = ptt::pack2<T>(s[8 * kk + 6], s[8 * kk + 7]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Store rows r0 and r0 + 8 of a warpgroup's [64, D] accumulators to a
// [*, D] matrix of row stride `stride` (rows at or past `limit` skipped).
template <typename T, int D>
__device__ __forceinline__ void store_rows(const float* acc, T* base,
                                           long long stride, int r0,
                                           int limit, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= limit) continue;
    T* row = base + r * stride + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) =
          ptt::pack2<T>(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
  }
}

template <int D>
struct FwdCfg {
  static constexpr int BQ = 128, BK = 128, NS = 2;
  static constexpr int kQ = BQ * D * 2, kKV = BK * D * 2;
  static constexpr int kBars = kQ + 2 * NS * kKV;
  static constexpr size_t kSmem = kBars + 8 * (1 + 4 * NS) + 1024;
};

// Online softmax of one key tile for the rows r0 and r0 + 8 of a thread:
// s holds the raw scores q.k (the wgmma accumulator layout) and becomes
// p = exp2(s * scale log2 e - m) in place; m and l are the running max
// (base-2 units) and sum; returns the factors that rescale the rows'
// earlier output.
template <int BK>
__device__ __forceinline__ float2 softmax_tile(float* s, float& m0, float& m1,
                                               float& l0, float& l1, int k0,
                                               int sk, int r0, int t,
                                               float sc2, bool edge,
                                               int causal) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * sc2;
      if (edge) {     // masks only on the tiles they cut
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        if (key >= sk || (causal && key > r0 + 8 * (e >> 1))) x = -INFINITY;
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
      const float p = exp2_ftz(s[4 * j + e] - (e < 2 ? b0 : b1));
      s[4 * j + e] = p;
      if (e < 2)
        ps0 += p;
      else
        ps1 += p;
    }
  const float a0 = exp2_ftz(m0 - b0), a1 = exp2_ftz(m1 - b1);
  l0 = l0 * a0 + ps0;
  l1 = l1 * a1 + ps1;
  m0 = n0;
  m1 = n1;
  return make_float2(a0, a1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_wgmma(
    const __grid_constant__ CUtensorMap mq,
    const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv, T* __restrict__ out,
    float* __restrict__ lse, int sq, int sk, int h, int hk, float scale,
    int causal) {
  using C = FwdCfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, NS = C::NS;
  extern __shared__ __align__(1024) uint8_t fa_tiles[];
  uint8_t* const sQ = align1024(fa_tiles);
  uint8_t* const sK = sQ + C::kQ;           // NS stages
  uint8_t* const sV = sK + NS * C::kKV;     // NS stages
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(sQ + C::kBars);
  uint64_t* const k_full = q_full + 1;
  uint64_t* const v_full = k_full + NS;
  uint64_t* const k_empty = v_full + NS;
  uint64_t* const v_empty = k_empty + NS;
  const int hq = blockIdx.x, b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * BQ;
  const int kvh = hq / (h / hk);
  const int n_kt = live_key_tiles(q0, BQ, sq, sk, BK, causal);
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < NS; ++i) {
      mbar_init(k_full + i, 1);
      mbar_init(v_full + i, 1);
      mbar_init(k_empty + i, kConsumers);
      mbar_init(v_empty + i, kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // -- producer: K and V stages freed on their own barriers --------------
    reg_dealloc<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::kQ);
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(sQ + c * BQ * 128, &mq, q_full, c * 64, hq, q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % NS;
        const uint32_t free = ((kt / NS) & 1) ^ 1;
        mbar_wait(k_empty + st, free);
        mbar_expect_tx(k_full + st, C::kKV);
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(sK + st * C::kKV + c * BK * 128, &mk, k_full + st,
                      c * 64, kvh, kt * BK, b);
        mbar_wait(v_empty + st, free);
        mbar_expect_tx(v_full + st, C::kKV);
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(sV + st * C::kKV + c * BK * 128, &mv, v_full + st,
                      c * 64, kvh, kt * BK, b);
      }
    }
  } else {
    // -- consumers: 64 query rows each.  Tile kt's QK^T and tile kt-1's PV
    // are in flight together; the softmax of tile kt runs under the PV.
    reg_alloc<240>();
    const int cw = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const int rw = q0 + cw * 64;                // this warpgroup's first row
    const int r0 = rw + warp * 16 + g;
    const float sc2 = scale * kLog2e;
    const uint32_t aq = smem_u32(sQ) + cw * 64 * 128;
    const uint32_t ak = smem_u32(sK), av = smem_u32(sV);
    float o[D / 2], s[BK / 2];
    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    // the two warpgroups take turns to issue their products (warpgroup 0
    // first), so one's softmax runs under the other's products
    const int my_turn = 1 + cw, their_turn = 2 - cw;
    if (cw == 1) named_arrive(1);
    mbar_wait(q_full, 0);
    // tile 0: scores and softmax alone
    mbar_wait(k_full, 0);
    named_sync(my_turn);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<T, BK>::ss(s, kdesc(aq, BQ, kk), kdesc(ak, BK, kk), kk);
    wgmma_commit();
    named_arrive(their_turn);
    wgmma_wait<0>();
    fence_regs<BK / 2>(s);
    mbar_arrive(k_empty);
    softmax_tile<BK>(s, m0, m1, l0, l1, 0, sk, r0, t, sc2,
                     (causal && BK - 1 > rw) || BK > sk, causal);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) to_a<T>(s, kk, pf[kk]);
    // tile kt's scores and tile kt-1's P.V in flight together
    for (int kt = 1; kt < n_kt; ++kt) {
      const int st = kt % NS, sp = (kt - 1) % NS;
      const int k0 = kt * BK;
      mbar_wait(k_full + st, (kt / NS) & 1);
      mbar_wait(v_full + sp, ((kt - 1) / NS) & 1);
      named_sync(my_turn);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<T, BK>::ss(s, kdesc(aq, BQ, kk),
                         kdesc(ak + st * C::kKV, BK, kk), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<T, D>::rs(o, pf[kk], mdesc(av + sp * C::kKV, BK, kk), 1);
      wgmma_commit();
      named_arrive(their_turn);
      wgmma_wait<1>();
      fence_regs<BK / 2>(s);
      mbar_arrive(k_empty + st);
      const float2 a = softmax_tile<BK>(
          s, m0, m1, l0, l1, k0, sk, r0, t, sc2,
          (causal && k0 + BK - 1 > rw) || k0 + BK > sk, causal);
      wgmma_wait<0>();
      fence_regs<D / 2>(o);
      mbar_arrive(v_empty + sp);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= a.x;
        o[4 * j + 1] *= a.x;
        o[4 * j + 2] *= a.y;
        o[4 * j + 3] *= a.y;
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) to_a<T>(s, kk, pf[kk]);
    }
    // the last tile's P.V
    const int sl = (n_kt - 1) % NS;
    mbar_wait(v_full + sl, ((n_kt - 1) / NS) & 1);
    named_sync(my_turn);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<T, D>::rs(o, pf[kk], mdesc(av + sl * C::kKV, BK, kk), 1);
    wgmma_commit();
    if (cw == 0) named_arrive(their_turn);   // warpgroup 1 issues last
    wgmma_wait<0>();
    fence_regs<D / 2>(o);
    mbar_arrive(v_empty + sl);
    l0 = fmaxf(quad_sum(l0), 1e-30f);
    l1 = fmaxf(quad_sum(l1), 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] /= l0;
      o[4 * j + 1] /= l0;
      o[4 * j + 2] /= l1;
      o[4 * j + 3] /= l1;
    }
    const long long qstr = static_cast<long long>(h) * D;
    store_rows<T, D>(o, out + (static_cast<long long>(b) * sq * h + hq) * D,
                     qstr, r0, sq, t);
    float* lrow = lse + (static_cast<long long>(b) * h + hq) * sq;
    if (t == 0 && r0 < sq) lrow[r0] = (m0 + log2f(l0)) * kLn2;
    if (t == 0 && r0 + 8 < sq) lrow[r0 + 8] = (m1 + log2f(l1)) * kLn2;
  }
}

template <int D>
struct DqCfg {
  static constexpr int BQ = 128, BK = 64, NS = 2;
  static constexpr int kQ = BQ * D * 2, kKV = BK * D * 2;
  static constexpr int kBars = 2 * kQ + 2 * NS * kKV;
  static constexpr size_t kSmem = kBars + 8 * (1 + 2 * NS) + 1024;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) flash_dq_wgmma(
    const __grid_constant__ CUtensorMap mq,
    const __grid_constant__ CUtensorMap mdo,
    const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv, const T* __restrict__ out,
    const T* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, T* __restrict__ dq, int sq, int sk, int h,
    int hk, float scale, int causal) {
  using C = DqCfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, NS = C::NS;
  extern __shared__ __align__(1024) uint8_t fa_tiles[];
  uint8_t* const sQ = align1024(fa_tiles);
  uint8_t* const sO = sQ + C::kQ;           // dO
  uint8_t* const sK = sO + C::kQ;           // NS stages of K, then of V
  uint8_t* const sV = sK + NS * C::kKV;
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(sQ + C::kBars);
  uint64_t* const full = q_full + 1;
  uint64_t* const empty = full + NS;
  const int hq = blockIdx.x, b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * BQ;
  const int kvh = hq / (h / hk);
  const int n_kt = live_key_tiles(q0, BQ, sq, sk, BK, causal);
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < NS; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    reg_dealloc<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * C::kQ);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(sQ + c * BQ * 128, &mq, q_full, c * 64, hq, q0, b);
        tma_load_4d(sO + c * BQ * 128, &mdo, q_full, c * 64, hq, q0, b);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % NS;
        mbar_wait(empty + st, ((kt / NS) & 1) ^ 1);
        mbar_expect_tx(full + st, 2 * C::kKV);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(sK + st * C::kKV + c * BK * 128, &mk, full + st, c * 64,
                      kvh, kt * BK, b);
          tma_load_4d(sV + st * C::kKV + c * BK * 128, &mv, full + st, c * 64,
                      kvh, kt * BK, b);
        }
      }
    }
  } else {
    reg_alloc<240>();
    const int cw = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const int rw = q0 + cw * 64;
    const int r0 = rw + warp * 16 + g;
    const float sc2 = scale * kLog2e;
    const long long qstr = static_cast<long long>(h) * D;
    const long long qoff = (static_cast<long long>(b) * sq * h + hq) * D;
    const long long soff = (static_cast<long long>(b) * h + hq) * sq;
    // delta = rowsum(dO . O) in fp32: the four threads of a quad split
    // the row; lse in base-2 units
    float dl[2], l2[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      float acc = 0.f;
      if (r < sq) {
        const long long at = qoff + r * qstr + t * (D / 4);
#pragma unroll
        for (int u = 0; u < D / 4; u += ptt::Vec<T>::N) {
          float x[ptt::Vec<T>::N], y[ptt::Vec<T>::N];
          ptt::load_vec<T>(dout + at + u, x);
          ptt::load_vec<T>(out + at + u, y);
#pragma unroll
          for (int i = 0; i < ptt::Vec<T>::N; ++i) acc = fmaf(x[i], y[i], acc);
        }
      }
      dl[half] = quad_sum(acc);
      if (t == 0 && r < sq) delta[soff + r] = dl[half];
      l2[half] = r < sq ? lse[soff + r] * kLog2e : 0.f;
    }
    const uint32_t aq = smem_u32(sQ) + cw * 64 * 128;
    const uint32_t ao = smem_u32(sO) + cw * 64 * 128;
    const uint32_t ak = smem_u32(sK), av = smem_u32(sV);
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(q_full, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt % NS;
      const int k0 = kt * BK;
      float s[BK / 2], dp[BK / 2];
      mbar_wait(full + st, (kt / NS) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<T, BK>::ss(s, kdesc(aq, BQ, kk),
                         kdesc(ak + st * C::kKV, BK, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<T, BK>::ss(dp, kdesc(ao, BQ, kk),
                         kdesc(av + st * C::kKV, BK, kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<BK / 2>(s);
      fence_regs<BK / 2>(dp);
      // s becomes ds = p * (dp - delta) * scale
      const bool edge = (causal && k0 + BK - 1 > rw) || k0 + BK > sk;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int half = e >> 1;
          float p = exp2_ftz(s[4 * j + e] * sc2 - l2[half]);
          if (edge) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            if (key >= sk || (causal && key > r0 + 8 * half)) p = 0.f;
          }
          s[4 * j + e] = p * (dp[4 * j + e] - dl[half]) * scale;
        }
      uint32_t df[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) to_a<T>(s, kk, df[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<T, D>::rs(acc, df[kk], mdesc(ak + st * C::kKV, BK, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<D / 2>(acc);
      mbar_arrive(empty + st);
    }
    store_rows<T, D>(acc, dq + qoff, qstr, r0, sq, t);
  }
}

template <int D>
struct DkvCfg {
  static constexpr int BKV = 128, BQ = 64, NS = 3;
  // lse and delta boxes: a TMA box starts 16-byte aligned, so a row's
  // 64 values are read from the multiple of 4 at or below their start,
  // 4 more; each stage's slot is 128-byte aligned
  static constexpr int kVecBox = BQ + 4;
  static constexpr int kKV = BKV * D * 2, kQ = BQ * D * 2, kVec = 384;
  static constexpr int kBars = 2 * kKV + 2 * NS * kQ + 2 * NS * kVec;
  static constexpr size_t kSmem = kBars + 8 * (1 + 2 * NS) + 1024;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) flash_dkv_wgmma(
    const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv,
    const __grid_constant__ CUtensorMap mq,
    const __grid_constant__ CUtensorMap mdo,
    const __grid_constant__ CUtensorMap ml,
    const __grid_constant__ CUtensorMap md, T* __restrict__ dk,
    T* __restrict__ dv, int sq, int sk, int h, int hk, float scale,
    int causal) {
  using C = DkvCfg<D>;
  constexpr int BKV = C::BKV, BQ = C::BQ, NS = C::NS;
  extern __shared__ __align__(1024) uint8_t fa_tiles[];
  uint8_t* const sK = align1024(fa_tiles);
  uint8_t* const sV = sK + C::kKV;
  uint8_t* const sQ = sV + C::kKV;          // NS stages of Q, then of dO
  uint8_t* const sO = sQ + NS * C::kQ;
  float* const sL = reinterpret_cast<float*>(sO + NS * C::kQ);   // lse
  float* const sD = sL + NS * C::kVec / 4;                       // delta
  uint64_t* const kv_full = reinterpret_cast<uint64_t*>(sK + C::kBars);
  uint64_t* const full = kv_full + 1;
  uint64_t* const empty = full + NS;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BKV;        // causal: the heaviest tile first
  const int group = h / hk;
  const int qt0 = causal ? k0 / BQ : 0;
  const int n_qt = (sq + BQ - 1) / BQ;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int i = 0; i < NS; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    reg_dealloc<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * C::kKV);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(sK + c * BKV * 128, &mk, kv_full, c * 64, kvh, k0, b);
        tma_load_4d(sV + c * BKV * 128, &mv, kv_full, c * 64, kvh, k0, b);
      }
      int it = 0;
      for (int gi = 0; gi < group; ++gi) {
        const int hq = kvh * group + gi;
        const int lrow = (b * h + hq) * sq;
        for (int qt = qt0; qt < n_qt; ++qt, ++it) {
          const int st = it % NS;
          mbar_wait(empty + st, ((it / NS) & 1) ^ 1);
          mbar_expect_tx(full + st, 2 * C::kQ + 2 * C::kVecBox * 4);
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(sQ + st * C::kQ + c * BQ * 128, &mq, full + st,
                        c * 64, hq, qt * BQ, b);
            tma_load_4d(sO + st * C::kQ + c * BQ * 128, &mdo, full + st,
                        c * 64, hq, qt * BQ, b);
          }
          const int at = (lrow + qt * BQ) & ~3;
          tma_load_1d(sL + st * C::kVec / 4, &ml, full + st, at);
          tma_load_1d(sD + st * C::kVec / 4, &md, full + st, at);
        }
      }
    }
  } else {
    reg_alloc<240>();
    const int cw = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const int kw = k0 + cw * 64;                // this warpgroup's first key
    const int kr0 = kw + warp * 16 + g;
    const float sc2 = scale * kLog2e;
    const uint32_t ak = smem_u32(sK) + cw * 64 * 128;
    const uint32_t av = smem_u32(sV) + cw * 64 * 128;
    const uint32_t aq = smem_u32(sQ), ao = smem_u32(sO);
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    mbar_wait(kv_full, 0);
    int it = 0;
    for (int gi = 0; gi < group; ++gi) {
      const int lrow = (b * h + kvh * group + gi) * sq;
      for (int qt = qt0; qt < n_qt; ++qt, ++it) {
        const int st = it % NS;
        const int q0 = qt * BQ;
        mbar_wait(full + st, (it / NS) & 1);
        if (!causal || q0 + BQ - 1 >= kw) {   // some row sees some key
          float s[BQ / 2], dp[BQ / 2];        // S^T and dP^T: keys x rows
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            Wgmma<T, BQ>::ss(s, kdesc(ak, BKV, kk),
                             kdesc(aq + st * C::kQ, BQ, kk), kk);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            Wgmma<T, BQ>::ss(dp, kdesc(av, BKV, kk),
                             kdesc(ao + st * C::kQ, BQ, kk), kk);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<BQ / 2>(s);
          fence_regs<BQ / 2>(dp);
          // s becomes p, dp becomes ds
          const bool edge = (causal && q0 < kw + 63) || q0 + BQ > sq;
          const int off = (lrow + q0) & 3;     // the box's aligned start
          const float* L = sL + st * C::kVec / 4 + off + 2 * t;
          const float* Dl = sD + st * C::kVec / 4 + off + 2 * t;
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float lc = L[8 * j + (e & 1)];
              const float dc = Dl[8 * j + (e & 1)];
              float p = exp2_ftz(s[4 * j + e] * sc2 - lc * kLog2e);
              if (edge) {
                const int row = q0 + 8 * j + 2 * t + (e & 1);
                const int key = kr0 + 8 * (e >> 1);
                if (row >= sq || (causal && row < key)) p = 0.f;
              }
              s[4 * j + e] = p;
              dp[4 * j + e] = p * (dp[4 * j + e] - dc) * scale;
            }
          }
          uint32_t pf[BQ / 16][4], df[BQ / 16][4];
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) {
            to_a<T>(s, kk, pf[kk]);
            to_a<T>(dp, kk, df[kk]);
          }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
            Wgmma<T, D>::rs(dva, pf[kk], mdesc(ao + st * C::kQ, BQ, kk), 1);
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
            Wgmma<T, D>::rs(dka, df[kk], mdesc(aq + st * C::kQ, BQ, kk), 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<D / 2>(dka);
          fence_regs<D / 2>(dva);
        }
        mbar_arrive(empty + st);
      }
    }
    const long long kstr = static_cast<long long>(hk) * D;
    const long long koff = (static_cast<long long>(b) * sk * hk + kvh) * D;
    store_rows<T, D>(dka, dk + koff, kstr, kr0, sk, t);
    store_rows<T, D>(dva, dv + koff, kstr, kr0, sk, t);
  }
}

// delta = rowsum(dO . O) [B, h, sq] for the fp32 path, one thread a row
template <typename T, int D>
__global__ void __launch_bounds__(256) flash_delta_simt(
    const T* __restrict__ out, const T* __restrict__ dout,
    float* __restrict__ delta, int B, int sq, int h) {
  const long long i = blockIdx.x * 256ll + threadIdx.x;   // over [B, sq, h]
  if (i >= static_cast<long long>(B) * sq * h) return;
  const int hq = static_cast<int>(i % h);
  const long long bs = i / h;
  const int r = static_cast<int>(bs % sq), b = static_cast<int>(bs / sq);
  float acc = 0.f;
  for (int d = 0; d < D; ++d)
    acc = fmaf(ptt::to_f(dout[i * D + d]), ptt::to_f(out[i * D + d]), acc);
  delta[(static_cast<long long>(b) * h + hq) * sq + r] = acc;
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

int blocks(int n, int rows) { return (n + rows - 1) / rows; }

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
    using C = FwdCfg<D>;
    static int rc_opt = opt_in(flash_fwd_wgmma<T, D>, C::kSmem);
    if (rc_opt) return rc_opt;
    CUtensorMap mq, mk, mv;
    if (!map_rows16(&mq, q, s.B, s.sq, s.h, D, C::BQ) ||
        !map_rows16(&mk, k, s.B, s.sk, s.hk, D, C::BK) ||
        !map_rows16(&mv, v, s.B, s.sk, s.hk, D, C::BK))
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(s.h, s.B, blocks(s.sq, C::BQ));
    flash_fwd_wgmma<T, D><<<grid, kThreads, C::kSmem, st>>>(
        mq, mk, mv, static_cast<T*>(out), static_cast<float*>(lse), s.sq,
        s.sk, s.h, s.hk, s.scale, s.causal);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int bwd(const Shape& s, const void* q, const void* k, const void* v,
        const void* out, const void* dout, const void* lse, void* delta,
        void* dq, void* dk, void* dv, cudaStream_t st) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* o_ = static_cast<const T*>(out);
  const T* g_ = static_cast<const T*>(dout);
  const float* l_ = static_cast<const float*>(lse);
  float* d_ = static_cast<float*>(delta);
  if constexpr (std::is_same<T, float>::value) {
    const size_t smem_q = dq_simt_smem<D>(), smem_kv = dkv_simt_smem<D>();
    static int rc_q = opt_in(flash_dq_simt<T, D>, smem_q);
    static int rc_kv = opt_in(flash_dkv_simt<T, D>, smem_kv);
    if (rc_q) return rc_q;
    if (rc_kv) return rc_kv;
    const long long rows = static_cast<long long>(s.B) * s.sq * s.h;
    flash_delta_simt<T, D><<<static_cast<unsigned>((rows + 255) / 256), 256,
                             0, st>>>(o_, g_, d_, s.B, s.sq, s.h);
    int rc = static_cast<int>(cudaGetLastError());
    if (rc) return rc;
    const dim3 gq((s.sq + kRowsSimt - 1) / kRowsSimt, s.h, s.B);
    flash_dq_simt<T, D><<<gq, 128, smem_q, st>>>(
        q_, k_, v_, g_, l_, d_, static_cast<T*>(dq), s.sq, s.sk, s.h, s.hk,
        s.scale, s.causal);
    rc = static_cast<int>(cudaGetLastError());
    if (rc) return rc;
    const dim3 gkv((s.sk + 31) / 32, s.hk, s.B);
    flash_dkv_simt<T, D><<<gkv, 128, smem_kv, st>>>(
        q_, k_, v_, g_, l_, d_, static_cast<T*>(dk), static_cast<T*>(dv),
        s.sq, s.sk, s.h, s.hk, s.scale, s.causal);
  } else {
    using Q = DqCfg<D>;
    using KV = DkvCfg<D>;
    static int rc_q = opt_in(flash_dq_wgmma<T, D>, Q::kSmem);
    static int rc_kv = opt_in(flash_dkv_wgmma<T, D>, KV::kSmem);
    if (rc_q) return rc_q;
    if (rc_kv) return rc_kv;
    const long long n = static_cast<long long>(s.B) * s.h * s.sq;
    CUtensorMap mq, mdo, mk, mv, mk2, mv2, mq2, mdo2, ml, md;
    if (!map_rows16(&mq, q, s.B, s.sq, s.h, D, Q::BQ) ||
        !map_rows16(&mdo, dout, s.B, s.sq, s.h, D, Q::BQ) ||
        !map_rows16(&mk, k, s.B, s.sk, s.hk, D, Q::BK) ||
        !map_rows16(&mv, v, s.B, s.sk, s.hk, D, Q::BK) ||
        !map_rows16(&mk2, k, s.B, s.sk, s.hk, D, KV::BKV) ||
        !map_rows16(&mv2, v, s.B, s.sk, s.hk, D, KV::BKV) ||
        !map_rows16(&mq2, q, s.B, s.sq, s.h, D, KV::BQ) ||
        !map_rows16(&mdo2, dout, s.B, s.sq, s.h, D, KV::BQ) ||
        !map_vec32(&ml, lse, n, KV::kVecBox) ||
        !map_vec32(&md, delta, n, KV::kVecBox))
      return static_cast<int>(cudaErrorInvalidValue);
    flash_dq_wgmma<T, D><<<dim3(s.h, s.B, blocks(s.sq, Q::BQ)), kThreads,
                           Q::kSmem, st>>>(
        mq, mdo, mk, mv, o_, g_, l_, d_, static_cast<T*>(dq), s.sq, s.sk,
        s.h, s.hk, s.scale, s.causal);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc) return rc;
    flash_dkv_wgmma<T, D><<<dim3(s.hk, s.B, blocks(s.sk, KV::BKV)), kThreads,
                            KV::kSmem, st>>>(
        mk2, mv2, mq2, mdo2, ml, md, static_cast<T*>(dk), static_cast<T*>(dv),
        s.sq, s.sk, s.h, s.hk, s.scale, s.causal);
  }
  return static_cast<int>(cudaGetLastError());
}

// the grids' y and z dimensions and the 32-bit offsets of the lse and
// delta tensor maps bound the sizes
bool bad_shape(int B, int sq, int sk, int h, int hk, int d) {
  return B <= 0 || B > 65535 || sq <= 0 || sk <= 0 || h <= 0 || h > 65535 ||
         hk <= 0 || h % hk || (d != 64 && d != 128) ||
         static_cast<long long>(B) * h * sq >= (1ll << 31) ||
         sq > 65535 * 128 || sk > 65535 * 128;
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

// out and dout like q; lse [B, h, sq] fp32; delta [B, h, sq] fp32 is
// scratch the first launch fills with rowsum(dout * out); dq like q,
// dk/dv like k.  bf16/fp16: two launches, dq (with delta), then dk/dv;
// fp32: delta, dq, dk/dv.
extern "C" int ptt_flash_bwd(int device, int dtype, const void* q,
                             const void* k, const void* v, const void* out,
                             const void* dout, const void* lse, void* delta,
                             void* dq, void* dk, void* dv, int B, int sq,
                             int sk, int h, int hk, int d, float scale,
                             int causal, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bad_shape(B, sq, sk, h, hk, d) || !ptt::aligned16(q) ||
      !ptt::aligned16(k) || !ptt::aligned16(v) || !ptt::aligned16(out) ||
      !ptt::aligned16(dout) || !ptt::aligned16(lse) ||
      !ptt::aligned16(delta) || !ptt::aligned16(dq) || !ptt::aligned16(dk) ||
      !ptt::aligned16(dv))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{B, sq, sk, h, hk, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH(dtype, T, {
    return d == 64 ? bwd<T, 64>(s, q, k, v, out, dout, lse, delta, dq, dk,
                                dv, st)
                   : bwd<T, 128>(s, q, k, v, out, dout, lse, delta, dq, dk,
                                 dv, st);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}
