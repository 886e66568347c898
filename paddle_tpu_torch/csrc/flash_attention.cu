// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py::
// flash_attention (:816): forward _fwd_kernel (:482) and its _small /
// _1b twins, backward _bwd_dq_kernel (:585) and _bwd_dkv_kernel (:630).
//   out = softmax(q.k^T * scale [+ key bias] [causal]) . v
// q [B, sq, h, d], k/v [B, sk, hk, d] (h % hk == 0, query head hq reads
// kv head hq / (h / hk), `_kv_head_map` :64), addressed in that layout
// through strides: none of the TPU wrapper's transposes to [b*h, s, d].
// d is any multiple of 8 from 8 to 256: the body is the next multiple of
// 64 (the TPU kernel's domain is d % 64 == 0, :826-831), columns past d
// are zero-filled on load (TMA) or read as 0, and stores stop at d.
//
// Masks follow the reference twin `xla_attention` (paddle_tpu/ops/
// __init__.py:80-102), which replaces a masked logit by -1e30:
//   * causal: key j is live for row i iff j <= i + sk - sq (bottom-right
//     aligned; top-left when sq == sk, as the TPU kernel's);
//   * an optional key bias [B or 1, skp] fp32 (the wrapper's form of a
//     key-padding mask: 0 / -1e30 for a bool mask, the values clamped at
//     -1e30 for an additive one), added to every row's logits;
//   * a row whose every key is masked gets the reference's uniform
//     weights over all sk keys (its logits are all -1e30): the forward
//     walks every key tile for such a block, counts each masked key with
//     p = 1 there, and saves the row max +inf as the row's mark.  The
//     backward reads the mark: p = exp(x - m) = 0 for dq and ds, 1/sk
//     for dv, as autograd through the twin's `where` gives.
// The saved statistics (flash_attention.py::_stats): without a key bias
// lse [B, h, sq], each row's logsumexp; with one, [B, h, sq, 2]: each
// row's max m and g = log sum exp(x - m), so that the backward's
// p = exp((x - m) - g) keeps a row whose logits all carry a large finite
// bias (-1e9: lse = m + log(sk) rounds to m in fp32).  The bias bodies
// keep their logits in natural units, the backward's x - m exact.
// Keys past sk (the ragged edge) count nowhere.  fp32 softmax; p is
// rounded to the operand type before P.V (:518), ds and p before their
// products in the backward (:618, :664, :670).
//
// What bounds it on the H100: operations.  At the training shape
// (q [4, 2048, 20, 128], kv [4, 2048, 4, 128], bf16, causal) the forward
// does 4*b*h*s^2*d/2 = 8.6e10 FLOP, 0.087 ms at 989 TFLOP/s, against
// ~0.03 ms for its bytes; the backward 2.5x the forward (five products
// of the same size), and these kernels issue seven (S and dP are
// recomputed by both backward kernels so that no sum crosses blocks).
//
// Design.  The TPU's sequential grid over K blocks becomes a loop inside
// the block; no state crosses blocks (but within an fp32 dk/dv cluster,
// in a fixed order), so there are no atomics and the result is
// deterministic.
//   * bf16/fp16: Hopper warp specialisation.  A block is three
//     warpgroups.  Warpgroup 0 gives up its registers
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
//     tiles they cut; the key bias (MASK bodies) on every tile.
//       fwd: one block per (128 query rows, q head, batch), walking the
//            live key tiles (128 keys; 64 for bodies wider than 128)
//            through a 2-stage K/V ring (K and V
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
//            tiles (a ring of Q, dO, lse and delta; lse and
//            delta through 1-D tensor maps), with S^T = K.Q^T,
//            dP^T = V.dO^T, dV += P^T.dO and dK += dS^T.Q, the dK and dV
//            accumulators in registers over the whole walk (the TPU
//            kernel's accumulation over t = (g, qi), :717-741).
//     Bodies wider than 128 (d 136-256): the same walks with what the
//     card holds.  fwd takes 64-key tiles (Q 48-64 KB and two K and V
//     stages fit in 227 KB); dq keeps 2 stages at 192 and 1 at 256; dkv
//     cannot keep dK and dV of 64 keys x 256 columns in a warpgroup's
//     registers (256 a thread), so its grid also splits the columns of
//     dK and dV into chunks (3 of 64 at 192, 2 of 128 at 256), each
//     block recomputing S^T and dP^T over the full width for its chunk,
//     with 2 stages at 192 and 1 at 256.  Simple first: the widths of
//     64 and 128 keep their bodies and times.
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
//   * fp32: the same three walks on the tensor cores, as a three-pass
//     TF32 split, in flash_attention_f32.cu (a translation unit of its
//     own; its header says what bounds those bodies and how they are
//     built).  The pieces both share are in flash_attention.cuh.
//   * ragged edges: rows past sq and keys past sk are masked in the
//     kernel (the TPU kernel needs a power-of-two block dividing s).
#include <type_traits>

#include "flash_attention.cuh"

namespace {

using namespace ptt::sm90;
using namespace ptt::flash;

// the body width of head dim d: the next multiple of 64
constexpr int body_width(int d) { return (d + 63) / 64 * 64; }

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

// Store rows r0 and r0 + 8 of a warpgroup's [64, D] accumulators to a
// [*, stride] matrix (rows at or past `limit` skipped, columns at or past
// `cols` too; cols is a multiple of 8).
template <typename T, int D>
__device__ __forceinline__ void store_rows(const float* acc, T* base,
                                           long long stride, int r0,
                                           int limit, int t, int cols) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= limit) continue;
    T* row = base + r * stride + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j < cols)
        *reinterpret_cast<uint32_t*>(row + 8 * j) =
            ptt::pack2<T>(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
  }
}

template <int D, bool MASK>
struct FwdCfg {
  // 128-key tiles up to d 128; 64 above, so that two K and V stages and
  // the 128-row Q tile fit in shared memory; MASK bodies stage each key
  // tile's bias beside its K
  static constexpr int BQ = 128, BK = D > 128 ? 64 : 128, NS = 2;
  static constexpr int kQ = BQ * D * 2, kKV = BK * D * 2;
  static constexpr int kB = MASK ? BK * 4 : 0;
  static constexpr int kBars = kQ + 2 * NS * kKV + NS * kB;
  static constexpr size_t kSmem = kBars + 8 * (1 + 4 * NS) + 1024;
};

// The bodies: MASK false takes no key bias and no row without a live
// key (causal needs sq <= sk); MASK true reads the key bias (never null)
// and handles such rows.  FIT (MASK false, d the body's width, causal
// only with sq == sk) compiles the d and offset arithmetic away: the
// widths 64 and 128 keep their earlier code, bits and times.
template <typename T, int D, bool MASK, bool FIT>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_wgmma(
    const __grid_constant__ CUtensorMap mq,
    const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv, T* __restrict__ out,
    float* __restrict__ lse, const float* __restrict__ bias, int bstride,
    int sq, int sk, int h, int hk, int d_arg, float scale, int causal) {
  using C = FwdCfg<D, MASK>;
  constexpr int BQ = C::BQ, BK = C::BK, NS = C::NS;
  extern __shared__ __align__(1024) uint8_t fa_tiles[];
  uint8_t* const sQ = align1024(fa_tiles);
  uint8_t* const sK = sQ + C::kQ;           // NS stages
  uint8_t* const sV = sK + NS * C::kKV;     // NS stages
  float* const sB = reinterpret_cast<float*>(sV + NS * C::kKV);  // bias
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(sQ + C::kBars);
  uint64_t* const k_full = q_full + 1;
  uint64_t* const v_full = k_full + NS;
  uint64_t* const k_empty = v_full + NS;
  uint64_t* const v_empty = k_empty + NS;
  const int hq = blockIdx.x, b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * BQ;
  const int kvh = hq / (h / hk);
  // FIT: d the body's width, causal with sq == sk (the 64 / 128 bodies
  // as they were)
  const int off = FIT ? 0 : sk - sq;
  const int d = FIT ? D : d_arg;
  // MASK: any row may have no live key, and then needs every tile
  const int n_kt = live_key_tiles(q0, BQ, sq, sk, BK, causal, off, MASK);
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
      const float* brow = bias + static_cast<long long>(b) * bstride;
      mbar_expect_tx(q_full, C::kQ);
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(sQ + c * BQ * 128, &mq, q_full, c * 64, hq, q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % NS;
        const uint32_t free = ((kt / NS) & 1) ^ 1;
        mbar_wait(k_empty + st, free);
        mbar_expect_tx(k_full + st, C::kKV + C::kB);
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(sK + st * C::kKV + c * BK * 128, &mk, k_full + st,
                      c * 64, kvh, kt * BK, b);
        if constexpr (MASK)
          bulk_load(sB + st * BK, brow + kt * BK, C::kB, k_full + st);
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
    const int rl = r0 + off, rwl = rw + off;    // their last live keys
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
    // a MASK body frees the K stage after its softmax has read the bias
    if (!MASK) mbar_arrive(k_empty);
    softmax_tile<BK, MASK>(s, m0, m1, l0, l1, 0, sk, rl, t,
                           MASK ? scale : sc2,
                           (causal && BK - 1 > rwl) || BK > sk, causal, sB);
    if (MASK) mbar_arrive(k_empty);
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
      if (!MASK) mbar_arrive(k_empty + st);
      const float2 a = softmax_tile<BK, MASK>(
          s, m0, m1, l0, l1, k0, sk, rl, t, MASK ? scale : sc2,
          (causal && k0 + BK - 1 > rwl) || k0 + BK > sk, causal,
          sB + st * BK);
      if (MASK) mbar_arrive(k_empty + st);
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
    const long long qstr = static_cast<long long>(h) * d;
    store_rows<T, D>(o, out + (static_cast<long long>(b) * sq * h + hq) * d,
                     qstr, r0, sq, t, d);
    const long long srow = (static_cast<long long>(b) * h + hq) * sq;
    if (t == 0 && r0 < sq) save_stats<MASK>(lse, srow + r0, m0, l0);
    if (t == 0 && r0 + 8 < sq) save_stats<MASK>(lse, srow + r0 + 8, m1, l1);
  }
}

template <int D, bool MASK>
struct DqCfg {
  // one stage at 256: Q and dO (64 KB each) and a K and V stage fill it;
  // MASK bodies stage each key tile's bias beside its K and V
  static constexpr int BQ = 128, BK = 64, NS = D > 192 ? 1 : 2;
  static constexpr int kQ = BQ * D * 2, kKV = BK * D * 2;
  static constexpr int kB = MASK ? BK * 4 : 0;
  static constexpr int kBars = 2 * kQ + 2 * NS * kKV + NS * kB;
  static constexpr size_t kSmem = kBars + 8 * (1 + 2 * NS) + 1024;
};

template <typename T, int D, bool MASK, bool FIT>
__global__ void __launch_bounds__(kThreads, 1) flash_dq_wgmma(
    const __grid_constant__ CUtensorMap mq,
    const __grid_constant__ CUtensorMap mdo,
    const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv, const T* __restrict__ out,
    const T* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, T* __restrict__ dq,
    const float* __restrict__ bias, int bstride, int sq, int sk, int h,
    int hk, int d_arg, float scale, int causal) {
  using C = DqCfg<D, MASK>;
  constexpr int BQ = C::BQ, BK = C::BK, NS = C::NS;
  extern __shared__ __align__(1024) uint8_t fa_tiles[];
  uint8_t* const sQ = align1024(fa_tiles);
  uint8_t* const sO = sQ + C::kQ;           // dO
  uint8_t* const sK = sO + C::kQ;           // NS stages of K, then of V
  uint8_t* const sV = sK + NS * C::kKV;
  float* const sB = reinterpret_cast<float*>(sV + NS * C::kKV);  // bias
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(sQ + C::kBars);
  uint64_t* const full = q_full + 1;
  uint64_t* const empty = full + NS;
  const int hq = blockIdx.x, b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * BQ;
  const int kvh = hq / (h / hk);
  // FIT: d the body's width, causal with sq == sk (the 64 / 128 bodies
  // as they were)
  const int off = FIT ? 0 : sk - sq;
  const int d = FIT ? D : d_arg;
  // a row with no live key gets dq = 0: no tile beyond the frontier
  const int n_kt = live_key_tiles(q0, BQ, sq, sk, BK, causal, off, false);
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
      const float* brow = bias + static_cast<long long>(b) * bstride;
      mbar_expect_tx(q_full, 2 * C::kQ);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(sQ + c * BQ * 128, &mq, q_full, c * 64, hq, q0, b);
        tma_load_4d(sO + c * BQ * 128, &mdo, q_full, c * 64, hq, q0, b);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % NS;
        mbar_wait(empty + st, ((kt / NS) & 1) ^ 1);
        mbar_expect_tx(full + st, 2 * C::kKV + C::kB);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(sK + st * C::kKV + c * BK * 128, &mk, full + st, c * 64,
                      kvh, kt * BK, b);
          tma_load_4d(sV + st * C::kKV + c * BK * 128, &mv, full + st, c * 64,
                      kvh, kt * BK, b);
        }
        if constexpr (MASK)
          bulk_load(sB + st * BK, brow + kt * BK, C::kB, full + st);
      }
    }
  } else {
    reg_alloc<240>();
    const int cw = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const int rw = q0 + cw * 64;
    const int r0 = rw + warp * 16 + g;
    const int rl = r0 + off, rwl = rw + off;    // their last live keys
    const float sc2 = scale * kLog2e;
    const long long qstr = static_cast<long long>(h) * d;
    const long long qoff = (static_cast<long long>(b) * sq * h + hq) * d;
    const long long soff = (static_cast<long long>(b) * h + hq) * sq;
    // delta = rowsum(dO . O) in fp32: the four threads of a quad split
    // the row; lse in base-2 units (MASK: the row max mx, whose +inf
    // marks a row with no live key: its p, and so its ds, are 0, and the
    // log sum in base-2 units)
    float dl[2], l2[2], mx[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      float acc = 0.f;
      if (r < sq) {
        const long long at = qoff + r * qstr + t * (D / 4);
#pragma unroll
        for (int u = 0; u < D / 4; u += ptt::Vec<T>::N) {
          if (t * (D / 4) + u >= d) continue;
          float x[ptt::Vec<T>::N], y[ptt::Vec<T>::N];
          ptt::load_vec<T>(dout + at + u, x);
          ptt::load_vec<T>(out + at + u, y);
#pragma unroll
          for (int i = 0; i < ptt::Vec<T>::N; ++i) acc = fmaf(x[i], y[i], acc);
        }
      }
      dl[half] = quad_sum(acc);
      if (t == 0 && r < sq) delta[soff + r] = dl[half];
      if constexpr (MASK) {
        const float2 st =
            r < sq ? reinterpret_cast<const float2*>(lse)[soff + r]
                   : make_float2(0.f, 0.f);
        mx[half] = st.x;
        l2[half] = st.y * kLog2e;
      } else {
        l2[half] = r < sq ? lse[soff + r] * kLog2e : 0.f;
      }
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
      const bool edge = (causal && k0 + BK - 1 > rwl) || k0 + BK > sk;
      const float* sb = sB + st * BK;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int half = e >> 1;
          float p;
          if constexpr (MASK)
            p = exp2_ftz(fmaf(fmaf(s[4 * j + e], scale,
                                   sb[8 * j + 2 * t + (e & 1)]) - mx[half],
                              kLog2e, -l2[half]));
          else
            p = exp2_ftz(s[4 * j + e] * sc2 - l2[half]);
          if (edge) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            if (key >= sk || (causal && key > rl + 8 * half)) p = 0.f;
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
    store_rows<T, D>(acc, dq + qoff, qstr, r0, sq, t, d);
  }
}

template <int D, bool MASK>
struct DkvCfg {
  // dK and dV columns a block: all of them up to 128; above, chunks of
  // 64 (192) or 128 (256) columns, each a block of its own
  static constexpr int DC = D <= 128 ? D : (D % 128 == 0 ? 128 : 64);
  static constexpr int NCH = D / DC;
  static constexpr int BKV = 128, BQ = 64;
  static constexpr int NS = D <= 128 ? 3 : (D > 192 ? 1 : 2);
  // lse and delta boxes: a TMA box starts 16-byte aligned, so a row's
  // 64 values are read from the multiple of 4 at or below their start,
  // 4 more (MASK: 64 pairs of statistics, 128 values and 4 more); each
  // stage's slot is 128-byte aligned
  static constexpr int kVecBox = BQ + 4;
  static constexpr int kStatBox = MASK ? 2 * BQ + 4 : kVecBox;
  static constexpr int kKV = BKV * D * 2, kQ = BQ * D * 2, kVec = 384;
  static constexpr int kStat = MASK ? 640 : kVec;
  static constexpr int kBars = 2 * kKV + 2 * NS * kQ + NS * (kStat + kVec);
  static constexpr size_t kSmem = kBars + 8 * (1 + 2 * NS) + 1024;
};

template <typename T, int D, bool MASK, bool FIT>
__global__ void __launch_bounds__(kThreads, 1) flash_dkv_wgmma(
    const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv,
    const __grid_constant__ CUtensorMap mq,
    const __grid_constant__ CUtensorMap mdo,
    const __grid_constant__ CUtensorMap ml,
    const __grid_constant__ CUtensorMap md, T* __restrict__ dk,
    T* __restrict__ dv, const float* __restrict__ bias, int bstride, int sq,
    int sk, int h, int hk, int d_arg, float scale, int causal) {
  using C = DkvCfg<D, MASK>;
  constexpr int BKV = C::BKV, BQ = C::BQ, NS = C::NS, DC = C::DC;
  extern __shared__ __align__(1024) uint8_t fa_tiles[];
  uint8_t* const sK = align1024(fa_tiles);
  uint8_t* const sV = sK + C::kKV;
  uint8_t* const sQ = sV + C::kKV;          // NS stages of Q, then of dO
  uint8_t* const sO = sQ + NS * C::kQ;
  float* const sL = reinterpret_cast<float*>(sO + NS * C::kQ);   // lse
  float* const sD = sL + NS * C::kStat / 4;                      // delta
  uint64_t* const kv_full = reinterpret_cast<uint64_t*>(sK + C::kBars);
  uint64_t* const full = kv_full + 1;
  uint64_t* const empty = full + NS;
  const int kvh = blockIdx.x, b = blockIdx.y;
  // causal: the heaviest key tile first; then the column chunk
  const int ch = blockIdx.z % C::NCH;
  const int k0 = blockIdx.z / C::NCH * BKV;
  const int group = h / hk;
  // FIT: d the body's width, causal with sq == sk (the 64 / 128 bodies
  // as they were)
  const int off = FIT ? 0 : sk - sq;
  const int d = FIT ? D : d_arg;
  // MASK: a row with no live key still adds 1/sk of its dO to every dv,
  // so every query tile is walked
  const int qt0 = causal && !MASK ? max(k0 - off, 0) / BQ : 0;
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
          mbar_expect_tx(full + st,
                         2 * C::kQ + (C::kStatBox + C::kVecBox) * 4);
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(sQ + st * C::kQ + c * BQ * 128, &mq, full + st,
                        c * 64, hq, qt * BQ, b);
            tma_load_4d(sO + st * C::kQ + c * BQ * 128, &mdo, full + st,
                        c * 64, hq, qt * BQ, b);
          }
          const int at = (lrow + qt * BQ) & ~3;
          tma_load_1d(sL + st * C::kStat / 4, &ml, full + st,
                      MASK ? (2 * (lrow + qt * BQ)) & ~3 : at);
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
    // the first row that sees key kr0 under causal (kr0 + 8: 8 more)
    const int kf0 = kr0 - off, kwf = kw - off;
    const float sc2 = scale * kLog2e;
    // MASK: the bias of the thread's two keys
    float kb[2] = {0.f, 0.f};
    if constexpr (MASK) {
      const float* brow = bias + static_cast<long long>(b) * bstride;
      kb[0] = __ldg(brow + kr0);
      kb[1] = __ldg(brow + kr0 + 8);
    }
    const uint32_t ak = smem_u32(sK) + cw * 64 * 128;
    const uint32_t av = smem_u32(sV) + cw * 64 * 128;
    // the chunk's first column block of the Q and dO stages
    const uint32_t cq = ch * (DC / 64) * BQ * 128;
    const uint32_t aq = smem_u32(sQ), ao = smem_u32(sO);
    float dka[DC / 2], dva[DC / 2];
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) dka[i] = dva[i] = 0.f;
    mbar_wait(kv_full, 0);
    int it = 0;
    for (int gi = 0; gi < group; ++gi) {
      const int lrow = (b * h + kvh * group + gi) * sq;
      for (int qt = qt0; qt < n_qt; ++qt, ++it) {
        const int st = it % NS;
        const int q0 = qt * BQ;
        mbar_wait(full + st, (it / NS) & 1);
        // some row sees some key (MASK: a row may see none)
        if (!causal || MASK || q0 + BQ - 1 >= kwf) {
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
          // s becomes p (MASK: 1/sk across a row with no live key), dp
          // becomes ds
          const bool edge = (causal && q0 < kwf + 63) || q0 + BQ > sq;
          const int vo = (lrow + q0) & 3;      // the box's aligned start
          // MASK: the pair (max, log sum) of row q0 + i at 2 i
          const float* L =
              sL + st * C::kStat / 4 +
              (MASK ? ((2 * (lrow + q0)) & 3) + 4 * t : vo + 2 * t);
          const float* Dl = sD + st * C::kVec / 4 + vo + 2 * t;
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float lc =
                  MASK ? L[16 * j + 2 * (e & 1)] : L[8 * j + (e & 1)];
              const float dc = Dl[8 * j + (e & 1)];
              float p;
              if constexpr (MASK)
                p = exp2_ftz(fmaf(fmaf(s[4 * j + e], scale, kb[e >> 1]) - lc,
                                  kLog2e,
                                  -L[16 * j + 2 * (e & 1) + 1] * kLog2e));
              else
                p = exp2_ftz(s[4 * j + e] * sc2 - lc * kLog2e);
              if (edge) {
                const int row = q0 + 8 * j + 2 * t + (e & 1);
                const int first = kf0 + 8 * (e >> 1);
                if (row >= sq || (causal && row < first)) p = 0.f;
              }
              float pv = p;
              if constexpr (MASK) {
                const int row = q0 + 8 * j + 2 * t + (e & 1);
                if (lc == INFINITY && row < sq) pv = 1.f / sk;
              }
              s[4 * j + e] = pv;
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
            Wgmma<T, DC>::rs(dva, pf[kk],
                             mdesc(ao + st * C::kQ + cq, BQ, kk), 1);
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
            Wgmma<T, DC>::rs(dka, df[kk],
                             mdesc(aq + st * C::kQ + cq, BQ, kk), 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<DC / 2>(dka);
          fence_regs<DC / 2>(dva);
        }
        mbar_arrive(empty + st);
      }
    }
    const long long kstr = static_cast<long long>(hk) * d;
    const long long koff =
        (static_cast<long long>(b) * sk * hk + kvh) * d + ch * DC;
    store_rows<T, DC>(dka, dk + koff, kstr, kr0, sk, t, d - ch * DC);
    store_rows<T, DC>(dva, dv + koff, kstr, kr0, sk, t, d - ch * DC);
  }
}

// ---------------------------------------------------------------------------
// launchers (Shape, blocks and opt_in in flash_attention.cuh)
// ---------------------------------------------------------------------------
template <typename T, int D, bool M, bool F>
int fwd(const Shape& s, const void* q, const void* k, const void* v,
        void* out, void* lse, cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value) {
    return fwd_f32(s, D, M, static_cast<const float*>(q),
                   static_cast<const float*>(k), static_cast<const float*>(v),
                   static_cast<float*>(out), static_cast<float*>(lse), st);
  } else {
    using C = FwdCfg<D, M>;
    static int rc_opt = opt_in(flash_fwd_wgmma<T, D, M, F>, C::kSmem);
    if (rc_opt) return rc_opt;
    CUtensorMap mq, mk, mv;
    if (!map_rows16(&mq, q, s.B, s.sq, s.h, s.d, C::BQ) ||
        !map_rows16(&mk, k, s.B, s.sk, s.hk, s.d, C::BK) ||
        !map_rows16(&mv, v, s.B, s.sk, s.hk, s.d, C::BK))
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(s.h, s.B, blocks(s.sq, C::BQ));
    flash_fwd_wgmma<T, D, M, F><<<grid, kThreads, C::kSmem, st>>>(
        mq, mk, mv, static_cast<T*>(out), static_cast<float*>(lse), s.bias,
        s.bstride, s.sq, s.sk, s.h, s.hk, s.d, s.scale, s.causal);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool M, bool F>
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
    return bwd_f32(s, D, M, q_, k_, v_, o_, g_, l_, d_, static_cast<T*>(dq),
                   static_cast<T*>(dk), static_cast<T*>(dv), st);
  } else {
    using Q = DqCfg<D, M>;
    using KV = DkvCfg<D, M>;
    static int rc_q = opt_in(flash_dq_wgmma<T, D, M, F>, Q::kSmem);
    static int rc_kv = opt_in(flash_dkv_wgmma<T, D, M, F>, KV::kSmem);
    if (rc_q) return rc_q;
    if (rc_kv) return rc_kv;
    const long long n = static_cast<long long>(s.B) * s.h * s.sq;
    CUtensorMap mq, mdo, mk, mv, mk2, mv2, mq2, mdo2, ml, md;
    if (!map_rows16(&mq, q, s.B, s.sq, s.h, s.d, Q::BQ) ||
        !map_rows16(&mdo, dout, s.B, s.sq, s.h, s.d, Q::BQ) ||
        !map_rows16(&mk, k, s.B, s.sk, s.hk, s.d, Q::BK) ||
        !map_rows16(&mv, v, s.B, s.sk, s.hk, s.d, Q::BK) ||
        !map_rows16(&mk2, k, s.B, s.sk, s.hk, s.d, KV::BKV) ||
        !map_rows16(&mv2, v, s.B, s.sk, s.hk, s.d, KV::BKV) ||
        !map_rows16(&mq2, q, s.B, s.sq, s.h, s.d, KV::BQ) ||
        !map_rows16(&mdo2, dout, s.B, s.sq, s.h, s.d, KV::BQ) ||
        !map_vec32(&ml, lse, M ? 2 * n : n, KV::kStatBox) ||
        !map_vec32(&md, delta, n, KV::kVecBox))
      return static_cast<int>(cudaErrorInvalidValue);
    flash_dq_wgmma<T, D, M, F><<<dim3(s.h, s.B, blocks(s.sq, Q::BQ)), kThreads,
                              Q::kSmem, st>>>(
        mq, mdo, mk, mv, o_, g_, l_, d_, static_cast<T*>(dq), s.bias,
        s.bstride, s.sq, s.sk, s.h, s.hk, s.d, s.scale, s.causal);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc) return rc;
    flash_dkv_wgmma<T, D, M, F><<<dim3(s.hk, s.B,
                                    blocks(s.sk, KV::BKV) * KV::NCH),
                               kThreads, KV::kSmem, st>>>(
        mk2, mv2, mq2, mdo2, ml, md, static_cast<T*>(dk), static_cast<T*>(dv),
        s.bias, s.bstride, s.sq, s.sk, s.h, s.hk, s.d, s.scale, s.causal);
  }
  return static_cast<int>(cudaGetLastError());
}

// The body of head dim d (its width): with the key bias (MASK), or
// without it; the widths 64 and 128 also FIT when d is the width and
// causal has sq == sk.
#define PTT_FLASH_BODY(s, CALL)                                          \
  switch (body_width((s).d)) {                                           \
    case 64:                                                             \
      return (s).bias ? CALL(64, true, false)                            \
             : fits(s) ? CALL(64, false, true) : CALL(64, false, false); \
    case 128:                                                            \
      return (s).bias ? CALL(128, true, false)                           \
             : fits(s) ? CALL(128, false, true)                          \
                       : CALL(128, false, false);                        \
    case 192:                                                            \
      return (s).bias ? CALL(192, true, false) : CALL(192, false, false); \
    case 256:                                                            \
      return (s).bias ? CALL(256, true, false) : CALL(256, false, false); \
  }

bool fits(const Shape& s) {
  return s.d == body_width(s.d) && !(s.causal && s.sq != s.sk);
}

// the grids' y and z dimensions and the 32-bit offsets of the lse and
// delta tensor maps bound the sizes (the bias bodies' lse holds pairs);
// causal with sq > sk leaves rows with no live key, which only the bias
// bodies handle (a zero bias without a mask)
bool bad_shape(int B, int sq, int sk, int h, int hk, int d, int bstride,
               const void* bias, int causal) {
  return B <= 0 || B > 65535 || sq <= 0 || sk <= 0 || h <= 0 || h > 65535 ||
         hk <= 0 || h % hk || d < 8 || d > 256 || d % 8 ||
         static_cast<long long>(B) * h * sq >= (bias ? 1ll << 30 : 1ll << 31) ||
         sq > 65535 * 128 || sk > 65535 * 32 || bstride < 0 ||
         (causal && sq > sk && bias == nullptr);
}

}  // namespace

// q [B, sq, h, d], k/v [B, sk, hk, d], out like q, lse [B, h, sq] fp32
// ([B, h, sq, 2] with a bias: each row's max and log sum);
// all contiguous and 16-byte aligned, one dtype; d a multiple of 8 from 8
// to 256.  bias: nullptr, or the fp32 key bias, row b at bias + b *
// bstride (bstride 0: one row for every batch; a multiple of 128),
// 16-byte aligned and readable up to sk rounded up to 128; causal with
// sq > sk needs one.
extern "C" int ptt_flash_fwd(int device, int dtype, const void* q,
                             const void* k, const void* v, const void* bias,
                             void* out, void* lse, int B, int sq, int sk,
                             int h, int hk, int d, int bstride, float scale,
                             int causal, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bad_shape(B, sq, sk, h, hk, d, bstride, bias, causal) || !ptt::aligned16(q) ||
      !ptt::aligned16(k) || !ptt::aligned16(v) || !ptt::aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{B,     sq,     sk,
                h,     hk,     d,
                scale, causal, static_cast<const float*>(bias),
                bstride};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PTT_FWD(W, M, F) fwd<T, W, M, F>(s, q, k, v, out, lse, st)
  PTT_DISPATCH(dtype, T, { PTT_FLASH_BODY(s, PTT_FWD) });
#undef PTT_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// out and dout like q; lse the forward's statistics; delta
// [B, h, sq] fp32 is scratch the first launch fills with rowsum(dout *
// out); dq like q, dk/dv like k; bias as the forward's.  Two launches,
// dq (with delta), then dk/dv (fp32: in clusters of `dkv_splits`).
extern "C" int ptt_flash_bwd(int device, int dtype, const void* q,
                             const void* k, const void* v, const void* bias,
                             const void* out, const void* dout,
                             const void* lse, void* delta, void* dq,
                             void* dk, void* dv, int B, int sq, int sk, int h,
                             int hk, int d, int bstride, float scale,
                             int causal, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bad_shape(B, sq, sk, h, hk, d, bstride, bias, causal) || !ptt::aligned16(q) ||
      !ptt::aligned16(k) || !ptt::aligned16(v) || !ptt::aligned16(out) ||
      !ptt::aligned16(dout) || !ptt::aligned16(lse) ||
      !ptt::aligned16(delta) || !ptt::aligned16(dq) || !ptt::aligned16(dk) ||
      !ptt::aligned16(dv))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{B,     sq,     sk,
                h,     hk,     d,
                scale, causal, static_cast<const float*>(bias),
                bstride};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PTT_BWD(W, M, F) \
  bwd<T, W, M, F>(s, q, k, v, out, dout, lse, delta, dq, dk, dv, st)
  PTT_DISPATCH(dtype, T, { PTT_FLASH_BODY(s, PTT_BWD) });
#undef PTT_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
