// The bf16 / fp16 flash bodies of flash_attention.cu, as templates that
// two translation units instantiate: flash_attention.cu the bodies of
// width 64, 128, 192 and 256, flash_attention_narrow.cu those of width
// 16, 48, 80 and 160 (so that the two compile in parallel).  A body
// takes two widths:
//   D  the width of its shared-memory tiles, a multiple of 64: D / 64
//      column blocks of 64 elements with 128-byte swizzle, loaded by TMA
//      (columns past d zero-filled);
//   W  the width its products run over, d rounded up to 16 (W <= D):
//      the products that reduce over the head dim (QK^T, dO.V^T, K.Q^T,
//      V.dO^T) take W / 16 k-steps, those whose output is the head dim
//      (P.V, dS.K, P^T.dO, dS^T.Q) N = W columns (a B operand read
//      MN-major across D / 64 blocks, the last one in part), and the
//      accumulators hold W columns.
// W == D for the widths 64-256.  Every body but FIT branches once a tile
// on whether a mask or the ragged edge cuts it (softmax_cut, dq_ds,
// dkv_p_ds); FIT tests it once a score inside the unrolled loop, as it
// did.  The widths 64-256 outside FIT (kWideWalk: the MASK bodies, and
// those without a bias at d below the width, under bottom-right causal or
// at 192 / 256) also walk only the key tiles that hold a live key (the
// key bias's live range, key_range), without causal launch the query
// tiles (dk/dv: the key tiles) of one (batch, head) next to each other, so
// that the head's K and V (Q and dO) stay in L2 between them; the MASK
// bodies of width 64 and 128 launch their forward persistent where a call
// has enough work tiles (flash_fwd_wgmma's PERSIST).  The header of
// flash_attention.cu describes the walks.
#pragma once

#include "flash_attention.cuh"

namespace {

using namespace ptt::sm90;
using namespace ptt::flash;

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

// softmax_tile with the test of a cut tile (`edge`) taken out of the
// element loop where HOIST: every body but FIT branches once a tile
// between two copies of the loop (a test in the unrolled loop costs a
// branch and a convergence barrier a score: tools/flash_sass.py); FIT
// keeps the test inside.
template <int BK, bool MASK, bool HOIST>
__device__ __forceinline__ float2 softmax_cut(float* s, float& m0, float& m1,
                                              float& l0, float& l1, int k0,
                                              int sk, int rl, int t, float sc,
                                              bool edge, int causal,
                                              const float* sb) {
  if constexpr (!HOIST)
    return softmax_tile<BK, MASK>(s, m0, m1, l0, l1, k0, sk, rl, t, sc, edge,
                                  causal, sb);
  else if (edge)
    return softmax_tile<BK, MASK, 1>(s, m0, m1, l0, l1, k0, sk, rl, t, sc,
                                     true, causal, sb);
  else
    return softmax_tile<BK, MASK, 0>(s, m0, m1, l0, l1, k0, sk, rl, t, sc,
                                     false, causal, sb);
}

// Store rows r0 and r0 + 8 of a warpgroup's [64, D] accumulators to a
// [*, stride] matrix (rows at or past `limit` skipped, columns at or past
// `cols` and before `first` too; both multiples of 8).
template <typename T, int D>
__device__ __forceinline__ void store_rows(const float* acc, T* base,
                                           long long stride, int r0,
                                           int limit, int t, int cols,
                                           int first = 0) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= limit) continue;
    T* row = base + r * stride + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j < cols && 8 * j >= first)
        *reinterpret_cast<uint32_t*>(row + 8 * j) =
            ptt::pack2<T>(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
  }
}

// The bodies of width 64-256 outside FIT (W == D): they walk only the key
// tiles that hold a live key and order their grids by (batch, head)
template <int D, int W, bool FIT>
constexpr bool kWideWalk = W == D && !FIT;

template <int D, bool MASK, int BKS = 0, bool PERSIST = false>
struct FwdCfg {
  // 128-key tiles up to d 128; 64 above, so that two K and V stages and
  // the 128-row Q tile fit in shared memory; MASK bodies stage each key
  // tile's bias beside its K.  BKS > 0: one tile of BKS keys (a multiple
  // of 16) that holds every key (a short key walk: kShortKeys).
  // PERSIST: two Q buffers (flash_fwd_wgmma's persistent launch).
  static constexpr int BQ = 128, BK = BKS ? BKS : D > 128 ? 64 : 128;
  static constexpr int NS = 2, kQB = PERSIST ? 2 : 1;
  static constexpr int kQ = BQ * D * 2, kKV = BK * D * 2;
  static constexpr int kB = MASK ? BK * 4 : 0;
  static constexpr int kBars = kQB * kQ + 2 * NS * kKV + NS * kB;
  static constexpr size_t kSmem =
      kBars + 8 * (kQB + (PERSIST ? 2 : 0) + 4 * NS) + 1024;
};

// The persistent forward (PERSIST) of the key-bias (MASK) bodies of width
// 64 and 128, where a call has at least kPersistTurns work tiles an SM:
// one block an SM takes the work tiles in the grid's order, its turns
// back and forth (persist_work).  The K / V ring runs on across tiles and
// Q has two buffers, so the producer loads the next tile's Q and first
// K / V stage while the consumers finish the current tile's last P.V and
// its epilogue.  The grid runs elsewhere (tools/flash_parent_ab.py,
// PERF.md): static turns take uneven tiles (a padded batch's) unevenly
// where an SM has few, which the grid's blocks, handed out as SMs free
// up, do not; and the persistent loop ran slower than the grid at width
// 192 and in the bodies without a key bias.
constexpr int kPersistTurns = 6;

// The work tile of a block's it-th turn among G blocks: the turns run back
// and forth (block i takes tiles i, 2 G - 1 - i, 2 G + i, ...), so that
// under causal, whose tiles run heaviest first, a block's turns add up to
// about the same work as another's
__device__ __forceinline__ int persist_work(int it) {
  const int G = gridDim.x, i = blockIdx.x;
  return it * G + ((it & 1) ? G - 1 - i : i);
}

// Whether a block's turn `it` has a work tile (w): the grid's block one
template <bool PERSIST>
__device__ __forceinline__ bool fwd_turn(int it, int w, int n_work) {
  return PERSIST ? w < n_work : it == 0;
}

// A forward work tile: its batch, head, first query row and the key
// tiles [kt0, n_kt) it walks
struct FwdTile {
  int b, hq, q0, kt0, n_kt;
};

// The bodies: MASK false takes no key bias and no row without a live
// key (causal needs sq <= sk); MASK true reads the key bias (never null)
// and handles such rows.  FIT (MASK false, d the body's width, causal
// only with sq == sk) compiles the d and offset arithmetic away: the
// widths 64 and 128 keep their earlier code, bits and times.  BKS: the
// key tile of a short walk (FwdCfg), 0 for the width's own.  `range`:
// the key bias's live keys (key_range), read by kWideWalk MASK bodies.
// A block walks one work tile (query tile, head, batch) of the grid, or
// where PERSIST the n_work tiles of its turns (kPersistTurns).
template <typename T, int D, int W, bool MASK, bool FIT, int BKS = 0,
          bool PERSIST = false>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_wgmma(
    const __grid_constant__ CUtensorMap mq,
    const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv, T* __restrict__ out,
    float* __restrict__ lse, const float* __restrict__ bias,
    const int* __restrict__ range, int bstride, int sq, int sk, int h,
    int hk, int d_arg, float scale, int causal, int n_work) {
  using C = FwdCfg<D, MASK, BKS, PERSIST>;
  constexpr int BQ = C::BQ, BK = C::BK, NS = C::NS;
  constexpr bool WALK = kWideWalk<D, W, FIT>;
  static_assert(!PERSIST || (WALK && MASK && !BKS), "persistent: MASK");
  extern __shared__ __align__(1024) uint8_t fa_tiles[];
  uint8_t* const sQ = align1024(fa_tiles);  // kQB buffers
  uint8_t* const sK = sQ + C::kQB * C::kQ;  // NS stages
  uint8_t* const sV = sK + NS * C::kKV;     // NS stages
  float* const sB = reinterpret_cast<float*>(sV + NS * C::kKV);  // bias
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(sQ + C::kBars);
  uint64_t* const q_empty = q_full + C::kQB;          // PERSIST's two
  uint64_t* const k_full = q_empty + (PERSIST ? 2 : 0);
  uint64_t* const v_full = k_full + NS;
  uint64_t* const k_empty = v_full + NS;
  uint64_t* const v_empty = k_empty + NS;
  // FIT: d the body's width, causal with sq == sk (the 64 / 128 bodies
  // as they were)
  const int off = FIT ? 0 : sk - sq;
  const int d = FIT ? D : d_arg;
  // WALK without causal: the work tiles in (query tile, head, batch)
  // order, else (head, batch, query tile), causal taking the heaviest
  // query tile first
  const bool hm = WALK && !causal;
  auto tile = [&](int w) {
    FwdTile u;
    int nqt, bq;
    if constexpr (PERSIST) {
      nqt = (sq + BQ - 1) / BQ;
      const int B = n_work / (nqt * h);
      bq = hm ? w % nqt : w / (h * B);
      u.hq = hm ? (w / nqt) % h : w % h;
      u.b = hm ? w / (nqt * h) : (w / h) % B;
    } else {
      u.hq = hm ? blockIdx.y : blockIdx.x;
      u.b = hm ? blockIdx.z : blockIdx.y;
      nqt = hm ? gridDim.x : gridDim.z;
      bq = hm ? blockIdx.x : blockIdx.z;
    }
    u.q0 = (causal ? nqt - 1 - bq : bq) * BQ;
    // MASK: any row may have no live key, and then needs every tile;
    // WALK takes the tiles of the live keys alone when every row of the
    // block has one (the first row's causal frontier reaches the first
    // live key): a tile with none adds p = 0 and rescales by 1, so the
    // bits are those of the whole walk
    u.kt0 = 0;
    u.n_kt = live_key_tiles(u.q0, BQ, sq, sk, BK, causal, off, MASK);
    if constexpr (WALK && MASK) {
      const KeyRange r = key_range(range, u.b, bstride, sk);
      if (r.all_live(causal, u.q0 + off)) {
        u.kt0 = r.tile0(BK);
        u.n_kt = min(r.tile_end(BK), live_key_tiles(u.q0, BQ, sq, sk, BK,
                                                    causal, off, false));
      }
    }
    return u;
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < C::kQB; ++i) {
      mbar_init(q_full + i, 1);
      if (PERSIST) mbar_init(q_empty + i, kConsumers);
    }
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
    // -- producer: Q into its buffer, then K and V stages freed on their
    // own barriers; the ring's count runs on across tiles ----------------
    reg_dealloc<24>();
    if (threadIdx.x == 0) {
      int ring = 0;
      for (int it = 0, w = blockIdx.x; fwd_turn<PERSIST>(it, w, n_work);
           w = persist_work(++it)) {
        const FwdTile u = tile(w);
        const int kvh = u.hq / (h / hk);
        const float* brow = bias + static_cast<long long>(u.b) * bstride;
        const int qb = PERSIST ? it & 1 : 0;
        if (PERSIST) mbar_wait(q_empty + qb, ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(q_full + qb, C::kQ);
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(sQ + qb * C::kQ + c * BQ * 128, &mq, q_full + qb,
                      c * 64, u.hq, u.q0, u.b);
        for (int kt = u.kt0; kt < u.n_kt; ++kt, ++ring) {
          const int st = ring % NS;
          const uint32_t free = ((ring / NS) & 1) ^ 1;
          mbar_wait(k_empty + st, free);
          mbar_expect_tx(k_full + st, C::kKV + C::kB);
          for (int c = 0; c < D / 64; ++c)
            tma_load_4d(sK + st * C::kKV + c * BK * 128, &mk, k_full + st,
                        c * 64, kvh, kt * BK, u.b);
          if constexpr (MASK)
            bulk_load(sB + st * BK, brow + kt * BK, C::kB, k_full + st);
          mbar_wait(v_empty + st, free);
          mbar_expect_tx(v_full + st, C::kKV);
          for (int c = 0; c < D / 64; ++c)
            tma_load_4d(sV + st * C::kKV + c * BK * 128, &mv, v_full + st,
                        c * 64, kvh, kt * BK, u.b);
        }
      }
    }
  } else {
    // -- consumers: 64 query rows each.  Tile kt's QK^T and tile kt-1's PV
    // are in flight together; the softmax of tile kt runs under the PV.
    reg_alloc<240>();
    const int cw = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const float sc2 = scale * kLog2e;
    const uint32_t ak = smem_u32(sK), av = smem_u32(sV);
    // the two warpgroups take turns to issue their products (warpgroup 0
    // first), so one's softmax runs under the other's products
    const int my_turn = 1 + cw, their_turn = 2 - cw;
    int ring = 0;
    for (int it = 0, w = blockIdx.x; fwd_turn<PERSIST>(it, w, n_work);
         w = persist_work(++it)) {
      const FwdTile u = tile(w);
      const int kt0 = u.kt0, n_kt = u.n_kt;
      const int rw = u.q0 + cw * 64;            // this warpgroup's first row
      const int r0 = rw + warp * 16 + g;
      const int rl = r0 + off, rwl = rw + off;  // their last live keys
      const int qb = PERSIST ? it & 1 : 0;
      const uint32_t aq = smem_u32(sQ) + qb * C::kQ + cw * 64 * 128;
      float o[W / 2], s[BK / 2];
      uint32_t pf[BK / 16][4];
#pragma unroll
      for (int i = 0; i < W / 2; ++i) o[i] = 0.f;
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
      if (cw == 1) named_arrive(1);
      mbar_wait(q_full + qb, PERSIST ? (it >> 1) & 1 : 0);
      // the first tile: scores and softmax alone
      const int kf = kt0 * BK, sf = ring % NS;
      mbar_wait(k_full + sf, (ring / NS) & 1);
      named_sync(my_turn);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk)
        Wgmma<T, BK>::ss(s, kdesc(aq, BQ, kk),
                         kdesc(ak + sf * C::kKV, BK, kk), kk);
      wgmma_commit();
      named_arrive(their_turn);
      wgmma_wait<0>();
      fence_regs<BK / 2>(s);
      // a MASK body frees the K stage after its softmax has read the bias
      if (!MASK) mbar_arrive(k_empty + sf);
      softmax_cut<BK, MASK, !FIT>(s, m0, m1, l0, l1, kf, sk, rl, t,
                                  MASK ? scale : sc2,
                                  (causal && kf + BK - 1 > rwl) || kf + BK > sk,
                                  causal, sB + sf * BK);
      if (MASK) mbar_arrive(k_empty + sf);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) to_a<T>(s, kk, pf[kk]);
      // tile kt's scores and tile kt-1's P.V in flight together
      for (int kt = kt0 + 1; kt < n_kt; ++kt) {
        const int i = ring + kt - kt0;          // the ring's count
        const int st = i % NS, sp = (i - 1) % NS;
        const int k0 = kt * BK;
        mbar_wait(k_full + st, (i / NS) & 1);
        mbar_wait(v_full + sp, ((i - 1) / NS) & 1);
        named_sync(my_turn);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < W / 16; ++kk)
          Wgmma<T, BK>::ss(s, kdesc(aq, BQ, kk),
                           kdesc(ak + st * C::kKV, BK, kk), kk);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          Wgmma<T, W>::rs(o, pf[kk], mdesc(av + sp * C::kKV, BK, kk), 1);
        wgmma_commit();
        named_arrive(their_turn);
        wgmma_wait<1>();
        fence_regs<BK / 2>(s);
        if (!MASK) mbar_arrive(k_empty + st);
        const float2 a = softmax_cut<BK, MASK, !FIT>(
            s, m0, m1, l0, l1, k0, sk, rl, t, MASK ? scale : sc2,
            (causal && k0 + BK - 1 > rwl) || k0 + BK > sk, causal,
            sB + st * BK);
        if (MASK) mbar_arrive(k_empty + st);
        wgmma_wait<0>();
        fence_regs<W / 2>(o);
        mbar_arrive(v_empty + sp);
#pragma unroll
        for (int j = 0; j < W / 8; ++j) {
          o[4 * j] *= a.x;
          o[4 * j + 1] *= a.x;
          o[4 * j + 2] *= a.y;
          o[4 * j + 3] *= a.y;
        }
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) to_a<T>(s, kk, pf[kk]);
      }
      // PERSIST: every QK^T of the tile is done, so its Q buffer is free
      // for the tile after next
      if (PERSIST) mbar_arrive(q_empty + qb);
      // the last tile's P.V
      const int last = ring + n_kt - kt0 - 1;
      const int sl = last % NS;
      mbar_wait(v_full + sl, (last / NS) & 1);
      named_sync(my_turn);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<T, W>::rs(o, pf[kk], mdesc(av + sl * C::kKV, BK, kk), 1);
      wgmma_commit();
      if (cw == 0) named_arrive(their_turn);   // warpgroup 1 issues last
      wgmma_wait<0>();
      fence_regs<W / 2>(o);
      mbar_arrive(v_empty + sl);
      ring = last + 1;
      l0 = fmaxf(quad_sum(l0), 1e-30f);
      l1 = fmaxf(quad_sum(l1), 1e-30f);
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        o[4 * j] /= l0;
        o[4 * j + 1] /= l0;
        o[4 * j + 2] /= l1;
        o[4 * j + 3] /= l1;
      }
      const long long qstr = static_cast<long long>(h) * d;
      store_rows<T, W>(
          o, out + (static_cast<long long>(u.b) * sq * h + u.hq) * d, qstr,
          r0, sq, t, d);
      const long long srow = (static_cast<long long>(u.b) * h + u.hq) * sq;
      if (t == 0 && r0 < sq) save_stats<MASK>(lse, srow + r0, m0, l0);
      if (t == 0 && r0 + 8 < sq) save_stats<MASK>(lse, srow + r0 + 8, m1, l1);
    }
  }
}

// dq's tile: the scores s [64, BK] of the thread's rows r0 and r0 + 8
// become ds = p (dp - delta) scale, p from the saved statistics (l2 in
// base-2 units; MASK: the row max mx and the key bias sb); keys past sk
// or past a row's causal frontier (rl, rl + 8) weigh 0 on a cut tile.
// EDGE as softmax_tile's: every body but FIT branches on `edge` once a
// tile
template <int BK, bool MASK, int EDGE>
__device__ __forceinline__ void dq_ds(float* s, const float* dp,
                                      const float* sb, const float* mx,
                                      const float* l2, const float* dl,
                                      int k0, int sk, int rl, int t,
                                      float scale, float sc2, bool edge,
                                      int causal) {
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
      if (EDGE == 1 || (EDGE == 2 && edge)) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        if (key >= sk || (causal && key > rl + 8 * half)) p = 0.f;
      }
      s[4 * j + e] = p * (dp[4 * j + e] - dl[half]) * scale;
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

template <typename T, int D, int W, bool MASK, bool FIT>
__global__ void __launch_bounds__(kThreads, 1) flash_dq_wgmma(
    const __grid_constant__ CUtensorMap mq,
    const __grid_constant__ CUtensorMap mdo,
    const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv, const T* __restrict__ out,
    const T* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, T* __restrict__ dq,
    const float* __restrict__ bias, const int* __restrict__ range,
    int bstride, int sq, int sk, int h, int hk, int d_arg, float scale,
    int causal) {
  using C = DqCfg<D, MASK>;
  constexpr int BQ = C::BQ, BK = C::BK, NS = C::NS;
  constexpr bool WALK = kWideWalk<D, W, FIT>;
  extern __shared__ __align__(1024) uint8_t fa_tiles[];
  uint8_t* const sQ = align1024(fa_tiles);
  uint8_t* const sO = sQ + C::kQ;           // dO
  uint8_t* const sK = sO + C::kQ;           // NS stages of K, then of V
  uint8_t* const sV = sK + NS * C::kKV;
  float* const sB = reinterpret_cast<float*>(sV + NS * C::kKV);  // bias
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(sQ + C::kBars);
  uint64_t* const full = q_full + 1;
  uint64_t* const empty = full + NS;
  // the forward's grid order
  const bool hm = WALK && !causal;
  const int hq = hm ? blockIdx.y : blockIdx.x;
  const int b = hm ? blockIdx.z : blockIdx.y;
  const int nqt = hm ? gridDim.x : gridDim.z;
  const int bq = hm ? blockIdx.x : blockIdx.z;
  const int qt = causal ? nqt - 1 - bq : bq;
  const int q0 = qt * BQ;
  const int kvh = hq / (h / hk);
  // FIT: d the body's width, causal with sq == sk (the 64 / 128 bodies
  // as they were)
  const int off = FIT ? 0 : sk - sq;
  const int d = FIT ? D : d_arg;
  // the key tiles [kt0, n_kt) walked.  A row with no live key gets
  // dq = 0: no tile beyond the frontier.  WALK: nor a tile without a live
  // key, where every row's p is 0 (a row with no live key has p = 0
  // across): none at all for a bias row with no live key
  int kt0 = 0;
  int n_kt = live_key_tiles(q0, BQ, sq, sk, BK, causal, off, false);
  if constexpr (WALK && MASK) {
    const KeyRange r = key_range(range, b, bstride, sk);
    kt0 = r.tile0(BK);
    n_kt = min(n_kt, r.tile_end(BK));
  }
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
      for (int kt = kt0; kt < n_kt; ++kt) {
        const int st = (kt - kt0) % NS;
        mbar_wait(empty + st, (((kt - kt0) / NS) & 1) ^ 1);
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
    float acc[W / 2];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
    mbar_wait(q_full, 0);
    for (int kt = kt0; kt < n_kt; ++kt) {
      const int st = (kt - kt0) % NS;
      const int k0 = kt * BK;
      float s[BK / 2], dp[BK / 2];
      mbar_wait(full + st, ((kt - kt0) / NS) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk)
        Wgmma<T, BK>::ss(s, kdesc(aq, BQ, kk),
                         kdesc(ak + st * C::kKV, BK, kk), kk);
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk)
        Wgmma<T, BK>::ss(dp, kdesc(ao, BQ, kk),
                         kdesc(av + st * C::kKV, BK, kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<BK / 2>(s);
      fence_regs<BK / 2>(dp);
      // s becomes ds = p * (dp - delta) * scale
      const bool edge = (causal && k0 + BK - 1 > rwl) || k0 + BK > sk;
      const float* sb = sB + st * BK;
      if constexpr (FIT)
        dq_ds<BK, MASK, 2>(s, dp, sb, mx, l2, dl, k0, sk, rl, t, scale, sc2,
                           edge, causal);
      else if (edge)
        dq_ds<BK, MASK, 1>(s, dp, sb, mx, l2, dl, k0, sk, rl, t, scale, sc2,
                           true, causal);
      else
        dq_ds<BK, MASK, 0>(s, dp, sb, mx, l2, dl, k0, sk, rl, t, scale, sc2,
                           false, causal);
      uint32_t df[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) to_a<T>(s, kk, df[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<T, W>::rs(acc, df[kk], mdesc(ak + st * C::kKV, BK, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<W / 2>(acc);
      mbar_arrive(empty + st);
    }
    store_rows<T, W>(acc, dq + qoff, qstr, r0, sq, t, d);
  }
}

// dk/dv's tile: S^T [64 keys, BQ rows] of the thread's keys kr0 and
// kr0 + 8 becomes p (MASK: 1/sk across a row with no live key, whose
// saved max is +inf), dP^T becomes ds = p (dp - delta) scale, from the
// stage's statistics L and delta Dl (MASK: L holds (max, log sum) pairs
// and kb the two keys' bias); rows past sq or before a key's causal
// frontier (kf0, kf0 + 8) weigh 0 on a cut tile.  EDGE as softmax_tile's.
template <int BQ, bool MASK, int EDGE>
__device__ __forceinline__ void dkv_p_ds(float* s, float* dp, const float* L,
                                         const float* Dl, const float* kb,
                                         int q0, int sq, int sk, int kf0,
                                         int t, float scale, float sc2,
                                         bool edge, int causal) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lc = MASK ? L[16 * j + 2 * (e & 1)] : L[8 * j + (e & 1)];
      const float dc = Dl[8 * j + (e & 1)];
      float p;
      if constexpr (MASK)
        p = exp2_ftz(fmaf(fmaf(s[4 * j + e], scale, kb[e >> 1]) - lc, kLog2e,
                          -L[16 * j + 2 * (e & 1) + 1] * kLog2e));
      else
        p = exp2_ftz(s[4 * j + e] * sc2 - lc * kLog2e);
      if (EDGE == 1 || (EDGE == 2 && edge)) {
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
}

template <int D, int W, bool MASK>
struct DkvCfg {
  // dK and dV columns a block: all of them up to 128; above, chunks of
  // 64 (192) or 128 (256) columns, each a block of its own.  Width 160:
  // two chunks of 96 (a chunk starts on a column block: columns 0 and
  // 64), the first storing columns 0-79, the second 80-159.  Chunk ch
  // computes the columns from ch * kStep, stores those from ch * kKeep.
  static_assert(W <= 128 || W % 64 == 0 || W == 160, "no dK / dV chunks");
  static constexpr int DC = W <= 128 ? W : W == 160 ? 96
                                               : (W % 128 == 0 ? 128 : 64);
  static constexpr int NCH = W == 160 ? 2 : W / DC;
  static constexpr int kStep = W == 160 ? 64 : DC;
  static constexpr int kKeep = W / NCH;
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

// Store a dk/dv block's accumulators (DC columns of its chunk ch) for the
// thread's keys kr0 and kr0 + 8
template <typename T, typename C>
__device__ __forceinline__ void store_dkv(const float* dka, const float* dva,
                                          T* dk, T* dv, int b, int kvh,
                                          int ch, int kr0, int sk, int hk,
                                          int d, int t) {
  const long long kstr = static_cast<long long>(hk) * d;
  const int c0 = ch * C::kStep;
  const long long koff = (static_cast<long long>(b) * sk * hk + kvh) * d + c0;
  // the chunk's stored columns, from its first column c0
  const int first = ch * C::kKeep - c0;
  const int cols =
      C::kKeep == C::DC ? d - c0 : min(d, (ch + 1) * C::kKeep) - c0;
  store_rows<T, C::DC>(dka, dk + koff, kstr, kr0, sk, t, cols, first);
  store_rows<T, C::DC>(dva, dv + koff, kstr, kr0, sk, t, cols, first);
}

template <typename T, int D, int W, bool MASK, bool FIT>
__global__ void __launch_bounds__(kThreads, 1) flash_dkv_wgmma(
    const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv,
    const __grid_constant__ CUtensorMap mq,
    const __grid_constant__ CUtensorMap mdo,
    const __grid_constant__ CUtensorMap ml,
    const __grid_constant__ CUtensorMap md, T* __restrict__ dk,
    T* __restrict__ dv, const float* __restrict__ bias,
    const int* __restrict__ range, int bstride, int sq, int sk, int h,
    int hk, int d_arg, float scale, int causal) {
  using C = DkvCfg<D, W, MASK>;
  constexpr int BKV = C::BKV, BQ = C::BQ, NS = C::NS, DC = C::DC;
  constexpr bool WALK = kWideWalk<D, W, FIT>;
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
  // WALK without causal: grid (key tiles x chunks, kv heads, batch),
  // else (kv heads, batch, key tiles x chunks), causal taking the
  // heaviest key tile first; then the column chunk
  const bool hm = WALK && !causal;
  const int kvh = hm ? blockIdx.y : blockIdx.x;
  const int b = hm ? blockIdx.z : blockIdx.y;
  const int bk = hm ? blockIdx.x : blockIdx.z;
  const int ch = bk % C::NCH;
  const int k0 = bk / C::NCH * BKV;
  const int group = h / hk;
  // FIT: d the body's width, causal with sq == sk (the 64 / 128 bodies
  // as they were)
  const int off = FIT ? 0 : sk - sq;
  const int d = FIT ? D : d_arg;
  // MASK: a row with no live key still adds 1/sk of its dO to every dv,
  // so every query tile is walked.  WALK: where every row has a live key
  // (the first row's causal frontier reaches the first live key) a dead
  // key's p is 0 in every row, so a block with no live key stores zeros,
  // and under causal the rows before the block's frontier are skipped
  bool live_rows = !MASK;
  if constexpr (WALK && MASK) {
    const KeyRange r = key_range(range, b, bstride, sk);
    live_rows = r.all_live(causal, off);
    const int kt = k0 / BKV;
    if (live_rows && (kt < r.tile0(BKV) || kt >= r.tile_end(BKV))) {
      if (threadIdx.x >= 128) {
        const float zero[DC / 2] = {};
        const int kr0 = k0 + (threadIdx.x / 128 - 1) * 64 +
                        ((threadIdx.x >> 5) & 3) * 16 +
                        ((threadIdx.x & 31) >> 2);
        store_dkv<T, C>(zero, zero, dk, dv, b, kvh, ch, kr0, sk, hk, d,
                        threadIdx.x & 3);
      }
      return;
    }
  }
  const bool skip = causal && live_rows;
  const int qt0 = skip ? max(k0 - off, 0) / BQ : 0;
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
    const uint32_t cq = ch * (C::kStep / 64) * BQ * 128;
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
        if (!skip || q0 + BQ - 1 >= kwf) {
          float s[BQ / 2], dp[BQ / 2];        // S^T and dP^T: keys x rows
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < W / 16; ++kk)
            Wgmma<T, BQ>::ss(s, kdesc(ak, BKV, kk),
                             kdesc(aq + st * C::kQ, BQ, kk), kk);
#pragma unroll
          for (int kk = 0; kk < W / 16; ++kk)
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
          if constexpr (FIT)
            dkv_p_ds<BQ, MASK, 2>(s, dp, L, Dl, kb, q0, sq, sk, kf0, t,
                                  scale, sc2, edge, causal);
          else if (edge)
            dkv_p_ds<BQ, MASK, 1>(s, dp, L, Dl, kb, q0, sq, sk, kf0, t,
                                  scale, sc2, true, causal);
          else
            dkv_p_ds<BQ, MASK, 0>(s, dp, L, Dl, kb, q0, sq, sk, kf0, t,
                                  scale, sc2, false, causal);
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
    store_dkv<T, C>(dka, dva, dk, dv, b, kvh, ch, kr0, sk, hk, d, t);
  }
}

// ---------------------------------------------------------------------------
// launchers of the 16-bit bodies (Shape, blocks and opt_in in
// flash_attention.cuh)
// ---------------------------------------------------------------------------
template <typename T, int D, int W, bool M, bool F, int BKS = 0>
int fwd16(const Shape& s, const void* q, const void* k, const void* v,
          void* out, void* lse, cudaStream_t st) {
  using C = FwdCfg<D, M, BKS>;
  static int rc_opt = opt_in(flash_fwd_wgmma<T, D, W, M, F, BKS>, C::kSmem);
  if (rc_opt) return rc_opt;
  CUtensorMap mq, mk, mv;
  if (!map_rows16(&mq, q, s.B, s.sq, s.h, s.d, C::BQ) ||
      !map_rows16(&mk, k, s.B, s.sk, s.hk, s.d, C::BK) ||
      !map_rows16(&mv, v, s.B, s.sk, s.hk, s.d, C::BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nqt = blocks(s.sq, C::BQ);
  if constexpr (kWideWalk<D, W, F> && M && D <= 128 && !BKS) {
    // persistent where an SM gets kPersistTurns work tiles or more
    int dev = 0;
    const cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int sms = ptt::sm_count(dev);
    if (sms < 0) return -sms;
    const long long n_work = static_cast<long long>(nqt) * s.h * s.B;
    if (n_work >= static_cast<long long>(kPersistTurns) * sms) {
      using P = FwdCfg<D, true, 0, true>;
      static int rc_p =
          opt_in(flash_fwd_wgmma<T, D, W, true, false, 0, true>, P::kSmem);
      if (rc_p) return rc_p;
      if (n_work >= (1ll << 31))
        return static_cast<int>(cudaErrorInvalidValue);
      flash_fwd_wgmma<T, D, W, true, false, 0, true>
          <<<sms, kThreads, P::kSmem, st>>>(
              mq, mk, mv, static_cast<T*>(out), static_cast<float*>(lse),
              s.bias, s.range, s.bstride, s.sq, s.sk, s.h, s.hk, s.d, s.scale,
              s.causal, static_cast<int>(n_work));
      return static_cast<int>(cudaGetLastError());
    }
  }
  const dim3 grid = kWideWalk<D, W, F> && !s.causal ? dim3(nqt, s.h, s.B)
                                                   : dim3(s.h, s.B, nqt);
  flash_fwd_wgmma<T, D, W, M, F, BKS><<<grid, kThreads, C::kSmem, st>>>(
      mq, mk, mv, static_cast<T*>(out), static_cast<float*>(lse), s.bias,
      s.range, s.bstride, s.sq, s.sk, s.h, s.hk, s.d, s.scale, s.causal, 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, int W, bool M, bool F>
int bwd16(const Shape& s, const void* q, const void* k, const void* v,
          const void* out, const void* dout, const void* lse, void* delta,
          void* dq, void* dk, void* dv, cudaStream_t st) {
  const T* o_ = static_cast<const T*>(out);
  const T* g_ = static_cast<const T*>(dout);
  const float* l_ = static_cast<const float*>(lse);
  float* d_ = static_cast<float*>(delta);
  using Q = DqCfg<D, M>;
  using KV = DkvCfg<D, W, M>;
  static int rc_q = opt_in(flash_dq_wgmma<T, D, W, M, F>, Q::kSmem);
  static int rc_kv = opt_in(flash_dkv_wgmma<T, D, W, M, F>, KV::kSmem);
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
  // kWideWalk without causal: the tiles of one (batch, head) next to
  // each other
  const bool hm = kWideWalk<D, W, F> && !s.causal;
  const int nqt = blocks(s.sq, Q::BQ);
  const int nkt = blocks(s.sk, KV::BKV) * KV::NCH;
  flash_dq_wgmma<T, D, W, M, F><<<hm ? dim3(nqt, s.h, s.B)
                                     : dim3(s.h, s.B, nqt),
                                  kThreads, Q::kSmem, st>>>(
      mq, mdo, mk, mv, o_, g_, l_, d_, static_cast<T*>(dq), s.bias, s.range,
      s.bstride, s.sq, s.sk, s.h, s.hk, s.d, s.scale, s.causal);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  flash_dkv_wgmma<T, D, W, M, F><<<hm ? dim3(nkt, s.hk, s.B)
                                      : dim3(s.hk, s.B, nkt),
                                   kThreads, KV::kSmem, st>>>(
      mk2, mv2, mq2, mdo2, ml, md, static_cast<T*>(dk), static_cast<T*>(dv),
      s.bias, s.range, s.bstride, s.sq, s.sk, s.h, s.hk, s.d, s.scale,
      s.causal);
  return static_cast<int>(cudaGetLastError());
}

// What the body of widths (D, W) runs, into p[2..5]: its forward's query
// and key tiles, dk/dv's column chunks and their width (ptt_flash_plan)
template <int D, int W, bool M, int BKS = 0>
void body_plan(int* p) {
  p[2] = FwdCfg<D, M, BKS>::BQ;
  p[3] = FwdCfg<D, M, BKS>::BK;
  p[4] = DkvCfg<D, W, M>::NCH;
  p[5] = DkvCfg<D, W, M>::DC;
}

}  // namespace
