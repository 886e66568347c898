// Flash attention in fp32, forward and backward, for Hopper (sm_90a).
//
// Replaces, at fp32, the TPU kernel paddle_tpu/ops/pallas/
// flash_attention.py::flash_attention (:816), forward _fwd (:540) and
// backward _bwd (:679); the bf16 / fp16 bodies are in
// flash_attention.cu, whose header gives the function, the masks and
// the saved statistics these bodies share (flash_attention.cuh).  They
// compute what ops/flash_attention.py's plain_flash_fwd and
// plain_flash_bwd compute, with no rounding of p or ds (fp32 operands).
//
// The three walks of flash_attention.cu (forward, dq with delta, dk/dv)
// on the tensor cores, as a three-pass TF32 split (mma.sync m16n8k8):
// each operand x = hi + lo, both TF32, and a.b = lo.hi + hi.lo + hi.hi
// accumulated in fp32, ~2^-21 |a||b| a term where one TF32 pass gives
// 2^-11, so the results stay fp32-accurate.  mma.sync and not wgmma: a
// TF32 wgmma takes both operands K-major, so P.V (and dS.K, P^T.dO,
// dS^T.Q) would need V (K, dO, Q) transposed in shared memory, where
// mma.sync reads them in place in a permuted row order (below).
//
// What bounds them on the H100: three TF32 products an fp32 one, so the
// operations at 495 / 3 = 165 TFLOP/s, or the bytes at 3.35 TB/s.  At
// ViT-B/16's [32, 197, 12, 64] the forward takes 0.0232 ms by its bytes
// (0.0231 by its operations), the backward 0.0578 ms by its operations.
//
// Design.  Blocks of 4 warps of 16 rows (dk/dv: keys) on a cp.async ring
// of fp32 tiles of the body width (columns past d zero-filled; rows of
// width + 4 floats, so fragment reads are conflict-free), each product
// branch-free over whole tiles so that the compiler interleaves the
// loads, splits and products; each TF32 rounding of the split is two
// integer instructions (`tf32_rna`), where sm_90 emulates cvt.rna with
// four and a select.
//   fwd: one block per (64 query rows, q head, batch; 128 rows of 8
//        warps at width 192), 32-key tiles in two stages; Q's split
//        fragments in registers at width 64; the online softmax of the
//        16-bit bodies (`softmax_tile`) on the m16n8k8 accumulators,
//        whose layout is the wgmma one a warp.
//   dq:  one block per (64 query rows, q head, batch), Q and dO held,
//        32-key tiles in two stages (one at 256); its prologue computes
//        delta = rowsum(dO.O), a warp a row (coalesced), and writes it
//        for dkv.
//   dkv: one block per 64 keys, kv head, batch and column half (above
//        width 128), 32-row query tiles (16 above width 64), times a
//        cluster of up to 8 blocks that share its walk over (query head,
//        query tile) when the grid would give fewer than two blocks an
//        SM (`dkv_splits`): each leaves its fp32 partial dK and dV in
//        shared memory, and block r sums its share of the rows over the
//        cluster's blocks in rank order through distributed shared
//        memory.  No atomics: the same bits every launch.
// Each k-step's three products go to a fresh accumulator and are added
// to the output's with one rounded FADD (`mma3`): the tensor cores'
// adder truncates, and a chain through one accumulator gathers errors of
// one sign.  What is left between them and the card: the split's
// integer work (every warp splits the B tiles it reads), those four
// FADDs to every three products, the softmax's elementwise work per
// product, and at widths above 128 one block an SM (200 KB of tiles),
// so that latencies go unhidden.

#include "flash_attention.cuh"

namespace ptt {
namespace flash {
namespace {

// ---------------------------------------------------------------------------
// tensor-core kernels (fp32: three-pass TF32 on mma.sync m16n8k8)
// ---------------------------------------------------------------------------
// Each fp32 operand x is split into hi = tf32(x) and lo = tf32(x - hi),
// and a product a.b is taken as lo_a.hi_b + hi_a.lo_b + hi_a.hi_b, three
// TF32 products accumulated in fp32: each term is off by about 2^-21 of
// |a||b| (the dropped lo.lo and lo's own rounding), where one TF32 pass
// is off by 2^-11.  Fragments (PTX ISA, "Matrix Fragments for
// mma.m16n8k8" with .tf32; lane 4g + t):
//   A 16x8: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B 8x8:  b0 (t, g), b1 (t + 4, g)   (row k, column n)
//   C 16x8: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A C fragment (scores) becomes the A fragment of the next product with
// no data movement: its columns 2t and 2t + 1 are taken as the logical
// columns t and t + 4 (a = c0, c2, c1, c3), and the B operand's rows are
// read in the same order (rows 2t and 2t + 1 of the 8), which a sum over
// keys (or rows) does not see.  Tiles sit in shared memory as rows of
// D + 4 floats (D the body width, columns past d zero): with a row
// stride of 4 (mod 32) words, the A and B reads ((g, t): word 4g + t)
// and the permuted B reads ((2t, g): word 8t + g) hit 32 distinct banks.
// cp.async fills a two-stage ring (rows past the sequence zero-filled),
// so the next tile's copy runs under this tile's products.  Every
// product runs over the whole body width and tile, with no branch inside
// (the zero columns and keys add zeros), so that the compiler can
// interleave the loads, splits and products of independent tiles.
template <int D>
struct F32Fwd {
  // 4 warps of 16 query rows (8 at width 192, where 4 would leave a
  // 150 KB block alone on an SM); 32-key tiles in two stages; Q's split
  // fragments held in registers at width 64 (64 of them), read from
  // shared memory each tile above
  static constexpr int WARPS = D == 192 ? 8 : 4, THREADS = 32 * WARPS;
  static constexpr int BQ = 16 * WARPS, BK = 32, LD = D + 4;
  static constexpr bool QREG = D <= 64;
  static constexpr size_t kSmem = 4 * ((BQ + 4 * BK) * LD + 2 * BK);
  // three blocks an SM at width 64 (52 KB each): at most 168 registers
  static constexpr int MIN_BLOCKS = D <= 64 ? 3 : 1;
};

template <int D>
struct F32Dq {
  // 4 warps of 16 query rows (Q and dO held), 32-key tiles in two
  // stages (one at 256, where Q and dO take 130 KB)
  static constexpr int THREADS = 128, BQ = 64, BK = 32, LD = D + 4;
  static constexpr int NS = D > 192 ? 1 : 2;
  static constexpr size_t kSmem = 4 * ((2 * BQ + 2 * NS * BK) * LD + NS * BK);
};

template <int D>
struct F32Dkv {
  // 4 warps of 16 keys (K and V held); query tiles of 32 rows (16 above
  // width 64) in two stages with their statistics; the dK and dV columns
  // a block: all up to width 128, above half of them (2 blocks)
  static constexpr int THREADS = 128, BKV = 64, BQ = D > 64 ? 16 : 32;
  static constexpr int LD = D + 4, NCH = D > 128 ? 2 : 1, DC = D / NCH;
  static constexpr size_t kSmem = 4 * ((2 * BKV + 4 * BQ) * LD + 6 * BQ);
  // three blocks an SM at width 64 (70 KB each): at most 168 registers
  static constexpr int MIN_BLOCKS = D <= 64 ? 3 : 1;
};

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x (to nearest
// on the 10 mantissa bits kept, ties away from zero): half the range of
// the 13 dropped bits added to the magnitude, then cleared.  Two integer
// instructions, where sm_90 emulates the cvt with four and a select.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// the split fragments of an operand: hi + lo = x to ~2^-22 |x|
template <int N>
struct Split {
  uint32_t hi[N], lo[N];
  __device__ __forceinline__ void set(int i, float x) {
    hi[i] = tf32_rna(x);
    lo[i] = tf32_rna(x - __uint_as_float(hi[i]));
  }
};

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a.b to about fp32 accuracy: the three products of one k-step,
// the small ones first, into a fresh accumulator, then one rounded add.
// The tensor cores' adder truncates, so a long chain of products through
// one accumulator (every k-step, every key tile) piles up errors of one
// sign: 2.0e-4 of layer 1's query-bias gradient at BERT-base's width
// (chip_smoke.py's 15c allows 1e-4), 4.2e-5 this way.
__device__ __forceinline__ void mma3(float* d, const Split<4>& a,
                                     const Split<2>& b) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += c[i];
}

// A fragment of 16 rows of a [*][LD] tile, p at (row g, column t) of the
// k-step
template <int LD>
__device__ __forceinline__ Split<4> frag_a(const float* p) {
  Split<4> a;
  a.set(0, p[0]);
  a.set(1, p[8 * LD]);
  a.set(2, p[4]);
  a.set(3, p[8 * LD + 4]);
  return a;
}

// A fragment from a C fragment (columns 2t, 2t + 1 as t, t + 4)
__device__ __forceinline__ Split<4> frag_a_of_c(const float* c) {
  Split<4> a;
  a.set(0, c[0]);
  a.set(1, c[2]);
  a.set(2, c[1]);
  a.set(3, c[3]);
  return a;
}

// B fragment of B = M^T (M's rows are B's columns): p at M (row g,
// column t of the k-step)
__device__ __forceinline__ Split<2> frag_b_rows(const float* p) {
  Split<2> b;
  b.set(0, p[0]);
  b.set(1, p[4]);
  return b;
}

// B fragment of B = M in the permuted row order: p at M (row 2t of the
// k-step, column g) of a [*][LD] tile
template <int LD>
__device__ __forceinline__ Split<2> frag_b_cols(const float* p) {
  Split<2> b;
  b.set(0, p[0]);
  b.set(1, p[LD]);
  return b;
}

// s[j] += A . B over D / 8 k-steps: A 16 rows of a [*][LD] tile at `a`
// ((row g, column t)), B the rows of another at `b` ((row g, column t)),
// N / 8 column tiles of 8 rows each
template <int D, int N, int LD>
__device__ __forceinline__ void mma_rows(float (*s)[4], const float* a,
                                         const float* b) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const Split<4> af = frag_a<LD>(a + 8 * kk);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      mma3(s[j], af, frag_b_rows(b + 8 * j * LD + 8 * kk));
  }
}

// o[j] += C . M over the K / 8 k-steps of C fragments c (K columns) and
// the K rows of M at `m` ((row 2t, column g)), N / 8 column tiles
template <int K, int N, int LD>
__device__ __forceinline__ void mma_cols(float (*o)[4], float (*c)[4],
                                         const float* m) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    const Split<4> af = frag_a_of_c(c[kk]);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      mma3(o[j], af, frag_b_cols<LD>(m + 8 * kk * LD + 8 * j));
  }
}

__device__ __forceinline__ void cp_async(float* dst, const void* src,
                                         int bytes, bool in) {
  const uint32_t a = smem_u32(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(a),
                 "l"(src), "r"(in ? 8 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a),
                 "l"(src), "r"(in ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows [r0, r0 + ROWS) of a [*, stride] fp32 matrix of width d (a
// multiple of 8) into shared [ROWS][D + 4], zero at or past row `limit`
// and past column d; all THREADS threads, 16 bytes each
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long stride, int r0,
                                           int limit, int d) {
#pragma unroll 4
  for (int e = threadIdx.x; e < ROWS * D / 4; e += THREADS) {
    const int r = e / (D / 4), c = 4 * (e % (D / 4));
    const bool in = r0 + r < limit && c < d;
    cp_async(dst + r * (D + 4) + c, in ? src + (r0 + r) * stride + c : src,
             16, in);
  }
}

// N elements of W words (1 or 2) of a vector from element e0, zero at or
// past `limit`
template <int N, int W, int THREADS>
__device__ __forceinline__ void stage_vec(float* dst, const float* src,
                                          int e0, int limit) {
  for (int e = threadIdx.x; e < N; e += THREADS) {
    const bool in = e0 + e < limit;
    cp_async(dst + W * e, in ? src + W * (e0 + e) : src, 4 * W, in);
  }
}

// N floats (a multiple of 4) of the key bias from `src`
template <int N, int THREADS>
__device__ __forceinline__ void stage_bias(float* dst, const float* src) {
  for (int e = threadIdx.x; e < N / 4; e += THREADS)
    cp_async(dst + 4 * e, src + 4 * e, 16, true);
}

// Forward, fp32: one block per (BQ query rows, q head, batch), each warp
// 16 rows; S = Q.K^T and O += P.V by the three-pass split, the online
// softmax of the 16-bit bodies (`softmax_tile`, fp32 in registers).
template <int D, bool MASK>
__global__ void __launch_bounds__(F32Fwd<D>::THREADS, F32Fwd<D>::MIN_BLOCKS)
    flash_fwd_tf32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, const float* __restrict__ bias, int bstride,
    int sq, int sk, int h, int hk, int d, float scale, int causal) {
  using C = F32Fwd<D>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, NT = C::THREADS;
  extern __shared__ uint4 fa_f32[];
  float* const sQ = reinterpret_cast<float*>(fa_f32);
  float* const sK = sQ + BQ * LD;           // 2 stages
  float* const sV = sK + 2 * BK * LD;       // 2 stages
  float* const sB = sV + 2 * BK * LD;       // 2 stages of the key bias
  const int hq = blockIdx.y, b = blockIdx.z;
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BQ;
  const int kvh = hq / (h / hk);
  const int off = sk - sq;
  const long long qstr = static_cast<long long>(h) * d;
  const long long kstr = static_cast<long long>(hk) * d;
  const long long qoff = (static_cast<long long>(b) * sq * h + hq) * d;
  const long long koff = (static_cast<long long>(b) * sk * hk + kvh) * d;
  const float* const brow =
      MASK ? bias + static_cast<long long>(b) * bstride : nullptr;
  // MASK: any row may have no live key, and then needs every tile
  const int n_kt = live_key_tiles(q0, BQ, sq, sk, BK, causal, off, MASK);
  auto stage = [&](int kt) {
    const int st = kt & 1;
    stage_rows<D, BK, NT>(sK + st * BK * LD, k + koff, kstr, kt * BK, sk, d);
    stage_rows<D, BK, NT>(sV + st * BK * LD, v + koff, kstr, kt * BK, sk, d);
    if constexpr (MASK) stage_bias<BK, NT>(sB + st * BK, brow + kt * BK);
  };
  stage_rows<D, BQ, NT>(sQ, q + qoff, qstr, q0, sq, d);
  stage(0);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = q0 + 16 * warp;            // the warp's first row
  const bool live = rw < sq;                // warp-uniform
  const int r0 = rw + g;
  const int rl = r0 + off, rwl = rw + off;  // their last live keys
  const float sc2 = scale * kLog2e;
  const float* const qa = sQ + (16 * warp + g) * LD + t;
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  Split<4> qf[C::QREG ? D / 8 : 1];
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      stage(kt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      const int st = kt & 1, k0 = kt * BK;
      const float* const Ks = sK + st * BK * LD + g * LD + t;
      float s[BK / 8][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      if constexpr (C::QREG) {
        if (kt == 0) {
#pragma unroll
          for (int kk = 0; kk < D / 8; ++kk) qf[kk] = frag_a<LD>(qa + 8 * kk);
        }
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
            mma3(s[j], qf[kk], frag_b_rows(Ks + 8 * j * LD + 8 * kk));
      } else {
        mma_rows<D, BK, LD>(s, qa, Ks);
      }
      const float2 al = softmax_tile<BK, MASK>(
          &s[0][0], m0, m1, l0, l1, k0, sk, rl, t, MASK ? scale : sc2,
          (causal && k0 + BK - 1 > rwl) || k0 + BK > sk, causal,
          sB + st * BK);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][0] *= al.x;
        o[j][1] *= al.x;
        o[j][2] *= al.y;
        o[j][3] *= al.y;
      }
      mma_cols<BK, D, LD>(o, s, sV + st * BK * LD + 2 * t * LD + g);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  if (!live) return;
  l0 = fmaxf(quad_sum(l0), 1e-30f);
  l1 = fmaxf(quad_sum(l1), 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= sq) continue;
    const float l = half ? l1 : l0;
    float* const row = out + qoff + r * qstr + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j < d)
        *reinterpret_cast<float2*>(row + 8 * j) =
            make_float2(o[j][2 * half] / l, o[j][2 * half + 1] / l);
  }
  const long long srow = (static_cast<long long>(b) * h + hq) * sq;
  if (t == 0 && r0 < sq) save_stats<MASK>(lse, srow + r0, m0, l0);
  if (t == 0 && r0 + 8 < sq) save_stats<MASK>(lse, srow + r0 + 8, m1, l1);
}

// dq, fp32: one block per (64 query rows, q head, batch).  Its prologue
// computes delta = rowsum(dO.O) for its rows (coalesced: a warp a row)
// and writes it for dkv; each key tile gives S = Q.K^T and dP = dO.V^T,
// then dS = P (dP - delta) scale and dQ += dS.K, all by the split.
template <int D, bool MASK>
__global__ void __launch_bounds__(F32Dq<D>::THREADS) flash_dq_tf32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ out,
    const float* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, float* __restrict__ dq,
    const float* __restrict__ bias, int bstride, int sq, int sk, int h,
    int hk, int d, float scale, int causal) {
  using C = F32Dq<D>;
  constexpr int BQ = C::BQ, BK = C::BK, NS = C::NS, LD = C::LD;
  constexpr int NT = C::THREADS;
  extern __shared__ uint4 fa_f32[];
  float* const sQ = reinterpret_cast<float*>(fa_f32);
  float* const sO = sQ + BQ * LD;           // dO
  float* const sK = sO + BQ * LD;           // NS stages
  float* const sV = sK + NS * BK * LD;      // NS stages
  float* const sB = sV + NS * BK * LD;      // NS stages of the key bias
  const int hq = blockIdx.y, b = blockIdx.z;
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BQ;
  const int kvh = hq / (h / hk);
  const int off = sk - sq;
  const long long qstr = static_cast<long long>(h) * d;
  const long long kstr = static_cast<long long>(hk) * d;
  const long long qoff = (static_cast<long long>(b) * sq * h + hq) * d;
  const long long koff = (static_cast<long long>(b) * sk * hk + kvh) * d;
  const long long soff = (static_cast<long long>(b) * h + hq) * sq;
  const float* const brow =
      MASK ? bias + static_cast<long long>(b) * bstride : nullptr;
  // a row with no live key gets dq = 0: no tile beyond the frontier
  const int n_kt = live_key_tiles(q0, BQ, sq, sk, BK, causal, off, false);
  auto stage = [&](int kt) {
    const int st = NS == 2 ? kt & 1 : 0;
    stage_rows<D, BK, NT>(sK + st * BK * LD, k + koff, kstr, kt * BK, sk, d);
    stage_rows<D, BK, NT>(sV + st * BK * LD, v + koff, kstr, kt * BK, sk, d);
    if constexpr (MASK) stage_bias<BK, NT>(sB + st * BK, brow + kt * BK);
  };
  if (n_kt > 0) {
    stage_rows<D, BQ, NT>(sQ, q + qoff, qstr, q0, sq, d);
    stage_rows<D, BQ, NT>(sO, dout + qoff, qstr, q0, sq, d);
    stage(0);
  }
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = q0 + 16 * warp;
  const bool live = rw < sq;
  const int r0 = rw + g;
  const int rl = r0 + off, rwl = rw + off;
  const float sc2 = scale * kLog2e;
  // delta of the warp's 16 rows, a row at a time over the warp's lanes;
  // lse in base-2 units (MASK: the row max, whose +inf marks a row with
  // no live key, and the log sum in base-2 units)
  float dl[2] = {0.f, 0.f}, l2[2] = {0.f, 0.f}, mx[2] = {0.f, 0.f};
  if (live) {
    for (int i = 0; i < 16; ++i) {
      const int r = rw + i;
      if (r >= sq) break;
      float acc = 0.f;
      for (int c = lane; c < d; c += 32)
        acc = fmaf(dout[qoff + r * qstr + c], out[qoff + r * qstr + c], acc);
      acc = ptt::warp_sum(acc);
      if (i == g) dl[0] = acc;
      if (i == g + 8) dl[1] = acc;
      if (lane == 0) delta[soff + r] = acc;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      if (r >= sq) continue;
      if constexpr (MASK) {
        const float2 st = reinterpret_cast<const float2*>(lse)[soff + r];
        mx[half] = st.x;
        l2[half] = st.y * kLog2e;
      } else {
        l2[half] = lse[soff + r] * kLog2e;
      }
    }
  }
  const float* const qa = sQ + (16 * warp + g) * LD + t;
  const float* const oa = sO + (16 * warp + g) * LD + t;
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    if constexpr (NS == 2) {
      if (kt + 1 < n_kt) {
        stage(kt + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      if (kt > 0) {
        stage(kt);
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      const int st = NS == 2 ? kt & 1 : 0, k0 = kt * BK;
      const float* const Ks = sK + st * BK * LD;
      const float* const Vs = sV + st * BK * LD;
      float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      mma_rows<D, BK, LD>(s, qa, Ks + g * LD + t);
      mma_rows<D, BK, LD>(dp, oa, Vs + g * LD + t);
      // s becomes ds = p (dp - delta) scale
      const bool edge = (causal && k0 + BK - 1 > rwl) || k0 + BK > sk;
      const float* const sb = sB + st * BK;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int half = e >> 1;
          float p;
          if constexpr (MASK)
            p = exp2_ftz(fmaf(fmaf(s[j][e], scale,
                                   sb[8 * j + 2 * t + (e & 1)]) - mx[half],
                              kLog2e, -l2[half]));
          else
            p = exp2_ftz(s[j][e] * sc2 - l2[half]);
          if (edge) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            if (key >= sk || (causal && key > rl + 8 * half)) p = 0.f;
          }
          s[j][e] = p * (dp[j][e] - dl[half]) * scale;
        }
      mma_cols<BK, D, LD>(acc, s, Ks + 2 * t * LD + g);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  if (!live) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= sq) continue;
    float* const row = dq + qoff + r * qstr + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j < d)
        *reinterpret_cast<float2*>(row + 8 * j) =
            make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
  }
}

__device__ __forceinline__ float2 ld_cluster_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

// dk/dv, fp32: blocks of 64 keys, kv head and batch, times the NCH
// column chunks, times `ns` (1, 2, 4 or 8) blocks of a cluster that share
// the walk over (query head of the group, query tile): block x = ((key
// tile * NCH) + chunk) * ns + rank.  Each tile gives S^T = K.Q^T and
// dP^T = V.dO^T, then dV += P^T.dO and dK += dS^T.Q, by the split.  With
// ns > 1 each block leaves its fp32 partial of dK and dV in its shared
// memory, and after a cluster barrier block r sums rows [r 64 / ns,
// (r + 1) 64 / ns) of them over ranks 0, 1, ... in that order (no
// atomics: the same bits every launch) and stores them.
template <int D, bool MASK>
__global__ void __launch_bounds__(F32Dkv<D>::THREADS, F32Dkv<D>::MIN_BLOCKS)
    flash_dkv_tf32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv,
    const float* __restrict__ bias, int bstride, int sq, int sk, int h,
    int hk, int d, float scale, int causal, int ns) {
  using C = F32Dkv<D>;
  constexpr int BKV = C::BKV, BQ = C::BQ, DC = C::DC, LD = C::LD;
  constexpr int NT = C::THREADS;
  constexpr int W = MASK ? 2 : 1;           // statistics a row
  extern __shared__ uint4 fa_f32[];
  float* const sK = reinterpret_cast<float*>(fa_f32);
  float* const sV = sK + BKV * LD;
  float* const sQ = sV + BKV * LD;          // 2 stages of Q, then of dO
  float* const sO = sQ + 2 * BQ * LD;
  float* const sL = sO + 2 * BQ * LD;       // 2 stages of lse (MASK: pairs)
  float* const sD = sL + 2 * W * BQ;        // 2 stages of delta
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int rank = blockIdx.x % ns;
  const int ch = blockIdx.x / ns % C::NCH;
  const int k0 = blockIdx.x / ns / C::NCH * BKV;
  const int group = h / hk;
  const int off = sk - sq;
  const int c0 = ch * DC;                   // the chunk's first column
  const long long qstr = static_cast<long long>(h) * d;
  const long long kstr = static_cast<long long>(hk) * d;
  const long long koff = (static_cast<long long>(b) * sk * hk + kvh) * d;
  // the walk: (gi, qt) for qt from qt0 (MASK: a row with no live key
  // adds 1/sk of its dO to every dv, so every query tile), this rank's
  // contiguous share of it
  const int qt0 = causal && !MASK ? max(k0 - off, 0) / BQ : 0;
  const int nq = (sq + BQ - 1) / BQ - qt0;
  const int units = group * nq;
  const int u0 = static_cast<int>(static_cast<long long>(units) * rank / ns);
  const int u1 =
      static_cast<int>(static_cast<long long>(units) * (rank + 1) / ns);
  auto stage = [&](int u) {
    const int st = (u - u0) & 1;
    const int gi = u / nq, q0 = (qt0 + u % nq) * BQ;
    const int hq = kvh * group + gi;
    const long long qoff = (static_cast<long long>(b) * sq * h + hq) * d;
    const long long srow = (static_cast<long long>(b) * h + hq) * sq;
    stage_rows<D, BQ, NT>(sQ + st * BQ * LD, q + qoff, qstr, q0, sq, d);
    stage_rows<D, BQ, NT>(sO + st * BQ * LD, dout + qoff, qstr, q0, sq, d);
    stage_vec<BQ, W, NT>(sL + st * W * BQ, lse + W * srow, q0, sq);
    stage_vec<BQ, 1, NT>(sD + st * BQ, delta + srow, q0, sq);
  };
  stage_rows<D, BKV, NT>(sK, k + koff, kstr, k0, sk, d);
  stage_rows<D, BKV, NT>(sV, v + koff, kstr, k0, sk, d);
  if (u0 < u1) stage(u0);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw = k0 + 16 * warp;            // the warp's first key
  const bool live = kw < sk;
  const int kr0 = kw + g;
  const int kwf = kw - off;                 // the first row that sees kw
  const float sc2 = scale * kLog2e;
  const float inv_sk = 1.f / sk;
  // MASK: the bias of the thread's two keys
  float kb[2] = {0.f, 0.f};
  if (MASK && live) {
    const float* brow = bias + static_cast<long long>(b) * bstride;
    kb[0] = __ldg(brow + kr0);
    kb[1] = __ldg(brow + kr0 + 8);
  }
  const float* const ka = sK + (16 * warp + g) * LD + t;
  const float* const va = sV + (16 * warp + g) * LD + t;
  float dka[DC / 8][4], dva[DC / 8][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  for (int u = u0; u < u1; ++u) {
    if (u + 1 < u1) {
      stage(u + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = (qt0 + u % nq) * BQ;
    // some row of the tile sees some key of the warp (MASK: a row may
    // see none and still weigh every key)
    if (live && (!causal || MASK || q0 + BQ - 1 >= kwf)) {
      const int st = (u - u0) & 1;
      const float* const Qs = sQ + st * BQ * LD;
      const float* const Os = sO + st * BQ * LD;
      const float* const L = sL + st * W * BQ;
      const float* const Dl = sD + st * BQ;
      float s[BQ / 8][4], dp[BQ / 8][4];   // S^T and dP^T: keys x rows
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      mma_rows<D, BQ, LD>(s, ka, Qs + g * LD + t);
      mma_rows<D, BQ, LD>(dp, va, Os + g * LD + t);
      // s becomes p (MASK: 1/sk across a row with no live key), dp
      // becomes ds
      const bool edge = (causal && q0 < kwf + 15) || q0 + BQ > sq;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * j + 2 * t + (e & 1);   // the row in the tile
          const float lc = L[W * i];
          float p;
          if constexpr (MASK)
            p = exp2_ftz(fmaf(fmaf(s[j][e], scale, kb[e >> 1]) - lc, kLog2e,
                              -L[2 * i + 1] * kLog2e));
          else
            p = exp2_ftz(s[j][e] * sc2 - lc * kLog2e);
          if (edge) {
            const int row = q0 + i;
            if (row >= sq || (causal && row < kwf + g + 8 * (e >> 1)))
              p = 0.f;
          }
          float pv = p;
          if constexpr (MASK)
            if (lc == INFINITY && q0 + i < sq) pv = inv_sk;
          s[j][e] = pv;
          dp[j][e] = p * (dp[j][e] - Dl[i]) * scale;
        }
      mma_cols<BQ, DC, LD>(dva, s, Os + 2 * t * LD + c0 + g);
      mma_cols<BQ, DC, LD>(dka, dp, Qs + 2 * t * LD + c0 + g);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  const long long at = koff + c0;           // column c0 of key 0
  if (ns == 1) {
    if (!live) return;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = kr0 + 8 * half;
      if (key >= sk) continue;
#pragma unroll
      for (int j = 0; j < DC / 8; ++j)
        if (c0 + 8 * j < d) {
          const long long e = at + key * kstr + 8 * j + 2 * t;
          *reinterpret_cast<float2*>(dk + e) =
              make_float2(dka[j][2 * half], dka[j][2 * half + 1]);
          *reinterpret_cast<float2*>(dv + e) =
              make_float2(dva[j][2 * half], dva[j][2 * half + 1]);
        }
    }
    return;
  }
  // the partials [2][64][DC] over the tiles, once every copy has landed
  __syncthreads();
  float* const part = reinterpret_cast<float*>(fa_f32);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kr = 16 * warp + g + 8 * half;
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      const int e = kr * DC + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(part + e) =
          make_float2(dka[j][2 * half], dka[j][2 * half + 1]);
      *reinterpret_cast<float2*>(part + BKV * DC + e) =
          make_float2(dva[j][2 * half], dva[j][2 * half + 1]);
    }
  }
  cluster_sync();
  const int rows = BKV / ns;
  for (int e = threadIdx.x; e < rows * DC; e += NT) {   // pairs of dK, dV
    const int which = e / (rows * DC / 2);   // 0: dK, 1: dV
    const int rem = e - which * (rows * DC / 2);
    const int kr = rank * rows + rem / (DC / 2), c = 2 * (rem % (DC / 2));
    const uint32_t addr = smem_u32(part + (which * BKV + kr) * DC + c);
    float2 sum = make_float2(0.f, 0.f);
    for (int r = 0; r < ns; ++r) {
      const float2 x = ld_cluster_f2(map_rank(addr, r));
      sum.x += x.x;
      sum.y += x.y;
    }
    if (k0 + kr < sk && c0 + c < d)
      *reinterpret_cast<float2*>((which ? dv : dk) + at + (k0 + kr) * kstr +
                                 c) = sum;
  }
  // no block leaves while another still reads its partial
  cluster_sync();
}


// fp32: the three-pass TF32 bodies
template <int D, bool M>
int fwd_t(const Shape& s, const float* q, const float* k, const float* v,
            float* out, float* lse, cudaStream_t st) {
  using C = F32Fwd<D>;
  static int rc_opt = opt_in(flash_fwd_tf32<D, M>, C::kSmem);
  if (rc_opt) return rc_opt;
  const dim3 grid(blocks(s.sq, C::BQ), s.h, s.B);
  flash_fwd_tf32<D, M><<<grid, C::THREADS, C::kSmem, st>>>(
      q, k, v, out, lse, s.bias, s.bstride, s.sq, s.sk, s.h, s.hk, s.d,
      s.scale, s.causal);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of a dk/dv cluster (1, 2, 4 or 8): doubled while the grid
// gives fewer than two blocks an SM and each block keeps at least two
// (query head, query tile) units of the first key tile's walk
int dkv_splits(const Shape& s, int blocks_kv, int bq, int sms) {
  const long long base = 1ll * blocks_kv * s.hk * s.B;
  const int units = s.h / s.hk * blocks(s.sq, bq);
  int ns = 1;
  while (ns < 8 && base * ns < 2ll * sms && 4 * ns <= units) ns *= 2;
  return ns;
}

// dq (with delta), then dk/dv over clusters of `dkv_splits` blocks
template <int D, bool M>
int bwd_t(const Shape& s, const float* q, const float* k, const float* v,
            const float* out, const float* dout, const float* lse,
            float* delta, float* dq, float* dk, float* dv, cudaStream_t st) {
  using Q = F32Dq<D>;
  using KV = F32Dkv<D>;
  static int rc_q = opt_in(flash_dq_tf32<D, M>, Q::kSmem);
  static int rc_kv = opt_in(flash_dkv_tf32<D, M>, KV::kSmem);
  if (rc_q) return rc_q;
  if (rc_kv) return rc_kv;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = ptt::sm_count(device);
  if (sms < 0) return -sms;
  flash_dq_tf32<D, M><<<dim3(blocks(s.sq, Q::BQ), s.h, s.B), Q::THREADS,
                        Q::kSmem, st>>>(
      q, k, v, out, dout, lse, delta, dq, s.bias, s.bstride, s.sq, s.sk, s.h,
      s.hk, s.d, s.scale, s.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks_kv = blocks(s.sk, KV::BKV) * KV::NCH;
  const int ns = dkv_splits(s, blocks_kv, KV::BQ, sms);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks_kv * ns, s.hk, s.B);
  cfg.blockDim = dim3(KV::THREADS);
  cfg.dynamicSmemBytes = KV::kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(ns);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ns > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, flash_dkv_tf32<D, M>, q, k, v, dout, lse,
                           delta, dk, dv, s.bias, s.bstride, s.sq, s.sk, s.h,
                           s.hk, s.d, s.scale, s.causal, ns);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// the body of `width` with the key bias (mask) or without
#define PTT_F32_BODY(width, mask, CALL)                                   \
  switch (width) {                                                        \
    case 64:                                                              \
      return mask ? CALL(64, true) : CALL(64, false);                     \
    case 128:                                                             \
      return mask ? CALL(128, true) : CALL(128, false);                   \
    case 192:                                                             \
      return mask ? CALL(192, true) : CALL(192, false);                   \
    case 256:                                                             \
      return mask ? CALL(256, true) : CALL(256, false);                   \
  }                                                                       \
  return static_cast<int>(cudaErrorInvalidValue);

int fwd_f32(const Shape& s, int width, bool mask, const float* q,
            const float* k, const float* v, float* out, float* lse,
            cudaStream_t st) {
#define PTT_FWD(W, M) fwd_t<W, M>(s, q, k, v, out, lse, st)
  PTT_F32_BODY(width, mask, PTT_FWD)
#undef PTT_FWD
}

int bwd_f32(const Shape& s, int width, bool mask, const float* q,
            const float* k, const float* v, const float* out,
            const float* dout, const float* lse, float* delta, float* dq,
            float* dk, float* dv, cudaStream_t st) {
#define PTT_BWD(W, M) \
  bwd_t<W, M>(s, q, k, v, out, dout, lse, delta, dq, dk, dv, st)
  PTT_F32_BODY(width, mask, PTT_BWD)
#undef PTT_BWD
}

}  // namespace flash
}  // namespace ptt
