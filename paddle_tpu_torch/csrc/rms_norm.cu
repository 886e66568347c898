// RMSNorm forward and backward, and the fused residual-add + RMSNorm,
// for Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/rms_norm.py:
//   * rms_norm (:130) -> _rms2 (:78) -> _fwd_kernel (:43):
//     rms_fwd_rows_kernel (rms_fwd_wide_kernel for rows too wide for it);
//   * its backward _rms_bwd (:105) -> _bwd_kernel (:50) and the fused
//     add's backward _add_rms_bwd (:201) -> _add_bwd_kernel (:154): one
//     body with an optional residual cotangent, rms_bwd_rows_kernel
//     (rms_bwd_wide_kernel for rows too wide for it), and its dw
//     reduction;
//   * fused_add_rms_norm (:228) -> _add_rms2 (:170) -> _add_fwd_kernel
//     (:142): add_rms_norm_kernel.
//
// Forward (bytes: x read and the output written once, w read once; 84
// MB, 0.0250 ms at 3.35 TB/s at the training shape [8192, 2560] bf16;
// 0.13 MB, ~0.04 us at the decode shape [8, 4096], where the launch and
// one dependent chain of loads, a barrier and a store set the time):
//     y = x * rsqrt(mean(x^2, -1) + eps) * w
// with fp32 statistics and ONE cast to the storage type at the end, as
// _fwd_kernel does (the plain twin ops.xla_rms_norm casts before the
// multiply by w, so in bf16 the two differ by one rounding).  Two
// bodies, chosen by shape alone, the rows a block by shape and the
// card's occupancy (ptt_rms::fwd_plan, rms_norm_plan.cuh, which
// ptt_rms_norm_plan reports and chip_smoke.py's phase 3 holds to the
// tables below; never in reaction to an error):
//
//   * rows body (rms_fwd_rows_kernel): the backward's rows body (below)
//     without the cotangent and without its loop, on the same pieces
//     (load_rows, warp_transpose_sum; ptt::Chunk, ptt::store_chunk).
//       - Thread t owns vectors t, t + threads, ... (V of them) of a row,
//         V = 1 or 2, the least that keeps the block within 512 threads;
//         on the scalar path (H % (16 / sizeof(T)) != 0, or a pointer not
//         16-byte aligned) a "vector" is one element.  Four vectors a
//         thread spill under the register cap below and measured slower
//         than the wide body.
//       - A block takes one batch of R rows.  Its w vectors and the R
//         rows' x vectors are loaded together, and x stays in registers
//         from the sum of squares to the output: each row is read from
//         device memory once.  The R sums go over the warp in one
//         transposing butterfly (R - 1 + 5 - log2(R) shuffles) and over
//         the block through shared memory behind ONE __syncthreads; then
//         the outputs are formed and stored.
//       - R from the plan: 1 while the rows fit on the card at once (the
//         one-row body's blocks an SM from the occupancy API, asked once
//         per device, body and block size and cached, as the SM count is:
//         a launch makes no CUDA query), so a decode step's 8 rows take 8
//         blocks and the chain is one round of loads, one barrier, the
//         store; past that R = 4 / V, so a thread has 4 vectors (64 bytes)
//         of x in flight.  __launch_bounds__(512, 2) keeps two of the
//         widest blocks an SM.
//       - One batch a block, not a persistent grid: the blocks resident
//         on an SM overlap one another's chains, and the block scheduler
//         evens out the tail.  A persistent grid (the blocks the card
//         holds at once, each a contiguous share of the rows, the next
//         batch's loads issued before this batch's outputs) measured
//         slower on an H100 at [8192, 2560] and [8192, 4096] bf16 and
//         [8192, 2560] fp32.
//     shape                     V  threads  R (past the resident rows)
//     bf16/fp16 H = 2560        1  320      4
//     bf16/fp16 H = 4096        1  512      4
//     bf16/fp16 H = 8192        2  512      2
//     fp32 H = 2560             2  320      2
//     scalar bf16 H = 1003      2  512      2
//   * wide body (rms_fwd_wide_kernel): wider rows (bf16/fp16 H > 8192,
//     fp32 H > 4096, scalar H > 1024), with no upper bound.  The first
//     design: one block of <= 256 threads a row, which reads the row
//     twice (the second time from L1/L2) around a block reduction.
//     shape                     V  threads  R
//     bf16/fp16 H = 16384       0  256      1
//     bf16/fp16 H = 32768       0  256      1
//     scalar bf16 H = 2048      0  256      1
//     scalar bf16 H = 58079     0  256      1
//
// Backward (bytes: x and g read, dx written, plus g_resid read for the
// fused add; 126 MB or 168 MB at the training shape [8192, 2560] bf16,
// 0.038 / 0.050 ms at 3.35 TB/s):
//     dx = r*(g*w) - r^3 * x * mean(g*w*x)  (+ g_resid),   r = rsqrt(...)
//     dw = sum_rows g * x * r
// with fp32 statistics and r recomputed from x, as _bwd_kernel does; dx
// is rounded once to T, dw summed in fp32 and rounded once.  Two bodies,
// chosen by shape alone (bwd_plan below, which ptt_rms_norm_bwd_plan
// reports and chip_smoke.py's phase 6 holds to the tables below; never
// in reaction to an error), then one reduction launch:
//
//   * rows body (rms_bwd_rows_kernel): rows of at most 512 x 4 vectors
//     of 16 bytes (bf16/fp16 H <= 16384, fp32 H <= 8192); on the scalar
//     path (H % (16 / sizeof(T)) != 0, or a pointer not 16-byte aligned)
//     a "vector" is one element, so H <= 2048.
//       - The row's vectors are shared evenly by a block of
//         ceil(vectors / V) threads rounded up to a warp, V = 1, 2 or 4
//         (the least that keeps the block within 512 threads).  Thread t
//         owns vectors t, t + threads, ... of every row, so its w and dw
//         are fixed columns: w is loaded once per block into registers,
//         and dw is summed in fp32 registers over all the block's rows.
//       - A block takes R rows at a time (a batch): R = 4 / V, or 2 / V
//         (at least 1) with the residual cotangent, whose loads add to
//         the registers a thread holds.  A thread holds the 16-byte
//         loads of x and g of its columns of all R rows in registers
//         (2 R V; g_resid's R V more once the sums are formed), forms
//         the R rows' sums of x^2 and of g*w*x, reduces the 2R sums over
//         the warp in one transposing butterfly (2R - 1 + 5 - log2(2R)
//         shuffles instead of 10 R) and over the block through shared
//         memory behind ONE __syncthreads (two buffers alternate, so the
//         next batch needs no second barrier).  Right after the barrier
//         it issues the next batch's loads, then forms this batch's dx
//         and dw from the registers, so a batch's loads are in flight
//         while the one before it is finished and stored.  Each row is
//         read from device memory once.  Plain 16-byte loads, not
//         cp.async or a TMA ring: with two batches in registers a block
//         of 320 threads keeps 40 KB of loads in flight at [8192, 2560]
//         bf16 (ptxas: ~118 registers, one block an SM; ~93 with the
//         residual, two), about what covers HBM's latency at 25 GB/s an
//         SM.  Capping the registers for two blocks an SM, loading the
//         next batch only after dx, or twice the rows a batch measured
//         no faster on the H100.
//       - A persistent grid: as many blocks as the card holds at once
//         (the occupancy API; ptt_rms_norm_bwd_blocks, which the caller
//         asks before it sizes the dw partials), at most one per batch,
//         each a contiguous share of the rows whose sizes differ by at
//         most one row: no uneven last wave.
//     shape                     V  threads  R  R with g_resid
//     bf16/fp16 H = 2560        1  320      4  2
//     bf16/fp16 H = 4096        1  512      4  2
//     bf16/fp16 H = 8192        2  512      2  1
//     fp32 H = 2560             2  320      2  1
//     scalar bf16 H = 1003      2  512      2  1
//   * wide body (rms_bwd_wide_kernel): wider rows, as long as the fp32
//     dw row and the reduction's 33 floats fit in one block's dynamic
//     shared memory, 4 (H + 33) <= 232448 bytes (H <= 58079).  The
//     first design: a block of <= 256 threads per contiguous share of
//     the rows walks them one at a time, reads
//     each row twice (the second time from L1/L2) with two block
//     reductions between, and sums dw in a shared-memory row of fp32,
//     each thread its own columns.
//     shape                     V  threads  R  R with g_resid
//     bf16/fp16 H = 32768       0  256      1  1
//     scalar bf16/fp16 H = 58079  0  256    1  1
//   * reduction (rms_dw_reduce_kernel): each block wrote its fp32 dw
//     partial row to dw_part [blocks, H]; blocks of 32 columns x 16
//     slices sum them in a fixed order (slice s: partials s, s + 16, ...;
//     then the 16 slices in order) and round once to T.  No atomics: two
//     launches on the same inputs give bit-identical dx and dw.
//
// Fused add (bytes: x, y read, resid and out written, 168 MB, 0.050 ms):
// the residual x + y is rounded to the storage type BEFORE the
// statistics (_add_fwd_kernel :146), so it is bit-identical to an
// unfused `x + y`; the second pass recomputes it from x and y rather
// than re-reading what it wrote.
#include "common.cuh"
#include "rms_norm_plan.cuh"

namespace {

using ptt::Chunk;
using ptt::store_chunk;
using ptt_rms::block_threads;
using ptt_rms::kFwdRV;
using ptt_rms::kRowsThreads;
using ptt_rms::rows_threads;

// ---- the rows bodies' pieces, shared by the forward and the backward ------

// rows [base, base + R) of `a` (row stride H) that lie below r1, the
// vectors k a thread owns, into c
template <typename T, int VW, int V, int R>
__device__ __forceinline__ void load_rows(Chunk<T, VW> (&c)[R][V],
                                          const T* __restrict__ a,
                                          long long base, long long r1, int H,
                                          const bool* own, const int* col) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (base + i < r1 && own[k]) c[i][k].load(a + (base + i) * H + col[k]);
}

// Sum each of the M values v[] (M a power of two <= 32) over the warp; on
// return v[0] of lane l holds the total of value l / (32 / M).  The
// first log2(M) levels halve the values a lane keeps (each lane sends
// its partner the half the partner keeps), the rest add all to all.
template <int M>
__device__ __forceinline__ void warp_transpose_sum(float* v, int lane) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int off = 16 >> k;
    const int h = M >> (k + 1);
    if (h >= 1) {
      const bool up = (lane & off) != 0;
#pragma unroll
      for (int j = 0; j < h; ++j) {
        const float send = up ? v[j] : v[j + h];
        const float keep = up ? v[j + h] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
    }
  }
}

// ---- forward ----------------------------------------------------------------

// The rows body: rows [blockIdx.x * R, blockIdx.x * R + R) of out [rows,
// H], one batch a block.  VW elements a vector, V vectors of a row a
// thread, R rows a batch.
template <typename T, int VW, int V, int R>
__global__ void __launch_bounds__(kRowsThreads, 2)
rms_fwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ out, long long rows, int H, float eps) {
  static_assert(R <= 32 && (R & (R - 1)) == 0, "R a power of two <= 32");
  __shared__ float red[kRowsThreads / 32][R];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int vecs = H / VW;
  const long long r0 = static_cast<long long>(blockIdx.x) * R;
  const long long r1 = r0 + R < rows ? r0 + R : rows;
  const float hf = static_cast<float>(H);
  bool own[V];
  int col[V];                          // first element of vector k
  Chunk<T, VW> wa[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = tid + k * static_cast<int>(blockDim.x);
    own[k] = c < vecs;
    col[k] = c * VW;
    if (own[k]) wa[k].load(w + col[k]);
  }
  // w and the batch's x go out together; x stays in registers.  The
  // vectors no row or column owns stay zero, so the sums take no guard:
  // one shared with the loads lets the compiler fuse each row's load with
  // its sum, and then each load waits for the sum before it
  Chunk<T, VW> xa[R][V] = {};
  load_rows<T, VW, V, R>(xa, x, r0, r1, H, own, col);
  float v[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k)
#pragma unroll
      for (int u = 0; u < VW; ++u) {
        const float a = xa[i][k][u];
        ss = fmaf(a, a, ss);
      }
    v[i] = ss;
  }
  warp_transpose_sum<R>(v, lane);
  if ((lane & (32 / R - 1)) == 0) red[warp][lane / (32 / R)] = v[0];
  __syncthreads();
  // every warp sums the warps' partials in the same order
  float t = 0.f;
  if (lane < R) {
#pragma unroll
    for (int j = 0; j < kRowsThreads / 32; ++j)
      if (j < nwarps) t += red[j][lane];
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float ss = __shfl_sync(0xffffffffu, t, i);
    if (r0 + i >= r1) continue;
    // mean then rsqrt, as jnp.mean + lax.rsqrt; 1/sqrtf is correctly
    // rounded in each step (rsqrtf is an approximation)
    const float r = 1.0f / sqrtf(ss / hf + eps);
    T* orow = out + (r0 + i) * H;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (!own[k]) continue;
      float f[VW];
#pragma unroll
      for (int u = 0; u < VW; ++u) f[u] = xa[i][k][u] * r * wa[k][u];
      store_chunk<T, VW>(orow + col[k], f);
    }
  }
}

// The wide body: the same output for rows too wide for the rows body's
// registers, one block a row.
template <typename T>
__global__ void rms_fwd_wide_kernel(const T* __restrict__ x,
                                    const T* __restrict__ w,
                                    T* __restrict__ out, int H, float eps,
                                    bool vec) {
  __shared__ float scratch[33];
  const long long row = blockIdx.x;
  const T* xr = x + row * H;
  T* orow = out + row * H;
  constexpr int N = ptt::Vec<T>::N;
  float ss = 0.f;
  if (vec) {
    for (int i = threadIdx.x * N; i < H; i += blockDim.x * N) {
      float f[N];
      ptt::load_vec(xr + i, f);
#pragma unroll
      for (int u = 0; u < N; ++u) ss = fmaf(f[u], f[u], ss);
    }
  } else {
    for (int i = threadIdx.x; i < H; i += blockDim.x) {
      const float v = ptt::to_f(xr[i]);
      ss = fmaf(v, v, ss);
    }
  }
  ss = ptt::block_sum(ss, scratch);
  // mean then rsqrt, as jnp.mean + lax.rsqrt; 1/sqrtf is correctly
  // rounded in each step (rsqrtf is an approximation)
  const float r = 1.0f / sqrtf(ss / static_cast<float>(H) + eps);
  if (vec) {
    for (int i = threadIdx.x * N; i < H; i += blockDim.x * N) {
      float f[N], g[N];
      ptt::load_vec(xr + i, f);
      ptt::load_vec(w + i, g);
#pragma unroll
      for (int u = 0; u < N; ++u) f[u] = f[u] * r * g[u];
      ptt::store_vec(orow + i, f);
    }
  } else {
    for (int i = threadIdx.x; i < H; i += blockDim.x) {
      orow[i] = ptt::from_f<T>(ptt::to_f(xr[i]) * r * ptt::to_f(w[i]));
    }
  }
}


// x, y [rows, H]: resid = round(x + y), out = rms_norm(resid) * w
template <typename T>
__global__ void add_rms_norm_kernel(const T* __restrict__ x,
                                    const T* __restrict__ y,
                                    const T* __restrict__ w,
                                    T* __restrict__ resid,
                                    T* __restrict__ out, int H, float eps,
                                    bool vec) {
  __shared__ float scratch[33];
  const long long row = blockIdx.x;
  const T* xr = x + row * H;
  const T* yr = y + row * H;
  T* rr = resid + row * H;
  T* orow = out + row * H;
  constexpr int N = ptt::Vec<T>::N;
  float ss = 0.f;
  if (vec) {
    for (int i = threadIdx.x * N; i < H; i += blockDim.x * N) {
      float a[N], b[N];
      ptt::load_vec(xr + i, a);
      ptt::load_vec(yr + i, b);
#pragma unroll
      for (int u = 0; u < N; ++u) {
        a[u] = ptt::to_f(ptt::from_f<T>(a[u] + b[u]));
        ss = fmaf(a[u], a[u], ss);
      }
      ptt::store_vec(rr + i, a);
    }
  } else {
    for (int i = threadIdx.x; i < H; i += blockDim.x) {
      const T s = ptt::from_f<T>(ptt::to_f(xr[i]) + ptt::to_f(yr[i]));
      rr[i] = s;
      const float v = ptt::to_f(s);
      ss = fmaf(v, v, ss);
    }
  }
  ss = ptt::block_sum(ss, scratch);
  const float r = 1.0f / sqrtf(ss / static_cast<float>(H) + eps);
  if (vec) {
    for (int i = threadIdx.x * N; i < H; i += blockDim.x * N) {
      float a[N], b[N], g[N];
      ptt::load_vec(xr + i, a);
      ptt::load_vec(yr + i, b);
      ptt::load_vec(w + i, g);
#pragma unroll
      for (int u = 0; u < N; ++u)
        a[u] = ptt::to_f(ptt::from_f<T>(a[u] + b[u])) * r * g[u];
      ptt::store_vec(orow + i, a);
    }
  } else {
    for (int i = threadIdx.x; i < H; i += blockDim.x) {
      const float s = ptt::to_f(ptt::from_f<T>(ptt::to_f(xr[i]) +
                                               ptt::to_f(yr[i])));
      orow[i] = ptt::from_f<T>(s * r * ptt::to_f(w[i]));
    }
  }
}

// ---- backward ---------------------------------------------------------------

// R * V of the rows body, without and with the residual cotangent: rows
// a batch times vectors a thread (a thread keeps 2 R V loads of 16
// bytes in flight, and holds 2 R V more)
constexpr int kRowsRV = 4;
constexpr int kRowsRVResid = 2;
constexpr int kWideSmem = 232448;      // the wide body's dw row + scratch
constexpr int kSlices = 16;            // the reduction's row slices

// rows [r0, r1) of block `b` of `blocks`: contiguous shares whose sizes
// differ by at most one
__device__ __forceinline__ void row_share(long long rows, long long b,
                                          long long blocks, long long* r0,
                                          long long* r1) {
  const long long q = rows / blocks, rem = rows % blocks;
  *r0 = b * q + (b < rem ? b : rem);
  *r1 = *r0 + q + (b < rem ? 1 : 0);
}

// The rows body: dx [rows, H] (+ gr, the residual cotangent, when GR)
// and the fp32 dw partial of the block's rows in dw_part[blockIdx.x].
// VW elements a vector, V vectors of a row a thread, R rows a batch.
template <typename T, int VW, int V, int R, bool GR>
__global__ void __launch_bounds__(kRowsThreads)
rms_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ g, const T* __restrict__ gr,
                    T* __restrict__ dx, float* __restrict__ dw_part,
                    long long rows, int H, float eps) {
  constexpr int M = 2 * R;             // each row's sum of x^2 and g*w*x
  static_assert(M <= 32 && (M & (M - 1)) == 0, "2R a power of two <= 32");
  __shared__ float red[2][kRowsThreads / 32][M];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int vecs = H / VW;
  long long r0, r1;
  row_share(rows, blockIdx.x, gridDim.x, &r0, &r1);
  const float hf = static_cast<float>(H);
  bool own[V];
  int col[V];                          // first element of vector k
  float wf[V][VW], dw[V][VW];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = tid + k * static_cast<int>(blockDim.x);
    own[k] = c < vecs;
    col[k] = c * VW;
    Chunk<T, VW> t;
    if (own[k]) t.load(w + col[k]);
#pragma unroll
    for (int u = 0; u < VW; ++u) {
      wf[k][u] = own[k] ? t[u] : 0.f;
      dw[k][u] = 0.f;
    }
  }
  Chunk<T, VW> xa[R][V], ga[R][V];
  load_rows<T, VW, V, R>(xa, x, r0, r1, H, own, col);
  load_rows<T, VW, V, R>(ga, g, r0, r1, H, own, col);
  int buf = 0;
  for (long long base = r0; base < r1; base += R, buf ^= 1) {
    float v[M];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float ss = 0.f, dot = 0.f;
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (base + i < r1 && own[k])
#pragma unroll
          for (int u = 0; u < VW; ++u) {
            const float a = xa[i][k][u];
            ss = fmaf(a, a, ss);
            dot = fmaf(ga[i][k][u] * wf[k][u], a, dot);
          }
      v[i] = ss;
      v[R + i] = dot;
    }
    Chunk<T, VW> ea[GR ? R : 1][V];
    if constexpr (GR) load_rows<T, VW, V, R>(ea, gr, base, r1, H, own, col);
    warp_transpose_sum<M>(v, lane);
    if ((lane & (32 / M - 1)) == 0) red[buf][warp][lane / (32 / M)] = v[0];
    __syncthreads();
    // the next batch's loads go out before this batch's dx
    Chunk<T, VW> xn[R][V], gn[R][V];
    load_rows<T, VW, V, R>(xn, x, base + R, r1, H, own, col);
    load_rows<T, VW, V, R>(gn, g, base + R, r1, H, own, col);
    // every warp sums the warps' partials in the same order
    float t = 0.f;
    if (lane < M)
      for (int j = 0; j < nwarps; ++j) t += red[buf][j][lane];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float ss = __shfl_sync(0xffffffffu, t, i);
      const float dot = __shfl_sync(0xffffffffu, t, R + i);
      if (base + i >= r1) continue;
      const float r = 1.0f / sqrtf(ss / hf + eps);
      const float mean_dot = dot / hf;
      const float r3 = r * r * r;
      T* drow = dx + (base + i) * H;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (!own[k]) continue;
        float d[VW];
#pragma unroll
        for (int u = 0; u < VW; ++u) {
          const float a = xa[i][k][u], b = ga[i][k][u];
          float e = r * (b * wf[k][u]) - r3 * a * mean_dot;
          if constexpr (GR) e += ea[i][k][u];
          dw[k][u] += b * a * r;
          d[u] = e;
        }
        store_chunk<T, VW>(drow + col[k], d);
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < V; ++k) {
        xa[i][k] = xn[i][k];
        ga[i][k] = gn[i][k];
      }
  }
  float* part = dw_part + static_cast<long long>(blockIdx.x) * H;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (!own[k]) continue;
    if constexpr (VW % 4 == 0) {
#pragma unroll
      for (int u = 0; u < VW; u += 4)
        *reinterpret_cast<float4*>(part + col[k] + u) =
            make_float4(dw[k][u], dw[k][u + 1], dw[k][u + 2], dw[k][u + 3]);
    } else {
#pragma unroll
      for (int u = 0; u < VW; ++u) part[col[k] + u] = dw[k][u];
    }
  }
}

// The wide body: the same outputs for rows too wide for the rows body's
// registers, a row at a time, dw in a shared-memory row [H].
template <typename T>
__global__ void rms_bwd_wide_kernel(const T* __restrict__ x,
                                    const T* __restrict__ w,
                                    const T* __restrict__ g,
                                    const T* __restrict__ gr,
                                    T* __restrict__ dx,
                                    float* __restrict__ dw_part,
                                    long long rows, int H, float eps,
                                    bool vec) {
  extern __shared__ float dw_acc[];   // [H], each thread its own columns
  float* scratch = dw_acc + H;        // [33], block_sum's
  constexpr int N = ptt::Vec<T>::N;
  const int step = vec ? blockDim.x * N : blockDim.x;
  const int first = vec ? threadIdx.x * N : threadIdx.x;
  const int width = vec ? N : 1;
  for (int i = first; i < H; i += step)
    for (int u = 0; u < width; ++u) dw_acc[i + u] = 0.f;
  long long r0, r1;
  row_share(rows, blockIdx.x, gridDim.x, &r0, &r1);
  for (long long row = r0; row < r1; ++row) {
    const T* xr = x + row * H;
    const T* gw_ = g + row * H;
    float ss = 0.f, dot = 0.f;
    for (int i = first; i < H; i += step) {
      float a[N], b[N], c[N];
      if (vec) {
        ptt::load_vec(xr + i, a);
        ptt::load_vec(gw_ + i, b);
        ptt::load_vec(w + i, c);
      } else {
        a[0] = ptt::to_f(xr[i]);
        b[0] = ptt::to_f(gw_[i]);
        c[0] = ptt::to_f(w[i]);
      }
      for (int u = 0; u < width; ++u) {
        ss = fmaf(a[u], a[u], ss);
        dot = fmaf(b[u] * c[u], a[u], dot);
      }
    }
    ss = ptt::block_sum(ss, scratch);
    dot = ptt::block_sum(dot, scratch);
    const float r = 1.0f / sqrtf(ss / static_cast<float>(H) + eps);
    const float mean_dot = dot / static_cast<float>(H);
    const float r3 = r * r * r;
    for (int i = first; i < H; i += step) {
      float a[N], b[N], c[N], e[N];
      if (vec) {
        ptt::load_vec(xr + i, a);
        ptt::load_vec(gw_ + i, b);
        ptt::load_vec(w + i, c);
        if (gr != nullptr) ptt::load_vec(gr + row * H + i, e);
      } else {
        a[0] = ptt::to_f(xr[i]);
        b[0] = ptt::to_f(gw_[i]);
        c[0] = ptt::to_f(w[i]);
        if (gr != nullptr) e[0] = ptt::to_f(gr[row * H + i]);
      }
      for (int u = 0; u < width; ++u) {
        float d = r * (b[u] * c[u]) - r3 * a[u] * mean_dot;
        if (gr != nullptr) d += e[u];
        dw_acc[i + u] += b[u] * a[u] * r;
        c[u] = d;
      }
      if (vec) {
        ptt::store_vec(dx + row * H + i, c);
      } else {
        dx[row * H + i] = ptt::from_f<T>(c[0]);
      }
    }
  }
  float* part = dw_part + static_cast<long long>(blockIdx.x) * H;
  for (int i = first; i < H; i += step)
    for (int u = 0; u < width; ++u) part[i + u] = dw_acc[i + u];
}

// dw [H] = sum over b of dw_part[b, :], rounded once to T.  Block: 32
// columns x kSlices slices; slice s sums partials s, s + kSlices, ... in
// order, then the slices are summed in order.
template <typename T>
__global__ void __launch_bounds__(32 * kSlices)
rms_dw_reduce_kernel(const float* __restrict__ part, int blocks, int H,
                     T* __restrict__ dw) {
  __shared__ float acc[kSlices][33];
  const int lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float t = 0.f;
  if (c < H) {
#pragma unroll 4
    for (int b = slice; b < blocks; b += kSlices)
      t += part[static_cast<long long>(b) * H + c];
  }
  acc[slice][lane] = t;
  __syncthreads();
  if (slice == 0 && c < H) {
    float u = 0.f;
#pragma unroll
    for (int j = 0; j < kSlices; ++j) u += acc[j][lane];
    dw[c] = ptt::from_f<T>(u);
  }
}

// The backward body a shape takes (the header's tables): V vectors of a
// row a thread (0: the wide body), the block's threads, R rows a batch
// and the dynamic shared memory.
struct BwdPlan {
  int V, threads, R;
  size_t smem;
};

// By shape alone: the rows body with the least V of 1, 2, 4 that keeps
// the block within kRowsThreads, R = kRowsRV / V (kRowsRVResid / V, at
// least 1, with the residual cotangent); past it the wide body, a row
// at a time.  False: no body takes the shape.
template <typename T>
bool bwd_plan(int H, bool vec, bool gr, BwdPlan* p) {
  constexpr int N = ptt::Vec<T>::N;
  const int VW = vec ? N : 1;
  if (H <= 0 || (vec && H % N)) return false;
  for (int V = 1; V <= 4; V *= 2) {
    const int threads = rows_threads(H, VW, V);
    if (threads <= kRowsThreads) {
      const int R = (gr ? kRowsRVResid : kRowsRV) / V;
      *p = {V, threads, R > 0 ? R : 1, 0};
      return true;
    }
  }
  *p = {0, block_threads(H, vec, N), 1,
        sizeof(float) * (static_cast<size_t>(H) + 33)};
  return p->smem <= static_cast<size_t>(kWideSmem);
}

template <typename T, int VW, int V, bool GR>
const void* rows_body() {
  constexpr int R = (GR ? kRowsRVResid : kRowsRV) / V;
  return reinterpret_cast<const void*>(
      rms_bwd_rows_kernel<T, VW, V, (R > 0 ? R : 1), GR>);
}

template <typename T, int VW, bool GR>
const void* rows_body_of(int V) {
  switch (V) {
    case 1: return rows_body<T, VW, 1, GR>();
    case 2: return rows_body<T, VW, 2, GR>();
    case 4: return rows_body<T, VW, 4, GR>();
    default: return nullptr;
  }
}

// The kernel of plan p; null if the wide body's shared memory cannot be
// granted.
template <typename T>
const void* bwd_body(const BwdPlan& p, bool vec, bool gr) {
  constexpr int N = ptt::Vec<T>::N;
  if (p.V == 0) {
    const void* fn = reinterpret_cast<const void*>(rms_bwd_wide_kernel<T>);
    if (p.smem > 48 * 1024 &&
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(p.smem)) != cudaSuccess)
      return nullptr;
    return fn;
  }
  if (vec)
    return gr ? rows_body_of<T, N, true>(p.V) : rows_body_of<T, N, false>(p.V);
  return gr ? rows_body_of<T, 1, true>(p.V) : rows_body_of<T, 1, false>(p.V);
}

bool known_dtype(int dtype) {
  return dtype == ptt::kF32 || dtype == ptt::kBF16 || dtype == ptt::kF16;
}

// ---- the forward's launch -----------------------------------------------

template <typename T, int VW>
const void* fwd_rows_body_of(int V, int R) {
  const void* fn = nullptr;
  if (V == 1 && R == 1) fn = reinterpret_cast<const void*>(
      rms_fwd_rows_kernel<T, VW, 1, 1>);
  if (V == 1 && R == kFwdRV) fn = reinterpret_cast<const void*>(
      rms_fwd_rows_kernel<T, VW, 1, kFwdRV>);
  if (V == 2 && R == 1) fn = reinterpret_cast<const void*>(
      rms_fwd_rows_kernel<T, VW, 2, 1>);
  if (V == 2 && R == kFwdRV / 2) fn = reinterpret_cast<const void*>(
      rms_fwd_rows_kernel<T, VW, 2, kFwdRV / 2>);
  return fn;
}

// Blocks of a forward rows body an SM at `threads` threads: asked of the
// occupancy API once per (device, body, block size) and cached, so a
// launch makes no CUDA query.  `body` numbers the instantiation (dtype,
// vector path, V).  Negative: a CUDA error.
int fwd_rows_per_sm(int device, int body, const void* fn, int threads) {
  constexpr int kBodies = 3 * 2 * 2, kSizes = kRowsThreads / 32 + 1;
  static std::atomic<int> cached[64][kBodies][kSizes];   // zero: not asked
  if (device < 0 || device >= 64 || body < 0 || body >= kBodies ||
      threads <= 0 || threads % 32 || threads > kRowsThreads)
    return -static_cast<int>(cudaErrorInvalidValue);
  std::atomic<int>& c = cached[device][body][threads / 32];
  int n = c.load(std::memory_order_relaxed);
  if (n > 0) return n;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (n <= 0) return -static_cast<int>(cudaErrorInvalidConfiguration);
  c.store(n, std::memory_order_relaxed);
  return n;
}

// What a forward launch runs: the plan, its kernel and the one-row
// body's blocks an SM that the plan was made from (0 for the wide body).
struct FwdLaunch {
  ptt_rms::FwdPlan p;
  const void* fn;
  int per_sm;
};

template <typename T>
cudaError_t fwd_launch_of(int device, int dtype, int H, bool vec,
                          long long rows, FwdLaunch* L) {
  constexpr int N = ptt::Vec<T>::N;
  int V = 0, threads = 0;
  if (!ptt_rms::fwd_body(H, sizeof(T), vec, &V, &threads))
    return cudaErrorInvalidValue;
  L->per_sm = 0;
  int sms = 0;
  if (V != 0) {
    const void* one = vec ? fwd_rows_body_of<T, N>(V, 1)
                          : fwd_rows_body_of<T, 1>(V, 1);
    const int body = (dtype * 2 + (vec ? 1 : 0)) * 2 + V - 1;
    L->per_sm = fwd_rows_per_sm(device, body, one, threads);
    if (L->per_sm < 0) return static_cast<cudaError_t>(-L->per_sm);
    sms = ptt::sm_count(device);
    if (sms < 0) return static_cast<cudaError_t>(-sms);
  }
  ptt_rms::fwd_plan(H, sizeof(T), vec, rows, sms, L->per_sm, &L->p);
  if (V == 0)
    L->fn = reinterpret_cast<const void*>(rms_fwd_wide_kernel<T>);
  else
    L->fn = vec ? fwd_rows_body_of<T, N>(V, L->p.R)
                : fwd_rows_body_of<T, 1>(V, L->p.R);
  return L->fn != nullptr ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// x [rows, H], w [H], out [rows, H], all contiguous, one dtype.  The body
// is the shape's plan (ptt_rms_norm_plan): the 16-byte vector path when
// H is a multiple of 16 bytes' elements and every pointer is aligned.
extern "C" int ptt_rms_norm(int device, int dtype, const void* x,
                            const void* w, void* out, long long rows,
                            int H, float eps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || rows > 0x7fffffffLL || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH(dtype, T, {
    constexpr int N = ptt::Vec<T>::N;
    bool vec = (H % N == 0) && ptt::aligned16(x) && ptt::aligned16(w) &&
               ptt::aligned16(out);
    FwdLaunch L;
    err = fwd_launch_of<T>(device, dtype, H, vec, rows, &L);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>(L.p.blocks)),
        block(static_cast<unsigned>(L.p.threads));
    if (L.p.V == 0) {                  // the wide body's parameters
      void* args[] = {&x, &w, &out, &H, &eps, &vec};
      err = cudaLaunchKernel(L.fn, grid, block, args, 0, s);
    } else {                           // the rows body's
      void* args[] = {&x, &w, &out, &rows, &H, &eps};
      err = cudaLaunchKernel(L.fn, grid, block, args, 0, s);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  });
  return static_cast<int>(cudaGetLastError());
}

// The forward's plan for (dtype, H, vec) over `rows` rows on `device`, as
// a launch takes it: plan[0] vectors of a row a thread (0: the wide
// body), plan[1] threads a block, plan[2] rows a block, plan[3] blocks,
// plan[4] the one-row body's blocks an SM (0 for the wide body).
extern "C" int ptt_rms_norm_plan(int device, int dtype, int H, int vec,
                                 long long rows, int* plan) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!known_dtype(dtype) || plan == nullptr || rows <= 0 ||
      rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdLaunch L;
  PTT_DISPATCH(dtype, T,
               { err = fwd_launch_of<T>(device, dtype, H, vec != 0, rows, &L); });
  if (err != cudaSuccess) return static_cast<int>(err);
  plan[0] = L.p.V;
  plan[1] = L.p.threads;
  plan[2] = L.p.R;
  plan[3] = static_cast<int>(L.p.blocks);
  plan[4] = L.per_sm;
  return 0;
}

// x, y, resid, out [rows, H], w [H], all contiguous, one dtype.
extern "C" int ptt_add_rms_norm(int device, int dtype, const void* x,
                                const void* y, const void* w, void* resid,
                                void* out, long long rows, int H, float eps,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || rows > 0x7fffffffLL || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH(dtype, T, {
    constexpr int N = ptt::Vec<T>::N;
    const bool vec = (H % N == 0) && ptt::aligned16(x) && ptt::aligned16(y) &&
                     ptt::aligned16(w) && ptt::aligned16(resid) &&
                     ptt::aligned16(out);
    add_rms_norm_kernel<T><<<static_cast<unsigned>(rows),
                             block_threads(H, vec, N), 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(y),
        static_cast<const T*>(w), static_cast<T*>(resid), static_cast<T*>(out),
        H, eps, vec);
  });
  return static_cast<int>(cudaGetLastError());
}

// The backward's plan for (dtype, H, vec, a residual cotangent or not),
// by shape alone (the header's tables): plan[0] vectors of a row a
// thread (0: the wide body), plan[1] threads a block, plan[2] rows a
// batch.  Asks no device.
extern "C" int ptt_rms_norm_bwd_plan(int dtype, int H, int vec,
                                     int has_resid, int* plan) {
  if (!known_dtype(dtype) || plan == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdPlan p{};
  bool ok = false;
  PTT_DISPATCH(dtype, T,
               { ok = bwd_plan<T>(H, vec != 0, has_resid != 0, &p); });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = p.V;
  plan[1] = p.threads;
  plan[2] = p.R;
  return 0;
}

// The backward's persistent grid for (dtype, H, vec, a residual
// cotangent or not) over `rows` rows: the blocks of the shape's body
// that the card holds at once (the occupancy API's blocks an SM times
// the SMs), at most one per batch of rows.  The caller sizes dw_part
// [blocks, H] by it.  Negative: a CUDA error.
extern "C" int ptt_rms_norm_bwd_blocks(int device, int dtype, int H, int vec,
                                       int has_resid, long long rows) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (!known_dtype(dtype) || rows <= 0)
    return -static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0, sms = 0, R = 1;
  PTT_DISPATCH(dtype, T, {
    BwdPlan p{};
    if (!bwd_plan<T>(H, vec != 0, has_resid != 0, &p))
      return -static_cast<int>(cudaErrorInvalidValue);
    const void* fn = bwd_body<T>(p, vec != 0, has_resid != 0);
    if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                        p.threads, p.smem);
    if (err != cudaSuccess) return -static_cast<int>(err);
    R = p.R;
  });
  sms = ptt::sm_count(device);
  if (sms < 0) return sms;
  if (per_sm <= 0) return -static_cast<int>(cudaErrorInvalidConfiguration);
  const long long batches = (rows + R - 1) / R;
  const long long resident = static_cast<long long>(per_sm) * sms;
  return static_cast<int>(batches < resident ? batches : resident);
}

// x, g, dx (and g_resid, or null) [rows, H], w and dw [H], one dtype,
// all contiguous; dw_part [blocks, H] fp32 scratch.  vec: the 16-byte
// vector path (H % (16 / sizeof(T)) == 0 and every pointer 16-byte
// aligned), else element by element.  The body is the shape's plan
// (ptt_rms_norm_bwd_plan); blocks is the persistent grid (any number
// >= 1 is right; ptt_rms_norm_bwd_blocks gives what the card holds at
// once).  Two launches: the body, then the dw reduction.
extern "C" int ptt_rms_norm_bwd(int device, int dtype, const void* x,
                                const void* w, const void* g,
                                const void* g_resid, void* dx, void* dw_part,
                                void* dw, long long rows, int H, int vec,
                                int blocks, float eps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || H <= 0 || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && !(ptt::aligned16(x) && ptt::aligned16(w) && ptt::aligned16(g) &&
               ptt::aligned16(dx) && ptt::aligned16(dw_part) &&
               (g_resid == nullptr || ptt::aligned16(g_resid))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool gr = g_resid != nullptr;
  PTT_DISPATCH(dtype, T, {
    BwdPlan p{};
    if (!bwd_plan<T>(H, vec != 0, gr, &p))
      return static_cast<int>(cudaErrorInvalidValue);
    const void* fn = bwd_body<T>(p, vec != 0, gr);
    if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(blocks)),
        block(static_cast<unsigned>(p.threads));
    if (p.V == 0) {                    // the wide body's parameters
      bool vflag = vec != 0;
      void* args[] = {&x, &w, &g, &g_resid, &dx, &dw_part, &rows, &H, &eps,
                      &vflag};
      err = cudaLaunchKernel(fn, grid, block, args, p.smem, s);
    } else {                           // the rows body's
      void* args[] = {&x, &w, &g, &g_resid, &dx, &dw_part, &rows, &H, &eps};
      err = cudaLaunchKernel(fn, grid, block, args, 0, s);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    rms_dw_reduce_kernel<T><<<(H + 31) / 32, 32 * kSlices, 0, s>>>(
        static_cast<const float*>(dw_part), blocks, H, static_cast<T*>(dw));
  });
  return static_cast<int>(cudaGetLastError());
}
