// Cross-entropy rows of the fused linear + cross-entropy loss, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel
// paddle_tpu/ops/pallas/fused_cross_entropy.py::_ce_rows_pallas (:95),
// body _ce_kernel (:78), which fused_linear_cross_entropy (:396) runs on
// every row chunk's fp32 logits [C, V].  Per row, in one kernel:
//     m     = max(x),  s = sum(exp(x - m)),  lse = m + log(s)
//     loss  = (lse - x[label]) * scale                  (0 if label < 0)
//     dlog  = (exp(x - m) / s - onehot(label)) * scale  (0 row if label < 0)
// with dlog cast once to the output dtype (the weight's compute dtype).
// `scale` (1 / the number of valid labels) is read from device memory, so
// the caller never synchronises to fetch it.  A label >= V picks 0.
//
// What bounds it on the H100: bytes.  The logits are read (fp32), dlog
// written once (2 or 4 bytes), labels and the row losses are noise: at
// the training shape [1024, 8192] with bf16 dlog, ~50 MB, ~0.015 ms at
// 3.35 TB/s.  An exp and a few flops an element are far below the ridge.
//
// The bodies, chosen by shape and alignment alone (ptt_ce::plan in
// cross_entropy_plan.cuh, which ptt_ce_rows_plan reports and
// chip_smoke.py's phase 6 holds to CE_PLANS; never in reaction to an
// error):
//
//   * rows body (ce_rows_kernel<T, VW, false>): one block a row, of the
//     fewest warps whose registers hold it.
//       - A thread owns vectors t, t + threads, ... (N = 32 / VW of them)
//         of VW logits: 16-byte loads where V % 4 == 0 and the logits
//         and dlog addresses allow, else 8-byte or one logit (V % 4 != 0,
//         an offset pointer).  The label and scale loads and all N vector
//         loads issue before the first use; the registers start at -inf
//         and the max runs unguarded over them, so no load waits behind
//         an arithmetic guard.  Each logit is read from device memory
//         once.
//       - exp is computed once an element, relative to the warp's max
//         (five shuffles, no barrier), and kept in the registers that
//         held x; the thread that holds x[label] keeps it.  Each warp
//         sums its exps, writes its (max, sum) pair to shared memory, and
//         after ONE __syncthreads every thread folds the pairs in the
//         same order: M = max, S = sum_w s_w exp(m_w - M).  A one-warp
//         row needs no barrier.
//       - No division an element: one reciprocal a thread, then dlog =
//         e * (exp(m_w - M) * (1 / S) * scale), and at the label
//         fma(e, that, -scale); stored as one vector of VW outputs (8
//         bytes of bf16 / fp16, 16 of fp32) with st.global.cs (evict
//         first: 0.0204 against 0.0222 ms with plain stores at [1024,
//         8192] on an H100; loads hinted L1::no_allocate, L2::256B or L2
//         evict-first measured no faster).  The thread that holds the
//         label writes the row's loss.
//       - One row a block: the blocks resident on an SM overlap one
//         another's chains and the block scheduler evens out the tail
//         (a persistent grid lost for the RMSNorm forward).
//   * cluster body (ce_rows_kernel<T, VW, true>): rows of more than
//     512 x 32 logits (V > 16384), up to 8 x that (V <= 131072), split
//     over a thread-block cluster of 2-8 blocks, each holding one slice
//     in registers as above.  Each block's (M, S) pair goes to every
//     block of the cluster through distributed shared memory
//     (st.shared::cluster at map_rank addresses) behind one cluster
//     barrier (its arrive half-issued at the block's start, so the wait
//     before the remote stores costs nothing); every block folds the
//     pairs in rank order, so all agree on M and S bit for bit.
//   * wide body (ce_rows_wide_kernel): wider rows, with no upper bound.
//     The first design: one block of 256 threads a row, three passes
//     over the row (the max, the sum of exp, the writes with exp again),
//     the re-reads from L1/L2.
//     shape                         body     VW  threads  cluster
//     [1024, 8192]                  rows     4   256      1
//     [1024, 8191], or x + 1        rows     1   256      1
//     [1024, 32000]                 cluster  4   512      2
//     [256, 50257]                  cluster  1   416      4
//     [64, 128256]                  cluster  4   512      8
//     [256, 151936]                 wide     1   256      1
//
// Rounding: the kernel's exp(x - m_w) exp(m_w - M) / S and the plain
// version's exp(x - M) / s differ by a few fp32 roundings (~2^-20 of p),
// within the 2^-18 p scale that chip_smoke.py's tolerance allows for the
// sum order; the label's output takes one rounding where the plain
// version takes two.  No atomics: two launches give the same bits.
#include "common.cuh"
#include "cross_entropy_plan.cuh"
#include "hopper.cuh"

namespace {

using ptt::Chunk;
using ptt::store_chunk;
using ptt_ce::kElems;
using ptt_ce::kMaxCluster;
using ptt_ce::kMaxThreads;

// The row's (max, sum of exp(x - max)) from the n (max, sum) pairs p[0,
// n) of its parts, folded in order; a part with no logit is (-inf, 0)
// and adds 0.
template <int CAP>
__device__ __forceinline__ float2 fold_pairs(const float2* p, int n) {
  float M = -INFINITY;
#pragma unroll
  for (int j = 0; j < CAP; ++j)
    if (j < n) M = fmaxf(M, p[j].x);
  float S = 0.f;
#pragma unroll
  for (int j = 0; j < CAP; ++j)
    if (j < n) S += p[j].y * expf(p[j].x - M);
  return make_float2(M, S);
}

// The rows body (CLUSTER false: a block a row) and the cluster body
// (`cluster` blocks a row, rank r holding vectors [r * slice, (r + 1) *
// slice)).  VW logits a vector, N = kElems / VW vectors a thread.
template <typename T, int VW, bool CLUSTER>
__global__ void __launch_bounds__(kMaxThreads, 2)
ce_rows_kernel(const float* __restrict__ logits,
               const int* __restrict__ labels,
               const float* __restrict__ scale_p, float* __restrict__ loss,
               T* __restrict__ dlog, int V, int slice, int cluster) {
  constexpr int N = kElems / VW;
  __shared__ float2 part[kMaxThreads / 32];
  __shared__ float2 peer[kMaxCluster];
  if constexpr (CLUSTER) ptt::sm90::cluster_arrive_relaxed();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nw = nt >> 5;
  const int rank = CLUSTER ? static_cast<int>(blockIdx.x) % cluster : 0;
  const long long row = CLUSTER ? blockIdx.x / cluster : blockIdx.x;
  const int v0 = rank * slice;
  const int v1 = min(v0 + slice, V / VW);   // this block's vectors
  const float* x = logits + row * V;
  const int lbl = __ldg(labels + row);
  const float scale = __ldg(scale_p);
  Chunk<float, VW> c[N];
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int u = 0; u < VW; ++u) c[k].e[u] = -INFINITY;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = v0 + tid + k * nt;
    if (j < v1) c[k].load(x + j * VW);
  }
  // where this thread holds the label's logit: vector kl, element ul
  int kl = -1, ul = 0;
  if (lbl >= 0 && lbl < V) {
    const int d = lbl / VW - v0 - tid;
    if (d >= 0 && lbl / VW < v1 && d % nt == 0 && d / nt < N) {
      kl = d / nt;
      ul = lbl % VW;
    }
  }
  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int u = 0; u < VW; ++u) m = fmaxf(m, c[k].e[u]);
  m = ptt::warp_max(m);
  const float mz = m == -INFINITY ? 0.f : m;   // a warp with no logit
  float picked = 0.f;
  if (kl >= 0) {
#pragma unroll
    for (int k = 0; k < N; ++k)
#pragma unroll
      for (int u = 0; u < VW; ++u)
        if (k == kl && u == ul) picked = c[k].e[u];
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int u = 0; u < VW; ++u) {
      const float e = expf(c[k].e[u] - mz);
      c[k].e[u] = e;
      s += e;
    }
  s = ptt::warp_sum(s);
  float M = m, S = s;
  if (CLUSTER || nw > 1) {
    if (lane == 0) part[warp] = make_float2(m, s);
    __syncthreads();
    const float2 b = fold_pairs<kMaxThreads / 32>(part, nw);
    M = b.x;
    S = b.y;
  }
  if constexpr (CLUSTER) {
    using namespace ptt::sm90;
    cluster_wait();                  // every block of the cluster runs
    if (tid < cluster)
      st_cluster_f2(map_rank(smem_u32(&peer[rank]), tid), make_float2(M, S));
    cluster_sync();
    const float2 b = fold_pairs<kMaxCluster>(peer, cluster);
    M = b.x;
    S = b.y;
  }
  const bool valid = lbl >= 0;
  const float lse = M + logf(S);
  if (kl >= 0)
    loss[row] = (lse - picked) * scale;
  else if ((lbl < 0 || lbl >= V) && rank == 0 && tid == 0)
    loss[row] = valid ? lse * scale : 0.f;
  // dlog = e * exp(m - M) / S * scale: one reciprocal, no division an
  // element
  const float f = m == -INFINITY ? 0.f : expf(m - M) * (1.0f / S) * scale;
  T* d = dlog + row * V;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = v0 + tid + k * nt;
    if (j >= v1) continue;
    float g[VW];
#pragma unroll
    for (int u = 0; u < VW; ++u) g[u] = valid ? c[k].e[u] * f : 0.f;
    if (k == kl) {                   // the label: (p - 1) * scale
#pragma unroll
      for (int u = 0; u < VW; ++u)
        if (u == ul) g[u] = fmaf(c[k].e[u], f, -scale);
    }
    store_chunk<T, VW, true>(d + j * VW, g);
  }
}

// The wide body: the first design, for rows past the largest cluster.
// One block a row, three passes over the row (the max, the sum of exp,
// then the writes, computing exp again), the second and third reads from
// L1/L2; scalar loads; the quotient e / s and the products rounded on
// their own (_rn intrinsics), in the plain version's order.
template <typename T>
__global__ void ce_rows_wide_kernel(const float* __restrict__ logits,
                                    const int* __restrict__ labels,
                                    const float* __restrict__ scale_p,
                                    float* __restrict__ loss,
                                    T* __restrict__ dlog, int V) {
  __shared__ float scratch[33];
  const long long row = blockIdx.x;
  const float* x = logits + row * V;
  T* d = dlog + row * V;
  const int lbl = labels[row];
  const bool valid = lbl >= 0;
  const float scale = *scale_p;

  float mx = -INFINITY;
  for (int i = threadIdx.x; i < V; i += blockDim.x) mx = fmaxf(mx, x[i]);
  mx = ptt::block_max(mx, scratch);
  float s = 0.f;
  for (int i = threadIdx.x; i < V; i += blockDim.x)
    s = __fadd_rn(s, expf(__fsub_rn(x[i], mx)));
  s = ptt::block_sum(s, scratch);

  if (threadIdx.x == 0) {
    const float picked = (valid && lbl < V) ? x[lbl] : 0.f;
    const float lse = __fadd_rn(mx, logf(s));
    loss[row] = valid ? __fmul_rn(__fsub_rn(lse, picked), scale) : 0.f;
  }
  for (int i = threadIdx.x; i < V; i += blockDim.x) {
    float g = 0.f;
    if (valid) {
      const float p = __fdiv_rn(expf(__fsub_rn(x[i], mx)), s);
      g = __fmul_rn(__fsub_rn(p, i == lbl ? 1.f : 0.f), scale);
    }
    d[i] = ptt::from_f<T>(g);
  }
}

// The widest vector (4, 2 or 1 logits) that the logits' and dlog's
// addresses allow
template <typename T>
int align_of(const void* logits, const void* dlog) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(logits);
  const uintptr_t b = reinterpret_cast<uintptr_t>(dlog);
  for (int w = 4; w > 1; w /= 2)
    if (a % (4 * w) == 0 && b % (sizeof(T) * w) == 0) return w;
  return 1;
}

template <typename T, bool CLUSTER>
const void* body_of(int VW) {
  if (VW == 4) return reinterpret_cast<const void*>(
      ce_rows_kernel<T, 4, CLUSTER>);
  if (VW == 2) return reinterpret_cast<const void*>(
      ce_rows_kernel<T, 2, CLUSTER>);
  return reinterpret_cast<const void*>(ce_rows_kernel<T, 1, CLUSTER>);
}

template <typename T>
const void* kernel_of(const ptt_ce::Plan& p) {
  if (p.body == ptt_ce::kWide)
    return reinterpret_cast<const void*>(ce_rows_wide_kernel<T>);
  return p.body == ptt_ce::kCluster ? body_of<T, true>(p.VW)
                                    : body_of<T, false>(p.VW);
}

}  // namespace

// logits fp32 [rows, V], labels int32 [rows], scale fp32 [1] (device);
// loss fp32 [rows], dlog [rows, V] of `out_dtype`.  All contiguous.  The
// body is the shape's plan (ptt_ce_rows_plan) at the vector width the
// addresses allow.
extern "C" int ptt_ce_rows(int device, int out_dtype, const void* logits,
                           const void* labels, const void* scale, void* loss,
                           void* dlog, long long rows, int V, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH(out_dtype, T, {
    ptt_ce::Plan p;
    if (!ptt_ce::plan(V, rows, align_of<T>(logits, dlog), &p))
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(p.blocks)),
        block(static_cast<unsigned>(p.threads));
    int slice = static_cast<int>(p.slice), cluster = p.cluster;
    void* args[] = {&logits, &labels, &scale, &loss, &dlog, &V, &slice,
                    &cluster};   // the wide body takes the first six
    if (p.body == ptt_ce::kCluster) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = grid;
      cfg.blockDim = block;
      cfg.stream = s;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = static_cast<unsigned>(p.cluster);
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      err = cudaLaunchKernelExC(&cfg, kernel_of<T>(p), args);
    } else {
      err = cudaLaunchKernel(kernel_of<T>(p), grid, block, args, 0, s);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  });
  return static_cast<int>(cudaGetLastError());
}

// The plan a launch on these operands takes: plan[0] the body (0 rows,
// 1 cluster, 2 wide), plan[1] logits a vector, plan[2] threads a block,
// plan[3] blocks a row, plan[4] blocks, plan[5] the body's blocks an SM
// at that block size (the occupancy API; asked here, never at a launch).
extern "C" int ptt_ce_rows_plan(int device, int out_dtype, const void* logits,
                                const void* dlog, long long rows, int V,
                                int* plan) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (plan == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  PTT_DISPATCH(out_dtype, T, {
    ptt_ce::Plan p;
    if (!ptt_ce::plan(V, rows, align_of<T>(logits, dlog), &p))
      return static_cast<int>(cudaErrorInvalidValue);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel_of<T>(p), p.threads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    plan[0] = p.body;
    plan[1] = p.VW;
    plan[2] = p.threads;
    plan[3] = p.cluster;
    plan[4] = static_cast<int>(p.blocks);
    plan[5] = per_sm;
  });
  return 0;
}
