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
// the caller never synchronises to fetch it.
//
// What bounds it on the H100: bytes.  The logits are read (fp32), dlog
// written once (2 or 4 bytes), labels and the row losses are noise: at
// the training shape [1024, 8192] with bf16 dlog, 50 MB, 0.015 ms at
// 3.35 TB/s.  exp costs ~2 flops per element of the 3 passes; far below
// the ridge.
//
// Design: one block per row (rows are independent; the TPU kernel's row
// blocks of 8 become 256-thread blocks over one row).  Three passes over
// the row — max, sum of exp, then the writes — with coalesced loads
// (thread t takes elements t, t + 256, ...); the second and third reads
// of a row (32 KB at V = 8192) come from L1/L2, so device memory sees
// one read.  Block reductions by warp shuffles and shared memory, no
// atomics.  Any V: the TPU kernel's VMEM ceiling (_KERNEL_MAX_VOCAB,
// :59) has no counterpart here.  The quotient e / s and the products are
// rounded on their own (_rn intrinsics), in the plain version's order.
#include "common.cuh"

namespace {

template <typename T>
__global__ void ce_rows_kernel(const float* __restrict__ logits,
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

}  // namespace

// logits fp32 [rows, V], labels int32 [rows], scale fp32 [1] (device);
// loss fp32 [rows], dlog [rows, V] of `out_dtype`.  All contiguous.
extern "C" int ptt_ce_rows(int device, int out_dtype, const void* logits,
                           const void* labels, const void* scale, void* loss,
                           void* dlog, long long rows, int V, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || rows > 0x7fffffffLL || V <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH(out_dtype, T, {
    ce_rows_kernel<T><<<static_cast<unsigned>(rows), 256, 0, s>>>(
        static_cast<const float*>(logits), static_cast<const int*>(labels),
        static_cast<const float*>(scale), static_cast<float*>(loss),
        static_cast<T*>(dlog), V);
  });
  return static_cast<int>(cudaGetLastError());
}
