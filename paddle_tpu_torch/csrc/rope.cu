// Rotary position embedding (NeoX rotate-half) for Hopper, forward and
// backward.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/rope.py::rope_apply
// (:142) -> _rope3 (:73) -> _rope_kernel (:45): q AND k rotate in one
// launch,
//     o[:half] = x1*cos1 - x2*sin1,   o[half:] = x2*cos2 + x1*sin2
// with fp32 math and one cast at the end.  neg_sin negates sin, as
// _rope_kernel's flag does: the backward (_rope_bwd :120) is this kernel
// on (g_q, g_k) with sin's halves swapped by the caller and neg_sin set
// (the backward's bytes at the training shape: g_q, g_k read, d_q, d_k
// written, 100 MB, 0.030 ms).  cos/sin are fp32, either [s, d] (shared
// by every batch row) or [b, s, d] (per-slot positions, as serving
// passes them).  Unlike the TPU kernel there is no row-block
// restriction (_pick_rows, rope.py:65, refuses some decode shapes):
// every shape is served.
//
// What bounds it on the H100: bytes — q and k read once and written
// once, cos/sin read once per row: at the serve decode shape (8 rows of
// 32+32 heads x 128, bf16) ~0.26 MB, i.e. ~0.08 us at 3.35 TB/s, so at
// decode it is launch-bound; at the prefill shape (256 rows) ~8 MB,
// ~2.5 us.
//
// Design: one block per (row, head) with one thread per rotation pair
// (x[i], x[i+half]), so a decode step still spreads over 8*64 blocks.
// The products and the sum use round-to-nearest intrinsics, which keeps
// the compiler from contracting them into FMAs: the result is then
// bit-identical to the plain PyTorch version (qf*cos + rotate_half(qf)
// *sin, each op rounded) before the final cast.
#include "common.cuh"

namespace {

template <typename T>
__global__ void rope_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const float* __restrict__ cos,
                            const float* __restrict__ sin,
                            T* __restrict__ oq, T* __restrict__ ok, int h,
                            int hk, int d, long long cs_rows, bool neg_sin) {
  const long long n = blockIdx.x;          // row of [b*s]
  const int head = blockIdx.y;             // q heads first, then k heads
  const T* x;
  T* o;
  if (head < h) {
    x = q + (n * h + head) * d;
    o = oq + (n * h + head) * d;
  } else {
    x = k + (n * hk + (head - h)) * d;
    o = ok + (n * hk + (head - h)) * d;
  }
  const long long cr = n % cs_rows;        // [s, d] tables repeat per batch
  const float* c = cos + cr * d;
  const float* sn = sin + cr * d;
  const int half = d / 2;
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
    const float x1 = ptt::to_f(x[i]);
    const float x2 = ptt::to_f(x[i + half]);
    const float s1 = neg_sin ? -sn[i] : sn[i];
    const float s2 = neg_sin ? -sn[i + half] : sn[i + half];
    o[i] = ptt::from_f<T>(__fsub_rn(__fmul_rn(x1, c[i]), __fmul_rn(x2, s1)));
    o[i + half] = ptt::from_f<T>(
        __fadd_rn(__fmul_rn(x2, c[i + half]), __fmul_rn(x1, s2)));
  }
}

}  // namespace

// q [rows, h, d], k [rows, hk, d] (rows = b*s), cos/sin fp32
// [cs_rows, d] with row n of q/k using table row n % cs_rows; outputs
// like q and k.  All contiguous.  neg_sin != 0 rotates by -sin.
extern "C" int ptt_rope(int device, int dtype, const void* q, const void* k,
                        const void* cos, const void* sin, void* oq, void* ok,
                        long long rows, int h, int hk, int d,
                        long long cs_rows, int neg_sin, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || rows > 0x7fffffffLL || h <= 0 || hk <= 0 ||
      h + hk > 65535 || d <= 0 || d % 2 || cs_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int half = d / 2;
  int threads = ((half + 31) / 32) * 32;
  threads = threads > 256 ? 256 : threads;
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(h + hk));
  PTT_DISPATCH(dtype, T, {
    rope_kernel<T><<<grid, threads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const float*>(cos), static_cast<const float*>(sin),
        static_cast<T*>(oq), static_cast<T*>(ok), h, hk, d, cs_rows,
        neg_sin != 0);
  });
  return static_cast<int>(cudaGetLastError());
}
