// RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/rms_norm.py::rms_norm
// (:130) -> _rms2 (:78) -> _fwd_kernel (:43):
//     y = x * rsqrt(mean(x^2, -1) + eps) * w
// with fp32 statistics and ONE cast to the storage type at the end, as
// _fwd_kernel does (the plain twin ops.xla_rms_norm casts before the
// multiply by w, so in bf16 the two differ by one rounding).
//
// What bounds it on the H100: bytes.  Each row is read once for the
// sum of squares and once more for the output (the second read hits
// L1/L2), w is read once per row from L2, the output written once; the
// least time is (2*rows*H + H) * sizeof(T) / 3.35 TB/s.  At the serve
// decode shape [8, 4096] bf16 that is ~0.04 us, far under the launch
// latency of a few us, so at decode the kernel is launch-bound; at the
// prefill shape [256, 4096] it is ~1.3 us of traffic.
//
// Design: one block per row (rows are independent; the TPU's row
// blocks of 256 become 256-thread blocks over one row), 16-byte vector
// loads and stores when the row and the pointers allow them, a
// warp-shuffle + shared-memory block reduction, no atomics.
#include "common.cuh"

namespace {

template <typename T>
__global__ void rms_norm_kernel(const T* __restrict__ x,
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

}  // namespace

// x [rows, H], w [H], out [rows, H], all contiguous, one dtype.
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
    const bool vec = (H % N == 0) && ptt::aligned16(x) &&
                     ptt::aligned16(w) && ptt::aligned16(out);
    const int work = vec ? H / N : H;
    int threads = ((work + 31) / 32) * 32;
    threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
    rms_norm_kernel<T><<<static_cast<unsigned>(rows), threads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(out), H, eps, vec);
  });
  return static_cast<int>(cudaGetLastError());
}
