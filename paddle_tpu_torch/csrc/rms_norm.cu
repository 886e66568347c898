// RMSNorm forward and backward, and the fused residual-add + RMSNorm,
// for Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/rms_norm.py:
//   * rms_norm (:130) -> _rms2 (:78) -> _fwd_kernel (:43), below;
//   * its backward _rms_bwd (:105) -> _bwd_kernel (:50) and the fused
//     add's backward _add_rms_bwd (:201) -> _add_bwd_kernel (:154): one
//     kernel body, rms_norm_bwd_kernel, with an optional residual
//     cotangent;
//   * fused_add_rms_norm (:228) -> _add_rms2 (:170) -> _add_fwd_kernel
//     (:142): add_rms_norm_kernel.
// The forward computes
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
//
// Backward (bytes too: x, g, dx, plus g_resid for the fused add, 126 MB
// or 168 MB at the training shape [8192, 2560] bf16, 0.038 / 0.050 ms):
//     dx = r*(g*w) - r^3 * x * mean(g*w*x)  (+ g_resid),   r = rsqrt(...)
//     dw = sum_rows g * x * r
// recomputing r, as _bwd_kernel does.  A block walks `rows_per_block`
// rows; each thread owns the same columns of every row, so it adds its
// share of dw into shared memory with no synchronisation, and the block
// writes one fp32 dw partial row — the TPU kernel's per-row-block
// partials, summed outside the kernel as :123 sums them.
//
// Fused add (bytes: x, y read, resid and out written, 168 MB, 0.050 ms):
// the residual x + y is rounded to the storage type BEFORE the
// statistics (_add_fwd_kernel :146), so it is bit-identical to an
// unfused `x + y`; the second pass recomputes it from x and y rather
// than re-reading what it wrote.
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

// dx [rows, H] (+ gr, the residual cotangent, when not null) and the fp32
// dw partial of rows [blockIdx.x * rpb, ...) in dw_part[blockIdx.x]
template <typename T>
__global__ void rms_norm_bwd_kernel(const T* __restrict__ x,
                                    const T* __restrict__ w,
                                    const T* __restrict__ g,
                                    const T* __restrict__ gr,
                                    T* __restrict__ dx,
                                    float* __restrict__ dw_part,
                                    long long rows, int H, int rpb,
                                    float eps, bool vec) {
  __shared__ float scratch[33];
  extern __shared__ float dw_acc[];   // [H], each thread its own columns
  constexpr int N = ptt::Vec<T>::N;
  const int step = vec ? blockDim.x * N : blockDim.x;
  const int first = vec ? threadIdx.x * N : threadIdx.x;
  const int width = vec ? N : 1;
  for (int i = first; i < H; i += step)
    for (int u = 0; u < width; ++u) dw_acc[i + u] = 0.f;
  const long long r0 = static_cast<long long>(blockIdx.x) * rpb;
  const long long r1 = r0 + rpb < rows ? r0 + rpb : rows;
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

int block_threads(int H, bool vec, int N) {
  const int work = vec ? H / N : H;
  int threads = ((work + 31) / 32) * 32;
  return threads < 32 ? 32 : (threads > 256 ? 256 : threads);
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
    rms_norm_kernel<T><<<static_cast<unsigned>(rows),
                         block_threads(H, vec, N), 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(out), H, eps, vec);
  });
  return static_cast<int>(cudaGetLastError());
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

// x, g, dx (and g_resid, or null) [rows, H], w [H], one dtype; dw_part
// [ceil(rows / rows_per_block), H] fp32.  All contiguous.
extern "C" int ptt_rms_norm_bwd(int device, int dtype, const void* x,
                                const void* w, const void* g,
                                const void* g_resid, void* dx, void* dw_part,
                                long long rows, int H, int rows_per_block,
                                float eps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || H <= 0 || rows_per_block <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  const size_t smem = sizeof(float) * static_cast<size_t>(H);
  if (blocks > 0x7fffffffLL || smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH(dtype, T, {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(rms_norm_bwd_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    constexpr int N = ptt::Vec<T>::N;
    const bool vec = (H % N == 0) && ptt::aligned16(x) && ptt::aligned16(w) &&
                     ptt::aligned16(g) && ptt::aligned16(dx) &&
                     (g_resid == nullptr || ptt::aligned16(g_resid));
    rms_norm_bwd_kernel<T><<<static_cast<unsigned>(blocks),
                             block_threads(H, vec, N), smem, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const T*>(g), static_cast<const T*>(g_resid),
        static_cast<T*>(dx), static_cast<float*>(dw_part), rows, H,
        rows_per_block, eps, vec);
  });
  return static_cast<int>(cudaGetLastError());
}
