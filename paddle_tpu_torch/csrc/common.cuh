// Shared device helpers for the hand-written Hopper kernels of
// paddle_tpu_torch.  Every kernel file exposes plain C entry points
// (extern "C") that take raw pointers, sizes and a cudaStream_t, launch
// on that stream, and return cudaGetLastError() — the Python wrappers
// (paddle_tpu_torch/ops/*.py) bind them with ctypes and raise on a
// non-zero code.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

namespace ptt {

// dtype codes shared with paddle_tpu_torch/ops/_build.py::DTYPE_CODES
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// xor-butterfly reductions: every lane ends with the same value (each
// level adds two equal partial sums in commuted order, which rounds the
// same), so lanes never disagree on a softmax max or normaliser
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the whole block (blockDim.x a multiple of 32, at most 1024);
// every thread gets the total.  `scratch` holds 33 floats.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < nwarps ? scratch[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) scratch[32] = t;
  }
  __syncthreads();
  return scratch[32];
}

// Max over the whole block, as block_sum; every thread gets it.
__device__ __forceinline__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_max(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < nwarps ? scratch[lane] : -INFINITY;
    t = warp_max(t);
    if (lane == 0) scratch[32] = t;
  }
  __syncthreads();
  return scratch[32];
}

// 16-byte vector of T: loads and stores of VEC consecutive elements
template <typename T> struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int u = 0; u < Vec<T>::N; ++u) f[u] = to_f(e[u]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* f) {
  alignas(16) T e[Vec<T>::N];
#pragma unroll
  for (int u = 0; u < Vec<T>::N; ++u) e[u] = from_f<T>(f[u]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(e);
}

// The unsigned type of one load or store of B bytes (2, 4, 8 or 16)
template <int B> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

// VW consecutive elements of T: one vector of 4, 8 or 16 bytes, or one
// element
template <typename T, int VW>
struct alignas(VW * sizeof(T)) Chunk {
  static_assert(VW == 1 || VW * sizeof(T) == 4 || VW * sizeof(T) == 8 ||
                    VW * sizeof(T) == 16,
                "a vector of 4, 8 or 16 bytes, or an element");
  T e[VW];
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (VW == 1) {
      e[0] = __ldg(p);
    } else {
      using R = typename Raw<VW * sizeof(T)>::type;
      *reinterpret_cast<R*>(e) = __ldg(reinterpret_cast<const R*>(p));
    }
  }
  __device__ __forceinline__ float operator[](int u) const {
    return to_f(e[u]);
  }
};

// VW values rounded to T and stored as one vector (or one element);
// STREAM: with st.global.cs (evict first), for an output written once
// and not read back by the kernel
template <typename T, int VW, bool STREAM = false>
__device__ __forceinline__ void store_chunk(T* p, const float* f) {
  if constexpr (VW == 1 && !STREAM) {
    *p = from_f<T>(f[0]);
  } else {
    static_assert(VW == 1 || VW * sizeof(T) == 4 || VW * sizeof(T) == 8 ||
                      VW * sizeof(T) == 16,
                  "a vector of 4, 8 or 16 bytes, or an element");
    using R = typename Raw<VW * sizeof(T)>::type;
    alignas(VW * sizeof(T)) T e[VW];
#pragma unroll
    for (int u = 0; u < VW; ++u) e[u] = from_f<T>(f[u]);
    if constexpr (STREAM) {
      __stcs(reinterpret_cast<R*>(p), *reinterpret_cast<const R*>(e));
    } else {
      *reinterpret_cast<R*>(p) = *reinterpret_cast<const R*>(e);
    }
  }
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The card's SM count, read once a device (the library's plans size
// their grids by it), or a negative CUDA error.
inline int sm_count(int device) {
  static std::atomic<int> cached[64];   // zero: not read yet
  if (device < 0 || device >= 64)
    return -static_cast<int>(cudaErrorInvalidDevice);
  int n = cached[device].load(std::memory_order_relaxed);
  if (n > 0) return n;
  const cudaError_t err =
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cached[device].store(n, std::memory_order_relaxed);
  return n;
}

// Two values as one 32-bit word of 16-bit elements, `lo` in the low
// half (the element at the lower address), rounded to nearest.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const T a = from_f<T>(lo), b = from_f<T>(hi);
  unsigned short ua, ub;
  memcpy(&ua, &a, 2);
  memcpy(&ub, &b, 2);
  return static_cast<uint32_t>(ua) | (static_cast<uint32_t>(ub) << 16);
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a . b for one warp-wide m16n8k16 tensor-core product: A 16x16
// (row-major fragments a[4]), B 16x8 (column fragments b[2]), fp32
// accumulators d[4] (PTX ISA, "Matrix Fragments for mma.m16n8k16").
template <typename T>
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a,
                                          const uint32_t* b);

template <>
__device__ __forceinline__ void mma_16816<__nv_bfloat16>(float* d,
                                                         const uint32_t* a,
                                                         const uint32_t* b) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#endif
}

template <>
__device__ __forceinline__ void mma_16816<__half>(float* d, const uint32_t* a,
                                                  const uint32_t* b) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#endif
}

}  // namespace ptt

// Instantiate BODY with T bound to the element type of `dtype`; an
// unknown code returns cudaErrorInvalidValue from the enclosing entry
// point.
#define PTT_DISPATCH(dtype, T, ...)                 \
  switch (dtype) {                                  \
    case ptt::kF32: {                               \
      using T = float;                              \
      __VA_ARGS__;                                  \
      break;                                        \
    }                                               \
    case ptt::kBF16: {                              \
      using T = __nv_bfloat16;                      \
      __VA_ARGS__;                                  \
      break;                                        \
    }                                               \
    case ptt::kF16: {                               \
      using T = __half;                             \
      __VA_ARGS__;                                  \
      break;                                        \
    }                                               \
    default:                                        \
      return static_cast<int>(cudaErrorInvalidValue); \
  }
