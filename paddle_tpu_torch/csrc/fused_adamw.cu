// Fused AdamW: one pass over a parameter tensor per optimizer step, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_adamw.py::fused_adamw
// (:140) and its four bodies: _kernel_fp32 (:223), _kernel_fp32_ef (:238),
// _kernel_master (:254) and _kernel_master_ef (:269), whose per-element
// math is _step_math (:67).  One templated body here covers the four:
//   MASTER = false: fp32 parameters — the parameter IS the master, and it
//                   is written once, in place;
//   MASTER = true:  a half-precision parameter P re-derived from the fp32
//                   master (both written);
//   EF = true:      the second moment is stored as (v, ef), two values of
//                   the moment dtype whose sum is the fp32 moment; it is
//                   rebuilt as v + ef, updated, and split again as
//                   _split_ef (:111) does: v rounded first, then
//                   ef = round(v_fp32 - float(v_rounded)).
// Per element, in fp32 and in _step_math's order:
//     g  = grad (+ wd * mst if L2 decay)
//     m  = b1 * m + (1 - b1) * g
//     v  = b2 * (v [+ ef]) + (1 - b2) * g * g
//     upd = (m / c1) / (sqrt(v / c2) + eps)  (+ wd * mst if decoupled)
//     mst = mst - lr * upd
// with c1 = 1 - b1^step and c2 = 1 - b2^step computed in fp32 by the
// wrapper, as the TPU wrapper computes them (fused_adamw.py:158-160).
// Every product, sum and quotient is rounded on its own: the _rn
// intrinsics are never contracted into FMAs, and m / c1 stays a
// division (not a multiply by a reciprocal), so the result is
// bit-identical to the plain PyTorch version, which runs the same ops
// one by one.  Grad, moments and ef may be fp32, bf16 or fp16 (grads of
// fp32 parameters arrive fp32 even when compute is bf16).
//
// What bounds it on the H100: bytes.  Each element is read once
// (grad, m, v, [ef], master) and written once (m, v, [ef], master,
// [param]); ~20 flops per element against 20-30 bytes.  For fp32
// parameters with bf16 moments: 12 bytes read + 8 written a parameter
// (+2 and +2 with ef), i.e. 354 MB and 0.106 ms for the [2560, 6912]
// MLP weight at 3.35 TB/s.
//
// Design: a grid-stride loop over the flat tensor; each thread takes 8
// consecutive elements per step with 16-byte loads and stores (two for
// an fp32 array, one for a 16-bit one) when every pointer is 16-byte
// aligned, and the last n % 8 elements (or all of them, unaligned)
// element by element.  No shared memory, no atomics; the update is in
// place: each element is read and then written by the same thread.
#include "common.cuh"

namespace {

struct AdamArgs {
  float lr, c1, c2, b1, omb1, b2, omb2, eps, wd;
  bool l2, decoupled;
};

// 8 consecutive elements at p (16-byte aligned) as floats; plain loads
// (not __ldg): m, v, ef and the master are written by this kernel
template <typename T>
__device__ __forceinline__ void ld8(const T* p, float* f) {
  constexpr int N = ptt::Vec<T>::N;
#pragma unroll
  for (int j = 0; j < 8; j += N) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + j);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int u = 0; u < N; ++u) f[j + u] = ptt::to_f(e[u]);
  }
}

template <typename T>
__device__ __forceinline__ void st8(T* p, const float* f) {
  constexpr int N = ptt::Vec<T>::N;
#pragma unroll
  for (int j = 0; j < 8; j += N) ptt::store_vec(p + j, f + j);
}

// one element's step: m, v (the full fp32 second moment, v + ef when
// split) and mst are updated in place
__device__ __forceinline__ void adam_step(float g, float& m, float& v,
                                          float& mst, const AdamArgs& a) {
  if (a.l2) g = __fadd_rn(g, __fmul_rn(a.wd, mst));
  m = __fadd_rn(__fmul_rn(a.b1, m), __fmul_rn(a.omb1, g));
  v = __fadd_rn(__fmul_rn(a.b2, v), __fmul_rn(__fmul_rn(a.omb2, g), g));
  const float mhat = __fdiv_rn(m, a.c1);
  const float vhat = __fdiv_rn(v, a.c2);
  float upd = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), a.eps));
  if (a.decoupled) upd = __fadd_rn(upd, __fmul_rn(a.wd, mst));
  mst = __fsub_rn(mst, __fmul_rn(a.lr, upd));
}

// (stored v, stored ef) of the fp32 moment v, as _split_ef
template <typename M>
__device__ __forceinline__ void split_ef(float v, float& v_low, float& ef) {
  v_low = ptt::to_f(ptt::from_f<M>(v));
  ef = __fsub_rn(v, v_low);
}

template <typename G, typename M, typename P, bool MASTER, bool EF>
__global__ void fused_adamw_kernel(const G* __restrict__ g,
                                   M* __restrict__ m, M* __restrict__ v,
                                   M* __restrict__ ef,
                                   float* __restrict__ mst,
                                   P* __restrict__ p_out, long long n,
                                   AdamArgs a, bool vec) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long nvec = vec ? n / 8 : 0;
  for (long long i = tid; i < nvec; i += stride) {
    const long long o = i * 8;
    float gf[8], mf[8], vf[8], ff[8], pf[8];
    ld8(g + o, gf);
    ld8(m + o, mf);
    ld8(v + o, vf);
    ld8(mst + o, pf);
    if (EF) {
      ld8(ef + o, ff);
#pragma unroll
      for (int u = 0; u < 8; ++u) vf[u] = __fadd_rn(vf[u], ff[u]);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) adam_step(gf[u], mf[u], vf[u], pf[u], a);
    if (EF) {
#pragma unroll
      for (int u = 0; u < 8; ++u) split_ef<M>(vf[u], vf[u], ff[u]);
      st8(ef + o, ff);
    }
    st8(m + o, mf);
    st8(v + o, vf);
    st8(mst + o, pf);
    if (MASTER) st8(p_out + o, pf);
  }
  for (long long i = nvec * 8 + tid; i < n; i += stride) {
    float mi = ptt::to_f(m[i]), vi = ptt::to_f(v[i]), pi = mst[i];
    if (EF) vi = __fadd_rn(vi, ptt::to_f(ef[i]));
    adam_step(ptt::to_f(g[i]), mi, vi, pi, a);
    if (EF) {
      float lo, e;
      split_ef<M>(vi, lo, e);
      ef[i] = ptt::from_f<M>(e);
    }
    m[i] = ptt::from_f<M>(mi);
    v[i] = ptt::from_f<M>(vi);
    mst[i] = pi;
    if (MASTER) p_out[i] = ptt::from_f<P>(pi);
  }
}

template <typename G, typename M, typename P, bool MASTER, bool EF>
void launch(const void* g, void* m, void* v, void* ef, void* mst,
            void* p_out, long long n, const AdamArgs& a, cudaStream_t s) {
  const bool vec =
      ptt::aligned16(g) && ptt::aligned16(m) && ptt::aligned16(v) &&
      ptt::aligned16(mst) && (!EF || ptt::aligned16(ef)) &&
      (!MASTER || ptt::aligned16(p_out));
  const int threads = 256;
  const long long items = vec ? (n / 8 > 0 ? n / 8 : 1) : n;
  long long blocks = (items + threads - 1) / threads;
  // a grid-stride loop: enough blocks to keep every SM busy (132 SMs x
  // 8 resident blocks of 256 threads), no more
  if (blocks > 132 * 8) blocks = 132 * 8;
  fused_adamw_kernel<G, M, P, MASTER, EF>
      <<<static_cast<unsigned>(blocks), threads, 0, s>>>(
          static_cast<const G*>(g), static_cast<M*>(m), static_cast<M*>(v),
          static_cast<M*>(ef), static_cast<float*>(mst),
          static_cast<P*>(p_out), n, a, vec);
}

}  // namespace

// One AdamW step over n elements, in place.  g_dtype / m_dtype: codes of
// the grad and of the moments (ef, when not null, has the moments'
// dtype).  p_dtype < 0: fp32 parameters, `mst` IS the parameter and
// p_out is unused; else `mst` is the fp32 master and p_out the parameter
// of that dtype (bf16 or fp16).  omb1 / omb2 are (1 - b1) / (1 - b2)
// rounded from double, as the reference rounds them; c1 / c2 the fp32
// bias corrections.  decoupled != 0: AdamW decay, else L2 (wd 0: none).
extern "C" int ptt_fused_adamw(int device, int g_dtype, int m_dtype,
                               int p_dtype, const void* g, void* m, void* v,
                               void* ef, void* mst, void* p_out,
                               long long n, float lr, float c1, float c2,
                               float b1, float omb1, float b2, float omb2,
                               float eps, float wd, int decoupled,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || (p_dtype >= 0 && p_out == nullptr) ||
      (p_dtype != -1 && p_dtype != ptt::kBF16 && p_dtype != ptt::kF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  AdamArgs a{lr, c1, c2, b1, omb1, b2, omb2, eps, wd,
             wd != 0.f && decoupled == 0, wd != 0.f && decoupled != 0};
  const bool has_ef = ef != nullptr;
  PTT_DISPATCH(g_dtype, G, PTT_DISPATCH(m_dtype, M, {
    if (p_dtype < 0) {
      if (has_ef)
        launch<G, M, float, false, true>(g, m, v, ef, mst, p_out, n, a, s);
      else
        launch<G, M, float, false, false>(g, m, v, ef, mst, p_out, n, a, s);
    } else if (p_dtype == ptt::kBF16) {
      if (has_ef)
        launch<G, M, __nv_bfloat16, true, true>(g, m, v, ef, mst, p_out, n,
                                                a, s);
      else
        launch<G, M, __nv_bfloat16, true, false>(g, m, v, ef, mst, p_out, n,
                                                 a, s);
    } else {
      if (has_ef)
        launch<G, M, __half, true, true>(g, m, v, ef, mst, p_out, n, a, s);
      else
        launch<G, M, __half, true, false>(g, m, v, ef, mst, p_out, n, a, s);
    }
  }));
  return static_cast<int>(cudaGetLastError());
}
