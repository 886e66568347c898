// Rotary position embedding (NeoX rotate-half) for Hopper, forward and
// backward.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/rope.py::rope_apply
// (:142) -> _rope3 (:73) -> _rope_kernel (:45): q AND k rotate in one
// launch,
//     o[:half] = x1*cos1 - x2*sin1,   o[half:] = x2*cos2 + x1*sin2
// with fp32 math and one cast at the end.  neg_sin negates sin, as
// _rope_kernel's flag does: the backward (_rope_bwd :120) is this kernel
// on (g_q, g_k) with sin's halves swapped by the caller and neg_sin set.
// cos/sin are fp32, either [s, d] (shared by every batch row) or [b, s,
// d] (per-slot positions, as serving passes them).  Unlike the TPU
// kernel there is no row-block restriction (_pick_rows, rope.py:65,
// refuses some decode shapes), and no bound on the heads: every shape is
// served.
//
// What bounds it on the H100: bytes -- q and k read once and written
// once, each cos/sin row read once: at the training shape (q [4, 2048,
// 20, 128], k [.., 4, ..], bf16; a [2048, 128] table) 103 MB, 0.0307 ms
// at 3.35 TB/s, the forward and the backward alike; at the serve decode
// shape (8 rows of 32 + 32 heads x 128) ~0.26 MB, ~0.08 us, where the
// launch and one round of loads set the time.
//
// Design (the plan: ptt_rotary::plan, rope_plan.cuh, from the shape, the
// dtype, the alignment and the SM count, reported by ptt_rope_plan and
// held by chip_smoke.py to the table below):
//   * A thread owns VW consecutive rotation pairs (x[i..i+VW) and
//     x[half+i..half+i+VW)) of one row: each is one 16-byte load and one
//     16-byte store (VW = 8 bf16/fp16, 4 fp32).  The scalar path (VW =
//     1) takes d / 2 not a multiple of VW or a pointer not 16-byte
//     aligned.
//   * Its cos/sin columns (4 VW fp32, as 16-byte loads) are loaded once
//     and held in registers while it walks the row's heads j, j + J, ...
//     (q heads, then k heads), so a table row is read once per thread,
//     not once per head.  neg_sin multiplies x by -1 (exact), not the
//     table registers, so no instruction waits on the table's loads
//     before the heads' loads go out.
//   * It issues the loads of U = 4 heads before it forms the first one's
//     outputs: 128 bytes of x in flight a thread, so 400 threads an SM
//     keep the ~50 KB that covers HBM's latency at 25 GB/s an SM
//     (Little's law).  J is the least power of two that gives the launch
//     400 threads an SM, at most the heads: at training a thread walks
//     all 24 heads of its row, 4 at a time; at decode each of the 8
//     rows' 64 heads is a split of its own, over 32 blocks.  A split of
//     fewer than 4 heads takes U = 2 or 1 (a kernel each), so no
//     unrolled slot idles.
//   * Flat work: (row, split, thread of the head) a thread, blocks of
//     128, at most 16 blocks an SM and a grid-stride loop past that, so
//     no grid dimension bounds the rows or the heads; 32-bit index math
//     while the work fits in 32 bits.
//     shape: rows x (h + hk) heads, d     VW  P   J     U  blocks (132 SMs)
//     bf16 training 8192 x 24, 128        8   8   1     4  512
//     bf16 decode 8 x 64, 128             8   8   64    1  32
//     bf16/fp16 admission 256 x 64, 128   8   8   32    2  512
//     fp32 4096 x 24, 128                 4   16  1     4  512
//     bf16 2048 x 24, d 64                8   4   8     2  512
//     bf16 1024 x 10, d 96                8   6   8     2  384
//     scalar bf16 512 x 10, d 100         1   50  4     2  800
//     scalar bf16 512 x 24, 128           1   64  2     4  512
//     bf16 8 x 65, 128                    8   8   64    2  32
//     bf16 1 x 70000, 128                 8   8   8192  4  512
// The products and the sum use round-to-nearest intrinsics, which keeps
// the compiler from contracting them into FMAs: the result is then
// bit-identical to the plain PyTorch version (qf*cos + rotate_half(qf)
// *sin, each op rounded) before the final cast.
#include "common.cuh"
#include "rope_plan.cuh"

namespace {

// VW consecutive fp32 values (16-byte loads when VW is a multiple of 4)
template <int VW>
__device__ __forceinline__ void load_f32(const float* p, float* f) {
  if constexpr (VW % 4 == 0) {
#pragma unroll
    for (int u = 0; u < VW; u += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p + u));
      f[u] = v.x;
      f[u + 1] = v.y;
      f[u + 2] = v.z;
      f[u + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < VW; ++u) f[u] = __ldg(p + u);
  }
}

// head `hh` of row n: q's heads first, then k's
template <typename Ptr>
__device__ __forceinline__ Ptr* head_of(Ptr* q, Ptr* k, long long n, int hh,
                                        int h, int hk, int d) {
  return hh < h ? q + (n * h + hh) * d : k + (n * hk + (hh - h)) * d;
}

template <typename T, int VW, int U>
__global__ void __launch_bounds__(ptt_rotary::kThreads)
rope_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const float* __restrict__ cos, const float* __restrict__ sin,
            T* __restrict__ oq, T* __restrict__ ok, long long rows, int h,
            int hk, int d, long long cs_rows, int P, int J, bool neg_sin) {
  const int half = d / 2, heads = h + hk;
  const long long units = rows * J * P;
  const int lj = __ffs(J) - 1;                  // J is a power of two
  const int lp = (P & (P - 1)) == 0 ? __ffs(P) - 1 : -1;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // neg_sin rotates by -sin: the sign goes on x (exact), so that nothing
  // waits on the cos/sin loads before the heads' loads go out
  const float m = neg_sin ? -1.f : 1.f;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < units; g += stride) {
    long long rest;
    int p;
    if (units <= 0xffffffffLL) {
      const unsigned gg = static_cast<unsigned>(g);
      const unsigned r = lp >= 0 ? gg >> lp : gg / static_cast<unsigned>(P);
      p = static_cast<int>(gg - r * static_cast<unsigned>(P));
      rest = r;
    } else {
      rest = g / P;
      p = static_cast<int>(g - rest * P);
    }
    const int i = p * VW;                                // first pair
    const long long n = rest >> lj;                      // row of [b*s]
    const int j = static_cast<int>(rest & (J - 1));      // head split
    // [s, d] tables repeat per batch; [b, s, d] ones do not
    const unsigned nn = static_cast<unsigned>(n);
    const unsigned cs = static_cast<unsigned>(cs_rows);
    const long long cr = static_cast<long long>(nn < cs ? nn : nn % cs) * d;
    float c1[VW], c2[VW], s1[VW], s2[VW];
    load_f32<VW>(cos + cr + i, c1);
    load_f32<VW>(cos + cr + half + i, c2);
    load_f32<VW>(sin + cr + i, s1);
    load_f32<VW>(sin + cr + half + i, s2);
    for (int hb = j; hb < heads; hb += U * J) {
      ptt::Chunk<T, VW> a[U], b[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int hh = hb + u * J;
        if (hh < heads) {
          const T* x = head_of(q, k, n, hh, h, hk, d);
          a[u].load(x + i);
          b[u].load(x + half + i);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int hh = hb + u * J;
        if (hh >= heads) continue;
        float o1[VW], o2[VW];
#pragma unroll
        for (int v = 0; v < VW; ++v) {
          const float x1 = a[u][v], x2 = b[u][v];
          o1[v] = __fsub_rn(__fmul_rn(x1, c1[v]), __fmul_rn(x2 * m, s1[v]));
          o2[v] = __fadd_rn(__fmul_rn(x2, c2[v]), __fmul_rn(x1 * m, s2[v]));
        }
        T* o = head_of(oq, ok, n, hh, h, hk, d);
        ptt::store_chunk<T, VW>(o + i, o1);
        ptt::store_chunk<T, VW>(o + half + i, o2);
      }
    }
  }
}

template <typename T, int VW>
const void* rope_body(int U) {
  switch (U) {
    case 1: return reinterpret_cast<const void*>(rope_kernel<T, VW, 1>);
    case 2: return reinterpret_cast<const void*>(rope_kernel<T, VW, 2>);
    default: return reinterpret_cast<const void*>(rope_kernel<T, VW, 4>);
  }
}

// Whether every pointer allows the 16-byte path and d / 2 is a multiple
// of its pairs a thread
template <typename T>
bool rope_vec(int d, const void* q, const void* k, const void* cos,
              const void* sin, const void* oq, const void* ok) {
  return (d / 2) % ptt::Vec<T>::N == 0 && ptt::aligned16(q) &&
         ptt::aligned16(k) && ptt::aligned16(cos) && ptt::aligned16(sin) &&
         ptt::aligned16(oq) && ptt::aligned16(ok);
}

bool valid(long long rows, int h, int hk, int d, long long cs_rows) {
  return rows > 0 && rows <= 0x7fffffffLL && h > 0 && hk > 0 &&
         static_cast<long long>(h) + hk <= 0x7fffffffLL && d > 0 &&
         d % 2 == 0 && cs_rows > 0;
}

}  // namespace

// q [rows, h, d], k [rows, hk, d] (rows = b*s), cos/sin fp32
// [cs_rows, d] with row n of q/k using table row n % cs_rows; outputs
// like q and k.  All contiguous.  neg_sin != 0 rotates by -sin.  The
// work is cut as the plan says (ptt_rope_plan).
extern "C" int ptt_rope(int device, int dtype, const void* q, const void* k,
                        const void* cos, const void* sin, void* oq, void* ok,
                        long long rows, int h, int hk, int d,
                        long long cs_rows, int neg_sin, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!valid(rows, h, hk, d, cs_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const int sms = ptt::sm_count(device);
  if (sms < 0) return -sms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH(dtype, T, {
    constexpr int N = ptt::Vec<T>::N;
    const bool vec = rope_vec<T>(d, q, k, cos, sin, oq, ok);
    const ptt_rotary::Plan p = ptt_rotary::plan(
        sizeof(T), d, vec, rows, static_cast<long long>(h) + hk, sms);
    const void* fn = vec ? rope_body<T, N>(p.U) : rope_body<T, 1>(p.U);
    int P = p.P, J = p.J;
    bool neg = neg_sin != 0;
    void* args[] = {&q, &k, &cos, &sin, &oq, &ok, &rows, &h, &hk, &d,
                    &cs_rows, &P, &J, &neg};
    err = cudaLaunchKernel(fn, dim3(static_cast<unsigned>(p.blocks)),
                           dim3(p.threads), args, 0, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  });
  return static_cast<int>(cudaGetLastError());
}

// The plan of a launch over `rows` rows of `heads` q + k heads of d
// elements, for the 16-byte path (vec) or the scalar one, on `device`:
// plan[0] pairs a thread (VW), plan[1] threads a head (P), plan[2] head
// splits a row (J), plan[3] heads loaded before any is formed (U),
// plan[4] threads a block, plan[5] blocks, plan[6] the card's SMs.
extern "C" int ptt_rope_plan(int device, int dtype, int d, int vec,
                             long long rows, long long heads, int* plan) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (plan == nullptr || heads < 2 || heads > 0x7fffffffLL ||
      !valid(rows, 1, 1, d, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int sms = ptt::sm_count(device);
  if (sms < 0) return -sms;
  int elem = 0;
  PTT_DISPATCH(dtype, T, {
    elem = sizeof(T);
    if (vec && (d / 2) % ptt::Vec<T>::N)
      return static_cast<int>(cudaErrorInvalidValue);
  });
  const ptt_rotary::Plan p = ptt_rotary::plan(elem, d, vec != 0, rows, heads, sms);
  plan[0] = p.VW;
  plan[1] = p.P;
  plan[2] = p.J;
  plan[3] = p.U;
  plan[4] = p.threads;
  plan[5] = static_cast<int>(p.blocks);
  plan[6] = sms;
  return 0;
}
