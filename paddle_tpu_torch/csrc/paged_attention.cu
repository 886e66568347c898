// Paged decode / chunked-prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel
// paddle_tpu/ops/pallas/paged_attention.py::paged_attention (:108) ->
// _kernel (:53): queries q [B, C, h, d] of slot b attend the K/V rows
// of that slot's pages in the shared pools [P, ps, L, n_kv, d], found
// through page_table [B, P_slot]; query lane c sits at global position
// pos[b] + c and sees key rows j*ps + t <= pos[b] + c.  GQA: query
// head hq reads kv head hq // group, so the block of kv head kvh serves
// query heads kvh*group .. kvh*group + group-1; its query row
// r = c*group + g is lane c = r // group of query head kvh*group + g
// (paged_attention.py:86-87).  fp32 scores and online softmax.
//
// int8 pools (the TPU kernel's quant branch, :77-80): the pools hold
// int8 and k_scale/v_scale [P, L, n_kv] fp32 hold one scale per page,
// layer and kv head.  A page tile is loaded at one byte an element and
// each value is dequantized as __fmul_rn((float)q, scale), rounded to
// q's dtype T (the reference twin's `_dequant_pages(...).astype(q.dtype)`,
// which the plain version follows) and stored into the same shared-memory
// tile; from there both kernels run unchanged.  The bytes a block reads
// halve; the math does not change.
//
// What bounds it on the H100: bytes.  A block reads only the pages up
// to its frontier, (pos[b] + C - 1) // ps — the TPU kernel's clamped
// index map (paged_attention.py:142-146) — so the least time is the
// live K/V pages of every (slot, kv head) plus q and the output, over
// 3.35 TB/s: ~18 us per layer for the 8 slots of chip_smoke.py's decode
// shape.  A page-walk iteration costs a global-load latency plus the
// math of the block's query rows, so a long walk in one block is
// latency-bound; the walk is therefore split across blocks.  Math on
// CUDA cores reads two shared-memory operands per FMA, which made
// chunked prefill (32 query lanes, 32-128 rows per block) ~40x slower
// than its byte bound, so bf16/fp16 pools with head_dim 64 or 128,
// pages of a multiple of 16 rows and at most 128 query rows per block
// take a tensor-core kernel (mma.sync m16n8k16, fp32 accumulate); fp32
// pools and other shapes take the CUDA-core kernel.  wgmma, cp.async /
// TMA double-buffering and persistent scheduling are later work.
//
// Design (both kernels):
//   * grid (n_kv, B, splits): one block per (slot, kv head, split) —
//     32 x 8 x 8 at the 7B serving decode shape.  The TPU's sequential
//     grid axis over pages becomes a loop inside the block over that
//     split's share of the slot's live pages (flash-decoding); with
//     splits > 1 each block leaves its un-normalised (max, sum, acc)
//     in fp32 scratch and a second launch merges the splits.
//   * the block reads the WHOLE 5-D pool through the layer index and
//     strides; no per-layer slice is ever copied.
//   * each page's K and V tiles [ps, d] are loaded once into shared
//     memory, shared by the C*group query rows of the block.
//   * CUDA-core kernel: tiles in fp32, K rows padded to d+1 so a lane
//     per key reads a distinct bank; each warp owns query rows; per
//     group of <= 32 keys a lane computes one key's dot product, the
//     warp reduces max and sum with shuffles, and lanes own output dims
//     for the P.V update.  The accumulator, running max and normaliser
//     live in shared memory.
//   * tensor-core kernel: see paged_attention_mma_kernel.
//   * masking is by position only (kpos <= qpos), never by page
//     content: free slots point at the null page 0, whose rows are junk.
//     Key row 0 is visible to every query (qpos >= 0), so every row has
//     at least one valid key and the normaliser is positive.
//   * CUDA-core kernel: query rows beyond the shared-memory budget are
//     processed in row tiles, each re-walking the pages (never at the
//     serving shapes).
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kSmemMax = 232448;     // H100 opt-in limit per block
constexpr int kSmemBudget = 163840;  // what a launch plans to use

// an int8 pool value dequantized and rounded to T, as the plain version
// rounds its dequantized view to q's dtype
template <typename T>
__device__ __forceinline__ T dequant(int8_t q, float scale) {
  return ptt::from_f<T>(__fmul_rn(static_cast<float>(q), scale));
}

// a pool value of type PT (T, or int8 with its page scale) as the float
// the math uses
template <typename T, typename PT>
__device__ __forceinline__ float pool_f(PT v, float scale) {
  if constexpr (std::is_same<PT, int8_t>::value)
    return ptt::to_f(dequant<T>(v, scale));
  else
    return ptt::to_f(v);
}

// PT-sized 16-byte vector of a pool row as floats
template <typename T, typename PT>
__device__ __forceinline__ void load_pool_vec(const PT* p, float scale,
                                              float* f) {
  if constexpr (std::is_same<PT, int8_t>::value) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int u = 0; u < 16; ++u) f[u] = ptt::to_f(dequant<T>(e[u], scale));
  } else {
    ptt::load_vec(p, f);
  }
}

template <typename T, typename PT>
__device__ __forceinline__ void load_tile(const PT* __restrict__ base,
                                          long long row_stride, int rows,
                                          int d, float* dst, int dst_stride,
                                          bool vec, float scale) {
  if (vec) {
    constexpr int N = ptt::Vec<PT>::N;
    const int per_row = d / N;
    for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
      const int t = e / per_row;
      const int i = (e - t * per_row) * N;
      float f[N];
      load_pool_vec<T, PT>(base + t * row_stride + i, scale, f);
#pragma unroll
      for (int u = 0; u < N; ++u) dst[t * dst_stride + i + u] = f[u];
    }
  } else {
    for (int e = threadIdx.x; e < rows * d; e += blockDim.x) {
      const int t = e / d;
      const int i = e - t * d;
      dst[t * dst_stride + i] =
          pool_f<T, PT>(base[t * row_stride + i], scale);
    }
  }
}

// the scale of page `page`, layer `layer`, kv head `kvh` ([P, L, n_kv]);
// 1 (unused) for a pool of q's dtype
__device__ __forceinline__ float page_scale(const float* __restrict__ sc,
                                            long long page, int L, int n_kv,
                                            int layer, int kvh) {
  return sc == nullptr ? 1.f : sc[(page * L + layer) * n_kv + kvh];
}

template <typename T, typename PT>
__global__ void paged_attention_kernel(
    const T* __restrict__ q, const PT* __restrict__ kpool,
    const PT* __restrict__ vpool, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ page_table,
    const int* __restrict__ pos, T* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int C, int h,
    int d, int ps, int L, int n_kv, int P_slot, int layer, float scale,
    int RT, int splits, bool vec) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int group = h / n_kv;
  const int R = C * group;
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int dp = d + 1;

  extern __shared__ float smem[];
  float* Qs = smem;                   // [RT][d]
  float* Acc = Qs + RT * d;           // [RT][d]
  float* Ks = Acc + RT * d;           // [ps][d + 1]
  float* Vs = Ks + ps * dp;           // [ps][d]
  float* Ms = Vs + ps * d;            // [RT] running max
  float* Ls = Ms + RT;                // [RT] running normaliser
  float* Pw = Ls + RT;                // [nwarps][32] probabilities

  const int p0 = pos[b];
  int last = (max(p0 + C - 1, 0)) / ps;
  if (last > P_slot - 1) last = P_slot - 1;
  // this block's share of the slot's live pages: [j_begin, j_end)
  const int per_split = (last + splits) / splits;
  const int j_begin = split * per_split;
  const int j_end = min(last + 1, j_begin + per_split);
  const long long row_stride = static_cast<long long>(L) * n_kv * d;
  const long long page_stride = static_cast<long long>(ps) * row_stride;
  const long long head_off =
      (static_cast<long long>(layer) * n_kv + kvh) * d;
  const int* pt = page_table + static_cast<long long>(b) * P_slot;
  float* pw = Pw + warp * 32;

  for (int r0 = 0; r0 < R; r0 += RT) {
    const int rt = min(RT, R - r0);
    for (int e = threadIdx.x; e < rt * d; e += blockDim.x) {
      const int rr = e / d;
      const int i = e - rr * d;
      const int r = r0 + rr;
      const int c = r / group;
      const int g = r - c * group;
      const long long qi =
          ((static_cast<long long>(b) * C + c) * h + kvh * group + g) * d + i;
      Qs[rr * d + i] = ptt::to_f(q[qi]);
      Acc[rr * d + i] = 0.f;
    }
    for (int rr = threadIdx.x; rr < rt; rr += blockDim.x) {
      Ms[rr] = -1e30f;
      Ls[rr] = 0.f;
    }
    __syncthreads();

    for (int j = j_begin; j < j_end; ++j) {
      const long long page = pt[j];
      load_tile<T, PT>(kpool + page * page_stride + head_off, row_stride, ps,
                       d, Ks, dp, vec,
                       page_scale(kscale, page, L, n_kv, layer, kvh));
      load_tile<T, PT>(vpool + page * page_stride + head_off, row_stride, ps,
                       d, Vs, d, vec,
                       page_scale(vscale, page, L, n_kv, layer, kvh));
      __syncthreads();
      for (int rr = warp; rr < rt; rr += nwarps) {
        const int qpos = p0 + (r0 + rr) / group;
        const float* qr = Qs + rr * d;
        float* acc = Acc + rr * d;
        float m_prev = Ms[rr];
        float l_prev = Ls[rr];
        for (int t0 = 0; t0 < ps; t0 += 32) {
          const int t = t0 + lane;
          const bool valid = t < ps && j * ps + t <= qpos;
          float s = -INFINITY;
          if (valid) {
            // four independent partial sums keep the FMA pipe busy
            const float* kr = Ks + t * dp;
            float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
            int i = 0;
            for (; i + 3 < d; i += 4) {
              d0 = fmaf(qr[i], kr[i], d0);
              d1 = fmaf(qr[i + 1], kr[i + 1], d1);
              d2 = fmaf(qr[i + 2], kr[i + 2], d2);
              d3 = fmaf(qr[i + 3], kr[i + 3], d3);
            }
            for (; i < d; ++i) d0 = fmaf(qr[i], kr[i], d0);
            s = ((d0 + d1) + (d2 + d3)) * scale;
          }
          const float m_new = fmaxf(m_prev, ptt::warp_max(s));
          const float pexp = valid ? expf(s - m_new) : 0.f;
          const float alpha = expf(m_prev - m_new);
          l_prev = l_prev * alpha + ptt::warp_sum(pexp);
          pw[lane] = pexp;
          __syncwarp();
          const int nt = min(32, ps - t0);
          for (int i = lane; i < d; i += 32) {
            float a = acc[i] * alpha;
            for (int u = 0; u < nt; ++u)
              a = fmaf(pw[u], Vs[(t0 + u) * d + i], a);
            acc[i] = a;
          }
          __syncwarp();
          m_prev = m_new;
        }
        if (lane == 0) {
          Ms[rr] = m_prev;
          Ls[rr] = l_prev;
        }
      }
      __syncthreads();
    }

    if (splits == 1) {
      for (int e = threadIdx.x; e < rt * d; e += blockDim.x) {
        const int rr = e / d;
        const int i = e - rr * d;
        const int r = r0 + rr;
        const int c = r / group;
        const int g = r - c * group;
        const long long oi =
            ((static_cast<long long>(b) * C + c) * h + kvh * group + g) * d +
            i;
        out[oi] = ptt::from_f<T>(Acc[rr * d + i] / fmaxf(Ls[rr], 1e-30f));
      }
    } else {
      // un-normalised partial state of this split, merged by
      // paged_attention_merge; an empty split leaves (-1e30, 0, 0)
      const long long base =
          ((static_cast<long long>(b) * n_kv + kvh) * splits + split) * R +
          r0;
      for (int e = threadIdx.x; e < rt * d; e += blockDim.x)
        part_acc[base * d + e] = Acc[e];
      for (int rr = threadIdx.x; rr < rt; rr += blockDim.x) {
        part_ml[(base + rr) * 2] = Ms[rr];
        part_ml[(base + rr) * 2 + 1] = Ls[rr];
      }
    }
    __syncthreads();
  }
}

// Combine the splits of each (slot, kv head): rescale every split's
// accumulator and normaliser to the common running max, sum, divide.
template <typename T>
__global__ void paged_attention_merge(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_ml,
                                      T* __restrict__ out, int C, int h,
                                      int d, int n_kv, int splits) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int group = h / n_kv;
  const int R = C * group;
  const long long base =
      (static_cast<long long>(b) * n_kv + kvh) * splits * R;
  for (int e = threadIdx.x; e < R * d; e += blockDim.x) {
    const int r = e / d;
    const int i = e - r * d;
    float m = -1e30f;
    for (int s = 0; s < splits; ++s)
      m = fmaxf(m, part_ml[(base + static_cast<long long>(s) * R + r) * 2]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < splits; ++s) {
      const long long pr = base + static_cast<long long>(s) * R + r;
      const float w = expf(part_ml[pr * 2] - m);
      l = fmaf(part_ml[pr * 2 + 1], w, l);
      a = fmaf(part_acc[pr * d + i], w, a);
    }
    const int c = r / group;
    const int g = r - c * group;
    const long long oi =
        ((static_cast<long long>(b) * C + c) * h + kvh * group + g) * d + i;
    out[oi] = ptt::from_f<T>(a / fmaxf(l, 1e-30f));
  }
}

// Offset of query row r (= c*group + g) of kv head kvh, slot b, in q/out.
__device__ __forceinline__ long long q_row(int b, int C, int h, int kvh,
                                           int group, int r, int d) {
  const int c = r / group;
  const int g = r - c * group;
  return ((static_cast<long long>(b) * C + c) * h + kvh * group + g) * d;
}

// Tensor-core variant for bf16/fp16 (FlashAttention-2 register layout):
// each warp owns 16 query rows; per 16-key tile it takes S = Q.K^T and
// O += P.V with m16n8k16 mma.sync and runs the online softmax on the S
// fragments in registers.  P is rounded to T before P.V, as the plain
// version rounds its softmax weights.  The page's K tile sits in shared
// memory row-major and its V tile transposed, rows padded by 8 elements,
// so every B fragment is one conflict-free 32-bit load.  Grid, page
// split and partial-state layout are those of paged_attention_kernel.
template <typename T, typename PT, int D>
__global__ void paged_attention_mma_kernel(
    const T* __restrict__ q, const PT* __restrict__ kpool,
    const PT* __restrict__ vpool, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ page_table,
    const int* __restrict__ pos, T* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int C, int h,
    int ps, int L, int n_kv, int P_slot, int layer, float scale,
    int splits) {
  constexpr int KS = D + 8;
  constexpr int N = ptt::Vec<PT>::N;   // pool elements per 16-byte load
  const int VS = ps + 8;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int group = h / n_kv;
  const int R = C * group;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  extern __shared__ uint4 smem_mma[];
  T* Ks = reinterpret_cast<T*>(smem_mma);   // [ps][D + 8]
  T* Vt = Ks + ps * KS;                       // [D][ps + 8]

  const int p0 = pos[b];
  int last = (max(p0 + C - 1, 0)) / ps;
  if (last > P_slot - 1) last = P_slot - 1;
  const int per_split = (last + splits) / splits;
  const int j_begin = split * per_split;
  const int j_end = min(last + 1, j_begin + per_split);
  const long long row_stride = static_cast<long long>(L) * n_kv * D;
  const long long page_stride = static_cast<long long>(ps) * row_stride;
  const long long head_off =
      (static_cast<long long>(layer) * n_kv + kvh) * D;
  const int* pt = page_table + static_cast<long long>(b) * P_slot;

  // this warp's rows ra and rb = ra + 8 (fragment rows g and g + 8)
  const int ra = warp * 16 + g;
  const int rb = ra + 8;
  const bool active = warp * 16 < R;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) {
      const int r = (reg & 1) ? rb : ra;
      const int col = ks * 16 + 2 * t4 + ((reg & 2) ? 8 : 0);
      qf[ks][reg] =
          r < R ? ptt::ld32(q + q_row(b, C, h, kvh, group, r, D) + col) : 0u;
    }
  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float ma = -1e30f, mb = -1e30f, la = 0.f, lb = 0.f;
  const int qpa = p0 + ra / group;
  const int qpb = p0 + rb / group;

  for (int j = j_begin; j < j_end; ++j) {
    const long long page = pt[j];
    const PT* kb = kpool + page * page_stride + head_off;
    const PT* vb = vpool + page * page_stride + head_off;
    const float ksc = page_scale(kscale, page, L, n_kv, layer, kvh);
    const float vsc = page_scale(vscale, page, L, n_kv, layer, kvh);
    // consecutive threads take consecutive keys, so the transposed V
    // stores of a warp land in distinct shared-memory words
    for (int e = threadIdx.x; e < ps * (D / N); e += blockDim.x) {
      const int t = e % ps;
      const int i = (e / ps) * N;
      const uint4 kv =
          __ldg(reinterpret_cast<const uint4*>(kb + t * row_stride + i));
      const uint4 vv =
          __ldg(reinterpret_cast<const uint4*>(vb + t * row_stride + i));
      if constexpr (std::is_same<PT, int8_t>::value) {
        // 16 int8 values: dequantized to T, two 16-byte K stores
        const int8_t* ke = reinterpret_cast<const int8_t*>(&kv);
        const int8_t* ve = reinterpret_cast<const int8_t*>(&vv);
        alignas(16) T kd[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          kd[u] = dequant<T>(ke[u], ksc);
          Vt[(i + u) * VS + t] = dequant<T>(ve[u], vsc);
        }
        reinterpret_cast<uint4*>(Ks + t * KS + i)[0] =
            reinterpret_cast<const uint4*>(kd)[0];
        reinterpret_cast<uint4*>(Ks + t * KS + i)[1] =
            reinterpret_cast<const uint4*>(kd)[1];
      } else {
        *reinterpret_cast<uint4*>(Ks + t * KS + i) = kv;
        const T* ve = reinterpret_cast<const T*>(&vv);
#pragma unroll
        for (int u = 0; u < N; ++u) Vt[(i + u) * VS + t] = ve[u];
      }
    }
    __syncthreads();
    if (active) {
      for (int kt = 0; kt < ps; kt += 16) {
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const T* kr = Ks + (kt + nt * 8 + g) * KS + ks * 16 + 2 * t4;
            const uint32_t bf[2] = {ptt::ld32(kr), ptt::ld32(kr + 8)};
            ptt::mma_16816<T>(s[nt], qf[ks], bf);
          }
        float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = j * ps + kt + nt * 8 + 2 * t4 + (e & 1);
            const bool ok = key <= (e < 2 ? qpa : qpb);
            s[nt][e] = ok ? s[nt][e] * scale : -INFINITY;
            if (e < 2)
              mxa = fmaxf(mxa, s[nt][e]);
            else
              mxb = fmaxf(mxb, s[nt][e]);
          }
        // the four lanes of a quad hold one row's 16 scores
#pragma unroll
        for (int x = 1; x <= 2; x <<= 1) {
          mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, x));
          mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, x));
        }
        const float na = fmaxf(ma, mxa);
        const float nb = fmaxf(mb, mxb);
        float sa = 0.f, sb = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v = s[nt][e];
            const float p = v == -INFINITY ? 0.f : expf(v - (e < 2 ? na : nb));
            s[nt][e] = p;
            if (e < 2)
              sa += p;
            else
              sb += p;
          }
#pragma unroll
        for (int x = 1; x <= 2; x <<= 1) {
          sa += __shfl_xor_sync(0xffffffffu, sa, x);
          sb += __shfl_xor_sync(0xffffffffu, sb, x);
        }
        const float aa = expf(ma - na);
        const float ab = expf(mb - nb);
        la = la * aa + sa;
        lb = lb * ab + sb;
        ma = na;
        mb = nb;
        const uint32_t pf[4] = {ptt::pack2<T>(s[0][0], s[0][1]),
                                ptt::pack2<T>(s[0][2], s[0][3]),
                                ptt::pack2<T>(s[1][0], s[1][1]),
                                ptt::pack2<T>(s[1][2], s[1][3])};
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          o[nt][0] *= aa;
          o[nt][1] *= aa;
          o[nt][2] *= ab;
          o[nt][3] *= ab;
          const T* vr = Vt + (nt * 8 + g) * VS + kt + 2 * t4;
          const uint32_t bf[2] = {ptt::ld32(vr), ptt::ld32(vr + 8)};
          ptt::mma_16816<T>(o[nt], pf, bf);
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    if (r >= R) continue;
    const float m = half ? mb : ma;
    const float l = half ? lb : la;
    if (splits == 1) {
      T* orow = out + q_row(b, C, h, kvh, group, r, D);
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        const int col = nt * 8 + 2 * t4;
        orow[col] = ptt::from_f<T>(o[nt][2 * half] / fmaxf(l, 1e-30f));
        orow[col + 1] =
            ptt::from_f<T>(o[nt][2 * half + 1] / fmaxf(l, 1e-30f));
      }
    } else {
      const long long pr =
          ((static_cast<long long>(b) * n_kv + kvh) * splits + split) * R +
          r;
      float* acc = part_acc + pr * D;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        const int col = nt * 8 + 2 * t4;
        acc[col] = o[nt][2 * half];
        acc[col + 1] = o[nt][2 * half + 1];
      }
      if (t4 == 0) {
        part_ml[pr * 2] = m;
        part_ml[pr * 2 + 1] = l;
      }
    }
  }
}

// Everything a launch needs besides the element types.
struct Args {
  const void* q;
  const void* kpool;
  const void* vpool;
  const float* kscale;  // int8 pools only, else nullptr
  const float* vscale;
  const int* page_table;
  const int* pos;
  void* out;
  float* part_acc;
  float* part_ml;
  int C, h, d, ps, L, n_kv, P_slot, layer;
  float scale;
  int splits;
};

template <typename T, typename PT, int D>
int launch_mma(const dim3& grid, int threads, cudaStream_t s, const Args& a) {
  const size_t smem = sizeof(T) * (static_cast<size_t>(a.ps) * (D + 8) +
                                    static_cast<size_t>(D) * (a.ps + 8));
  if (smem > static_cast<size_t>(kSmemMax))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_opt_in = false;
  if (!smem_opt_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_mma_kernel<T, PT, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_opt_in = true;
  }
  paged_attention_mma_kernel<T, PT, D><<<grid, threads, smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const PT*>(a.kpool),
      static_cast<const PT*>(a.vpool), a.kscale, a.vscale, a.page_table,
      a.pos, static_cast<T*>(a.out), a.part_acc, a.part_ml, a.C, a.h, a.ps,
      a.L, a.n_kv, a.P_slot, a.layer, a.scale, a.splits);
  return static_cast<int>(cudaGetLastError());
}

size_t smem_bytes(int rt, int ps, int d, int nwarps) {
  return sizeof(float) *
         (2 * static_cast<size_t>(rt) * d + static_cast<size_t>(ps) * (d + 1) +
          static_cast<size_t>(ps) * d + 2 * static_cast<size_t>(rt) +
          32 * static_cast<size_t>(nwarps));
}

// One attention launch (plus the split merge) for queries of type T over
// pools of type PT (T, or int8 with page scales).  The tensor-core kernel
// takes bf16/fp16 queries with head_dim 64 or 128, pages of a multiple
// of 16 rows and at most 128 query rows per block; everything else takes
// the CUDA-core kernel.
template <typename T, typename PT>
int run(int B, cudaStream_t s, const Args& a) {
  const int R = a.C * (a.h / a.n_kv);
  const dim3 grid(static_cast<unsigned>(a.n_kv), static_cast<unsigned>(B),
                  static_cast<unsigned>(a.splits));
  const dim3 merge_grid(static_cast<unsigned>(a.n_kv),
                        static_cast<unsigned>(B));
  const bool tensor_cores =
      !std::is_same<T, float>::value && (a.d == 64 || a.d == 128) &&
      a.ps % 16 == 0 && R <= 128 && ptt::aligned16(a.kpool) &&
      ptt::aligned16(a.vpool) &&
      (reinterpret_cast<uintptr_t>(a.q) & 3u) == 0;
  const int threads =
      tensor_cores ? 32 * max(4, (R + 15) / 16) : (R <= 4 ? 128 : 256);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  if constexpr (!std::is_same<T, float>::value) {
    if (tensor_cores)
      rc = a.d == 64 ? launch_mma<T, PT, 64>(grid, threads, s, a)
                     : launch_mma<T, PT, 128>(grid, threads, s, a);
  }
  if (!tensor_cores) {
    const int nwarps = threads / 32;
    int RT = R;
    while (RT > 1 && smem_bytes(RT, a.ps, a.d, nwarps) > kSmemBudget)
      RT = (RT + 1) / 2;
    const size_t smem = smem_bytes(RT, a.ps, a.d, nwarps);
    if (smem > static_cast<size_t>(kSmemMax))
      return static_cast<int>(cudaErrorInvalidValue);
    static bool smem_opt_in = false;
    if (!smem_opt_in) {
      const cudaError_t err = cudaFuncSetAttribute(
          paged_attention_kernel<T, PT>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_opt_in = true;
    }
    constexpr int N = ptt::Vec<PT>::N;
    const bool vec = (a.d % N == 0) && ptt::aligned16(a.kpool) &&
                     ptt::aligned16(a.vpool);
    paged_attention_kernel<T, PT><<<grid, threads, smem, s>>>(
        static_cast<const T*>(a.q), static_cast<const PT*>(a.kpool),
        static_cast<const PT*>(a.vpool), a.kscale, a.vscale, a.page_table,
        a.pos, static_cast<T*>(a.out), a.part_acc, a.part_ml, a.C, a.h, a.d,
        a.ps, a.L, a.n_kv, a.P_slot, a.layer, a.scale, RT, a.splits, vec);
    rc = static_cast<int>(cudaGetLastError());
  }
  if (rc != 0) return rc;
  if (a.splits > 1)
    paged_attention_merge<T><<<merge_grid, threads, 0, s>>>(
        a.part_acc, a.part_ml, static_cast<T*>(a.out), a.C, a.h, a.d,
        a.n_kv, a.splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pool codes: a pool of q's dtype, or int8 with scales
constexpr int kPoolSame = 0;
constexpr int kPoolInt8 = 3;

// q [B, C, h, d]; kpool/vpool [P, ps, L, n_kv, d]; page_table [B, P_slot]
// int32; pos [B] int32; out [B, C, h, d].  All contiguous.  pool ==
// kPoolSame: pools of q's dtype, k_scale/v_scale unused; pool ==
// kPoolInt8: int8 pools with k_scale/v_scale [P, L, n_kv] fp32.  splits
// > 1 divides each slot's live pages among that many blocks (grid z)
// whose partial states go to the fp32 scratch part_acc [B, n_kv, splits,
// C*h/n_kv, d] and part_ml [..., 2], merged by a second launch; splits
// == 1 writes `out` directly and takes no scratch.
extern "C" int ptt_paged_attention(int device, int dtype, int pool,
                                   const void* q, const void* kpool,
                                   const void* vpool, const void* k_scale,
                                   const void* v_scale,
                                   const void* page_table, const void* pos,
                                   void* out, void* part_acc, void* part_ml,
                                   int B, int C, int h, int d, int ps, int L,
                                   int n_kv, int P_slot, int layer,
                                   float scale, int splits, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || B > 65535 || C <= 0 || h <= 0 || n_kv <= 0 || h % n_kv ||
      d <= 0 || ps <= 0 || L <= 0 || P_slot <= 0 || layer < 0 ||
      layer >= L || splits <= 0 || splits > 65535 ||
      (splits > 1 && (part_acc == nullptr || part_ml == nullptr)) ||
      (pool != kPoolSame && pool != kPoolInt8) ||
      (pool == kPoolInt8 && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool int8 = pool == kPoolInt8;
  const Args a{q, kpool, vpool,
               int8 ? static_cast<const float*>(k_scale) : nullptr,
               int8 ? static_cast<const float*>(v_scale) : nullptr,
               static_cast<const int*>(page_table),
               static_cast<const int*>(pos), out,
               static_cast<float*>(part_acc), static_cast<float*>(part_ml),
               C, h, d, ps, L, n_kv, P_slot, layer, scale, splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH(dtype, T, {
    return int8 ? run<T, int8_t>(B, s, a) : run<T, T>(B, s, a);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}
