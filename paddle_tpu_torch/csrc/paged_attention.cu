// Paged decode / chunked-prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel
// paddle_tpu/ops/pallas/paged_attention.py::paged_attention (:108) ->
// _kernel (:53): queries q [B, C, h, d] of slot b attend the K/V rows
// of that slot's pages in the shared pools [P, ps, L, n_kv, d], found
// through page_table [B, P_slot]; query lane c sits at global position
// pos[b] + c and sees key rows j*ps + t <= pos[b] + c.  GQA: query
// head hq reads kv head hq // group, so the blocks of kv head kvh serve
// query heads kvh*group .. kvh*group + group-1; query row r = c*group + g
// is lane c = r // group of query head kvh*group + g
// (paged_attention.py:86-87).  fp32 scores and online softmax; the
// softmax weights P are rounded to q's dtype before P.V; the output is
// rounded once.
//
// int8 pools (the TPU kernel's quant branch, :77-80): the pools hold
// int8 and k_scale/v_scale [P, L, n_kv] fp32 hold one scale per page,
// layer and kv head.  Each value is dequantized as
// __fmul_rn((float)q, scale) and rounded to q's dtype T, bit for bit as
// the plain version's `dequant_pages(...).to(q.dtype)`.
//
// What bounds it on the H100: bytes.  One query row does 4*d flops per
// key row against 4*d bytes of bf16 K and V, so a block does R = C*group
// flops a byte: 1-8 at decode, 32-128 at an admission chunk, far under
// the ~295 at which the tensor cores would limit.  The least time is the
// live K/V rows of every (slot, kv head) plus q and the output over
// 3.35 TB/s.  What the design does about it:
//
//   * The plan (paged_attention_plan.cuh, from shapes and the card's SM
//     count, never from pos; ptt_paged_attention_plan reports it to the
//     wrapper, which sizes the scratch by it): every block walks at most
//     `chunk` pages — 512 keys (1024 past 64 query rows a block, 128-256
//     when a full table would give fewer than two blocks an SM).  Grid
//     (n_kv * row tiles, B, splits = ceil(P_slot / chunk)); block z of
//     slot b takes pages [z*chunk, z*chunk + chunk) cut at the slot's
//     frontier (pos[b] + C - 1) // ps, the TPU kernel's clamped index
//     map (paged_attention.py:142-146).  A block whose pages all lie past
//     the frontier exits at once, and no block reads a page past it.  A
//     slot whose frontier lies in its first chunk is written to `out` by
//     that one block.  A longer slot's blocks leave their un-normalised
//     (max, sum, acc) in fp32 scratch and count themselves on the
//     counter of their (slot, kv head, row tile); the last to arrive
//     merges only the splits that hold work, in split order, and re-arms
//     the counter (merge_if_last: one launch, and two launches on the
//     same inputs give bit-identical outputs).  So the counters are zero
//     between launches, and two launches may share them only if one
//     ends before the other starts (one stream).
//   * The tensor-core body (bf16/fp16 q, head_dim 64 or 128, 16-byte
//     aligned pools, any page size, any number of query rows):
//     - each block loads its page indices (and an int8 pool's scales)
//       once into shared memory, then streams its keys through a ring of
//       kStages = 2 stages of kKeys = 64 keys (4 pages of 16 rows) with
//       16-byte cp.async.cg: the next stage's bytes are in flight while
//       one is consumed, one __syncthreads a stage.  Two stages, not
//       three, because three blocks an SM (70 KB each at bf16, d 128)
//       hid the latency better than two with deeper rings (measured);
//     - K and V land row-major as they are in the pool: the S = Q.K^T
//       B fragments come from ldmatrix.x4 and the P.V B fragments from
//       ldmatrix.x4.trans (no transposing stores);
//     - an int8 stage lands as raw bytes (no dequantization in the
//       loading threads); once it has landed, the block dequantizes it
//       once, 16 bytes a thread, into a 16-bit K and V tile that every
//       row group reads through the same ldmatrix path, while the next
//       stage's bytes are in flight (one more barrier a stage).  The
//       int-to-float step is a byte permute into 2^23's mantissa and an
//       exact subtraction, off the conversion unit's eighth rate.
//       (Dequantizing in each warp's registers as it reads costs a pass
//       per 16-row group, and measured slower even at decode);
//     - mma.sync m16n8k16 with fp32 accumulators; a warp owns 16 query
//       rows; with R <= 16 rows (decode) the block's four warps take
//       a quarter of each stage's keys each, with R <= 32 two warps
//       share each 16-row group, and the warps' (max, sum, acc) are
//       merged in shared memory in warp order at the end, so no warp
//       idles; R > 128 rows take more blocks (row tiles) and read the
//       pages again;
//     - the causal mask is applied only to stages that reach past the
//       first lane's position or the block's last key.
//   * The CUDA-core body (fp32 pools, other head dims, unaligned pools)
//     keeps the first design: a page's K and V tiles in fp32 shared
//     memory, K rows padded to d+1, a lane per key for the scores, lanes
//     over output dims for P.V, (max, sum, acc) in shared memory, query
//     rows beyond the shared-memory budget in row tiles.  It follows the
//     same plan and merge.
//   * The body is chosen by shape (body_of, which the C entry
//     ptt_paged_attention_body reports): deterministic, never a reaction
//     to an error.
//   * masking is by position only (kpos <= qpos), never by page
//     content: free slots point at the null page 0, whose rows are junk.
//     Key row 0 is visible to every query (qpos >= 0), so every row has
//     at least one valid key in the slot's first split and the
//     normaliser is positive.
#include <type_traits>

#include "common.cuh"
#include "paged_attention_plan.cuh"

namespace {

constexpr int kSmemMax = 232448;     // H100 opt-in limit per block
constexpr int kSmemBudget = 163840;  // what a CUDA-core launch plans to use

// the tensor-core body's ring: keys a stage, stages; query rows a block
// (the plan's row tile)
constexpr int kKeys = 64;
constexpr int kStages = 2;
using ptt_paged::kRowTile;

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

// The slot's frontier: the last key row any of its C lanes sees, cut at
// the table's capacity.
__device__ __forceinline__ int frontier(int p0, int C, int ps, int P_slot) {
  return min(max(p0 + C - 1, 0), P_slot * ps - 1);
}

// Merges elements [e0, n) of a slot's rows, K a thread at once (element e
// is row r_begin + e / d, column e % d): each split's loads of all K are
// in flight together, since the merge reads from L2 and is bound by its
// latency.  Splits in split order.
template <typename T, int K>
__device__ void merge_items(const float* __restrict__ part_acc,
                            const float* __restrict__ part_ml,
                            T* __restrict__ out, int nb, int b, int kvh,
                            int C, int h, int d, int group, int R,
                            long long base, int r_begin, int n) {
  const int NT = blockDim.x;
  for (int e0 = threadIdx.x; e0 < n; e0 += K * NT) {
    int row[K], col[K];
    float m[K], l[K], a[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int e = min(e0 + k * NT, n - 1);  // past n: a repeat, unstored
      row[k] = r_begin + e / d;
      col[k] = e - (row[k] - r_begin) * d;
      m[k] = -1e30f;
      l[k] = a[k] = 0.f;
    }
#pragma unroll 4
    for (int s = 0; s < nb; ++s) {
      const long long sr = base + static_cast<long long>(s) * R;
#pragma unroll
      for (int k = 0; k < K; ++k)
        m[k] = fmaxf(m[k], __ldcg(part_ml + (sr + row[k]) * 2));
    }
#pragma unroll 4
    for (int s = 0; s < nb; ++s) {
      const long long sr = base + static_cast<long long>(s) * R;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float2 ml =
            __ldcg(reinterpret_cast<const float2*>(part_ml) + sr + row[k]);
        const float w = expf(ml.x - m[k]);
        l[k] = fmaf(ml.y, w, l[k]);
        a[k] = fmaf(__ldcg(part_acc + (sr + row[k]) * d + col[k]), w, a[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (e0 + k * NT >= n) break;
      const int c = row[k] / group;
      const int g = row[k] - c * group;
      out[((static_cast<long long>(b) * C + c) * h + kvh * group + g) * d +
          col[k]] = ptt::from_f<T>(a[k] / fmaxf(l[k], 1e-30f));
    }
  }
}

// Called by every block of a slot that holds work, after it wrote its
// partial state (rows [r_begin, r_end)): the block that arrives last at
// the slot's counter merges the nb splits that hold work in split order
// — rescale every split's accumulator and normaliser to the common
// running max, sum, divide — and re-arms the counter for the next
// launch.  The order is fixed, so the result does not depend on which
// block arrives last.
template <typename T>
__device__ void merge_if_last(const float* __restrict__ part_acc,
                              const float* __restrict__ part_ml,
                              T* __restrict__ out, int* __restrict__ counter,
                              int nb, int b, int kvh, int C, int h, int d,
                              int n_kv, int splits, int r_begin, int r_end) {
  __threadfence();
  __syncthreads();
  // (no static shared memory: the kernels opt in to all of it)
  if (!__syncthreads_or(threadIdx.x == 0 && atomicAdd(counter, 1) == nb - 1))
    return;
  __threadfence();
  const int group = h / n_kv;
  const int R = C * group;
  const long long base =
      (static_cast<long long>(b) * n_kv + kvh) * splits * R;
  const int n = (r_end - r_begin) * d;
  // elements a thread: one at decode, up to 16 for a chunk's rows
  if (n <= static_cast<int>(blockDim.x))
    merge_items<T, 1>(part_acc, part_ml, out, nb, b, kvh, C, h, d, group, R,
                      base, r_begin, n);
  else if (n <= 4 * static_cast<int>(blockDim.x))
    merge_items<T, 4>(part_acc, part_ml, out, nb, b, kvh, C, h, d, group, R,
                      base, r_begin, n);
  else
    merge_items<T, 16>(part_acc, part_ml, out, nb, b, kvh, C, h, d, group,
                       R, base, r_begin, n);
  if (threadIdx.x == 0) *counter = 0;
}

template <typename T, typename PT>
__global__ void paged_attention_kernel(
    const T* __restrict__ q, const PT* __restrict__ kpool,
    const PT* __restrict__ vpool, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ page_table,
    const int* __restrict__ pos, T* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml,
    int* __restrict__ counters, int C, int h, int d, int ps, int L,
    int n_kv, int P_slot, int layer, float scale, int RT, int chunk,
    int splits, bool vec) {
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
  const int last = frontier(p0, C, ps, P_slot) / ps;
  // this block's pages [j_begin, j_end); none past the frontier
  const int j_begin = split * chunk;
  if (j_begin > last) return;
  const int j_end = min(last + 1, j_begin + chunk);
  const bool direct = last < chunk;   // the slot's only split
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

    if (direct) {
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
      // un-normalised partial state of this split, merged by the
      // slot's last block
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
  if (!direct)
    merge_if_last(part_acc, part_ml, out,
                  counters + static_cast<long long>(b) * n_kv + kvh,
                  last / chunk + 1, b, kvh, C, h, d, n_kv, splits, 0, R);
}

// Offset of query row r (= c*group + g) of kv head kvh, slot b, in q/out.
__device__ __forceinline__ long long q_row(int b, int C, int h, int kvh,
                                           int group, int r, int d) {
  const int c = r / group;
  const int g = r - c * group;
  return ((static_cast<long long>(b) * C + c) * h + kvh * group + g) * d;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, L2 only; src_bytes 0 writes 16 zero bytes
// and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// two floats rounded to nearest T, `lo` in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  uint32_t u;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    memcpy(&u, &v, 4);
  } else {
    const __half2 v = __floats2half2_rn(lo, hi);
    memcpy(&u, &v, 4);
  }
  return u;
}

// byte i of x = w ^ 0x80808080 (each int8 byte of w offset by 128) as
// the float of the int8 value, dequantized (not yet rounded): the byte
// becomes the low mantissa byte of 2^23 (one byte permute), and 2^23 +
// 128 is subtracted exactly — the integer-to-float conversion unit runs
// at an eighth of the FMA rate
__device__ __forceinline__ float deq(uint32_t x, int i, float sc) {
  const float f =
      __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540u + i)) - 8388736.f;
  return __fmul_rn(f, sc);
}

// Shared-memory geometry of a ring stage: kKeys rows of K, then kKeys
// rows of V, each row as the pool holds it (d elements of PT).  16-bit
// rows are padded by 16 bytes so that the 8 rows an ldmatrix reads fall 4
// banks apart; an int8 stage is read once, 16 contiguous bytes a thread,
// and dequantized into a 16-bit K and V tile at that padded stride.
template <typename PT, int D>
struct Ring {
  static constexpr bool kQ8 = std::is_same<PT, int8_t>::value;
  static constexpr int kChunks = D * static_cast<int>(sizeof(PT)) / 16;
  static constexpr int kStride16 = 2 * D + 16;  // what ldmatrix reads
  static constexpr int kStride = kQ8 ? D : kStride16;
  static constexpr int kStageBytes = 2 * kKeys * kStride;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kStagedBytes = kQ8 ? 2 * kKeys * kStride16 : 0;
};

// Shared memory of a tensor-core launch: the ring, an int8 pool's 16-bit
// tile, the page indices and an int8 pool's two scales per page; the
// warps' partial states reuse the ring at the end.
template <typename PT, int D>
size_t ring_smem(int chunk, int warps, int kw) {
  using G = Ring<PT, D>;
  const size_t ring = G::kRingBytes + G::kStagedBytes +
                      static_cast<size_t>(chunk) * sizeof(int) *
                          (G::kQ8 ? 3 : 1);
  const size_t merge =
      kw > 1 ? static_cast<size_t>(warps) * 16 * (D + 2) * sizeof(float) : 0;
  return ring > merge ? ring : merge;
}

// The tensor-core body.  Block (kvh * tiles + tile, b, split): query
// rows [tile * 128, +128) of kv head kvh, slot b; warps = row groups of
// 16 (wr) x KW key groups (wk).  Warp (wr, wk) takes keys [wk * 64/KW,
// +64/KW) of every stage for its 16 rows.
// Four-warp blocks (KW 4 and 2) are held to 170 registers, three blocks
// an SM; eight-warp blocks (KW 1) take what they need, one an SM.
template <typename T, typename PT, int D, int KW>
__global__ void __launch_bounds__(KW == 1 ? 256 : 128, KW == 1 ? 1 : 3)
    paged_attention_ring_kernel(
    const T* __restrict__ q, const PT* __restrict__ kpool,
    const PT* __restrict__ vpool, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ page_table,
    const int* __restrict__ pos, T* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml,
    int* __restrict__ counters, int C, int h, int ps, int L, int n_kv,
    int P_slot, int layer, float scale, int chunk, int splits, int tiles) {
  using G = Ring<PT, D>;
  constexpr int S16 = G::kStride16;
  constexpr int kw = KW;
  constexpr int NK = kKeys / KW;        // keys a warp takes of a stage
  constexpr int NS = NK / 8;            // their n-tiles of S
  const int kvh = blockIdx.x / tiles;
  const int r0 = (blockIdx.x - kvh * tiles) * kRowTile;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int group = h / n_kv;
  const int R = C * group;
  const int tid = threadIdx.x;
  const int NT = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wr = warp / kw;
  const int wk = warp - wr * kw;

  extern __shared__ uint4 smem_ring[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem_ring);
  uint8_t* k16 = ring + G::kRingBytes;            // int8 pools only
  uint8_t* v16 = k16 + kKeys * S16;
  int* spage =
      reinterpret_cast<int*>(ring + G::kRingBytes + G::kStagedBytes);
  float* sksc = reinterpret_cast<float*>(spage + chunk);
  float* svsc = sksc + chunk;

  // the slot's position and this block's first page indices, together
  const int j0 = split * chunk;
  const int* pt = page_table + static_cast<long long>(b) * P_slot;
  const int pid0 =
      tid < chunk && j0 + tid < P_slot ? __ldg(pt + j0 + tid) : 0;
  const int p0 = __ldg(pos + b);
  const int kmax = frontier(p0, C, ps, P_slot);
  const int last = kmax / ps;
  if (j0 > last) return;
  const int npages = min(last + 1, j0 + chunk) - j0;
  const int kb = j0 * ps;                        // keys [kb, ke)
  const int ke = min((j0 + npages) * ps, kmax + 1);
  const int nst = (ke - kb + kKeys - 1) / kKeys;
  const bool direct = last < chunk;              // the slot's only split

  // this warp's query rows ra and rb = ra + 8 (fragment rows g, g + 8)
  const int ra = r0 + wr * 16 + g;
  const int rb = ra + 8;
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

  if (tid < npages) spage[tid] = pid0;
  for (int t = tid + NT; t < npages; t += NT) spage[t] = __ldg(pt + j0 + t);
  __syncthreads();

  const long long row_stride = static_cast<long long>(L) * n_kv * D;
  const long long page_stride = static_cast<long long>(ps) * row_stride;
  const long long head_off =
      (static_cast<long long>(layer) * n_kv + kvh) * D;
  // this thread's 16-byte chunk of a row and its rows of a stage
  const int cc = tid % G::kChunks;
  const int lrow0 = tid / G::kChunks;
  const int rstep = NT / G::kChunks;
  auto issue = [&](int st) {
    uint8_t* kd = ring + (st % kStages) * G::kStageBytes;
    uint8_t* vd = kd + kKeys * G::kStride;
    const int ks0 = kb + st * kKeys;
    for (int row = lrow0; row < kKeys; row += rstep) {
      const int key = ks0 + row;
      const bool ok = key < ke;
      long long off = 0;
      if (ok) {
        const int j = key / ps;
        off = static_cast<long long>(spage[j - j0]) * page_stride +
              static_cast<long long>(key - j * ps) * row_stride + head_off +
              cc * (16 / static_cast<int>(sizeof(PT)));
      }
      cp_async16(smem_addr(kd + row * G::kStride + cc * 16), kpool + off,
                 ok ? 16 : 0);
      cp_async16(smem_addr(vd + row * G::kStride + cc * 16), vpool + off,
                 ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nst) issue(st);
    cp_async_commit();
  }
  if constexpr (G::kQ8) {
    for (int t = tid; t < npages; t += NT) {
      const long long sp =
          (static_cast<long long>(spage[t]) * L + layer) * n_kv + kvh;
      sksc[t] = __ldg(kscale + sp);
      svsc[t] = __ldg(vscale + sp);
    }
  }

  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float ma = -1e30f, mb = -1e30f, la = 0.f, lb = 0.f;
  const int qpa = p0 + ra / group;
  const int qpb = p0 + rb / group;
  // ldmatrix row addresses of this lane: K (keys (l/16)*8 + l%8, dims
  // ((l/8)%2)*8), V (keys ((l/8)%2)*8 + l%8, n-tile l/16)
  const uint32_t k_lane =
      ((lane >> 4) * 8 + (lane & 7)) * S16 + ((lane >> 3) & 1) * 16;
  const uint32_t v_lane =
      (((lane >> 3) & 1) * 8 + (lane & 7)) * S16 + (lane >> 4) * 16;

  for (int st = 0; st < nst; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                    // stage st landed; st - 1 consumed
    if (st + kStages - 1 < nst) issue(st + kStages - 1);
    cp_async_commit();
    const uint8_t* kd = ring + (st % kStages) * G::kStageBytes;
    const uint8_t* vd = kd + kKeys * G::kStride;
    if constexpr (G::kQ8) {
      // the block dequantizes the landed int8 stage once, 16 bytes a
      // step, into the 16-bit K and V tiles every row group reads
      constexpr int CH = D / 16;
      const int ks0 = kb + st * kKeys;
      for (int e = tid; e < 2 * kKeys * CH; e += NT) {
        const bool isv = e >= kKeys * CH;
        const int re = isv ? e - kKeys * CH : e;
        const int row = re / CH;
        const int c = re - row * CH;
        const float sc = (isv ? svsc : sksc)[min((ks0 + row) / ps - j0,
                                                 npages - 1)];
        const uint4 raw = *reinterpret_cast<const uint4*>(
            (isv ? vd : kd) + row * G::kStride + c * 16);
        const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u,
                               raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
        uint32_t o16[8];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          o16[2 * u] = pack2f<T>(deq(w[u], 0, sc), deq(w[u], 1, sc));
          o16[2 * u + 1] = pack2f<T>(deq(w[u], 2, sc), deq(w[u], 3, sc));
        }
        uint4* dst =
            reinterpret_cast<uint4*>((isv ? v16 : k16) + row * S16 + c * 32);
        dst[0] = make_uint4(o16[0], o16[1], o16[2], o16[3]);
        dst[1] = make_uint4(o16[4], o16[5], o16[6], o16[7]);
      }
      __syncthreads();
      kd = k16;
      vd = v16;
    }
    // this warp's NK keys of the stage: [key0, key0 + NK)
    const int key0 = kb + st * kKeys + wk * NK;
    if (key0 >= ke) continue;           // past the block's last key
    const int row0 = wk * NK;           // their first row in the stage
    const bool masked = key0 + NK > min(ke, p0 + 1);
    float s[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const uint32_t kaddr = smem_addr(kd) + row0 * S16 + k_lane;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        uint32_t bk[4];
        ldsm_x4(bk, kaddr + j * 16 * S16 + ks * 32);
        ptt::mma_16816<T>(s[2 * j], qf[ks], bk);
        ptt::mma_16816<T>(s[2 * j + 1], qf[ks], bk + 2);
      }
    float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + nt * 8 + 2 * t4 + (e & 1);
        const bool ok = !masked || (key < ke && key <= (e < 2 ? qpa : qpb));
        s[nt][e] = ok ? s[nt][e] * scale : -INFINITY;
        if (e < 2)
          mxa = fmaxf(mxa, s[nt][e]);
        else
          mxb = fmaxf(mxb, s[nt][e]);
      }
    // the four lanes of a quad hold one row's scores
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, x));
      mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, x));
    }
    const float na = fmaxf(ma, mxa);
    const float nb = fmaxf(mb, mxb);
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
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
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      o[nt][0] *= aa;
      o[nt][1] *= aa;
      o[nt][2] *= ab;
      o[nt][3] *= ab;
    }
    // O += P.V over the warp's keys, 16 at a time
#pragma unroll
    for (int j = 0; j < NS / 2; ++j) {
      const uint32_t pf[4] = {pack2f<T>(s[2 * j][0], s[2 * j][1]),
                              pack2f<T>(s[2 * j][2], s[2 * j][3]),
                              pack2f<T>(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack2f<T>(s[2 * j + 1][2], s[2 * j + 1][3])};
      const uint32_t vaddr = smem_addr(vd) + (row0 + 16 * j) * S16 + v_lane;
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vaddr + jj * 32);
        ptt::mma_16816<T>(o[2 * jj], pf, bv);
        ptt::mma_16816<T>(o[2 * jj + 1], pf, bv + 2);
      }
    }
  }

  // output column of accumulator element (nt, e & 1)
  auto ocol = [&](int nt, int e1) { return nt * 8 + 2 * t4 + e1; };
  auto part_row = [&](int r) {
    return ((static_cast<long long>(b) * n_kv + kvh) * splits + split) * R +
           r;
  };
  if (kw == 1) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? rb : ra;
      if (r >= R) continue;
      const float m = half ? mb : ma;
      const float l = fmaxf(half ? lb : la, 1e-30f);
      if (direct) {
        T* orow = out + q_row(b, C, h, kvh, group, r, D);
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          orow[ocol(nt, 0)] = ptt::from_f<T>(o[nt][2 * half] / l);
          orow[ocol(nt, 1)] = ptt::from_f<T>(o[nt][2 * half + 1] / l);
        }
      } else {
        const long long pr = part_row(r);
        float* acc = part_acc + pr * D;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          acc[ocol(nt, 0)] = o[nt][2 * half];
          acc[ocol(nt, 1)] = o[nt][2 * half + 1];
        }
        if (t4 == 0) {
          part_ml[pr * 2] = m;
          part_ml[pr * 2 + 1] = half ? lb : la;
        }
      }
    }
  } else {
    // kw > 1: the warps of a row group merge their states in warp order
    cp_async_wait<0>();
    __syncthreads();                      // every warp is done with the ring
    float* so = reinterpret_cast<float*>(ring);          // [warps][16][D]
    float* sml = so + (NT >> 5) * 16 * D;                // [warps][16][2]
    {
      float* ow = so + warp * 16 * D;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        ow[g * D + ocol(nt, 0)] = o[nt][0];
        ow[g * D + ocol(nt, 1)] = o[nt][1];
        ow[(g + 8) * D + ocol(nt, 0)] = o[nt][2];
        ow[(g + 8) * D + ocol(nt, 1)] = o[nt][3];
      }
      if (t4 == 0) {
        float* mw = sml + warp * 32;
        mw[g * 2] = ma;
        mw[g * 2 + 1] = la;
        mw[(g + 8) * 2] = mb;
        mw[(g + 8) * 2 + 1] = lb;
      }
    }
    __syncthreads();
    const int rw = (NT >> 5) / kw;
    for (int e = tid; e < rw * 16 * D; e += NT) {
      const int lr = e / D;               // row of the tile
      const int i = e - lr * D;
      const int r = r0 + lr;
      if (r >= R) continue;
      const int w0 = (lr >> 4) * kw;      // the row group's first warp
      const int rr = lr & 15;
      float m = -1e30f;
      for (int k = 0; k < kw; ++k) m = fmaxf(m, sml[(w0 + k) * 32 + rr * 2]);
      float l = 0.f, a = 0.f;
      for (int k = 0; k < kw; ++k) {
        const float wgt = expf(sml[(w0 + k) * 32 + rr * 2] - m);
        l = fmaf(sml[(w0 + k) * 32 + rr * 2 + 1], wgt, l);
        a = fmaf(so[((w0 + k) * 16 + rr) * D + i], wgt, a);
      }
      if (direct) {
        out[q_row(b, C, h, kvh, group, r, D) + i] =
            ptt::from_f<T>(a / fmaxf(l, 1e-30f));
      } else {
        const long long pr = part_row(r);
        part_acc[pr * D + i] = a;
        if (i == 0) {
          part_ml[pr * 2] = m;
          part_ml[pr * 2 + 1] = l;
        }
      }
    }
  }
  if (!direct)
    merge_if_last(part_acc, part_ml, out,
                  counters + (static_cast<long long>(b) * n_kv + kvh) * tiles +
                      (r0 / kRowTile),
                  last / chunk + 1, b, kvh, C, h, D, n_kv, splits, r0,
                  min(R, r0 + kRowTile));
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
  int* counters;
  int C, h, d, ps, L, n_kv, P_slot, layer;
  float scale;
  int chunk, splits;
};

// The tensor-core body's warps: row groups of 16 over at most 128 rows,
// and key groups so that a block has at least 4 warps where it has at
// most 2 row groups.
void ring_warps(int R, int* warps, int* kw) {
  const int rows = R < kRowTile ? R : kRowTile;
  const int rw = (rows + 15) / 16;
  *kw = rw == 1 ? 4 : rw == 2 ? 2 : 1;
  *warps = rw * *kw;
}

template <typename T, typename PT, int D, int KW>
int launch_ring_kw(int B, cudaStream_t s, const Args& a, int tiles,
                   int warps) {
  const size_t smem = ring_smem<PT, D>(a.chunk, warps, KW);
  if (smem > static_cast<size_t>(kSmemMax))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_opt_in = false;
  if (!smem_opt_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_ring_kernel<T, PT, D, KW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_opt_in = true;
  }
  const dim3 grid(static_cast<unsigned>(a.n_kv * tiles),
                  static_cast<unsigned>(B), static_cast<unsigned>(a.splits));
  paged_attention_ring_kernel<T, PT, D, KW><<<grid, 32 * warps, smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const PT*>(a.kpool),
      static_cast<const PT*>(a.vpool), a.kscale, a.vscale, a.page_table,
      a.pos, static_cast<T*>(a.out), a.part_acc, a.part_ml, a.counters, a.C,
      a.h, a.ps, a.L, a.n_kv, a.P_slot, a.layer, a.scale, a.chunk, a.splits,
      tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename PT, int D>
int launch_ring(int B, cudaStream_t s, const Args& a) {
  const int R = a.C * (a.h / a.n_kv);
  const int tiles = (R + kRowTile - 1) / kRowTile;
  int warps, kw;
  ring_warps(R, &warps, &kw);
  if (static_cast<long long>(a.n_kv) * tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  return kw == 4   ? launch_ring_kw<T, PT, D, 4>(B, s, a, tiles, warps)
         : kw == 2 ? launch_ring_kw<T, PT, D, 2>(B, s, a, tiles, warps)
                   : launch_ring_kw<T, PT, D, 1>(B, s, a, tiles, warps);
}

size_t smem_bytes(int rt, int ps, int d, int nwarps) {
  return sizeof(float) *
         (2 * static_cast<size_t>(rt) * d + static_cast<size_t>(ps) * (d + 1) +
          static_cast<size_t>(ps) * d + 2 * static_cast<size_t>(rt) +
          32 * static_cast<size_t>(nwarps));
}

template <typename T, typename PT>
int launch_cuda_core(int B, cudaStream_t s, const Args& a) {
  const int R = a.C * (a.h / a.n_kv);
  const int threads = R <= 4 ? 128 : 256;
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
  const dim3 grid(static_cast<unsigned>(a.n_kv), static_cast<unsigned>(B),
                  static_cast<unsigned>(a.splits));
  paged_attention_kernel<T, PT><<<grid, threads, smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const PT*>(a.kpool),
      static_cast<const PT*>(a.vpool), a.kscale, a.vscale, a.page_table,
      a.pos, static_cast<T*>(a.out), a.part_acc, a.part_ml, a.counters, a.C,
      a.h, a.d, a.ps, a.L, a.n_kv, a.P_slot, a.layer, a.scale, RT, a.chunk,
      a.splits, vec);
  return static_cast<int>(cudaGetLastError());
}

// pool codes: a pool of q's dtype, or int8 with scales
constexpr int kPoolSame = 0;
constexpr int kPoolInt8 = 3;

// bodies: 1 the tensor-core ring body, 0 the CUDA-core body
constexpr int kBodyCudaCore = 0;
constexpr int kBodyRing = 1;

// The body a launch takes, from dtype, head_dim and alignment alone:
// bf16/fp16 queries with head_dim 64 or 128 over 16-byte aligned pools
// (so every pool row is) and 4-byte aligned q take the ring body; fp32
// and everything else the CUDA-core body.
int body_of(int dtype, int d, const void* q, const void* kpool,
            const void* vpool) {
  return dtype != ptt::kF32 && (d == 64 || d == 128) &&
                 ptt::aligned16(kpool) && ptt::aligned16(vpool) &&
                 (reinterpret_cast<uintptr_t>(q) & 3u) == 0
             ? kBodyRing
             : kBodyCudaCore;
}

// One attention launch for queries of type T over pools of type PT (T,
// or int8 with page scales), the body by shape.
template <typename T, typename PT>
int run(int B, int dtype, cudaStream_t s, const Args& a) {
  if (body_of(dtype, a.d, a.q, a.kpool, a.vpool) == kBodyRing) {
    if constexpr (!std::is_same<T, float>::value)
      return a.d == 64 ? launch_ring<T, PT, 64>(B, s, a)
                       : launch_ring<T, PT, 128>(B, s, a);
  }
  return launch_cuda_core<T, PT>(B, s, a);
}

}  // namespace

// The body ptt_paged_attention takes for these operands (1 ring, 0
// CUDA-core); -1 for an unknown pool code.
extern "C" int ptt_paged_attention_body(int dtype, int pool, int d,
                                        const void* q, const void* kpool,
                                        const void* vpool) {
  if (pool != kPoolSame && pool != kPoolInt8) return -1;
  return body_of(dtype, d, q, kpool, vpool);
}

// The plan of a launch on `device` (paged_attention_plan.cuh): writes
// {chunk, splits, counters} to plan[0..2].  With splits > 1 the launch
// takes fp32 scratch part_acc [B, n_kv, splits, R, d] and part_ml [...,
// 2] and `counters` int32 merge counters that are zero.
extern "C" int ptt_paged_attention_plan(int device, int B, int n_kv, int R,
                                        int P_slot, int ps, void* plan) {
  if (B <= 0 || n_kv <= 0 || R <= 0 || P_slot <= 0 || ps <= 0 ||
      plan == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int sms = ptt::sm_count(device);
  if (sms < 0) return -sms;
  const long long tiles = (R + kRowTile - 1) / kRowTile;
  if (static_cast<long long>(B) * n_kv * tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const ptt_paged::Plan p =
      ptt_paged::plan(B, n_kv, R, P_slot, ps, sms);
  int* out = static_cast<int*>(plan);
  out[0] = p.chunk;
  out[1] = p.splits;
  out[2] = p.counters;
  return 0;
}

// q [B, C, h, d]; kpool/vpool [P, ps, L, n_kv, d]; page_table [B, P_slot]
// int32; pos [B] int32; out [B, C, h, d].  All contiguous.  pool ==
// kPoolSame: pools of q's dtype, k_scale/v_scale unused; pool ==
// kPoolInt8: int8 pools with k_scale/v_scale [P, L, n_kv] fp32.  Each
// block walks at most `chunk` pages of its slot (the plan's), so splits
// = ceil(P_slot / chunk) blocks (grid z) cover a slot; with splits > 1
// the partial states of slots longer than one chunk go to the fp32
// scratch part_acc [B, n_kv, splits, C*h/n_kv, d] and part_ml [..., 2]
// and are merged by each slot's last block, through the plan's zeroed
// `counters`, which the launch leaves zero (launches that share them run
// one after another on one stream); splits == 1 takes no scratch.
extern "C" int ptt_paged_attention(int device, int dtype, int pool,
                                   const void* q, const void* kpool,
                                   const void* vpool, const void* k_scale,
                                   const void* v_scale,
                                   const void* page_table, const void* pos,
                                   void* out, void* part_acc, void* part_ml,
                                   void* counters, int B, int C, int h,
                                   int d, int ps, int L,
                                   int n_kv, int P_slot, int layer,
                                   float scale, int chunk, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || B > 65535 || C <= 0 || h <= 0 || n_kv <= 0 || h % n_kv ||
      d <= 0 || ps <= 0 || L <= 0 || P_slot <= 0 || layer < 0 ||
      layer >= L || chunk <= 0 || (P_slot + chunk - 1) / chunk > 65535 ||
      (pool != kPoolSame && pool != kPoolInt8) ||
      (pool == kPoolInt8 && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = (P_slot + chunk - 1) / chunk;
  if (splits > 1 &&
      (part_acc == nullptr || part_ml == nullptr || counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool int8 = pool == kPoolInt8;
  const Args a{q, kpool, vpool,
               int8 ? static_cast<const float*>(k_scale) : nullptr,
               int8 ? static_cast<const float*>(v_scale) : nullptr,
               static_cast<const int*>(page_table),
               static_cast<const int*>(pos), out,
               static_cast<float*>(part_acc), static_cast<float*>(part_ml),
               static_cast<int*>(counters), C, h, d, ps, L, n_kv, P_slot,
               layer, scale, chunk, splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH(dtype, T, {
    return int8 ? run<T, int8_t>(B, dtype, s, a) : run<T, T>(B, dtype, s, a);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}
