// Hopper (sm_90a) building blocks of the hand-written kernels: TMA
// tensor maps and loads, mbarriers, wgmma shared-memory descriptors and
// products, and register rebalancing between warpgroups (PTX ISA 8.x).
//
// Operand tiles live in shared memory as TMA writes them with 128-byte
// swizzle: rows of 64 16-bit elements (128 bytes), 8-row atoms of 1024
// bytes, a tile wider than 64 elements stored as consecutive 64-wide
// column blocks.  The tile base must be 1024-byte aligned.
//   K-major operand (the reduced dimension contiguous, e.g. Q or K
//   rows against d): descriptor LBO unused, SBO = 1024 (next 8 rows);
//   the k-th 16-element step starts 32 k bytes into the row, the fifth
//   in the next column block.
//   MN-major operand (the output dimension contiguous, e.g. V as the B
//   of P.V, whose reduced dimension is the key): LBO = the column
//   block's size in bytes (next 64 outputs), SBO = 1024 (next 8 rows of
//   the reduced dimension); the k-th step starts 16 k rows down.
// A block of a thread-block cluster reaches the other blocks' shared
// memory through `map_rank` addresses (distributed shared memory).
#pragma once

#include <cuda.h>   // CUtensorMap and its enums: types only, libcuda is
                    // reached through cudaGetDriverEntryPoint, not linked

#include "common.cuh"

namespace ptt {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// named barrier `id` (1-15) between two warpgroups: one syncs, the other
// arrives
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// 2^x in one MUFU instruction (results below 2^-126 flush to 0)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -- TMA ---------------------------------------------------------------------
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

// a plain bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from device memory, completing on `bar`'s transaction count
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// -- clusters ----------------------------------------------------------------
// every thread of every block of the cluster arrives, then waits; writes
// to shared memory before it are seen by the cluster's reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::
          : "memory");
}

// cluster_sync split in two: arrive (relaxed: it orders no memory) as
// soon as the block starts, wait before the first store to another
// block's shared memory, which then exists
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// the address in block `rank`'s shared memory of the variable at this
// block's shared address `addr`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// a store to another block's shared memory (posted: it does not wait)
__device__ __forceinline__ void st_cluster_f4(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void st_cluster_f2(uint32_t addr, float2 v) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr),
               "f"(v.x), "f"(v.y)
               : "memory");
}

// -- warpgroup registers -----------------------------------------------------
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// -- wgmma -------------------------------------------------------------------
// shared-memory matrix descriptor of a 128-byte-swizzled tile at `addr`
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// descriptor of the kk-th 16-element k step of a K-major tile of `rows`
// rows (row r holds the reduced dimension)
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int rows, int kk) {
  return desc_sw128(tile + (kk >> 2) * rows * 128 + (kk & 3) * 32, 16, 1024);
}

// descriptor of the kk-th 16-row k step of an MN-major tile of `rows`
// rows (row r is the r-th element of the reduced dimension)
__device__ __forceinline__ uint64_t mdesc(uint32_t tile, int rows, int kk) {
  return desc_sw128(tile + kk * 2048, rows * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from touching registers of an asynchronous product
// across wgmma_wait: reads of `r` stay after it.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x N] (+)= A[64 x 16] . B[16 x N] for one warpgroup, fp32
// accumulators: thread (warp w, lane 4g + t) holds d[4j + e] = D[16w + g
// + 8 (e >> 1)][8j + 2t + (e & 1)].
//   ss:  A and B from shared memory, both K-major.
//   rs:  A from registers in that accumulator layout (a[0..3] = rows g,
//        g + 8 at k 2t, 2t + 1; then the same at k 2t + 8, 2t + 9), B
//        MN-major (the transpose bit set).
//   rsk: A from registers as rs, B K-major.
// `acc` 0 overwrites D.
template <typename T, int N>
struct Wgmma {
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int acc);
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b, int acc);
  static __device__ __forceinline__ void rsk(float* d, const uint32_t* a,
                                             uint64_t b, int acc);
};

// The specializations differ only in the type, N, where A comes from
// and B's transpose bit; the accumulators are operands 0..N/2-1, then A,
// B and acc.
#define PTT_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define PTT_D24 PTT_D8(0), PTT_D8(8), PTT_D8(16)
#define PTT_D32 PTT_D8(0), PTT_D8(8), PTT_D8(16), PTT_D8(24)
#define PTT_D40 PTT_D32, PTT_D8(32)
#define PTT_D48 PTT_D40, PTT_D8(40)
#define PTT_D64 PTT_D32, PTT_D8(32), PTT_D8(40), PTT_D8(48), PTT_D8(56)
#define PTT_D80 PTT_D64, PTT_D8(64), PTT_D8(72)
#define PTT_D96 PTT_D64, PTT_D8(64), PTT_D8(72), PTT_D8(80), PTT_D8(88)
#define PTT_D128                                                         \
  PTT_D64, PTT_D8(64), PTT_D8(72), PTT_D8(80), PTT_D8(88), PTT_D8(96),   \
      PTT_D8(104), PTT_D8(112), PTT_D8(120)
#define PTT_R10(i)                                                       \
  "%" #i "0, %" #i "1, %" #i "2, %" #i "3, %" #i "4, %" #i "5, %" #i "6, " \
  "%" #i "7, %" #i "8, %" #i "9, "
#define PTT_REGS8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define PTT_REGS24                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, " PTT_R10(1)                 \
  "%20, %21, %22, %23}"
#define PTT_REGS32                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, " PTT_R10(1) PTT_R10(2)       \
  "%30, %31}"
#define PTT_REGS40                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, " PTT_R10(1) PTT_R10(2)       \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}"
#define PTT_REGS48                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, " PTT_R10(1) PTT_R10(2)       \
  PTT_R10(3) "%40, %41, %42, %43, %44, %45, %46, %47}"
#define PTT_REGS64                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, " PTT_R10(1) PTT_R10(2)       \
  PTT_R10(3) PTT_R10(4) PTT_R10(5) "%60, %61, %62, %63}"
#define PTT_REGS80                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, " PTT_R10(1) PTT_R10(2)       \
  PTT_R10(3) PTT_R10(4) PTT_R10(5) PTT_R10(6)                            \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79}"
#define PTT_REGS96                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, " PTT_R10(1) PTT_R10(2)       \
  PTT_R10(3) PTT_R10(4) PTT_R10(5) PTT_R10(6) PTT_R10(7) PTT_R10(8)       \
  "%90, %91, %92, %93, %94, %95}"
#define PTT_REGS128                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, " PTT_R10(1) PTT_R10(2)       \
  PTT_R10(3) PTT_R10(4) PTT_R10(5) PTT_R10(6) PTT_R10(7) PTT_R10(8)       \
  PTT_R10(9) PTT_R10(10) PTT_R10(11)                                     \
  "%120, %121, %122, %123, %124, %125, %126, %127}"

// T, its PTX type, N, the accumulator list and operands; A is operand
// a0 (ss) or a0..a0+3 (rs)
#define PTT_WGMMA(T, TY, N, REGS, D, a0, a1, a2, a3, a4, a5)               \
  template <>                                                             \
  __device__ __forceinline__ void Wgmma<T, N>::ss(float* d, uint64_t a,  \
                                                  uint64_t b, int acc) { \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #a2 ", 0;\n"         \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "."  \
                 TY " " REGS ", %" #a0 ", %" #a1 ", p, 1, 1, 0, 0;\n}\n"   \
                 : D                                                      \
                 : "l"(a), "l"(b), "r"(acc));                             \
  }                                                                       \
  template <>                                                             \
  __device__ __forceinline__ void Wgmma<T, N>::rs(                        \
      float* d, const uint32_t* a, uint64_t b, int acc) {                 \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #a5 ", 0;\n"         \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "."  \
                 TY " " REGS ", {%" #a0 ", %" #a1 ", %" #a2 ", %" #a3      \
                 "}, %" #a4 ", p, 1, 1, 1;\n}\n"                          \
                 : D                                                      \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),    \
                   "r"(acc));                                             \
  }                                                                       \
  template <>                                                             \
  __device__ __forceinline__ void Wgmma<T, N>::rsk(                       \
      float* d, const uint32_t* a, uint64_t b, int acc) {                 \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #a5 ", 0;\n"         \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "."  \
                 TY " " REGS ", {%" #a0 ", %" #a1 ", %" #a2 ", %" #a3      \
                 "}, %" #a4 ", p, 1, 1, 0;\n}\n"                          \
                 : D                                                      \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),    \
                   "r"(acc));                                             \
  }

PTT_WGMMA(__nv_bfloat16, "bf16", 64, PTT_REGS32, PTT_D32, 32, 33, 34, 35, 36,
          37)
PTT_WGMMA(__nv_bfloat16, "bf16", 128, PTT_REGS64, PTT_D64, 64, 65, 66, 67, 68,
          69)
PTT_WGMMA(__half, "f16", 64, PTT_REGS32, PTT_D32, 32, 33, 34, 35, 36, 37)
PTT_WGMMA(__half, "f16", 128, PTT_REGS64, PTT_D64, 64, 65, 66, 67, 68, 69)
PTT_WGMMA(__nv_bfloat16, "bf16", 192, PTT_REGS96, PTT_D96, 96, 97, 98, 99,
          100, 101)
PTT_WGMMA(__half, "f16", 192, PTT_REGS96, PTT_D96, 96, 97, 98, 99, 100, 101)
PTT_WGMMA(__nv_bfloat16, "bf16", 256, PTT_REGS128, PTT_D128, 128, 129, 130,
          131, 132, 133)
PTT_WGMMA(__half, "f16", 256, PTT_REGS128, PTT_D128, 128, 129, 130, 131, 132,
          133)
// the narrow flash bodies' head-dim widths (16, 48, 80, 160) and the
// dk/dv column chunk of width 160 (96)
PTT_WGMMA(__nv_bfloat16, "bf16", 16, PTT_REGS8, PTT_D8(0), 8, 9, 10, 11, 12,
          13)
PTT_WGMMA(__half, "f16", 16, PTT_REGS8, PTT_D8(0), 8, 9, 10, 11, 12, 13)
PTT_WGMMA(__nv_bfloat16, "bf16", 48, PTT_REGS24, PTT_D24, 24, 25, 26, 27, 28,
          29)
PTT_WGMMA(__half, "f16", 48, PTT_REGS24, PTT_D24, 24, 25, 26, 27, 28, 29)
PTT_WGMMA(__nv_bfloat16, "bf16", 80, PTT_REGS40, PTT_D40, 40, 41, 42, 43, 44,
          45)
PTT_WGMMA(__half, "f16", 80, PTT_REGS40, PTT_D40, 40, 41, 42, 43, 44, 45)
PTT_WGMMA(__nv_bfloat16, "bf16", 96, PTT_REGS48, PTT_D48, 48, 49, 50, 51, 52,
          53)
PTT_WGMMA(__half, "f16", 96, PTT_REGS48, PTT_D48, 48, 49, 50, 51, 52, 53)
PTT_WGMMA(__nv_bfloat16, "bf16", 160, PTT_REGS80, PTT_D80, 80, 81, 82, 83, 84,
          85)
PTT_WGMMA(__half, "f16", 160, PTT_REGS80, PTT_D80, 80, 81, 82, 83, 84, 85)

#undef PTT_WGMMA
#undef PTT_REGS128
#undef PTT_REGS96
#undef PTT_REGS80
#undef PTT_REGS64
#undef PTT_REGS48
#undef PTT_REGS40
#undef PTT_REGS32
#undef PTT_REGS24
#undef PTT_REGS8
#undef PTT_R10
#undef PTT_D128
#undef PTT_D96
#undef PTT_D80
#undef PTT_D64
#undef PTT_D48
#undef PTT_D40
#undef PTT_D32
#undef PTT_D24
#undef PTT_D8

// -- host: tensor maps -------------------------------------------------------
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, or nullptr
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A [B, s, heads, d] tensor of 16-bit elements (d a multiple of 8),
// read in boxes of (64 elements, 1 head, `rows` rows, 1 batch) with
// 128-byte swizzle: rows past s and columns past d are zero-filled and
// no box crosses into the next head or batch.
inline bool map_rows16(CUtensorMap* m, const void* base, int B, int s,
                       int heads, int d, int rows) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 2ull * d * heads;
  const cuuint64_t strides[3] = {2ull * d, row, row * s};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_UINT16, 4, const_cast<void*>(base),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A row-major [rows, cols] matrix of `elem` bytes an element (1 or 2)
// and `row_bytes` bytes a row (a multiple of 16), read in boxes of
// (box_cols, box_rows) with 128-byte swizzle (box_cols * elem == 128);
// elements past either edge are zero-filled.
inline bool map_2d(CUtensorMap* m, const void* base, int elem, long long cols,
                   long long rows, long long row_bytes, int box_cols,
                   int box_rows) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return enc(m,
             elem == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                       : CU_TENSOR_MAP_DATA_TYPE_UINT16,
             2, const_cast<void*>(base), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A row-major [rows, cols] matrix of `elem` bytes an element (2 or 4) and
// `row_bytes` bytes a row (a multiple of 16), read in unswizzled boxes of
// (box_cols, box_rows): row r of a box lands box_cols * elem bytes after
// row r - 1 (a multiple of 16 bytes); elements past either edge are
// zero-filled.
inline bool map_2d_rows(CUtensorMap* m, const void* base, int elem,
                        long long cols, long long rows, long long row_bytes,
                        int box_cols, int box_rows) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return enc(m,
             elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_UINT32
                       : CU_TENSOR_MAP_DATA_TYPE_UINT16,
             2, const_cast<void*>(base), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A flat fp32 vector of n elements read in boxes of `box` elements;
// elements past n are zero-filled.  A box must start on a 16-byte
// boundary (a coordinate that is a multiple of 4): an unaligned start
// faults with an illegal instruction.
inline bool map_vec32(CUtensorMap* m, const void* base, long long n,
                      int box) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {4};   // rank 1: not read
  const cuuint32_t boxes[1] = {static_cast<cuuint32_t>(box)};
  const cuuint32_t step[1] = {1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(base),
             dims, strides, boxes, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
}  // namespace ptt
