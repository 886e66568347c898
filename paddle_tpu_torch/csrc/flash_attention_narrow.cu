// Flash attention's bf16 / fp16 bodies for head dims off a multiple of
// 64: the products run over d rounded up to 16 (W = 16, 48, 80 or 160:
// d 8-16, 40-48, 72-80, 152-160; the SD UNet's heads are 80 and 160
// wide), not over the 64-column tiles that hold it.
//
// Replaces, with flash_attention.cu, the TPU kernel
// paddle_tpu/ops/pallas/flash_attention.py::flash_attention (:816), whose
// domain is d % 64 == 0 (:826-831); the walks, masks and statistics are
// flash_attention.cu's (its header), the templates
// flash_attention_wgmma.cuh's, here at product width W on tiles of width
// D = W rounded up to 64:
//   * QK^T, dO.V^T, K.Q^T and V.dO^T take W / 16 k-steps (of D / 16):
//     the k-steps over the zero-filled columns past W are gone;
//   * P.V, dS.K, P^T.dO and dS^T.Q run at N = W (of D), B read MN-major
//     across the 128-byte-swizzled column blocks, the last one in part;
//   * the accumulators hold W columns: o[W / 2] (40 at d80, not 64);
//   * dk/dv at 160: two column chunks of 96 (from columns 0 and 64, a
//     chunk starting on a column block), each storing its half, in place
//     of three of 64: S^T and dP^T are recomputed twice over 10 k-steps,
//     not three times over 12;
//   * the test of a tile that a mask or the ragged edge cuts runs once a
//     tile (two copies of the loop over scores), not once a score: in
//     the unrolled loop it cost a branch and a convergence barrier a
//     score, about half of the forward's loop (tools/flash_sass.py);
//   * a short key walk: where one tile of kShortKeys (80) keys holds
//     every key and there is no key bias (the UNet's cross-attention
//     over 77 context keys), the forward takes that tile, not one of 128
//     keys (40% of them dead at 77) or two of 64.
// A k-step over zero columns adds exact zeros, a dead key's p is 0 and
// the products' columns are independent, so each output has the bits
// the body of width D gave it, but where the short walk replaces two
// key tiles by one (d 152-160 with 65-80 keys: another online-softmax
// order, held to the plain version within its tolerance).  What bounds
// these bodies: at the UNet's self-attention d80 (q [8, 1024, 8, 80])
// the operations (0.0217 ms at 989 TFLOP/s), at its cross-attention and
// at d160 the bytes; the forward's time follows its softmax (one ex2 and
// ~5 other instructions a score, the same at every width) more than its
// products, and a block with one key tile overlaps no load with them.
//
// A translation unit of its own, so that nvcc compiles it beside
// flash_attention.cu and flash_attention_f32.cu; the entry points in
// flash_attention.cu call fwd_narrow / bwd_narrow.  Other head dims off
// a multiple of 64 (d 24-32, 88-96, 104-112, 136-144, 168-240) keep the
// body of the next multiple of 64.
#include "flash_attention_wgmma.cuh"

namespace ptt {
namespace flash {

// the narrow body of head dim d: with the key bias or without it (no FIT
// body: the offsets and d are runtime values here)
#define PTT_NARROW(s, CALL)                                              \
  switch (narrow_width((s).d)) {                                         \
    case 16:                                                             \
      return (s).bias ? CALL(64, 16, true) : CALL(64, 16, false);        \
    case 48:                                                             \
      return (s).bias ? CALL(64, 48, true) : CALL(64, 48, false);        \
    case 80:                                                             \
      return (s).bias ? CALL(128, 80, true) : CALL(128, 80, false);      \
    case 160:                                                            \
      return (s).bias ? CALL(192, 160, true) : CALL(192, 160, false);    \
  }

int fwd_narrow(const Shape& s, bool bf16, const void* q, const void* k,
               const void* v, void* out, void* lse, cudaStream_t st) {
  // a short key walk: one tile of kShortKeys keys (bodies without the
  // key bias alone, M false then)
#define PTT_FWD(D, W, M)                                                  \
  (short_keys(s)                                                          \
       ? (bf16 ? fwd16<__nv_bfloat16, D, W, false, false, kShortKeys>(     \
                     s, q, k, v, out, lse, st)                            \
               : fwd16<__half, D, W, false, false, kShortKeys>(s, q, k, v, \
                                                               out, lse,  \
                                                               st))       \
       : bf16 ? fwd16<__nv_bfloat16, D, W, M, false>(s, q, k, v, out, lse, \
                                                     st)                  \
              : fwd16<__half, D, W, M, false>(s, q, k, v, out, lse, st))
  PTT_NARROW(s, PTT_FWD)
#undef PTT_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

int bwd_narrow(const Shape& s, bool bf16, const void* q, const void* k,
               const void* v, const void* out, const void* dout,
               const void* lse, void* delta, void* dq, void* dk, void* dv,
               cudaStream_t st) {
#define PTT_BWD(D, W, M)                                                  \
  (bf16 ? bwd16<__nv_bfloat16, D, W, M, false>(s, q, k, v, out, dout, lse, \
                                               delta, dq, dk, dv, st)      \
        : bwd16<__half, D, W, M, false>(s, q, k, v, out, dout, lse, delta, \
                                        dq, dk, dv, st))
  PTT_NARROW(s, PTT_BWD)
#undef PTT_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

#undef PTT_NARROW

}  // namespace flash
}  // namespace ptt
