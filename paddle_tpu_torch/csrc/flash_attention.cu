// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py::
// flash_attention (:816): forward _fwd_kernel (:482) and its _small /
// _1b twins, backward _bwd_dq_kernel (:585) and _bwd_dkv_kernel (:630).
//   out = softmax(q.k^T * scale [+ key bias] [causal]) . v
// q [B, sq, h, d], k/v [B, sk, hk, d] (h % hk == 0, query head hq reads
// kv head hq / (h / hk), `_kv_head_map` :64), addressed in that layout
// through strides: none of the TPU wrapper's transposes to [b*h, s, d].
// d is any multiple of 8 from 8 to 256 (the TPU kernel's domain is
// d % 64 == 0, :826-831).  The tiles are the next multiple of 64 wide,
// columns past d zero-filled on load (TMA) or read as 0, and stores stop
// at d.  The bf16 / fp16 products run over the tiles' width, or, for d
// 8-16, 40-48, 72-80 and 152-160, over d rounded up to 16: the narrow
// bodies of flash_attention_narrow.cu (the SD UNet's heads are 80 and
// 160 wide), which skip the k-steps and output columns past it.
//
// Masks follow the reference twin `xla_attention` (paddle_tpu/ops/
// __init__.py:80-102), which replaces a masked logit by -1e30:
//   * causal: key j is live for row i iff j <= i + sk - sq (bottom-right
//     aligned; top-left when sq == sk, as the TPU kernel's);
//   * an optional key bias [B or 1, skp] fp32 (the wrapper's form of a
//     key-padding mask: 0 / -1e30 for a bool mask, the values clamped at
//     -1e30 for an additive one), added to every row's logits;
//   * a row whose every key is masked gets the reference's uniform
//     weights over all sk keys (its logits are all -1e30): the forward
//     walks every key tile for such a block, counts each masked key with
//     p = 1 there, and saves the row max +inf as the row's mark.  The
//     backward reads the mark: p = exp(x - m) = 0 for dq and ds, 1/sk
//     for dv, as autograd through the twin's `where` gives.
// The saved statistics (flash_attention.py::_stats): without a key bias
// lse [B, h, sq], each row's logsumexp; with one, [B, h, sq, 2]: each
// row's max m and g = log sum exp(x - m), so that the backward's
// p = exp((x - m) - g) keeps a row whose logits all carry a large finite
// bias (-1e9: lse = m + log(sk) rounds to m in fp32).  The bias bodies
// keep their logits in natural units, the backward's x - m exact.
// Keys past sk (the ragged edge) count nowhere.  fp32 softmax; p is
// rounded to the operand type before P.V (:518), ds and p before their
// products in the backward (:618, :664, :670).
//
// What bounds it on the H100: operations.  At the training shape
// (q [4, 2048, 20, 128], kv [4, 2048, 4, 128], bf16, causal) the forward
// does 4*b*h*s^2*d/2 = 8.6e10 FLOP, 0.087 ms at 989 TFLOP/s, against
// ~0.03 ms for its bytes; the backward 2.5x the forward (five products
// of the same size), and these kernels issue seven (S and dP are
// recomputed by both backward kernels so that no sum crosses blocks).
//
// Design.  The TPU's sequential grid over K blocks becomes a loop inside
// the block; no state crosses blocks (but within an fp32 dk/dv cluster,
// in a fixed order), so there are no atomics and the result is
// deterministic.
//   * bf16/fp16: Hopper warp specialisation.  A block is three
//     warpgroups.  Warpgroup 0 gives up its registers
//     (setmaxnreg) and one thread of it streams the tiles with TMA
//     (4-D tensor maps over [B, s, heads, d], boxes of 64 columns with
//     128-byte swizzle, rows past s zero-filled) into a ring of shared-
//     memory stages guarded by full/empty mbarriers.  Warpgroups 1 and
//     2 each own 64 rows and run the products as wgmma: QK^T-like
//     products from shared memory with both operands K-major, the
//     second product of each step with its A operand (p or ds, rounded
//     to the operand type) straight from the accumulator registers and
//     B read in place as an MN-major operand (V, K, Q or dO: no
//     transposes).  Softmax in base 2 (scale * log2 e folded into one
//     multiply, one MUFU ex2 an element); lse converted to natural-log
//     units once.  The causal and ragged-edge masks run only on the
//     tiles they cut; the key bias (MASK bodies) on every tile.
//       fwd: one block per (128 query rows, q head, batch), walking the
//            live key tiles (128 keys; 64 for bodies wider than 128)
//            through a 2-stage K/V ring (K and V
//            stages freed on barriers of their own).  Tile j's QK^T and
//            tile j-1's PV are in flight together and tile j's softmax
//            runs under the PV; the two warpgroups take turns to issue
//            (named barriers), so one's softmax also runs under the
//            other's products.
//       dq:  one block per (128 query rows, q head, batch); its
//            prologue computes delta = rowsum(dO.O) in fp32 for its rows
//            and writes it for dkv; it walks the live 64-key tiles:
//            S = QK^T, dP = dO.V^T, dQ += dS.K.
//       dkv: one block per (128 keys, kv head, batch); it walks every
//            query head of its GQA group and the live 64-row query
//            tiles (a ring of Q, dO, lse and delta; lse and
//            delta through 1-D tensor maps), with S^T = K.Q^T,
//            dP^T = V.dO^T, dV += P^T.dO and dK += dS^T.Q, the dK and dV
//            accumulators in registers over the whole walk (the TPU
//            kernel's accumulation over t = (g, qi), :717-741).
//     Bodies wider than 128 (d 136-256): the same walks with what the
//     card holds.  fwd takes 64-key tiles (Q 48-64 KB and two K and V
//     stages fit in 227 KB); dq keeps 2 stages at 192 and 1 at 256; dkv
//     cannot keep dK and dV of 64 keys x 256 columns in a warpgroup's
//     registers (256 a thread), so its grid also splits the columns of
//     dK and dV into chunks (3 of 64 at 192, 2 of 128 at 256), each
//     block recomputing S^T and dP^T over the full width for its chunk,
//     with 2 stages at 192 and 1 at 256.  Simple first: the widths of
//     64 and 128 keep their bodies and times.  The narrow bodies take
//     the tiles of the next multiple of 64 and run the products at
//     their width (flash_attention_wgmma.cuh); dk/dv at 160 splits dK
//     and dV into 2 chunks of 96 (from columns 0 and 64), not 3 of 64.
//     Causal grids launch heaviest first: the last query tiles (fwd,
//     dq) and the first key tiles (dkv) get the lowest block indices.
//     The bodies of width 64-256 outside FIT (`kWideWalk`: every MASK
//     body, and those without a bias at d below the width, under
//     bottom-right causal or at 192 / 256) walk less and keep more in L2:
//       - the wrapper hands them each bias row's live keys [first, end)
//         (a dead key's bias is -1e30: a bool mask's padding, an
//         additive one's at or below it).  fwd walks only the key tiles
//         between them where every row of the block has a live key (a
//         block with a row that has none still walks every tile for its
//         uniform weights); dq only those, always (such a row's p is 0);
//         a dk/dv block with no live key stores zeros where every row
//         has a live key, and under causal skips the rows before its
//         frontier then.  A tile of dead keys adds p = 0 and rescales
//         by 1, so the bits are those of the whole walk;
//       - they test a cut tile once a tile (two copies of the loop over
//         scores), not once a score;
//       - without causal their grids launch the query tiles (dkv: the
//         key tiles) of one (batch, head) next to each other: at
//         BERT-base's [64, 512, 12, 64] the 768 heads' K and V (96 MB)
//         outgrow the 50 MB L2, and head-minor order read each head's K
//         and V from device memory once a query tile.  Under causal they
//         keep the heaviest tiles of every head first (head-major order
//         cost d192 / d256 causal 17-21%);
//       - the MASK bodies of width 64 and 128, where a call has six work
//         tiles an SM or more, launch their forward persistent
//         (flash_fwd_wgmma's PERSIST): one block an SM walks the tiles in
//         that order and loads the next tile's Q and first K / V stage
//         under the current one's epilogue.
//     What is left between these kernels and the card: the forward's
//     exp and softmax instructions per product (it reaches ~1/3 of the
//     tensor peak where the backward, with more products per exp,
//     reaches ~1/2), each block's unhidden prologue (Q and the first K
//     tile) and epilogue, and in the backward no overlap of a tile's
//     elementwise work with the next tile's products; dkv has one block
//     per 128 keys and kv head, too few to fill the card at short
//     sequences and few kv heads.
//   * fp32: the same three walks on the tensor cores, as a three-pass
//     TF32 split, in flash_attention_f32.cu (a translation unit of its
//     own; its header says what bounds those bodies and how they are
//     built), at the widths 64-256 alone.  The pieces all share are in
//     flash_attention.cuh; the bf16 / fp16 bodies are templates in
//     flash_attention_wgmma.cuh that this file instantiates at the
//     widths 64-256 and flash_attention_narrow.cu at the narrow ones.
//   * ragged edges: rows past sq and keys past sk are masked in the
//     kernel (the TPU kernel needs a power-of-two block dividing s).
#include <type_traits>

#include "flash_attention_wgmma.cuh"

namespace {

// the launchers of the bodies of width 64-256: fp32 to
// flash_attention_f32.cu, bf16 / fp16 to the tensor-core bodies
template <typename T, int D, bool M, bool F>
int fwd(const Shape& s, const void* q, const void* k, const void* v,
        void* out, void* lse, cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value)
    return fwd_f32(s, D, M, static_cast<const float*>(q),
                   static_cast<const float*>(k), static_cast<const float*>(v),
                   static_cast<float*>(out), static_cast<float*>(lse), st);
  else
    return fwd16<T, D, D, M, F>(s, q, k, v, out, lse, st);
}

template <typename T, int D, bool M, bool F>
int bwd(const Shape& s, const void* q, const void* k, const void* v,
        const void* out, const void* dout, const void* lse, void* delta,
        void* dq, void* dk, void* dv, cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value)
    return bwd_f32(s, D, M, static_cast<const float*>(q),
                   static_cast<const float*>(k), static_cast<const float*>(v),
                   static_cast<const float*>(out),
                   static_cast<const float*>(dout),
                   static_cast<const float*>(lse), static_cast<float*>(delta),
                   static_cast<float*>(dq), static_cast<float*>(dk),
                   static_cast<float*>(dv), st);
  else
    return bwd16<T, D, D, M, F>(s, q, k, v, out, dout, lse, delta, dq, dk,
                                dv, st);
}

// The body of head dim d (its width, d rounded up to 64; bf16 / fp16 of
// a narrow width go to flash_attention_narrow.cu first): with the key
// bias (MASK), or without it; the widths 64 and 128 also FIT when d is
// the width and causal has sq == sk.
#define PTT_FLASH_BODY(s, CALL)                                          \
  switch (body_width((s).d)) {                                           \
    case 64:                                                             \
      return (s).bias ? CALL(64, true, false)                            \
             : fits(s) ? CALL(64, false, true) : CALL(64, false, false); \
    case 128:                                                            \
      return (s).bias ? CALL(128, true, false)                           \
             : fits(s) ? CALL(128, false, true)                          \
                       : CALL(128, false, false);                        \
    case 192:                                                            \
      return (s).bias ? CALL(192, true, false) : CALL(192, false, false); \
    case 256:                                                            \
      return (s).bias ? CALL(256, true, false) : CALL(256, false, false); \
  }

bool fits(const Shape& s) {
  return s.d == body_width(s.d) && !(s.causal && s.sq != s.sk);
}

// the grids' y and z dimensions and the 32-bit offsets of the lse and
// delta tensor maps bound the sizes (the bias bodies' lse holds pairs);
// causal with sq > sk leaves rows with no live key, which only the bias
// bodies handle (a zero bias without a mask)
bool bad_shape(int B, int sq, int sk, int h, int hk, int d, int bstride,
               const void* bias, int causal) {
  return B <= 0 || B > 65535 || sq <= 0 || sk <= 0 || h <= 0 || h > 65535 ||
         hk <= 0 || h % hk || d < 8 || d > 256 || d % 8 ||
         static_cast<long long>(B) * h * sq >= (bias ? 1ll << 30 : 1ll << 31) ||
         sq > 65535 * 128 || sk > 65535 * 32 || bstride < 0 ||
         (causal && sq > sk && bias == nullptr);
}

// a key bias comes with its live range (8-byte aligned int pairs), and
// no range without one
bool bad_range(const void* bias, const void* range) {
  return (bias == nullptr) != (range == nullptr) ||
         reinterpret_cast<uintptr_t>(range) % 8;
}

}  // namespace

// q [B, sq, h, d], k/v [B, sk, hk, d], out like q, lse [B, h, sq] fp32
// ([B, h, sq, 2] with a bias: each row's max and log sum);
// all contiguous and 16-byte aligned, one dtype; d a multiple of 8 from 8
// to 256.  bias: nullptr, or the fp32 key bias, row b at bias + b *
// bstride (bstride 0: one row for every batch; a multiple of 128),
// 16-byte aligned and readable up to sk rounded up to 128; causal with
// sq > sk needs one.  range: with a bias, its rows' live keys as int32
// pairs (sk - first, end), (0, 0) for a row with none, row b at range +
// 2 b (2 b when bstride > 0, else one pair): ops/flash_attention.py::
// _key_range; nullptr without a bias.
extern "C" int ptt_flash_fwd(int device, int dtype, const void* q,
                             const void* k, const void* v, const void* bias,
                             const void* range, void* out, void* lse, int B,
                             int sq, int sk, int h, int hk, int d,
                             int bstride, float scale, int causal,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bad_shape(B, sq, sk, h, hk, d, bstride, bias, causal) ||
      bad_range(bias, range) || !ptt::aligned16(q) || !ptt::aligned16(k) ||
      !ptt::aligned16(v) || !ptt::aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{B,      sq,
                sk,     h,
                hk,     d,
                scale,  causal,
                static_cast<const float*>(bias),
                static_cast<const int*>(range),
                bstride};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PTT_FWD(W, M, F) fwd<T, W, M, F>(s, q, k, v, out, lse, st)
  PTT_DISPATCH(dtype, T, {
    if (!std::is_same<T, float>::value && narrow_width(d))
      return fwd_narrow(s, dtype == ptt::kBF16, q, k, v, out, lse, st);
    PTT_FLASH_BODY(s, PTT_FWD)
  });
#undef PTT_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// out and dout like q; lse the forward's statistics; delta
// [B, h, sq] fp32 is scratch the first launch fills with rowsum(dout *
// out); dq like q, dk/dv like k; bias as the forward's.  Two launches,
// dq (with delta), then dk/dv (fp32: in clusters of `dkv_splits`).
extern "C" int ptt_flash_bwd(int device, int dtype, const void* q,
                             const void* k, const void* v, const void* bias,
                             const void* range, const void* out,
                             const void* dout, const void* lse, void* delta,
                             void* dq, void* dk, void* dv, int B, int sq,
                             int sk, int h, int hk, int d, int bstride,
                             float scale, int causal, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bad_shape(B, sq, sk, h, hk, d, bstride, bias, causal) ||
      bad_range(bias, range) || !ptt::aligned16(q) ||
      !ptt::aligned16(k) || !ptt::aligned16(v) || !ptt::aligned16(out) ||
      !ptt::aligned16(dout) || !ptt::aligned16(lse) ||
      !ptt::aligned16(delta) || !ptt::aligned16(dq) || !ptt::aligned16(dk) ||
      !ptt::aligned16(dv))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{B,      sq,
                sk,     h,
                hk,     d,
                scale,  causal,
                static_cast<const float*>(bias),
                static_cast<const int*>(range),
                bstride};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PTT_BWD(W, M, F) \
  bwd<T, W, M, F>(s, q, k, v, out, dout, lse, delta, dq, dk, dv, st)
  PTT_DISPATCH(dtype, T, {
    if (!std::is_same<T, float>::value && narrow_width(d))
      return bwd_narrow(s, dtype == ptt::kBF16, q, k, v, out, dout, lse,
                        delta, dq, dk, dv, st);
    PTT_FLASH_BODY(s, PTT_BWD)
  });
#undef PTT_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// What a call of these sizes runs, into p[0..7] (the kernels' plan, for
// reports; no launch): p[0] the width its products run over, p[1] the
// width of its shared-memory tiles, p[2] and p[3] the forward's query and
// key tiles, p[4] and p[5] dk/dv's column chunks and their width, p[6] 1
// for a FIT body, p[7] 1 for a narrow body (flash_attention_narrow.cu).
// `biased`: the call takes a key bias (a mask, or causal with sq > sk).
// fp32 fills p[0] and p[1] (its tiles are flash_attention_f32.cu's).
extern "C" int ptt_flash_plan(int dtype, int sq, int sk, int d, int biased,
                              int causal, int* p) {
  const float none = 0.f;
  const float* bias = biased ? &none : nullptr;
  if (dtype < ptt::kF32 || dtype > ptt::kF16 ||
      bad_shape(1, sq, sk, 1, 1, d, 0, bias, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{1, sq, sk, 1, 1, d, 1.f, causal, bias, nullptr, 0};
  const int narrow = dtype == ptt::kF32 ? 0 : narrow_width(d);
  for (int i = 0; i < 8; ++i) p[i] = 0;
  p[0] = narrow ? narrow : body_width(d);
  p[1] = body_width(d);
  if (dtype == ptt::kF32) return 0;
  p[6] = !s.bias && !narrow && p[1] <= 128 && fits(s);
  p[7] = narrow != 0;
#define PTT_PLAN(D, W)                                                   \
  case W:                                                                \
    s.bias ? body_plan<D, W, true>(p)                                    \
    : narrow && short_keys(s) ? body_plan<D, W, false, kShortKeys>(p)    \
                              : body_plan<D, W, false>(p);               \
    return 0;
  switch (p[0]) {
    PTT_PLAN(64, 16)
    PTT_PLAN(64, 48)
    PTT_PLAN(128, 80)
    PTT_PLAN(192, 160)
    PTT_PLAN(64, 64)
    PTT_PLAN(128, 128)
    PTT_PLAN(192, 192)
    PTT_PLAN(256, 256)
  }
#undef PTT_PLAN
  return static_cast<int>(cudaErrorInvalidValue);
}
