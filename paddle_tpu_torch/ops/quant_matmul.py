"""Weight-only quantized matmul: the Hopper kernel (csrc/quant_matmul.cu)
and its plain PyTorch version, with the packed-int4 layout helpers.

Replaces the TPU kernel `paddle_tpu/ops/pallas/quant_matmul.py::
quant_matmul` (:58, bodies `_kernel_int8` :36 and `_kernel_int4` :45).
The plain version is the reference's twin `xla_quant_matmul`
(ops/__init__.py:473); `pack_int4`, `unpack_int4` and `dequant_weight`
are its :423-470.

Formats (the reference's layout contract, ops/__init__.py:406-419):

  int8   qw [K, N] int8, scales [N] — per output channel
  int4   qw [K//2, N] int8 — row k in the LOW nibble, row k + K//2 in
         the HIGH nibble (half-split); scales [K//group, N], groups never
         straddling the half boundary (group divides K//2)

Scales keep the weight's storage dtype.  The dequantized weight is
`q_f32 * scale_f32` rounded to the activation dtype; the product is
`x @ w` summed in fp32 and rounded to x.dtype.  The kernel dequantizes
each tile on chip right after loading it, so the weight crosses device
memory at its packed width (1 or 1/2 byte an element) and no
dequantized [K, N] weight is ever allocated.

Three tensor-core bodies, picked by shape (mirrored in the kernel's
header): the admission chunks (bf16/fp16 x, M > 16, K % 8 == 0, x
16-byte aligned, int4 groups a multiple of 64: `_takes_wgmma`) take the
wgmma body — TMA ring, dequantization into wgmma's register operand, K
split over a thread-block cluster and reduced on chip, the row tile and
cluster size from a cost model (`_schedule`); decode (bf16/fp16 x, M <=
16, int4 groups a multiple of 16, where the library's plan takes the
shape: `_decode_plan`) takes the decode body — a TMA ring of the packed
weight dequantized straight into mma.sync's A operand, K split over a
cluster and reduced on chip, its split and stages planned by the library
from the shapes and the SM count; every other shape takes the mma.sync
body, K split with fp32 partials (`_splits`) where the column blocks
alone cannot fill the card.  fp32 x takes the CUDA-core body.

`quant_matmul` validates its arguments first (the reference's
ValueErrors), then takes the plain version for CPU tensors and launches
the kernel for CUDA tensors, or raises — there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["quant_matmul", "plain_quant_matmul", "pack_int4",
           "unpack_int4", "dequant_weight", "launches", "variant_launches"]

# kernel launches since the last reset (chip_smoke.py zeroes and reads
# them), in total and by weight format (the TPU kernel body each stands
# for: _kernel_int8, _kernel_int4)
launches = {"quant_matmul": 0}
variant_launches = {"int8": 0, "int4": 0}

# the mma.sync body's tiles (csrc/quant_matmul.cu kBN, kBK): output
# columns per block and logical K rows per tile, and its row tile
_BN, _BK, _BM = 128, 64, 64
# the wgmma body takes M past this (up to it, the decode plan decides)
_DECODE_ROWS = 16
# the wgmma body's schedule model (tools/quant_matmul_schedule.py fits
# it to the card's times): at most this many blocks of a cluster over K;
# us a block of 128 / 256 rows spends on one K tile (64 packed rows) of
# int8 / int4, and us a wave of blocks spends beside its K tiles (pipeline
# fill, epilogue, the cluster's reduction) by cluster size
_MAX_SPLITS = 4
_TILE_US = {(False, 128): 0.47, (False, 256): 0.62,
            (True, 128): 1.43, (True, 256): 1.57}
_WAVE_US = {128: {1: 5.9, 2: 8.9, 3: 9.0, 4: 9.6},
            256: {1: 10.2, 2: 14.1, 3: 14.7, 4: 16.5}}
# (device, int4, rows) -> {splits: clusters at once}
_capacity = {}
# (device, x's address % 16, M, K, N, int4, group, scale dtype) -> the
# decode plan (body, splits, stages, smem, x by TMA)
_plans = {}


def pack_int4(q):
    """Pack an int [K, N] tensor of int4 values (range [-8, 7]) into
    [K//2, N] int8 bytes: low nibble = row k, high nibble = row
    k + K//2.  K must be even."""
    K = q.shape[0]
    if K % 2:
        raise ValueError(f"pack_int4 needs an even K (got {K})")
    qi = q.to(torch.int32)
    lo = qi[: K // 2] & 15
    hi = qi[K // 2:] & 15
    return (lo | (hi << 4)).to(torch.int8)


def unpack_int4(packed):
    """Inverse of pack_int4: [K//2, N] int8 → [K, N] int32 in [-8, 7].
    The byte is sign-extended; the low nibble is ((p & 15) ^ 8) - 8 and
    the high one the arithmetic shift p >> 4."""
    p = packed.to(torch.int32)
    lo = ((p & 15) ^ 8) - 8
    hi = p >> 4
    return torch.cat([lo, hi], dim=0)


def dequant_weight(qw, scales, fmt, group_size=None):
    """fp32 [K, N] weight from its packed form: q_f32 * scale_f32."""
    if fmt == "int8":
        return qw.float() * scales.float()[None]
    if fmt != "int4":
        raise ValueError(f"unknown weight-only format {fmt!r}")
    if group_size is None:
        raise ValueError("int4 dequant needs group_size")
    q = unpack_int4(qw).float()
    s = torch.repeat_interleave(scales.float(), int(group_size), dim=0)
    return q * s


def _check_args(x, qw, fmt, group_size):
    if fmt not in ("int8", "int4"):
        raise ValueError(f"unknown weight-only format {fmt!r}")
    if fmt == "int4":
        if group_size is None:
            raise ValueError("int4 quant_matmul needs group_size")
        K = x.shape[-1]
        if qw.shape[0] * 2 != K:
            raise ValueError(f"packed rows {qw.shape[0]} != K/2 ({K}/2)")
        if (K // 2) % int(group_size):
            raise ValueError(f"group_size {group_size} must divide K/2 "
                             f"({K // 2})")


def plain_quant_matmul(x, qw, scales, fmt, group_size=None):
    """x [..., K] @ dequant(qw) → [..., N] in x.dtype: the weight is
    dequantized to fp32 and rounded to x.dtype, and the product is
    summed in fp32 (x and w widened exactly) and rounded to x.dtype."""
    _check_args(x, qw, fmt, group_size)
    w = dequant_weight(qw, scales, fmt, group_size).to(x.dtype)
    lead = x.shape[:-1]
    out = x.reshape(-1, x.shape[-1]).float() @ w.float()
    return out.to(x.dtype).reshape(*lead, w.shape[1])


def quant_matmul(x, qw, scales, fmt, group_size=None):
    """x [..., K] @ weight-only packed qw → [..., N] in x.dtype."""
    _check_args(x, qw, fmt, group_size)
    if x.device.type == "cpu":
        return plain_quant_matmul(x, qw, scales, fmt, group_size)
    return _launch(x, qw, scales, fmt, group_size)


def _launch(x, qw, scales, fmt, group_size):
    req = _build.require
    dev = _build.cuda_device_index(x, qw, scales)
    code = _build.dtype_code(x.dtype)
    scode = _build.dtype_code(scales.dtype)
    int4 = fmt == "int4"
    K = x.shape[-1]
    N = qw.shape[-1]
    M = x.numel() // max(K, 1)
    g = int(group_size) if int4 else 0
    req(qw.dtype == torch.int8 and qw.ndim == 2,
        "quant_matmul kernel takes an int8 packed weight [K or K/2, N]", qw)
    req(x.ndim >= 1 and M > 0 and K > 0 and N > 0,
        "quant_matmul kernel: empty input", x, qw)
    if int4:
        req(qw.shape[0] * 2 == K and scales.shape == (K // g, N),
            "quant_matmul kernel (int4) takes qw [K/2, N] and scales "
            "[K/group, N]", x, qw, scales)
    else:
        req(qw.shape[0] == K and scales.shape == (N,),
            "quant_matmul kernel (int8) takes qw [K, N] and scales [N]",
            x, qw, scales)
    req(N % 16 == 0, "quant_matmul kernel needs N % 16 == 0 (16-byte "
        "weight rows)", qw)
    req(x.is_contiguous() and qw.is_contiguous() and scales.is_contiguous(),
        "quant_matmul kernel needs contiguous x, qw and scales", x, qw,
        scales)
    req(qw.data_ptr() % 16 == 0 and scales.data_ptr() % 16 == 0,
        "quant_matmul kernel needs 16-byte aligned qw and scales", qw,
        scales)
    body = _body(dev, x, scales, M, K, N, fmt, g)
    if body == "wgmma":
        rows, splits = _schedule(M, K, N, int4,
                                 lambda r: _cluster_capacity(dev, int4, r))
    elif body == "decode":
        rows, splits = 0, 0         # the library plans the split
    else:
        rows, splits = 0, _splits(M, K, N, qw.numel())
    out = torch.empty(x.shape[:-1] + (N,), dtype=x.dtype, device=x.device)
    part = None
    if splits > 1 and not rows:
        part = torch.empty((splits, M, N), dtype=torch.float32,
                           device=x.device)
    rc = _build.library().ptt_quant_matmul(
        dev, code, scode, int(int4), g, x.data_ptr(), qw.data_ptr(),
        scales.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), M, K, N, splits, rows,
        _build.stream_of(x.device))
    _build.check(rc, "quant_matmul")
    launches["quant_matmul"] += 1
    variant_launches[fmt] += 1
    return out


def _body(dev, x, scales, M, K, N, fmt, group):
    """The kernel body a call takes, by shape alone: "wgmma" (the
    admission chunks, `_takes_wgmma`), "decode" (16-bit x the library's
    decode plan takes: M <= 16, int4 groups a multiple of 16), "mma.sync"
    (every other 16-bit shape) or
    "cuda-core" (fp32 x)."""
    if x.dtype == torch.float32:
        return "cuda-core"
    if _takes_wgmma(x, M, K, fmt, group):
        return "wgmma"
    if _decode_plan(dev, x, scales, M, K, N, fmt == "int4", group)[0]:
        return "decode"
    return "mma.sync"


def _takes_wgmma(x, M, K, fmt, group):
    """Whether the call takes the wgmma body: bf16/fp16 x past the decode
    rows, x's rows a TMA stride (K % 8 == 0) from a 16-byte aligned
    start, and for int4 one group scale row per 64 packed rows."""
    return (x.dtype != torch.float32 and M > _DECODE_ROWS and K % 8 == 0
            and x.data_ptr() % 16 == 0
            and (fmt == "int8" or group % 64 == 0))


def _decode_plan(dev, x, scales, M, K, N, int4, group):
    """(body, splits, stages, smem bytes, x by TMA) of the decode body for
    16-bit x [M, K] and a weight of N columns (int4: in groups of `group`
    rows) with `scales`' dtype, as the library plans it
    (csrc/quant_matmul_plan.cuh: the shapes, x's alignment and the card's
    SM count, never a tensor's values); body 0: the shape is not the
    decode body's."""
    scode = _build.dtype_code(scales.dtype)
    key = (dev, x.data_ptr() % 16, M, K, N, bool(int4), group, scode)
    got = _plans.get(key)
    if got is None:
        buf = (ctypes.c_int * 5)()
        _build.check(_build.library().ptt_quant_matmul_plan(
            dev, x.data_ptr(), M, K, N, int(int4), group, scode,
            ctypes.addressof(buf)), "quant_matmul plan")
        got = _plans[key] = tuple(buf)
    return got


def _cluster_capacity(dev, int4, rows):
    """{splits: clusters of that many blocks the card holds at once} for
    the wgmma body's blocks of `rows` rows (the kernel's occupancy query,
    once per device and configuration)."""
    key = (dev, bool(int4), rows)
    if key not in _capacity:
        lib = _build.library()
        cap = {}
        for s in range(1, _MAX_SPLITS + 1):
            n = lib.ptt_quant_matmul_clusters(dev, int(int4), rows, s)
            _build.check(-n if n < 0 else 0, "quant_matmul cluster query")
            cap[s] = n
        _capacity[key] = cap
    return _capacity[key]


def _schedule(M, K, N, int4, capacity):
    """The wgmma body's (rows, splits): blocks of 128 or 256 rows of x
    (256 only past M = 128) and clusters of 1-4 blocks over K, the pair
    with the least modelled time.  The blocks run in waves of as many
    clusters as `capacity(rows)[splits]` says fit at once; a wave costs
    its blocks' K tiles at _TILE_US each plus _WAVE_US.  Ties go to
    fewer splits, then to more rows.  No split is empty."""
    n_k = -(-(K // 2 if int4 else K) // 64)
    best = None
    for rows in ((128, 256) if M > 128 else (128,)):
        tiles = -(-N // 128) * -(-M // rows)
        cap = capacity(rows)
        for s in range(1, min(_MAX_SPLITS, n_k) + 1):
            if not cap[s]:
                continue
            t = -(-tiles // cap[s]) * (-(-n_k // s) * _TILE_US[int4, rows]
                                       + _WAVE_US[rows][s])
            key = (t, s, -rows)
            if best is None or key < best[0]:
                best = (key, rows, -(-n_k // -(-n_k // s)))
    return best[1], best[2]


def _splits(M, K, N, weight_bytes):
    """Splits over K for the mma.sync and CUDA-core bodies: enough blocks
    to give each of the 132 SMs ~4 (few rows leave only N/128 column
    blocks), but never more fp32 partial traffic (written and read back,
    8 B an output a split) than the packed weight's own bytes, and never
    an empty split (the launcher gives each split ceil(K tiles / splits)
    tiles).  Blocks of the mma.sync body's 64 rows (fp32's 8-row blocks
    are not counted)."""
    n_k = -(-K // _BK)
    blocks = -(-N // _BN) * -(-M // _BM)
    want = max(1, -(-528 // blocks))
    cap = max(1, weight_bytes // (8 * M * N))
    splits = max(1, min(want, cap, n_k))
    return -(-n_k // -(-n_k // splits))
