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
each tile in shared memory right after loading it, so the weight
crosses device memory at its packed width (1 or 1/2 byte an element)
and no dequantized [K, N] weight is ever allocated.

`quant_matmul` validates its arguments first (the reference's
ValueErrors), then takes the plain version for CPU tensors and launches
the kernel for CUDA tensors, or raises — there is no fallback.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["quant_matmul", "plain_quant_matmul", "pack_int4",
           "unpack_int4", "dequant_weight", "launches", "variant_launches"]

# kernel launches since the last reset (chip_smoke.py zeroes and reads
# them), in total and by weight format (the TPU kernel body each stands
# for: _kernel_int8, _kernel_int4)
launches = {"quant_matmul": 0}
variant_launches = {"int8": 0, "int4": 0}

# the kernel's tiles (csrc/quant_matmul.cu kBN, kBK): output columns
# per block and logical K rows per tile
_BN, _BK = 128, 64


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
    splits = _splits(M, K, N, qw.numel())
    out = torch.empty(x.shape[:-1] + (N,), dtype=x.dtype, device=x.device)
    part = None
    if splits > 1:
        part = torch.empty((splits, M, N), dtype=torch.float32,
                           device=x.device)
    rc = _build.library().ptt_quant_matmul(
        dev, code, scode, int(int4), g, x.data_ptr(), qw.data_ptr(),
        scales.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), M, K, N, splits,
        _build.stream_of(x.device))
    _build.check(rc, "quant_matmul")
    launches["quant_matmul"] += 1
    variant_launches[fmt] += 1
    return out


def _splits(M, K, N, weight_bytes):
    """Splits over K: enough blocks to give each of the 132 SMs ~4 (the
    decode shapes have only N/128 column blocks), but never more fp32
    partial traffic (written and read back, 8 B an output a split) than
    the packed weight's own bytes, and never an empty split (the
    launcher gives each split ceil(K tiles / splits) tiles).  The row
    tile mirrors the launcher's choice: 16 rows up to M = 16, else 64
    (8 rows a block for fp32, which this count ignores)."""
    n_k = -(-K // _BK)
    bm = 16 if M <= 16 else 64
    blocks = -(-N // _BN) * -(-M // bm)
    want = max(1, -(-528 // blocks))
    cap = max(1, weight_bytes // (8 * M * N))
    splits = max(1, min(want, cap, n_k))
    return -(-n_k // -(-n_k // splits))
