"""RMSNorm forward: the Hopper kernel (csrc/rms_norm.cu) and its plain
PyTorch version.

Replaces the TPU kernel `paddle_tpu/ops/pallas/rms_norm.py::rms_norm`
(:130, forward `_rms2` :78 / `_fwd_kernel` :43).  The plain version is
the reference's twin `xla_rms_norm` (ops/__init__.py:306): fp32
statistics, a cast to the input dtype, THEN the multiply by the weight.
The kernel casts once, after the multiply (as `_fwd_kernel` does), so
in bf16 the two differ by one rounding; in fp32 they agree to the sum
order.

`rms_norm` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor, or raises — there is no fallback.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["rms_norm", "plain_rms_norm", "launches"]

# kernel launches since the last reset (chip_smoke.py zeroes and reads it)
launches = 0


def plain_rms_norm(x, weight=None, epsilon=1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


def rms_norm(x, weight, epsilon=1e-6):
    """x [..., H]; weight [H] of x's dtype."""
    if x.device.type == "cpu":
        return plain_rms_norm(x, weight, epsilon)
    return _launch(x, weight, float(epsilon))


def _launch(x, weight, epsilon):
    global launches
    req = _build.require
    req(weight is not None, "rms_norm kernel needs a weight")
    dev = _build.cuda_device_index(x, weight)
    code = _build.dtype_code(x.dtype)
    H = x.shape[-1]
    req(x.numel() > 0, "rms_norm kernel: empty input", x)
    req(weight.dtype == x.dtype and weight.shape == (H,),
        "rms_norm kernel takes a weight [H] of x's dtype", x, weight)
    req(x.is_contiguous() and weight.is_contiguous(),
        "rms_norm kernel needs contiguous x and weight", x, weight)
    out = torch.empty_like(x)
    rc = _build.library().ptt_rms_norm(
        dev, code, x.data_ptr(), weight.data_ptr(), out.data_ptr(),
        x.numel() // H, H, epsilon, _build.stream_of(x.device))
    _build.check(rc, "rms_norm")
    launches += 1
    return out
