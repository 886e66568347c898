"""The device rule.

Entry points run on `cuda` unless the caller asks for the CPU: with no
CUDA device and no explicit `device="cpu"` they raise, so a run meant
for the card can never quietly fall back to the host.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "module_device"]


def resolve_device(device=None) -> torch.device:
    """`cuda` (the current CUDA device) when `device` is None, else the
    device asked for.  Raises RuntimeError when CUDA is wanted and
    absent."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU (the plain PyTorch versions of the kernels)")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} asked for, but no CUDA "
                               "device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: cuda or cpu")
    return dev


def module_device(module: torch.nn.Module) -> torch.device:
    """The one device every parameter of `module` lives on."""
    devs = {p.device for p in module.parameters()}
    if len(devs) != 1:
        raise ValueError(f"module parameters span devices {sorted(map(str, devs))}")
    return devs.pop()
