"""The device rule, and a model's init generator.

Entry points run on `cuda` unless the caller asks for the CPU: with no
CUDA device and no explicit `device="cpu"` they raise, so a run meant
for the card can never quietly fall back to the host.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "module_device", "init_generator"]


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


def init_generator(device, seed, generator=None) -> torch.Generator:
    """A model's init generator: the caller's, or a new one on `device`
    seeded with `seed`.  The random initializers (and Dropout) draw from
    it; a CPU and a CUDA generator of one seed give different streams."""
    if generator is not None:
        return generator
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen
