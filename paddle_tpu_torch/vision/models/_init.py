"""The device and the init generator of a zoo model, and the
`pretrained` refusal."""
from __future__ import annotations

from ...framework.device import init_generator, resolve_device


def device_and_generator(device, seed, generator):
    """(the resolved device, the caller's generator or a new one on it
    seeded with `seed`)."""
    dev = resolve_device(device)
    return dev, init_generator(dev, seed, generator)


def no_pretrained(pretrained):
    if pretrained:
        raise RuntimeError("no pretrained weights available offline; "
                           "load a local state_dict instead")
