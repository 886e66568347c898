#!/usr/bin/env python3
"""How far the card's fp32 convolutions and ResNet-50 gradients lie from
fp64, and whether TF32 is in them.

    python3 tools/cudnn_fp32_check.py

From the repo root, on one CUDA card, with TF32 off as chip_smoke.py
sets it (`allow_tf32 = False` for matmuls and cuDNN):

  * one convolution's output, input gradient and weight gradient in fp32
    against the same in fp64 (relative distance in norm) at four of
    resnet50's shapes at batch 256 on 32x32 images (3x3 at 8x8 and 4x4,
    the 7x7 stride-2 stem, 1x1 at 2x2), with TF32 off, with TF32 on, and
    with cuDNN off;
  * resnet50(num_classes=10) from seed 16 on chip_smoke phase 16a's 16
    images, in eval and in training mode: each parameter's gradient on
    the card in fp32 and on the CPU in fp32 against the CPU in fp64
    (the median and the largest relative distance over the tensors,
    and the logits'), with cuDNN on and off.

It prints the card's name and power limit, one JSON line a part, and last
`{"ok": true, "device": ...}`.  Exits 2 without a CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

# (batch, channels, spatial, kernel, stride) of resnet50 at 32x32
CONV_SHAPES = ((256, 64, 8, 3, 1), (256, 256, 4, 3, 1), (256, 3, 32, 7, 2),
               (256, 512, 2, 1, 1))


def _rel(a, b):
    return ((a.double().cpu() - b.double().cpu()).norm()
            / b.double().cpu().norm()).item()


def conv_errors(torch, dev):
    """{shape: [output, input grad, weight grad] relative distance}."""
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    F = torch.nn.functional
    out = {}
    for n, c, h, k, s in CONV_SHAPES:
        co = 64 if c == 3 else c
        x = torch.randn(n, c, h, h, generator=g, device=dev,
                        dtype=torch.float64)
        w = torch.randn(co, c, k, k, generator=g, device=dev,
                        dtype=torch.float64) / (c * k * k) ** 0.5
        res = {}
        for dt in (torch.float64, torch.float32):
            xx = x.to(dt).clone().requires_grad_()
            ww = w.to(dt).clone().requires_grad_()
            y = F.conv2d(xx, ww, stride=s, padding=k // 2)
            gy = 1.0 + 0.01 * torch.arange(y.numel(), device=dev,
                                           dtype=dt).reshape(y.shape) \
                / y.numel()
            y.backward(gy)
            res[dt] = (y.detach(), xx.grad, ww.grad)
        out[f"{n}x{c}x{h}x{h} k{k} s{s}"] = [
            _rel(a, b) for a, b in zip(res[torch.float32],
                                       res[torch.float64])]
    return out


def resnet_errors(torch, dev, mode):
    """Gradients and logits of resnet50 on the card in fp32 and the CPU
    in fp32, each against the CPU in fp64."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from paddle_tpu_torch.models import (load_numpy_state_dict,
                                         numpy_state_dict)
    from paddle_tpu_torch.vision.models import resnet50
    x, y = cs._class_correlated_images(16, 10, np.random.RandomState(16))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    w = numpy_state_dict(resnet50(num_classes=10, device="cpu", seed=16))

    def run(device, dtype):
        m = resnet50(num_classes=10, device=device, seed=16)
        load_numpy_state_dict(m, w)
        m.to(dtype)
        getattr(m, mode)()
        out = m(tx.to(device, dtype))
        torch.nn.functional.cross_entropy(out, ty.to(device)).backward()
        return out.detach(), {n: p.grad.detach()
                              for n, p in m.named_parameters()}
    l64, g64 = run("cpu", torch.float64)
    res = {}
    for tag, device in (("cpu32", "cpu"), ("card32", dev)):
        lg, gr = run(device, torch.float32)
        rel = sorted(_rel(gr[n], g64[n]) for n in g64)
        res[tag] = dict(logits=_rel(lg, l64),
                        grad_median=rel[len(rel) // 2], grad_max=rel[-1])
    return res


def main():
    import torch
    if not torch.cuda.is_available():
        print("cudnn_fp32_check: no CUDA device is available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip(), flush=True)
    print(json.dumps({"torch": torch.__version__,
                      "cudnn": torch.backends.cudnn.version()}), flush=True)
    cudnn = torch.backends.cudnn
    print(json.dumps({"conv, TF32 off": conv_errors(torch, dev)}),
          flush=True)
    cudnn.allow_tf32 = True
    print(json.dumps({"conv, TF32 on": conv_errors(torch, dev)}), flush=True)
    cudnn.allow_tf32 = False
    for mode in ("eval", "train"):
        print(json.dumps({f"resnet50 {mode}, cuDNN on":
                          resnet_errors(torch, dev, mode)}), flush=True)
    cudnn.enabled = False
    print(json.dumps({"conv, cuDNN off": conv_errors(torch, dev)}),
          flush=True)
    for mode in ("eval", "train"):
        print(json.dumps({f"resnet50 {mode}, cuDNN off":
                          resnet_errors(torch, dev, mode)}), flush=True)
    cudnn.enabled = True
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
