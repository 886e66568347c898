"""Weight-only quantization for the decode path.

Counterpart of `paddle_tpu/quantization/weight_only.py`: the same
math, sites, names and byte counts.  `quantize_model` packs a Llama's
decode-path linear weights IN PLACE — the q/k/v/o and gate/up/down
projections of every layer and an untied `lm_head` — so that decode
streams 1 byte (int8) or half a byte (int4) per weight element.  The
decode forwards (models/llama.py `_wo_mm`) then run those matmuls
through `ops.quant_matmul`: the Hopper kernel on the card, its plain
version on the CPU.  (The reference's GPT sites wait for a port of
`models/gpt.py`.)

Math (symmetric absmax):

  int8   per output channel: scale[n] = max(amax(|w[:, n]|), 1e-8) / 127,
         codes round(w / scale) clipped to [-127, 127]
  int4   per group of `group_size` rows along K: scale[g, n] =
         max(amax(|w[gG:(g+1)G, n]|), 1e-8) / 7, codes clipped to
         [-7, 7] and packed two a byte in the half-split layout
         (ops.pack_int4); group_size must divide K/2

computed in fp32 (rounding half to even), with the scales stored in
the weight's own dtype.

A packed weight replaces its parameter under the SAME name (an int8
parameter that takes no gradient) and a sibling `<name>_scale` holds
its scales, so `state_dict()` names match the reference's and a
reference model packed by its `quantize_model` loads by name
(models/convert.py).  The packed weights replace the originals, so a
quantized model is serving-only: its training `forward` raises.
Quantizing runs on the model's device.
"""
from __future__ import annotations

import torch
from torch import nn

from ..framework.flags import get_flag
from ..ops import pack_int4, dequant_weight

__all__ = ["quantize_weight", "dequantize_weight", "quantize_model",
           "weight_pool_bytes", "packed_bytes", "WEIGHT_ONLY_DTYPES"]

WEIGHT_ONLY_DTYPES = ("int8", "int4")

# decode-path matmul weights: a module holding ALL the listed parameters
# is a quantization site (embeddings are gathered, not multiplied)
_LLAMA_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
_LLAMA_MLP = ("gate_proj", "up_proj", "down_proj")


def _resolve(dtype=None, group_size=None):
    dtype = str(dtype if dtype is not None
                else get_flag("weight_only_dtype", "none"))
    if dtype in ("none", "", "None"):
        return None, None
    if dtype not in WEIGHT_ONLY_DTYPES:
        raise ValueError(f"unknown weight_only_dtype {dtype!r}; one of "
                         f"none|{'|'.join(WEIGHT_ONLY_DTYPES)}")
    group_size = int(group_size if group_size is not None
                     else get_flag("weight_only_group_size", 64))
    return dtype, group_size


@torch.no_grad()
def quantize_weight(w, dtype="int8", group_size=64):
    """(packed, scales) for a [K, N] weight, on w's device.  int8:
    packed [K, N] int8, scales [N]; int4: packed [K//2, N] int8
    (half-split), scales [K//group_size, N].  Scales keep w's dtype."""
    w = torch.as_tensor(w)
    if w.ndim != 2:
        raise ValueError(f"weight-only quantization expects a 2-D "
                         f"weight (got shape {tuple(w.shape)})")
    K, N = w.shape
    wf = w.float()

    def qmax(v):
        # the divisor as a tensor: the card divides by a Python scalar
        # through its reciprocal, which can move a scale by an ulp
        return torch.full((), v, dtype=torch.float32, device=w.device)
    if dtype == "int8":
        scale = torch.clamp_min(wf.abs().amax(dim=0), 1e-8) / qmax(127.0)
        q = torch.clamp(torch.round(wf / scale[None]), -127, 127)
        return q.to(torch.int8), scale.to(w.dtype)
    if dtype != "int4":
        raise ValueError(f"unknown weight-only dtype {dtype!r}")
    g = int(group_size)
    if K % 2 or (K // 2) % g:
        raise ValueError(
            f"int4 group_size {g} must divide K/2 (K={K}); pick a "
            f"group size that divides half the input dimension")
    wg = wf.reshape(K // g, g, N)
    scale = torch.clamp_min(wg.abs().amax(dim=1), 1e-8) / qmax(7.0)
    q = torch.clamp(torch.round(wg / scale[:, None, :]), -7, 7)
    return pack_int4(q.to(torch.int32).reshape(K, N)), scale.to(w.dtype)


def dequantize_weight(packed, scales, dtype="int8", group_size=64):
    """fp32 [K, N] reconstruction (ops.dequant_weight)."""
    return dequant_weight(packed, scales, dtype, group_size)


def _quantize_param(layer, name, dtype, group_size):
    packed, scale = quantize_weight(getattr(layer, name).detach(), dtype,
                                    group_size)
    # the packed weight takes the parameter's name, so state_dict names
    # stay the reference's; int8 takes no gradient
    setattr(layer, name, nn.Parameter(packed, requires_grad=False))
    layer.register_parameter(name + "_scale",
                             nn.Parameter(scale, requires_grad=False))


def _mark(layer, dtype, group_size):
    layer._wo_dtype = dtype
    layer._wo_group = group_size


def _sites(model):
    """(module, [parameter names]) of every quantization target."""
    for sub in model.modules():
        params = sub._parameters
        for group in (_LLAMA_ATTN, _LLAMA_MLP):
            if all(n in params for n in group):
                yield sub, list(group)
                break
    # llama's untied lm head lives on the CausalLM wrapper itself
    if "lm_head" in model._parameters:
        yield model, ["lm_head"]


def quantize_model(model, dtype=None, group_size=None):
    """Pack `model`'s decode-path linear weights in place.  Resolves
    dtype/group_size from FLAGS_weight_only_dtype /
    FLAGS_weight_only_group_size when not given ("none" leaves the model
    as it is).  Idempotent: a model already quantized at the same
    configuration is returned untouched; a different configuration
    raises (packed weights cannot be re-packed).  Returns the model;
    `model._weight_only` records the configuration."""
    dtype, group_size = _resolve(dtype, group_size)
    if dtype is None:
        return model
    prev = getattr(model, "_weight_only", None)
    if prev is not None:
        if prev != {"dtype": dtype, "group_size": group_size}:
            raise ValueError(
                f"model already weight-only quantized at {prev}; "
                f"cannot re-quantize to {dtype}/g{group_size}")
        return model
    sites = list(_sites(model))
    if not sites:
        raise ValueError(
            "quantize_model found no weight-only quantization sites "
            "(expected llama q/k/v/o + gate/up/down parameters)")
    for layer, names in sites:
        for n in names:
            _quantize_param(layer, n, dtype, group_size)
        _mark(layer, dtype, group_size)
    model._weight_only = {"dtype": dtype, "group_size": group_size}
    return model


def _target_params(model):
    """The parameters quantize_model targets (packed or not), plus any
    installed scale siblings — the decode weight pool."""
    out = []
    for layer, names in _sites(model):
        for n in names:
            out.append(layer._parameters[n])
            if n + "_scale" in layer._parameters:
                out.append(layer._parameters[n + "_scale"])
    return out


def weight_pool_bytes(model) -> int:
    """Resident bytes of the decode weight pool (the quantization
    targets and their scales) as the model stands."""
    return int(sum(p.numel() * p.element_size()
                   for p in _target_params(model)))


def packed_bytes(model, dtype, group_size=None) -> int:
    """What weight_pool_bytes WOULD be after quantize_model(model,
    dtype) — shape arithmetic only.  The model must be unquantized."""
    if getattr(model, "_weight_only", None) is not None:
        raise ValueError("packed_bytes expects an unquantized model")
    dtype, group_size = _resolve(dtype, group_size)
    total = 0
    for p in _target_params(model):
        K, N = p.shape
        sdt = p.element_size()
        if dtype is None:
            total += K * N * sdt
        elif dtype == "int8":
            total += K * N + N * sdt
        else:
            total += (K // 2) * N + (K // group_size) * N * sdt
    return int(total)
