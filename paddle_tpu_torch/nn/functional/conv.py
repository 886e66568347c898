"""Convolutions: conv1d/2d/3d and their transposes.

Counterpart of `paddle_tpu/nn/functional/conv.py` (:46-178), which
computes them with `jax.lax.conv_general_dilated`, outside any Pallas
kernel.  Here they are `torch.nn.functional.conv*d` /
`conv_transpose*d` (cuDNN on the card), as matmuls go to cuBLAS.

  * `padding` takes the reference's forms (`_padding`, :26-43): "SAME"
    or "VALID", an int, n ints, 2n ints (lo, hi per spatial dim), or
    nested [lo, hi] pairs (with or without the batch and channel dims).
    "SAME" is lax's rule: out = ceil(in / stride), the total padding
    split lo = total // 2.  torch takes only symmetric padding, so an
    asymmetric one is an explicit zero `F.pad` before the call;
  * a transpose runs with no padding and then crops lo from the front
    and hi - output_padding from the back of each spatial dim (a
    negative amount adds zeros), as the reference's dilated convolution
    over (k_eff - 1 - lo, k_eff - 1 - hi + output_padding) pads gives;
    the bias is added after, and `output_size` pads zeros at the end;
  * channels-last layouts (NLC, NHWC, NDHWC) are a permute around the
    channels-first call;
  * the weights are OI[D]HW for a convolution and [in, out / groups,
    k...] for a transpose, the layouts both packages use.
"""
from __future__ import annotations

import torch.nn.functional as TF

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def _tuplize(v, n):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(v)
    return v * n if len(v) == 1 else v


def _padding(padding, n):
    """The reference's padding spec as "SAME" / "VALID" or n (lo, hi)
    pairs."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n and all(isinstance(p, int) for p in padding):
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    if all(isinstance(p, (list, tuple)) for p in padding):
        flat = [tuple(p) for p in padding]
        if len(flat) == n + 2:
            flat = flat[2:]
        if len(flat) == n:
            return flat
    raise ValueError(f"bad padding {padding}")


def _same(sizes, window, strides):
    """lax's SAME pads: out = ceil(in / stride), lo = total // 2."""
    pads = []
    for size, k, s in zip(sizes, window, strides):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _flat(pads):
    """(lo, hi) pairs of the spatial dims in F.pad's order (last first)."""
    return [p for lo_hi in reversed(pads) for p in lo_hi]


def _channels_first(x, data_format):
    return x.movedim(-1, 1) if data_format[-1] == "C" else x


def _restore(out, data_format):
    return out.movedim(1, -1) if data_format[-1] == "C" else out


def _conv(x, weight, bias, stride, padding, dilation, groups, nd,
          data_format):
    strides, dilations = _tuplize(stride, nd), _tuplize(dilation, nd)
    x = _channels_first(x, data_format)
    k_eff = [(k - 1) * d + 1 for k, d in zip(weight.shape[2:], dilations)]
    pad = _padding(padding, nd)
    if pad == "SAME":
        pad = _same(x.shape[2:], k_eff, strides)
    elif pad == "VALID":
        pad = [(0, 0)] * nd
    if all(lo == hi >= 0 for lo, hi in pad):
        sym = tuple(lo for lo, _ in pad)
    else:
        x, sym = TF.pad(x, _flat(pad)), 0
    out = _CONV[nd](x, weight, bias, strides, sym, dilations, groups)
    return _restore(out, data_format)


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    groups, dilation, output_size, nd, data_format):
    strides, dilations = _tuplize(stride, nd), _tuplize(dilation, nd)
    x = _channels_first(x, data_format)
    k_eff = [(k - 1) * d + 1 for k, d in zip(weight.shape[2:], dilations)]
    pad = _padding(padding, nd)
    if pad == "SAME":
        pad = [((ke - 1) // 2, ke // 2) for ke in k_eff]
    elif pad == "VALID":
        pad = [(0, 0)] * nd
    opad = _tuplize(output_padding, nd)
    out = _CONV_T[nd](x, weight, None, strides, 0, 0, groups, dilations)
    crop = [(-lo, op - hi) for (lo, hi), op in zip(pad, opad)]
    if any(c for pair in crop for c in pair):
        out = TF.pad(out, _flat(crop))
    if bias is not None:
        out = out + bias.reshape(-1, *([1] * nd))
    if output_size is not None:
        want = _tuplize(output_size, nd)
        got = tuple(out.shape[2:])
        if any(w < g for w, g in zip(want, got)):
            raise ValueError(f"output_size {list(want)} is below the "
                             f"transpose's output {list(got)}")
        out = TF.pad(out, _flat([(0, w - g) for w, g in zip(want, got)]))
    return _restore(out, data_format)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           groups, dilation, output_size, 1, data_format)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           groups, dilation, output_size, 2, data_format)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           groups, dilation, output_size, 3, data_format)
