"""Pooling: max and average pools, and the adaptive ones, 1-3d.

Counterpart of `paddle_tpu/nn/functional/pooling.py` (:48-151), which
reduces windows with `lax.reduce_window`, outside any Pallas kernel.
Here they are `torch.nn.functional`'s pools:

  * padding takes the conv forms (nn/functional/conv.py), "SAME" by
    lax's rule.  A max pool pads with -inf, an average pool with zeros;
    torch pads only symmetrically and by at most half the window, so
    other padding is an explicit `F.pad` before an unpadded pool;
  * an average pool divides by the count of real elements under the
    window (`exclusive=True`, torch's count_include_pad=False — the
    opposite of torch's default), and by the whole window with
    `exclusive=False` or with "SAME" / "VALID" padding, as the
    reference does (:69-71);
  * the adaptive pools take the bins floor(i in / out) to
    ceil((i + 1) in / out), the reference's (:117-151) and torch's;
    a None in `output_size` keeps that dim;
  * channels-last layouts are a permute around the call.

The reference accepts `ceil_mode=True`, `return_mask=True` and
`divisor_override` and ignores them (:48-77); here each raises
NotImplementedError rather than compute something else.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from .conv import _channels_first, _flat, _padding, _restore, _same, \
    _tuplize

__all__ = ["max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d"]

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}
_ADAPTIVE = {("avg", 1): TF.adaptive_avg_pool1d,
             ("avg", 2): TF.adaptive_avg_pool2d,
             ("avg", 3): TF.adaptive_avg_pool3d,
             ("max", 1): TF.adaptive_max_pool1d,
             ("max", 2): TF.adaptive_max_pool2d,
             ("max", 3): TF.adaptive_max_pool3d}


def _unported(what):
    raise NotImplementedError(
        f"{what} is not ported: the reference accepts it and ignores it "
        f"(paddle_tpu/nn/functional/pooling.py), and the port does not "
        f"compute something else in its place")


def _pool(x, kernel_size, stride, padding, nd, data_format, mode,
          ceil_mode=False, exclusive=True):
    if ceil_mode:
        _unported("ceil_mode=True")
    window = _tuplize(kernel_size, nd)
    strides = _tuplize(stride if stride is not None else kernel_size, nd)
    x = _channels_first(x, data_format)
    pad = _padding(padding, nd)
    whole = isinstance(pad, str) or not exclusive
    if pad == "SAME":
        pad = _same(x.shape[2:], window, strides)
    elif pad == "VALID":
        pad = [(0, 0)] * nd
    native = all(lo == hi and 0 <= lo <= k // 2
                 for (lo, hi), k in zip(pad, window))
    sym = tuple(lo for lo, _ in pad) if native else 0
    if mode == "max":
        if not native:
            x = TF.pad(x, _flat(pad), value=-math.inf)
        out = _MAX[nd](x, window, strides, sym)
    elif native:
        out = _AVG[nd](x, window, strides, sym, False, whole)
    else:
        out = _AVG[nd](TF.pad(x, _flat(pad)), window, strides)
        if not whole:
            # the mean over the window over the share of it that is real
            ones = TF.pad(torch.ones_like(x[:1, :1]), _flat(pad))
            out = out / _AVG[nd](ones, window, strides)
    return _restore(out, data_format)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    if return_mask:
        _unported("return_mask=True")
    return _pool(x, kernel_size, stride, padding, 1, data_format, "max",
                 ceil_mode)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    if return_mask:
        _unported("return_mask=True")
    return _pool(x, kernel_size, stride, padding, 2, data_format, "max",
                 ceil_mode)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    if return_mask:
        _unported("return_mask=True")
    return _pool(x, kernel_size, stride, padding, 3, data_format, "max",
                 ceil_mode)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool(x, kernel_size, stride, padding, 1, data_format, "avg",
                 ceil_mode, exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    if divisor_override is not None:
        _unported("divisor_override")
    return _pool(x, kernel_size, stride, padding, 2, data_format, "avg",
                 ceil_mode, exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    if divisor_override is not None:
        _unported("divisor_override")
    return _pool(x, kernel_size, stride, padding, 3, data_format, "avg",
                 ceil_mode, exclusive)


def _adaptive_pool(x, output_size, nd, data_format, mode):
    x = _channels_first(x, data_format)
    size = (output_size,) * nd if isinstance(output_size, int) \
        else tuple(output_size)
    out = _ADAPTIVE[mode, nd](x, size[0] if nd == 1 else size)
    return _restore(out, data_format)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool(x, output_size, 1, "NCL", "avg")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool(x, output_size, 2, data_format, "avg")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool(x, output_size, 3, data_format, "avg")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    if return_mask:
        _unported("return_mask=True")
    return _adaptive_pool(x, output_size, 1, "NCL", "max")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    if return_mask:
        _unported("return_mask=True")
    return _adaptive_pool(x, output_size, 2, "NCHW", "max")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    if return_mask:
        _unported("return_mask=True")
    return _adaptive_pool(x, output_size, 3, "NCDHW", "max")
