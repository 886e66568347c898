"""`layer_norm` over the last len(normalized_shape) dims, `batch_norm`
and `group_norm`.

Counterpart of `paddle_tpu/nn/functional/norm.py`:

  * `layer_norm` (:17): `ops.layer_norm`'s math (fp32 statistics, the
    normalized value in the input's dtype, then the affine in the
    promoted dtype);
  * `batch_norm` (:63-123) over every dim but the channel one (dim 1,
    or the last for a channels-last `data_format` of an input of more
    than 2 dims).  In training, and unless `use_global_stats`, it
    normalizes by the batch's biased variance and updates the running
    statistics IN PLACE, once a call: running = momentum running +
    (1 - momentum) batch, the variance unbiased (n / (n - 1)).  Paddle's
    momentum weighs the running value, so torch's is 1 - momentum.
    Otherwise it normalizes by the running statistics.  An fp32 input
    is one `torch.nn.functional.batch_norm` call (cuDNN's on the card),
    and so is an fp64 one (statistics in fp64: the reference, whose
    arrays are fp32 unless jax's x64 mode is on, has no such case); a
    half-precision one takes fp32 statistics, rounds the normalized
    value to its dtype and applies the affine in the promoted dtype, as
    the reference does;
  * `group_norm` (:158-198): the channels (dim 1, or the last for a
    channels-last `data_format`) split into `num_groups` groups, each
    normalized over its channels and the spatial dims with fp32
    statistics (the biased variance); the normalized value is rounded to
    the input's dtype, then `* weight` and `+ bias` in the promoted
    dtype, so a bf16 input with fp32 parameters gives fp32, as jnp
    promotes it.  The statistics and the normalization are one
    `torch.nn.functional.group_norm` call on the fp32 input.
"""
from __future__ import annotations

import torch

from ... import ops

__all__ = ["layer_norm", "batch_norm", "group_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    return ops.layer_norm(x, weight, bias, epsilon,
                          normalized_shape=normalized_shape)


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    chan_last = data_format[-1] == "C" and x.ndim > 2
    if chan_last:
        x = x.movedim(-1, 1)
    use_batch = training and not use_global_stats
    if x.dtype in (torch.float32, torch.float64):
        out = torch.nn.functional.batch_norm(
            x, running_mean, running_var, weight, bias, use_batch,
            1.0 - momentum, epsilon)
    else:
        out = _batch_norm_half(x, running_mean, running_var, weight, bias,
                               use_batch, momentum, epsilon)
    return out.movedim(1, -1) if chan_last else out


def _batch_norm_half(x, running_mean, running_var, weight, bias, use_batch,
                     momentum, epsilon):
    shape = [1] * x.ndim
    shape[1] = x.shape[1]
    xf = x.float()
    if use_batch:
        dims = [d for d in range(x.ndim) if d != 1]
        mean = xf.mean(dims)
        var = xf.var(dims, correction=0)
        if running_mean is not None:
            n = x.numel() // x.shape[1]
            with torch.no_grad():
                running_mean.copy_(momentum * running_mean.float()
                                   + (1 - momentum) * mean)
                running_var.copy_(momentum * running_var.float()
                                  + (1 - momentum)
                                  * (var * n / max(n - 1, 1)))
    else:
        mean, var = running_mean.float(), running_var.float()
    out = ((xf - mean.reshape(shape))
           * torch.rsqrt(var.reshape(shape) + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    chan_last = data_format[-1] == "C" and x.ndim > 2
    xm = x.movedim(-1, 1) if chan_last else x
    out = torch.nn.functional.group_norm(xm.float(), num_groups,
                                         eps=epsilon)
    if chan_last:
        out = out.movedim(1, -1)
    out = out.to(x.dtype)
    shape = [1] * x.ndim
    shape[x.ndim - 1 if chan_last else 1] = x.shape[-1 if chan_last else 1]
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out
