"""Carry weights into the port by name.

`load_numpy_state_dict(model, {name: ndarray})` takes the values of a
`paddle_tpu` model's `state_dict()` as numpy arrays and copies them
into the port's parameters and persistable buffers (BatchNorm's `_mean`
and `_variance`) of the same names.  Both packages keep the [in, out]
layout (`x @ w`), so nothing is transposed.  A missing, extra or
mis-shaped name raises before anything is written.

Weight-only packed models carry over too: a model that
`quantization.quantize_model` packed holds int8 parameters under the
original names plus `<name>_scale` siblings, as the reference's does.
Quantize the port model at the same configuration first; its packed
parameters then take the reference's int8 arrays as they are (an int8
parameter takes only an int8 array, and an int8 array loads only into
one), and
`numpy_state_dict` hands int8 parameters out as int8.  It also gathers
the shards of a model that a ZeRO-3 `parallel.ShardedTrainStep` trains,
so it returns whole tensors on every rank.

`load_numpy_opt_state(step, {name: {key: ndarray}}, step_count)` does
the same for a train step's optimizer state: the reference
`jit.TrainStep._opt_states` (moment1 / moment2 / ef / master per
parameter, as numpy) become the port's `TrainStep` state, so a run can
be compared mid-way.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["load_numpy_state_dict", "numpy_state_dict",
           "load_numpy_opt_state"]


def _to_tensor(arr) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.kind not in "fiub" or a.dtype.name == "bfloat16":
        # numpy has no native bfloat16 (ml_dtypes adds one torch cannot
        # read): widen exactly to float32, the parameter cast narrows
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a))


def _persistable_buffers(model: torch.nn.Module):
    """{structural name: buffer} of the buffers `state_dict` holds."""
    out = {}
    for prefix, m in model.named_modules():
        for n, b in m._buffers.items():
            if b is not None and n not in m._non_persistent_buffers_set:
                out[f"{prefix}.{n}" if prefix else n] = b
    return out


def load_numpy_state_dict(model: torch.nn.Module,
                          state: Mapping[str, object]) -> None:
    params = dict(model.named_parameters())
    buffers = _persistable_buffers(model)
    missing = sorted((set(params) | set(buffers)) - set(state))
    extra = sorted(set(state) - set(params) - set(buffers))
    if missing or extra:
        raise KeyError(f"state dict does not match the model: missing "
                       f"{missing}, unexpected {extra}")
    for name, p in params.items():
        shape = tuple(np.shape(state[name]))
        if shape != tuple(p.shape):
            raise ValueError(f"{name}: shape {shape} != parameter shape "
                             f"{tuple(p.shape)}")
        packed = np.asarray(state[name]).dtype == np.int8
        if packed != (p.dtype == torch.int8):
            raise ValueError(
                f"{name}: a {np.asarray(state[name]).dtype} array cannot "
                f"load into a {p.dtype} parameter (a weight-only packed "
                f"parameter takes the packed int8 values, and only it; "
                f"quantize both models at the same configuration)")
    for name, b in buffers.items():
        shape = tuple(np.shape(state[name]))
        if shape != tuple(b.shape):
            raise ValueError(f"{name}: shape {shape} != buffer shape "
                             f"{tuple(b.shape)}")
    with torch.no_grad():
        for name, t in list(params.items()) + list(buffers.items()):
            t.copy_(_to_tensor(state[name]).to(device=t.device,
                                               dtype=t.dtype))


def numpy_state_dict(model: torch.nn.Module):
    """{name: ndarray} of every parameter — float32, or int8 for a
    weight-only packed parameter — and every persistable buffer (float32
    if floating), a copy that later updates of the model leave alone:
    the inverse view, for round-trip checks and carrying a model to
    another device.  A parameter that a ZeRO-3 `parallel.ShardedTrainStep`
    holds as shards (its `zero_shard`) is gathered whole: then every
    rank of the group calls this together."""
    out = {}
    for n, p in model.named_parameters():
        shard = getattr(p, "zero_shard", None)
        t = p.detach() if shard is None else shard.gathered_copy()
        t = (t if t.dtype == torch.int8 else t.float()).cpu()
        # a snapshot: an fp32 CPU parameter's .numpy() would share its
        # storage and follow later in-place updates
        out[n] = t.numpy().copy() if t.data_ptr() == p.data_ptr() \
            else t.numpy()
    for n, b in _persistable_buffers(model).items():
        t = b.detach().float() if b.is_floating_point() else b.detach()
        out[n] = t.cpu().numpy().copy()
    return out


def load_numpy_opt_state(step, states: Mapping[str, Mapping[str, object]],
                         step_count=None) -> None:
    """Copy {param name: {state key: array}} into the optimizer state of
    the port's `jit.TrainStep` `step` (each value cast to the dtype of
    the state it replaces), and set the optimizer's step count."""
    if step._opt_states is None:
        step._opt_states = step._init_opt_states()
    names = list(step._names)
    if sorted(states) != sorted(names):
        raise KeyError(f"optimizer state does not match the step: missing "
                       f"{sorted(set(names) - set(states))}, unexpected "
                       f"{sorted(set(states) - set(names))}")
    for name, st in zip(names, step._opt_states):
        if sorted(states[name]) != sorted(st):
            raise KeyError(f"{name}: state keys {sorted(states[name])} != "
                           f"{sorted(st)}")
        for key, t in st.items():
            if tuple(np.shape(states[name][key])) != tuple(t.shape):
                raise ValueError(f"{name}.{key}: shape "
                                 f"{np.shape(states[name][key])} != "
                                 f"{tuple(t.shape)}")
    with torch.no_grad():
        for name, st in zip(names, step._opt_states):
            for key, t in st.items():
                t.copy_(_to_tensor(states[name][key]).to(device=t.device,
                                                         dtype=t.dtype))
    if step_count is not None:
        step.optimizer._step_count = int(step_count)
