"""The train step.

Counterpart of `paddle_tpu/jit/__init__.py::TrainStep` (:267-360,
:507): `TrainStep(model, loss_fn, optimizer)`, then
`step(*inputs, label)` returns the loss.  One step runs the forward and
the loss, `backward`, the optimizer update of every trainable parameter
(`optimizer.jit_update.apply_updates`, as the reference step calls it
at :350-356: the fused AdamW kernel where the state layout allows it,
the pure rule elsewhere), and clears the gradients.  The optimizer's
step count advances before the update, as the reference's does, so
Adam's bias correction matches; the weight-decay list follows
`apply_decay_param_fun` as at :316-322, called with each parameter's
automatic name where it has one (`p.name or n` there).

The reference compiles the whole step into one program with donated
buffers; here the step is eager and the parameters and optimizer state
are updated in place.  CUDA-graph capture, `run_steps` and the
checkpoint/telemetry hooks are not ported yet.  `parallel.
ShardedTrainStep` is this step with its batch, loss, gradient and update
parts (`_to_device`, `_loss`, `_forward_backward`, `_grads`,
`_apply_updates`) extended for ZeRO.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework.device import module_device
from ..optimizer.jit_update import apply_updates, maybe_master_state

__all__ = ["TrainStep"]


class TrainStep:
    def __init__(self, model, loss_fn, optimizer):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.device = module_device(model)
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        self._names = [n for n, _ in named]
        self._params = [p for _, p in named]
        self._wds = [optimizer._decay_of(n, p) for n, p in named]
        self._opt_states = None

    def _init_opt_states(self):
        opt = self.optimizer
        return [maybe_master_state(opt, p, opt._init_state(p))
                for p in self._params]

    def _to_device(self, b):
        if not torch.is_tensor(b):
            b = torch.from_numpy(np.asarray(b))
        return b.to(self.device)

    def __call__(self, *batch):
        """batch: (*inputs, label) tensors or arrays; returns the loss
        (a detached scalar tensor on the model's device)."""
        if self._opt_states is None:
            self._opt_states = self._init_opt_states()
        *inputs, label = [self._to_device(b) for b in batch]
        opt = self.optimizer
        opt._step_count += 1
        lr, step_i = opt.get_lr(), opt._step_count
        upd, hp = type(opt)._update, opt._hyper()
        loss = self._forward_backward(inputs, label)
        self._apply_updates(upd, self._grads(), lr, step_i, hp)
        for p in self._params:
            p.grad = None
        return loss

    # the parts of a step that parallel.ShardedTrainStep extends
    def _loss(self, inputs, label):
        return self.loss_fn(self.model(*inputs), label)

    def _forward_backward(self, inputs, label):
        """The loss of this batch (detached), its gradients in `.grad`."""
        loss = self._loss(inputs, label)
        loss.backward()
        return loss.detach()

    def _grads(self):
        # a parameter the loss does not reach has a zero gradient, as in
        # the reference's value_and_grad
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self._params]

    def _apply_updates(self, upd, grads, lr, step_i, hp):
        apply_updates(upd, self._params, grads, self._opt_states, lr,
                      self._wds, step_i, hp)
