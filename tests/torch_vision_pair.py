"""Shared set-up of the port's vision tests (tests/test_torch_resnet*.py,
tests/test_torch_vision_zoo.py): bench.py's synthetic images, a
reference model's weights as numpy, the same weights in both packages,
and the rounding-spread check of training-mode results.

In training mode BatchNorm normalizes by the batch's own statistics,
and at initialisation a ResNet's fp32 results are ill-conditioned: at
resnet50, batch 16, both packages' gradients lie ~0.8% (median tensor,
in the largest entry) and up to ~14% from an fp64 evaluation of the
same weights (the port in fp64).  No fixed fp32 tolerance is then both
safe and sharp, so such a result is held to the reference's own
rounding spread: the reference run again on the same examples in
another batch order (the same function; only its summation orders
change).  The port's distance from the reference, in norm for each
tensor, is at most `SPREAD` = 4 times the permuted run's distance from
it, plus 1e-6 of the tensor's norm (measured at resnet50's gradients:
1.04x median, 1.83x worst).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu
import paddle_tpu.nn.functional as JF
from paddle_tpu.framework.tensor import Tensor as JTensor
from paddle_tpu.jit import _swapped_state
from paddle_tpu.vision import models as jmodels

from paddle_tpu_torch.models import load_numpy_state_dict, numpy_state_dict
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.vision import models

SPREAD = 4.0
TOL = 1e-5


def images(n, seed, size=32):
    """bench.py::_class_correlated_images: a template a class plus
    noise 0.6 N(0, 1)."""
    rng = np.random.RandomState(seed)
    templates = rng.randn(10, 3, size, size).astype(np.float32)
    labels = rng.randint(0, 10, n)
    imgs = templates[labels] + 0.6 * rng.randn(n, 3, size, size)
    return imgs.astype(np.float32), labels.astype(np.int64)


def perturbed_weights(jm, seed):
    """The reference model's state as numpy: its initial conv and linear
    weights; BatchNorm scales and shifts 1 + 0.1 N / 0.1 N, running
    means 0.1 N, running variances 1 + U(0, 0.2), so that eval mode
    means something."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in jm.state_dict().items():
        a = np.asarray(v.value, np.float32)
        if k.endswith("_variance"):
            a = 1.0 + 0.2 * rng.rand(*a.shape)
        elif a.ndim == 1:
            a = a + 0.1 * rng.randn(*a.shape)
        out[k] = a.astype(np.float32)
    return out


def pair(name, seed=0, perturb=True, **kw):
    """(reference model, port model, numpy state): the reference's
    `name` built after paddle_tpu.seed(seed), its state (perturbed or
    as initialised) loaded into both."""
    paddle_tpu.seed(seed)
    jm = getattr(jmodels, name)(**kw)
    w = perturbed_weights(jm, seed) if perturb else \
        {k: np.asarray(v.value) for k, v in jm.state_dict().items()}
    jm.set_state_dict(w)
    tm = getattr(models, name)(device="cpu", **kw)
    load_numpy_state_dict(tm, w)
    return jm, tm, w


def dist(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64)
                                - np.asarray(b, np.float64)))


def within_spread(got, want, perm, what):
    """got (the port) within SPREAD x the permuted reference run's
    distance from the reference `want`, per tensor."""
    for k in want:
        d, spread = dist(got[k], want[k]), dist(perm[k], want[k])
        floor = 1e-6 * float(np.linalg.norm(want[k]))
        assert d <= SPREAD * spread + floor, (what, k, d, spread)


def ref_forward_backward(jm, x, y):
    """One reference forward and backward (jax.value_and_grad, jitted as
    the reference's TrainStep jits its step) from the model's current
    state: (logits, loss, {param: grad}, {buffer: value after the
    forward}); the model's state is left as it was."""
    sd = jm.state_dict()
    names = [n for n, _ in jm.named_parameters()]
    bufs = [n for n in sd if n not in names]

    def loss_of(pv, bv, xv, yv):
        with _swapped_state(jm, names + bufs, list(pv) + list(bv)):
            out = jm(JTensor(xv))
            loss = JF.cross_entropy(out, JTensor(yv)).value
            return loss, (out.value, [sd[n]._value for n in bufs])
    (loss, (logits, new_bufs)), grads = jax.jit(jax.value_and_grad(
        loss_of, has_aux=True))([sd[n]._value for n in names],
                                [sd[n]._value for n in bufs],
                                jnp.asarray(x), jnp.asarray(y))
    return (np.asarray(logits), float(loss),
            {n: np.asarray(g) for n, g in zip(names, grads)},
            {n: np.asarray(b) for n, b in zip(bufs, new_bufs)})


def ref_eval(jm, x):
    """The reference's forward of `x` in its current mode, jitted with
    the state as arguments (the weights are not folded in as
    constants)."""
    sd = jm.state_dict()
    names = list(sd)

    def fwd(vals, xv):
        with _swapped_state(jm, names, list(vals)):
            return jm(JTensor(xv)).value
    return np.asarray(jax.jit(fwd)([sd[n]._value for n in names],
                                   jnp.asarray(x)))


def forward_backward(name, mode, batch):
    """The reference's and the port's forward and backward of `name`
    (10 classes, tests' weights) on one batch of 32x32 images in `mode`,
    and in training mode the reference's on the batch permuted:
    {"ref", "perm" (None in eval mode), "port"}, each (logits, loss,
    {param: grad}, {buffer: value after the forward}), and the weights
    "w"."""
    jm, tm, w = pair(name, num_classes=10)
    getattr(jm, mode)()
    getattr(tm, mode)()
    x, y = images(batch, 2)
    ref = ref_forward_backward(jm, x, y)
    perm = None
    if mode == "train":
        p = np.random.RandomState(3).permutation(batch)
        logits, loss, grads, bufs = ref_forward_backward(jm, x[p], y[p])
        perm = (logits[np.argsort(p)], loss, grads, bufs)
    out = tm(torch.from_numpy(x))
    loss = F.cross_entropy(out, torch.from_numpy(y))
    loss.backward()
    state = numpy_state_dict(tm)
    port = (out.detach().numpy(), loss.item(),
            {n: p.grad.numpy() for n, p in tm.named_parameters()},
            {n: state[n] for n in ref[3]})
    return dict(case=f"{name}-{mode}", ref=ref, perm=perm, port=port, w=w)


def check_logits(run):
    got, want = run["port"][0], run["ref"][0]
    if run["perm"] is None:
        np.testing.assert_allclose(got, want, rtol=TOL,
                                   atol=TOL * np.abs(want).max())
    else:
        within_spread({"logits": got}, {"logits": want},
                      {"logits": run["perm"][0]}, run["case"])


def check_loss_and_grads(run):
    """The cross-entropy loss bench_resnet trains on (in eval mode within
    the logits' tolerance, 1e-5 of the largest |logit|; rtol 1e-4 in
    training), and the gradient of every parameter against
    jax.value_and_grad (1e-5 + 1e-4 of its largest |entry| in eval mode,
    the spread in training)."""
    (logits, loss, grads, _), (_, jloss, jgrads, _) = run["port"], \
        run["ref"]
    if run["perm"] is None:
        np.testing.assert_allclose(loss, jloss, rtol=0,
                                   atol=TOL * np.abs(logits).max())
    else:
        np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    assert sorted(grads) == sorted(jgrads)
    if run["perm"] is not None:
        within_spread(grads, jgrads, run["perm"][2], run["case"])
        return
    for n, ref in jgrads.items():
        np.testing.assert_allclose(
            grads[n], ref, atol=1e-5 + 1e-4 * np.abs(ref).max(), err_msg=n)


def check_running_stats(run):
    """After one forward, every BatchNorm's `_mean` and `_variance`: moved
    in training mode (0.9 running + 0.1 batch, the variance unbiased),
    untouched in eval mode, in both packages."""
    got, want = run["port"][3], run["ref"][3]
    assert sorted(got) == sorted(want) and want
    if run["perm"] is None:
        for n in want:
            assert np.array_equal(got[n], run["w"][n]), n
            assert np.array_equal(want[n], run["w"][n]), n
        return
    assert not any(np.array_equal(got[n], run["w"][n]) for n in got)
    within_spread(got, want, run["perm"][3], run["case"])
