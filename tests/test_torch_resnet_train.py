"""The port's ResNet training step against paddle_tpu's, on the CPU:
`TrainStep.run_steps` with Momentum and SGD, buffers and velocity,
`to_static`'s eval forward, and weights carried both ways.

resnet18 from the reference's own initialisation after
`paddle_tpu.seed(0)` (bench_resnet's seed; no perturbation: this is the
state bench_resnet trains from) takes K = 4 steps at bench.py's CPU
batch (32 images of 32x32, made like `_class_correlated_images`) with
bench_resnet's `Momentum(0.02, momentum=0.9, weight_decay=1e-4)`, and
with `SGD(0.02, weight_decay=1e-4)`, in both packages' `TrainStep.
run_steps`.  Tolerances, with their reasons:

  * after the first step each parameter, running statistic and
    velocity is within 1e-3 of its change in that step, in norm
    (measured 1.1e-4): one step from equal states differs only by one
    backward's rounding, and a wrong or missing update is off by O(1)
    of the change;
  * after K steps the losses, every parameter, running statistic and
    velocity are held to the reference's rounding spread (tests/
    torch_vision_pair.py: 4x the distance of the reference's run on
    each step's batch in another order).  Training at lr 0.02 from
    initialisation amplifies rounding: the permuted run's losses move
    by up to ~5% by step 4 where the port's agree to ~1e-5 (measured);
  * the first loss, before any update: rtol 1e-5;
  * `run_steps` against K single calls of the port: bit-identical;
  * `to_static`'s eval forward: 1e-5 of the largest |logit| plus 1e-5
    relative;
  * the SGD and Momentum (and Nesterov) rules alone, 3 steps on the same
    arrays: rtol 1e-6 (one fp32 rounding; the same operations in the
    same order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cpu import one_cpu_thread  # noqa: F401 (autouse)
from torch_vision_pair import dist, images, pair, within_spread

import paddle_tpu
import paddle_tpu.nn.functional as JF
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.jit import to_static as j_to_static
from paddle_tpu.vision import models as jmodels

from paddle_tpu_torch.jit import TrainStep, to_static
from paddle_tpu_torch.models import load_numpy_state_dict, numpy_state_dict
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import SGD, Momentum
from paddle_tpu_torch.vision import models

TOL = 1e-5
LR, MU, WD, K, BATCH = 0.02, 0.9, 1e-4, 4, 32

OPTIMIZERS = {
    "momentum": (lambda params: paddle_tpu.optimizer.Momentum(
        LR, momentum=MU, parameters=params, weight_decay=WD),
        lambda params: Momentum(LR, momentum=MU, parameters=params,
                                weight_decay=WD)),
    "sgd": (lambda params: paddle_tpu.optimizer.SGD(
        LR, parameters=params, weight_decay=WD),
        lambda params: SGD(LR, parameters=params, weight_decay=WD)),
}


def _loss(out, label):
    return F.cross_entropy(out, label)


def _ref_train(w0, make_j, xs, ys):
    """The reference resnet18 from `w0` through its TrainStep.run_steps
    on the stacked batches: (losses, state, velocities, the model)."""
    jm = jmodels.resnet18(num_classes=10)
    jm.set_state_dict(w0)
    jstep = JTrainStep(jm, lambda o, t: JF.cross_entropy(o, t),
                       make_j(jm.parameters()))
    losses = np.asarray(jstep.run_steps(paddle_tpu.to_tensor(xs),
                                        paddle_tpu.to_tensor(ys)).value)
    assert jstep.optimizer._step_count == len(xs)
    velocity = {n: np.asarray(s["velocity"])
                for n, s in zip(jstep._names, jstep._opt_states)
                if "velocity" in s}
    return (losses, {k: np.asarray(v.value) for k, v
                     in jm.state_dict().items()}, velocity, jm)


def _velocity(step):
    return {n: s["velocity"].numpy()
            for n, s in zip(step._names, step._opt_states) if s}


@pytest.fixture(scope="module", params=sorted(OPTIMIZERS))
def trained(request):
    """resnet18 from the same state trained by each package's
    TrainStep.run_steps: one step, then K steps on one stacked epoch
    slice [K, 32, 3, 32, 32]; and by the reference's again with each
    step's batch permuted."""
    make_j, make_t = OPTIMIZERS[request.param]
    _, tm, w0 = pair("resnet18", seed=0, perturb=False, num_classes=10)
    x, y = images(K * BATCH, 0)
    xs, ys = x.reshape(K, BATCH, 3, 32, 32), y.reshape(K, BATCH)
    first = _ref_train(w0, make_j, xs[:1], ys[:1])
    ref = _ref_train(w0, make_j, xs, ys)
    p = np.stack([np.random.RandomState(5 + i).permutation(BATCH)
                  for i in range(K)])
    perm = _ref_train(w0, make_j, np.take_along_axis(
        xs, p[:, :, None, None, None], 1), np.take_along_axis(ys, p, 1))
    one = models.resnet18(num_classes=10, device="cpu")
    load_numpy_state_dict(one, w0)
    step1 = TrainStep(one, _loss, make_t(one.parameters()))
    step1.run_steps(torch.from_numpy(xs[:1]), torch.from_numpy(ys[:1]))
    step = TrainStep(tm, _loss, make_t(tm.parameters()))
    losses = step.run_steps(torch.from_numpy(xs), torch.from_numpy(ys))
    return dict(name=request.param, tm=tm, step=step, w0=w0, first=first,
                ref=ref, perm=perm, losses=losses,
                one=(numpy_state_dict(one), _velocity(step1)))


def test_first_step_matches_reference(trained):
    """One step from the same state: each parameter and running
    statistic within 1e-3 of its change, in norm, and the velocity
    (the first step's L2-decayed gradient) within 1e-3 of itself."""
    got, vel = trained["one"]
    _, want, want_vel, _ = trained["first"]
    w0 = trained["w0"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert dist(got[k], want[k]) <= 1e-3 * dist(want[k], w0[k]), k
    assert sorted(vel) == sorted(want_vel)
    assert bool(vel) == (trained["name"] == "momentum")
    for k in want_vel:
        assert dist(vel[k], want_vel[k]) <= \
            1e-3 * float(np.linalg.norm(want_vel[k])), k


def test_run_steps_losses_match_reference(trained):
    losses, want = trained["losses"], trained["ref"][0]
    assert losses.shape == (K,) and losses.dtype == torch.float32
    assert not losses.requires_grad
    np.testing.assert_allclose(losses[0].item(), want[0], rtol=TOL)
    within_spread({"losses": losses.numpy()}, {"losses": want},
                  {"losses": trained["perm"][0]}, "losses")
    assert trained["step"].optimizer._step_count == K


def test_run_steps_parameters_and_buffers_match_reference(trained):
    """Every parameter and both running statistics of every BatchNorm
    after K steps (the reference threads the buffers through its scan,
    the port updates them in each eager forward)."""
    got, want = numpy_state_dict(trained["tm"]), trained["ref"][1]
    assert sorted(got) == sorted(want)
    assert sum(k.endswith(("_mean", "_variance")) for k in want) == 40
    within_spread(got, want, trained["perm"][1], "state")


def test_run_steps_velocity_matches_reference(trained):
    got, want = _velocity(trained["step"]), trained["ref"][2]
    assert sorted(got) == sorted(want)
    assert bool(got) == (trained["name"] == "momentum")
    within_spread(got, want, trained["perm"][2], "velocity")


def test_trained_state_carries_back_to_the_reference(trained):
    """numpy_state_dict of the trained port model, parameters and
    buffers, loads by name into the reference model (over its own
    trained state); the port's `to_static` eval forward then equals the
    reference's `to_static` one."""
    tm, jm = trained["tm"], trained["ref"][3]
    jm.set_state_dict(numpy_state_dict(tm))
    jm.eval()
    tm.eval()
    x, _ = images(4, 7)
    want = np.asarray(j_to_static(jm)(paddle_tpu.to_tensor(x)).value)
    got = to_static(tm)(torch.from_numpy(x))
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL,
                               atol=TOL * np.abs(want).max())
    tm.train()


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_run_steps_is_k_single_steps(opt):
    """run_steps over [K, ...] equals K calls of the step, bit for bit:
    losses, parameters, running statistics and optimizer state."""
    _, make_t = OPTIMIZERS[opt]
    _, a, w = pair("resnet18", seed=5, num_classes=10)
    b = models.resnet18(num_classes=10, device="cpu")
    load_numpy_state_dict(b, w)
    x, y = images(2 * 4, 6)
    xs, ys = torch.from_numpy(x.reshape(2, 4, 3, 32, 32)), \
        torch.from_numpy(y.reshape(2, 4))
    sa = TrainStep(a, _loss, make_t(a.parameters()))
    sb = TrainStep(b, _loss, make_t(b.parameters()))
    stacked = sa.run_steps(xs, ys)
    single = torch.stack([sb(xs[i], ys[i]) for i in range(2)])
    assert torch.equal(stacked, single)
    for (n, ta), tb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(ta, tb), n
    for st_a, st_b in zip(sa._opt_states, sb._opt_states):
        assert all(torch.equal(st_a[k], st_b[k]) for k in st_a)
    assert sa.optimizer._step_count == sb.optimizer._step_count == 2


def test_to_static_leaves_the_layer_as_it_is():
    """to_static runs the layer in its current mode without a graph and
    changes nothing of it: the layer still trains afterwards; as a
    decorator it wraps a function the same way."""
    tm = models.resnet18(num_classes=10, device="cpu", seed=8)
    x, y = images(4, 9)
    tx = torch.from_numpy(x)
    tm.eval()
    out = to_static(tm)(tx)
    assert not out.requires_grad
    assert torch.equal(out, tm(tx).detach())
    tm.train()
    F.cross_entropy(tm(tx), torch.from_numpy(y)).backward()
    assert all(p.grad is not None for p in tm.parameters())

    @to_static
    def total(t):
        return (t * 2.0).sum()
    w = torch.ones(3, requires_grad=True)
    assert total(w).item() == 6.0 and not total(w).requires_grad
    assert not to_static()(lambda t: t * 2.0)(w).requires_grad


@pytest.mark.parametrize("wd", [0.0, WD])
@pytest.mark.parametrize("rule", ["sgd", "momentum", "nesterov"])
def test_update_rules_match_reference(rule, wd):
    """The pure rules, 3 steps on the same fp32 arrays: SGD, Momentum and
    Momentum with Nesterov, with and without L2 decay; the port's in
    place, the reference's returning new arrays; the velocity kept in the
    parameter's dtype.  The same fp32 operations in the same order:
    within one fp32 rounding of each value."""
    rng = np.random.RandomState(11)
    p0 = rng.randn(37, 5).astype(np.float32)
    grads = [rng.randn(37, 5).astype(np.float32) for _ in range(3)]
    if rule == "sgd":
        jcls, tcls, hp = paddle_tpu.optimizer.SGD, SGD, {}
    else:
        jcls, tcls = paddle_tpu.optimizer.Momentum, Momentum
        hp = {"mu": MU, "nesterov": rule == "nesterov"}
    jp, js = jnp.asarray(p0), {} if rule == "sgd" else {
        "velocity": jnp.zeros_like(jnp.asarray(p0))}
    tp = torch.from_numpy(p0.copy())
    ts = {} if rule == "sgd" else {"velocity": torch.zeros_like(tp)}
    for i, g in enumerate(grads):
        jp, js = jcls._update(jp, jnp.asarray(g), js, LR, wd, i + 1, **hp)
        tcls._update(tp, torch.from_numpy(g), ts, LR, wd, i + 1, **hp)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)
    for k in js:
        assert ts[k].dtype == tp.dtype
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=1e-6, atol=1e-7)
    half = torch.zeros(4, dtype=torch.bfloat16)
    assert Momentum(LR, parameters=[half])._init_state(half)[
        "velocity"].dtype == torch.bfloat16
