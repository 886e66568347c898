"""The port's ShardedTrainStep (ZeRO stages 0-3 over torch.distributed)
against paddle_tpu's, on the CPU.

The reference test's model and data (tests/test_distributed.py:180-203:
tiny Llama, 2 layers, hidden 64, vocab 128, fp32, batch 8 x 16, AdamW at
1e-2, 3 steps on one batch), its weights from `paddle_tpu.seed(0)` carried
into the port by `load_numpy_state_dict`.  The port runs as gloo ranks,
one process each (tests/torch_sharded_worker.py), spawned once per world
(2 ranks through the reference's PADDLE_* variables, 4 through
torchrun's); every case below reads what they recorded.  The reference
runs in this process on `build_mesh(sharding=N)` of the 8 virtual CPU
devices.  Tolerances, with their reasons:

  * fp32 losses: rtol = atol = 2e-4, the reference test's own;
  * fp32 parameters after 3 AdamW steps (test_torch_llama_train.py's
    limits): within 1e-5 for 99.9% of each tensor's entries, within
    2 lr steps for all (Adam normalises each update to ~lr, so a
    gradient entry near zero can flip the sign of its update);
  * bf16 moments + ef: as fp32 for the losses; parameters within 4e-5
    (2^-8 lr: a moment rounding the other way moves that step's update
    by 2^-8 of lr) for 99.9% of the entries, 2 lr steps for all;
  * a bf16 model (fp32 masters): losses rtol 1e-3 (activations and
    weights round to bf16 where XLA's and PyTorch's CPU kernels
    accumulate differently, so single roundings flip by an ulp); each
    parameter's mean |difference| under lr / 10 and every entry within
    2 lr steps + one bf16 ulp of the weight;
  * recompute against none, one device against TrainStep, and a user's
    loss_fn on the port's masked mean against `compute_loss`: equal,
    the same ops on the same values;
  * a user's loss_fn on torch's mean: the mean of the ranks' own means,
    computed here from the same weights, at the losses' 2e-4.
"""
import os
import pathlib
import pickle
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch_cpu import one_cpu_thread  # noqa: F401 (autouse)

import paddle_tpu
from paddle_tpu.distributed.fleet.base.distributed_strategy import \
    DistributedStrategy as JStrategy
from paddle_tpu.distributed.topology import batch_partition_spec as j_bps
from paddle_tpu.distributed.topology import build_mesh as j_build_mesh
from paddle_tpu.framework import flags as jflags
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.bert import BertForMaskedLM as JBert
from paddle_tpu.models.bert import bert_tiny_config as j_bert_tiny
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny_config as j_tiny
from paddle_tpu.parallel.sharded_trainer import ShardedTrainStep as JStep

import torch_sharded_worker as W
from paddle_tpu_torch.distributed import (Mesh, batch_partition_spec,
                                          build_mesh)
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny_config,
                                     load_numpy_state_dict, numpy_state_dict)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import ShardedTrainStep, shard_batch

WORKER = pathlib.Path(__file__).with_name("torch_sharded_worker.py")
WORLDS = (2, 4)
L = W.TINY["num_hidden_layers"]
# stage 3 shards every matrix: a layer's 7 (q, k, v, o, gate, up, down)
# form one unit and the root's 2 (embedding, lm head) another, each moved
# by one collective; the RMSNorm weights stay replicated
VECTORS = 2 * L + 1


# ---------------------------------------------------------------------------
# inputs, the ranks' runs and the reference's
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def inputs():
    ids = np.random.RandomState(0).randint(0, 128, (8, 16)).astype(np.int32)
    # ignored labels spread unevenly over the ranks' rows, at world 2
    # (rows 0-3 | 4-7) and 4 (0-1 | 2-3 | 4-5 | 6-7)
    ignored = ids.copy()
    ignored[0, :14] = -1
    ignored[1, ::2] = -1
    ignored[2, :5] = -1
    ignored[6, 3:9] = -1
    out = {"ids": ids, "ignored": ignored}
    for dtype in ("float32", "bfloat16"):
        paddle_tpu.seed(0)
        jm = JLlama(j_tiny(dtype=dtype, **W.TINY))
        for k, v in jm.state_dict().items():
            out[f"{dtype}:{k}"] = np.asarray(v.value, np.float32)
    paddle_tpu.seed(0)
    for k, v in JBert(j_bert_tiny()).state_dict().items():
        out[f"bert:{k}"] = np.asarray(v.value, np.float32)
    return out


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(world, inputs, tmp):
    """Start the world's ranks; returns (processes, log files, tmp)."""
    np.savez(tmp / "inputs.npz", **inputs)
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PADDLE_", "FLAGS_")) and k not in (
               "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
               "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    procs, logs = [], []
    for r in range(world):
        if world == 2:      # the reference's variables
            rank_env = dict(PADDLE_TRAINER_ID=str(r),
                            PADDLE_TRAINERS_NUM=str(world),
                            PADDLE_MASTER=f"127.0.0.1:{port}")
        else:               # torchrun's
            rank_env = dict(RANK=str(r), WORLD_SIZE=str(world),
                            LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                            MASTER_PORT=str(port))
        log = open(tmp / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), str(world), str(tmp)],
            env=dict(env, **rank_env), stdout=log, stderr=subprocess.STDOUT))
    return procs, logs, tmp


def _finish(procs, logs, tmp):
    """Wait for the ranks (killing any left at the time limit) and read
    their records."""
    try:
        for p in procs:
            p.wait(timeout=240)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (tmp / f"rank{r}.log").read_text()[-4000:]
    ranks = []
    for r in range(len(procs)):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


# the reference's runs the cases read (world, case, one device?)
REFERENCES = [(w, f"stage{s}", False) for w in WORLDS for s in range(4)] \
    + [(4, "dp2_sharding2", False), (2, "fused_ce3", True),
       (2, "ignored0", True), (2, "bert1", False)] \
    + [(2, f"bf16_{kind}{s}", False) for kind in ("moments", "model")
       for s in (1, 3)]


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """{world: [rank 0's record, rank 1's, ...]}; the reference's runs
    are made here too, while the ranks train."""
    jobs = [_start(w, inputs, tmp_path_factory.mktemp(f"world{w}"))
            for w in WORLDS]
    try:
        for key in REFERENCES:
            _reference(inputs, *key)
    finally:
        ranks = [_finish(*job) for job in jobs]
    return dict(zip(WORLDS, ranks))


_REF = {}


def _reference(inputs, world, case, one_device=False):
    """(losses, parameters) of paddle_tpu's ShardedTrainStep on the
    case's mesh of the virtual CPU devices (one_device: of its
    `jit.TrainStep`, whose numerics the reference's ZeRO stages keep:
    tests/test_distributed.py:204-227)."""
    key = (world, case, one_device)
    if key in _REF:
        return _REF[key]
    stage, axes, opts = W.cases(world)[case]
    dtype = opts.get("dtype", "float32")
    flags = opts.get("flags", {})
    if opts.get("model") == "bert":
        prefix, jm = "bert", JBert(j_bert_tiny(dtype=dtype))
    else:
        prefix = dtype
        jm = JLlama(j_tiny(dtype=dtype, **W.TINY, **opts.get("cfg", {})))
    jm.set_state_dict({k[len(prefix) + 1:]: v for k, v in inputs.items()
                       if k.startswith(prefix + ":")})
    jflags.set_flags(flags)     # the optimizer reads them at construction
    try:
        opt = paddle_tpu.optimizer.AdamW(
            W.LR, parameters=jm.parameters(),
            multi_precision=opts.get("multi_precision", False))
        if one_device:
            step = JTrainStep(jm, jm.compute_loss, opt)
        else:
            step = JStep(jm, opt, j_build_mesh(**axes),
                         sharding_stage=stage,
                         rematerialize=opts.get("remat", False))
        ids = paddle_tpu.to_tensor(inputs["ids"])
        labels = paddle_tpu.to_tensor(inputs[opts.get("labels", "ids")])
        losses = [float(np.asarray(step(ids, labels).value))
                  for _ in range(W.STEPS)]
    finally:
        jflags.set_flags({k: False for k in flags})
    params = {k: np.asarray(v.value, np.float32)
              for k, v in jm.state_dict().items()}
    _REF[key] = (losses, params)
    return _REF[key]


def _close_params(tp, jp, q999=1e-5):
    bound = 2 * W.LR * W.STEPS
    assert sorted(tp) == sorted(jp)
    for n in jp:
        d = np.abs(tp[n] - jp[n])
        assert np.quantile(d, 0.999) <= q999 and d.max() <= bound, \
            (n, np.quantile(d, 0.999), d.max())


def _same_on_every_rank(ranks, case):
    r0 = ranks[0][case]
    for r in ranks[1:]:
        assert r[case]["losses"] == r0["losses"]
        for n, v in r0["params"].items():
            np.testing.assert_array_equal(r[case]["params"][n], v,
                                          err_msg=n)


# ---------------------------------------------------------------------------
# (a) stages 0-3 against the reference, world 2 and 4
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_stage_matches_reference(runs, inputs, world, stage):
    case = f"stage{stage}"
    _same_on_every_rank(runs[world], case)
    port = runs[world][0][case]
    ref_losses, ref_params = _reference(inputs, world, case)
    np.testing.assert_allclose(port["losses"], ref_losses, rtol=2e-4,
                               atol=2e-4)
    _close_params(port["params"], ref_params)


# ---------------------------------------------------------------------------
# (b) the mechanism after a step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_stage_mechanism(runs, world, stage):
    for rank in runs[world]:
        rec = rank[f"stage{stage}"]
        numel = rec["numel"]
        matrices = sorted(n for n, v in rec["params"].items() if v.ndim >= 2)
        want = {0: [], 1: sorted(numel), 2: sorted(numel), 3: matrices}
        assert rec["sharded"] == want[stage]
        for n, k in numel.items():
            # the optimizer state holds 1/N of each sharded parameter
            assert rec["moments"][n] == (k // world if n in rec["sharded"]
                                         else k), n
            # stage 3 keeps a sharded parameter's own storage empty at rest
            held = 0 if stage == 3 and n in rec["sharded"] else 4 * k
            assert rec["storage"][n] == held, n
        n_sh = len(rec["sharded"])
        comm = {0: dict(all_gather=0, reduce_scatter=0,
                        all_reduce=len(numel)),
                1: dict(all_gather=n_sh, reduce_scatter=0,
                        all_reduce=len(numel)),
                2: dict(all_gather=n_sh, reduce_scatter=n_sh, all_reduce=0),
                3: dict(all_gather=1 + 2 * L, reduce_scatter=1 + L,
                        all_reduce=VECTORS)}
        assert rec["comm"] == comm[stage]
        # what the update of each sharded parameter was handed: stage 1 a
        # slice of the whole (all-reduced) gradient, stage 2 the
        # reduce-scattered shard alone, stage 3 its slice of its unit's
        # reduce-scattered buffer, where its parameter shard lies too
        assert sorted(rec["update_grads"]) == rec["sharded"]
        def unit_of(n):         # "llama.layers.<i>", or the root
            return ".".join(n.split(".")[:3]) if ".layers." in n else ""
        unit = {n: sum(numel[m] for m in rec["sharded"]
                       if unit_of(m) == unit_of(n)) // world
                for n in rec["sharded"]}
        for n, (g, base) in rec["update_grads"].items():
            assert g == numel[n] // world
            assert base == {1: numel[n], 2: None, 3: unit[n]}[stage], n
            assert rec["shard_base"][n] == (unit[n] if stage == 3
                                            else numel[n]), n


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_close_gives_the_model_back(runs, world, stage):
    """After `close()` every parameter is whole again (at stage 3 gathered
    from the shards, the values the step left), no hook or `zero_shard`
    stays on the model, and the step is freed as soon as its last name
    goes, and then the model as soon as its own does (no reference cycle
    holds either)."""
    for rank in runs[world]:
        rec = rank[f"stage{stage}"]
        closed = rec["closed"]
        assert closed["same"]
        assert closed["storage"] == {n: 4 * k
                                     for n, k in rec["numel"].items()}
        assert closed["hooks"] == 0 and closed["zero_shards"] == 0
        assert closed["freed"] and closed["model_freed"]


# ---------------------------------------------------------------------------
# (c) dp 2 x sharding 2 at stage 3
# ---------------------------------------------------------------------------
def test_dp2_sharding2_stage3_matches_reference(runs, inputs):
    ranks = runs[4]
    _same_on_every_rank(ranks, "dp2_sharding2")
    rec = ranks[0]["dp2_sharding2"]
    ref_losses, ref_params = _reference(inputs, 4, "dp2_sharding2")
    np.testing.assert_allclose(rec["losses"], ref_losses, rtol=2e-4,
                               atol=2e-4)
    _close_params(rec["params"], ref_params)
    for n in rec["sharded"]:
        assert rec["moments"][n] == rec["numel"][n] // 2
    # each unit's gradient shard is also all-reduced over dp
    assert rec["comm"]["all_reduce"] == VECTORS + 1 + L


def test_bert_stage1_world2_matches_reference(runs, inputs):
    """bench_bert's trainer over gloo: BERT (bert_tiny_config) at stage 1
    on dp 1 x sharding 2, batch over ("dp", "sharding"), against the
    reference's ShardedTrainStep on the same mesh of virtual devices.
    Every parameter has a dim that 2 divides, so each is sharded: its
    optimizer state holds half of it, its gradient is all-reduced and
    its update all-gathered.  The tolerances are the Llama cases', but
    the attention's key bias is held only to 2 lr steps: its gradient
    is zero in exact arithmetic, so Adam normalises each package's
    rounding noise to updates of ~lr of either sign
    (tests/test_torch_bert.py)."""
    _same_on_every_rank(runs[2], "bert1")
    rec = runs[2][0]["bert1"]
    ref_losses, ref_params = _reference(inputs, 2, "bert1")
    np.testing.assert_allclose(rec["losses"], ref_losses, rtol=2e-4,
                               atol=2e-4)
    assert sorted(rec["params"]) == sorted(ref_params)
    for n, ref in ref_params.items():
        d = np.abs(rec["params"][n] - ref)
        assert d.max() <= 2 * W.LR * W.STEPS, (n, d.max())
        if ".attention.key.bias" not in n:
            assert np.quantile(d, 0.999) <= 1e-5, (n, np.quantile(d, 0.999))
    numel = rec["numel"]
    assert rec["sharded"] == sorted(numel)
    assert all(rec["moments"][n] == k // 2 for n, k in numel.items())
    assert rec["comm"] == dict(all_gather=len(numel), reduce_scatter=0,
                               all_reduce=len(numel))


# ---------------------------------------------------------------------------
# (d) bf16 moments + ef, and a bf16 model with fp32 masters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stage", [1, 3])
def test_bf16_moments_ef_match_reference(runs, inputs, stage):
    case = f"bf16_moments{stage}"
    _same_on_every_rank(runs[2], case)
    rec = runs[2][0][case]
    assert all(k == ["ef", "moment1", "moment2"]
               for k in rec["state_keys"].values())
    ref_losses, ref_params = _reference(inputs, 2, case)
    np.testing.assert_allclose(rec["losses"], ref_losses, rtol=2e-4,
                               atol=2e-4)
    _close_params(rec["params"], ref_params, q999=2.0 ** -8 * W.LR)


@pytest.mark.parametrize("stage", [1, 3])
def test_bf16_model_with_masters_matches_reference(runs, inputs, stage):
    case = f"bf16_model{stage}"
    _same_on_every_rank(runs[2], case)
    rec = runs[2][0][case]
    assert all("master" in k for k in rec["state_keys"].values())
    ref_losses, ref_params = _reference(inputs, 2, case)
    np.testing.assert_allclose(rec["losses"], ref_losses, rtol=1e-3)
    for n, ref in ref_params.items():
        d = np.abs(rec["params"][n] - ref)
        ulp = 2.0 ** -7 * np.abs(ref)
        assert d.mean() <= W.LR / 10, (n, d.mean())
        assert (d <= 2 * W.LR * W.STEPS + ulp).all(), (n, d.max())


# ---------------------------------------------------------------------------
# (e) fused CE at stage 3; (f) recompute at stage 3
# ---------------------------------------------------------------------------
def test_fused_ce_stage3(runs, inputs):
    """Against the port's unfused stage-3 losses, and against the
    reference's fused CE with use_pallas=False (its default off the
    TPU) through its one-device TrainStep: its ShardedTrainStep under
    FLAGS_fused_ce is what tests/test_fused_cross_entropy.py::
    TestNoMaterializedLogits holds, and fails there (ROADMAP queue 3)."""
    rec = runs[2][0]["fused_ce3"]
    _same_on_every_rank(runs[2], "fused_ce3")
    np.testing.assert_allclose(rec["losses"], runs[2][0]["stage3"]["losses"],
                               rtol=2e-4, atol=2e-4)
    assert jax.default_backend() == "cpu"       # use_pallas=False
    ref_losses, ref_params = _reference(inputs, 2, "fused_ce3",
                                        one_device=True)
    np.testing.assert_allclose(rec["losses"], ref_losses, rtol=2e-4,
                               atol=2e-4)
    _close_params(rec["params"], ref_params)


@pytest.mark.parametrize("case", ["selective3", "remat3"])
def test_recompute_stage3_equals_none(runs, case):
    """Selective recompute of the first layer, and the whole forward
    rematerialized: the replays gather the layers' weights again and
    compute what the stage-3 run without recompute computed."""
    for rank in runs[2]:
        rec, base = rank[case], rank["stage3"]
        assert rec["losses"] == base["losses"]
        for n, v in base["params"].items():
            np.testing.assert_array_equal(rec["params"][n], v, err_msg=n)
    extra = {"selective3": 0, "remat3": L}[case]
    assert runs[2][0][case]["comm"]["all_gather"] \
        == runs[2][0]["stage3"]["comm"]["all_gather"] + extra


# ---------------------------------------------------------------------------
# (g) ignored labels spread unevenly over the ranks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world,case", [
    (2, "ignored0"), (4, "ignored0"), (2, "ignored3"), (4, "ignored3"),
    (2, "ignored_remat3")])
def test_uneven_ignored_labels_give_the_global_mean(runs, inputs, world,
                                                    case):
    """The loss is the reference's global masked mean (its one-device
    run: its ZeRO stages keep those numerics).  The parameters match the
    port's own one-device TrainStep on the same labels within the fp32
    limits (the group's mean is the one-device mean), and the
    reference's within lr / 100 for 99.9% of the entries: with 29 of
    128 labels ignored, the port's fp32 gradients drift from the
    reference's enough for Adam to move a few entries by ~1e-3 of an
    update on one device already (1.1e-5 at the 99.9th percentile)."""
    _same_on_every_rank(runs[world], case)
    rec = runs[world][0][case]
    ref_losses, ref_params = _reference(inputs, 2, "ignored0",
                                        one_device=True)
    np.testing.assert_allclose(rec["losses"], ref_losses, rtol=2e-4,
                               atol=2e-4)
    _close_params(rec["params"], ref_params, q999=W.LR / 100)
    m = _tiny_port(inputs)
    one = TrainStep(m, m.compute_loss, AdamW(W.LR, parameters=m.parameters()))
    for _ in range(W.STEPS):
        one(inputs["ids"], inputs["ignored"])
    _close_params(rec["params"], numpy_state_dict(m))


@pytest.mark.parametrize("world", WORLDS)
def test_uneven_ignored_labels_with_a_port_loss_fn(runs, world):
    """A user's loss_fn on the port's masked mean
    (`nn.functional.fused_cross_entropy`) gives the global mean too: the
    same run as through `compute_loss`."""
    for rank in runs[world]:
        rec, base = rank["ignored_port_ce3"], rank["ignored3"]
        assert rec["losses"] == base["losses"]
        for n, v in base["params"].items():
            np.testing.assert_array_equal(rec["params"][n], v, err_msg=n)


@pytest.mark.parametrize("world", WORLDS)
def test_uneven_ignored_labels_with_a_torch_loss_fn(runs, inputs, world):
    """A loss_fn on another mean (`torch.nn.functional.cross_entropy`)
    gives each rank's own mean, and the step the mean of those, as the
    module docstring says: the first step's loss is that mean of the
    ranks' means, which here differs from the global mean."""
    _same_on_every_rank(runs[world], "ignored_torch_ce3")
    m = _tiny_port(inputs)
    ids = torch.from_numpy(inputs["ids"])
    labels = torch.from_numpy(inputs["ignored"])
    rows = ids.shape[0] // world
    with torch.no_grad():
        means = [W.torch_ce(m(ids[r * rows:(r + 1) * rows]),
                            labels[r * rows:(r + 1) * rows]).item()
                 for r in range(world)]
        whole = W.torch_ce(m(ids), labels).item()
    got = runs[world][0]["ignored_torch_ce3"]["losses"][0]
    np.testing.assert_allclose(got, np.mean(means), rtol=2e-4, atol=2e-4)
    assert abs(np.mean(means) - whole) > 1e-2


# ---------------------------------------------------------------------------
# (h) bench.py's one-device call with no process group
# ---------------------------------------------------------------------------
def _tiny_port(inputs):
    m = LlamaForCausalLM(llama_tiny_config(dtype="float32", **W.TINY),
                         device="cpu")
    load_numpy_state_dict(m, {k[8:]: v for k, v in inputs.items()
                              if k.startswith("float32:")})
    return m


def test_one_device_no_group_is_train_step(inputs):
    a, b = _tiny_port(inputs), _tiny_port(inputs)
    step = ShardedTrainStep(a, AdamW(W.LR, parameters=a.parameters()),
                            build_mesh(devices=[torch.device("cpu")]),
                            sharding_stage=3, rematerialize=False)
    ref = TrainStep(b, b.compute_loss, AdamW(W.LR, parameters=b.parameters()))
    ids = inputs["ids"]
    for _ in range(W.STEPS):
        assert step(ids, ids).item() == ref(ids, ids).item()
    pa, pb = numpy_state_dict(a), numpy_state_dict(b)
    for n in pb:
        np.testing.assert_array_equal(pa[n], pb[n], err_msg=n)
    assert step.comm_counts == dict(all_gather=0, reduce_scatter=0,
                                    all_reduce=0)
    assert not step._shards


def test_weight_decay_follows_the_automatic_names(inputs):
    """apply_decay_param_fun and an optimizer's _exclude_fn see each
    parameter's automatic name (the reference's `p.name or n`), as in
    TrainStep."""
    m = _tiny_port(inputs)
    opt = AdamW(W.LR, parameters=m.parameters(), weight_decay=0.1,
                apply_decay_param_fun=lambda n: "rmsnorm" not in n)
    opt._exclude_fn = lambda n: n.endswith(".lm_head")
    step = ShardedTrainStep(m, opt, build_mesh(devices=[torch.device("cpu")]))
    for n, p, wd in zip(step._names, step._params, step._wds):
        skip = "norm" in n or n == "lm_head"
        assert wd == (0.0 if skip else 0.1), (n, p.auto_name, wd)
    assert step._wds == TrainStep(m, m.compute_loss, opt)._wds


def test_run_steps_is_steps(inputs):
    a, b = _tiny_port(inputs), _tiny_port(inputs)
    mesh = build_mesh(devices=[torch.device("cpu")])
    sa = ShardedTrainStep(a, AdamW(W.LR, parameters=a.parameters()), mesh)
    sb = ShardedTrainStep(b, AdamW(W.LR, parameters=b.parameters()), mesh)
    stacked = np.stack([inputs["ids"], inputs["ids"][::-1]])
    losses = sa.run_steps(stacked, stacked)
    assert losses.shape == (2,)
    assert losses.tolist() == [sb(s, s).item() for s in stacked]


# ---------------------------------------------------------------------------
# (i) from_strategy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sharding,configs", [
    (False, None), (True, None), (True, {"stage": 3}),
    (False, {"stage": 2})], ids=["off", "on-default", "on-stage3",
                                 "off-configs-ignored"])
def test_from_strategy_stage_matches_reference(inputs, sharding, configs):
    js, ts = JStrategy(), DistributedStrategy()
    for s in (js, ts):
        s.sharding = sharding
        if configs is not None:
            s.sharding_configs = dict(configs)
    jm = JLlama(j_tiny(dtype="float32", **W.TINY))
    jstep = JStep.from_strategy(
        jm, paddle_tpu.optimizer.AdamW(W.LR, parameters=jm.parameters()),
        j_build_mesh(devices=jax.devices()[:1]), js)
    m = _tiny_port(inputs)
    tstep = ShardedTrainStep.from_strategy(
        m, AdamW(W.LR, parameters=m.parameters()),
        build_mesh(devices=[torch.device("cpu")]), ts)
    assert tstep.stage == jstep.stage


def test_strategy_hybrid_configs_validate():
    s = DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 2}
    s.hybrid_configs = {"sharding_degree": 2}
    assert s.hybrid_configs["dp_degree"] == 2
    assert s.hybrid_configs["sharding_degree"] == 2
    for bad in ({"dp_degre": 2}, {"mp_degree": 0}, {"pp_degree": True}):
        with pytest.raises(ValueError):
            s.hybrid_configs = bad


# ---------------------------------------------------------------------------
# (j) what is not ported raises; meshes the port cannot build raise
# ---------------------------------------------------------------------------
def _step(inputs, **kw):
    m = _tiny_port(inputs)
    return ShardedTrainStep(m, AdamW(W.LR, parameters=m.parameters()),
                            build_mesh(devices=[torch.device("cpu")]), **kw)


@pytest.mark.parametrize("item,make", [
    (9, lambda i: _step(i, offload=True)),
    (9, lambda i: _step(i, offload="params")),
    (9, lambda i: _step(i).train_state()),
    (9, lambda i: _step(i).load_train_state({}, {})),
    (7, lambda i: _step(i, grad_scaler=object())),
    (8, lambda i: _step(i, comm_overlap=True)),
    (8, lambda i: _step(i, seq_axis="sep")),
    (8, lambda i: _step(i, comm_bucket_mb=64)),
    (8, lambda i: _step(i, grad_comm_dtype="bfloat16")),
    (10, lambda i: _step(i).preflight(i["ids"], i["ids"])),
    (10, lambda i: _step(i).lint(i["ids"], i["ids"])),
    (10, lambda i: _step(i).compiled_hlo(i["ids"], i["ids"])),
    (10, lambda i: _step(i).collective_schedule(i["ids"], i["ids"])),
], ids=["offload", "offload-params", "train_state", "load_train_state",
        "grad_scaler", "comm_overlap", "seq_axis", "comm_bucket_mb",
        "grad_comm_dtype", "preflight", "lint",
        "compiled_hlo", "collective_schedule"])
def test_unported_options_raise(inputs, item, make):
    with pytest.raises(NotImplementedError, match=f"item {item}\\b"):
        make(inputs)


@pytest.mark.parametrize("flag,value,item", [
    ("FLAGS_skip_nonfinite_steps", True, 9), ("FLAGS_comm_overlap", True, 8),
    ("FLAGS_comm_bucket_mb", 64.0, 8),
    ("FLAGS_grad_comm_dtype", "bfloat16", 8)])
def test_unported_flags_raise(inputs, flag, value, item):
    name = flag[len("FLAGS_"):]
    tflags.set_flags({flag: value})
    try:
        with pytest.raises(NotImplementedError, match=f"item {item}\\b"):
            _step(inputs)
    finally:
        tflags.set_flags({flag: tflags._registry[name]["default"]})


@pytest.mark.parametrize("axes", [{"mp": 2}, {"pp": 2}, {"sep": 2}])
def test_model_pipeline_and_sequence_axes_raise(axes):
    with pytest.raises(NotImplementedError, match="item 8"):
        build_mesh(devices=[torch.device("cpu")] * 4, **axes)


@pytest.mark.parametrize("axes", [{"sharding": 2}, {"dp": 2, "sharding": 2}])
def test_mesh_larger_than_the_world_raises(axes):
    with pytest.raises(ValueError, match="mesh requires"):
        build_mesh(devices=[torch.device("cpu")], **axes)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_must_span_the_process_group(runs, world):
    """Under a process group of W ranks a mesh of more devices raises the
    reference's ValueError, and one of fewer raises too (every rank is
    in the mesh)."""
    for rank in runs[world]:
        errors = rank["mesh_errors"]
        assert errors["larger"] and "mesh requires" in errors["larger"]
        assert errors["smaller"] and "must span" in errors["smaller"]


# ---------------------------------------------------------------------------
# the pieces against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["skip_nonfinite_steps", "comm_overlap",
                                  "comm_bucket_mb", "grad_comm_dtype"])
def test_trainer_flags_match_reference_defaults(name):
    assert tflags._registry[name]["default"] \
        == jflags._registry[name]["default"]
    assert tflags.get_flag(name) == jflags.get_flag(name)


@pytest.mark.parametrize("dp,sharding", [(1, 2), (2, 2), (4, 1), (2, 4)])
@pytest.mark.parametrize("shape", [(8, 16), (6, 16), (16,)])
def test_batch_partition_spec_matches_reference(dp, sharding, shape):
    sizes = dict(pp=1, sep=1, sharding=sharding, dp=dp, mp=1)
    mesh = Mesh(sizes, torch.device("cpu"))
    assert batch_partition_spec(mesh, shape) \
        == j_bps(j_build_mesh(dp=dp, sharding=sharding), shape)


def test_shard_batch_one_device_keeps_the_batch(inputs):
    mesh = build_mesh(devices=[torch.device("cpu")])
    t = shard_batch(mesh, inputs["ids"])
    np.testing.assert_array_equal(t.numpy(), inputs["ids"])
    assert mesh.shape == dict(pp=1, sep=1, sharding=1, dp=1, mp=1)
    assert mesh.size == 1 and mesh.device_mesh is None
