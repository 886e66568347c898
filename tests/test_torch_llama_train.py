"""The port's Llama training path against paddle_tpu's, on the CPU.

The same numpy weights (made from a seed) go into both packages through
their state dicts (2 layers, hidden 128, 4 heads, 2 KV heads, vocab 512,
sequence 64, batch 2); the same token batches go through
`paddle_tpu.jit.TrainStep` and `paddle_tpu_torch.jit.TrainStep`.  On the
CPU the port runs its ops' plain versions; the kernels' wiring is held
in tests/test_torch_train_ops.py.  Tolerances, with their reasons:

  * fp32 logits: atol 1e-4 — the packages' fp32 matmuls sum in
    different orders, moving logits of magnitude ~1 by ~1e-6..1e-5;
  * fp32 loss: rtol 1e-5, the same drift averaged over the tokens;
  * fp32 gradients: atol 1e-5 + rtol 1e-4 of each tensor's largest
    entry — the backward sums the same terms in other orders;
  * fp32 AdamW steps: per-step losses rtol 1e-5; parameters within
    1e-5 for 99.9% of each tensor's entries and within 2·lr·steps for
    all.  Adam normalises each update to ~lr, so a gradient entry near
    zero whose last bits differ between the packages can flip the sign
    of m/sqrt(v) (up to 2·lr per step; measured: one of 65536 up_proj
    entries 1.6e-4 apart after 5 steps); with bf16 moments a moment
    that rounds the other way moves that step's update by 2^-8 of lr,
    ~4e-6 (measured: lm_head's 99.9th percentile 5.3e-6);
  * bf16 compute with fp32 parameters, 3 steps: both packages round
    activations to bf16 at the same ops, but XLA and PyTorch's CPU
    kernels accumulate bf16 matmuls and reductions differently, so
    single roundings flip by one bf16 ulp.  Measured: losses 2.7e-4
    apart (relative), parameters 3.5e-5 apart on average per tensor,
    4.4e-3 at most (a sign flip of Adam's ~lr update, as above).
    Limits: losses rtol 1e-3, each tensor's mean |difference| 1e-4 (lr
    / 10), every entry within 2·lr·steps.  A port that drops the update
    (lr 1e-30) lands at 2.2e-3 and 1.7e-3: both limits fail it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cpu import one_cpu_thread  # noqa: F401 (autouse)

import paddle_tpu
from paddle_tpu.framework.tensor import Tensor as JTensor
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.jit import _swapped_state
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny_config as j_tiny

from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny_config,
                                     load_numpy_opt_state,
                                     load_numpy_state_dict, numpy_state_dict)
from paddle_tpu_torch.optimizer import AdamW

CFG = dict(dtype="float32", num_hidden_layers=2, num_key_value_heads=2)
B, S, V = 2, 64, 512


def _numpy_weights(jmodel, seed):
    rng = np.random.RandomState(seed)
    out = {}
    for name, p in jmodel.state_dict().items():
        shape = tuple(p.shape)
        if len(shape) == 1:
            out[name] = (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        else:
            out[name] = (rng.randn(*shape) / np.sqrt(shape[0])) \
                .astype(np.float32)
    return out


def _pair(seed=0, **cfg):
    cfg = dict(CFG, **cfg)
    jm = JLlama(j_tiny(**cfg))
    weights = _numpy_weights(jm, seed)
    jm.set_state_dict(weights)
    tm = LlamaForCausalLM(llama_tiny_config(**cfg), device="cpu")
    load_numpy_state_dict(tm, weights)
    return jm, tm


def _batch(rng):
    return rng.randint(0, V, (B, S)).astype(np.int32)


def _jparams(jm):
    return {k: np.asarray(v.value, np.float32)
            for k, v in jm.state_dict().items()}


def _close_params(tp, jp, steps, lr=1e-3):
    assert sorted(tp) == sorted(jp)
    for n in jp:
        d = np.abs(tp[n] - jp[n])
        assert np.quantile(d, 0.999) <= 1e-5 and d.max() <= 2 * lr * steps, \
            (n, np.quantile(d, 0.999), d.max())


def test_fp32_logits_loss_and_grads():
    jm, tm = _pair()
    ids = _batch(np.random.RandomState(1))
    jlogits = jm(JTensor(jnp.asarray(ids))).value
    tlogits = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-4)
    tloss = tm.compute_loss(tlogits, torch.from_numpy(ids))
    tloss.backward()

    names = [n for n, _ in jm.named_parameters()]
    vals = [jm.state_dict()[n]._value for n in names]

    def loss_of(param_vals):
        with _swapped_state(jm, names, list(param_vals)):
            out = jm(JTensor(jnp.asarray(ids)))
            return jm.compute_loss(out, JTensor(jnp.asarray(ids))).value

    jloss, jgrads = jax.value_and_grad(loss_of)(vals)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    tgrads = dict(tm.named_parameters())
    assert sorted(tgrads) == sorted(names)
    for n, g in zip(names, jgrads):
        ref = np.asarray(g)
        tol = 1e-5 + 1e-4 * np.abs(ref).max()
        np.testing.assert_allclose(tgrads[n].grad.numpy(), ref, atol=tol,
                                   err_msg=n)


def _run_jax(jm, batches, **opt_kw):
    opt = paddle_tpu.optimizer.AdamW(1e-3, parameters=jm.parameters(),
                                     weight_decay=0.1, **opt_kw)
    step = JTrainStep(jm, jm.compute_loss, opt)
    losses = [float(step(JTensor(jnp.asarray(b)), JTensor(jnp.asarray(b)))
                    .value) for b in batches]
    return step, losses


def _run_port(tm, batches, step=None, **opt_kw):
    if step is None:
        opt = AdamW(1e-3, parameters=tm.parameters(), weight_decay=0.1,
                    **opt_kw)
        step = TrainStep(tm, tm.compute_loss, opt)
    losses = [step(b, b).item() for b in batches]
    return step, losses


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
def test_fp32_adamw_steps_match_reference(moment_dtype):
    rng = np.random.RandomState(2)
    batches = [_batch(rng) for _ in range(5)]
    jm, tm = _pair()
    kw = {} if moment_dtype is None else {"moment_dtype": moment_dtype}
    jstep, jl = _run_jax(jm, batches, **kw)
    tstep, tl = _run_port(tm, batches, **kw)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    _close_params(numpy_state_dict(tm), _jparams(jm), 5)
    assert tstep.optimizer._step_count == jstep.optimizer._step_count == 5
    md = torch.float32 if moment_dtype is None else torch.bfloat16
    assert all(st["moment1"].dtype == md for st in tstep._opt_states)


def test_optimizer_state_carries_over_mid_run():
    """Two reference steps, then the reference's params and optimizer
    state carried into a fresh port step: the next three steps agree."""
    rng = np.random.RandomState(3)
    batches = [_batch(rng) for _ in range(5)]
    jm, tm = _pair(seed=5)
    jstep, _ = _run_jax(jm, batches[:2], moment_dtype="bfloat16")
    load_numpy_state_dict(tm, _jparams(jm))
    tstep = TrainStep(
        tm, tm.compute_loss, AdamW(1e-3, parameters=tm.parameters(),
                                   weight_decay=0.1,
                                   moment_dtype="bfloat16"))
    states = {n: {k: np.asarray(v.astype(jnp.float32))
                  for k, v in st.items()}
              for n, st in zip(jstep._names, jstep._opt_states)}
    load_numpy_opt_state(tstep, states, jstep.optimizer._step_count)
    jl = [float(jstep(JTensor(jnp.asarray(b)), JTensor(jnp.asarray(b)))
                .value) for b in batches[2:]]
    _, tl = _run_port(tm, batches[2:], step=tstep)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _close_params(numpy_state_dict(tm), _jparams(jm), 3)


def test_load_opt_state_rejects_mismatch():
    _, tm = _pair()
    step = TrainStep(tm, tm.compute_loss,
                     AdamW(1e-3, parameters=tm.parameters()))
    good = {n: {k: t.numpy() for k, t in st.items()}
            for n, st in zip(step._names, step._init_opt_states())}
    with pytest.raises(KeyError):
        load_numpy_opt_state(step, dict(list(good.items())[1:]))
    bad = dict(good)
    bad["lm_head"] = {"moment1": good["lm_head"]["moment1"]}
    with pytest.raises(KeyError):
        load_numpy_opt_state(step, bad)


def test_bf16_compute_fp32_params_tracks_reference():
    rng = np.random.RandomState(4)
    batches = [_batch(rng) for _ in range(3)]
    jm, tm = _pair(seed=6, dtype="bfloat16", param_dtype="float32")
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    _, jl = _run_jax(jm, batches, moment_dtype="bfloat16")
    _, tl = _run_port(tm, batches, moment_dtype="bfloat16")
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    tp, jp = numpy_state_dict(tm), _jparams(jm)
    assert sorted(tp) == sorted(jp)
    for n in jp:
        d = np.abs(tp[n] - jp[n])
        assert d.mean() <= 1e-4 and d.max() <= 2 * 1e-3 * 3, \
            (n, d.mean(), d.max())


def test_weight_decay_follows_apply_decay_param_fun():
    """The function sees the reference's automatic names (`llamarmsnorm_
    N.weight`), not the structural ones; the list is by structural name."""
    _, tm = _pair()
    seen = []
    opt = AdamW(1e-3, parameters=tm.parameters(), weight_decay=0.1,
                apply_decay_param_fun=lambda n: seen.append(n)
                or not n.startswith("llamarmsnorm_"))
    step = TrainStep(tm, tm.compute_loss, opt)
    wds = dict(zip(step._names, step._wds))
    assert wds["llama.norm.weight"] == 0.0
    assert wds["llama.layers.0.input_layernorm.weight"] == 0.0
    assert wds["llama.layers.1.post_attention_layernorm.weight"] == 0.0
    assert wds["lm_head"] == 0.1
    assert wds["llama.layers.0.self_attn.q_proj"] == 0.1
    assert sorted(seen) == sorted(p.auto_name for p in tm.parameters())
    assert not any(n.startswith("llama.") for n in seen)


def _decay_fn(n):
    # a structural-name policy: under the automatic names the norm
    # weights (`llamarmsnorm_N.weight`) match neither test, so decay
    return not n.endswith("norm.weight") and "layernorm" not in n


def test_decay_per_parameter_matches_reference(monkeypatch):
    """The same apply_decay_param_fun gives every parameter the same
    decay in both packages' train steps, matched by structural name (the
    reference's list read where its step hands it to apply_updates)."""
    import paddle_tpu.optimizer.jit_update as ju
    jm, tm = _pair(num_hidden_layers=1)
    seen = {}
    real = ju.apply_updates

    def spy(upd, params, grads, states, lr, wds, *a, **k):
        seen["wds"] = list(wds)
        return real(upd, params, grads, states, lr, wds, *a, **k)

    jopt = paddle_tpu.optimizer.AdamW(1e-3, parameters=jm.parameters(),
                                      weight_decay=0.1,
                                      apply_decay_param_fun=_decay_fn)
    jstep = JTrainStep(jm, jm.compute_loss, jopt)
    b = _batch(np.random.RandomState(8))
    monkeypatch.setattr(ju, "apply_updates", spy)
    jstep(JTensor(jnp.asarray(b)), JTensor(jnp.asarray(b)))
    jwds = dict(zip(jstep._names, seen["wds"]))
    tstep = TrainStep(tm, tm.compute_loss,
                      AdamW(1e-3, parameters=tm.parameters(),
                            weight_decay=0.1,
                            apply_decay_param_fun=_decay_fn))
    twds = dict(zip(tstep._names, tstep._wds))
    assert twds == jwds
    for n in ("llama.norm.weight", "llama.layers.0.input_layernorm.weight",
              "llama.layers.0.post_attention_layernorm.weight"):
        assert twds[n] == 0.1, n


def test_automatic_names_follow_reference_counters_and_ties(monkeypatch):
    """Per-class, per-process counters (both packages' counters reset)
    give the reference's names parameter for parameter; a parameter
    assigned to a second layer keeps its first owner's name."""
    import collections
    import paddle_tpu.nn.layer.layers as jlayers
    from paddle_tpu.framework.tensor import Parameter as JParameter
    import paddle_tpu_torch.nn.layer as tlayer
    monkeypatch.setattr(jlayers, "_layer_name_counters",
                        collections.defaultdict(int))
    monkeypatch.setattr(tlayer, "_layer_name_counters",
                        collections.defaultdict(int))
    jm, tm = _pair(num_hidden_layers=2)
    jnames = {n: p.name for n, p in jm.named_parameters()}
    tnames = {n: p.auto_name for n, p in tm.named_parameters()}
    assert tnames == jnames
    assert tnames["llama.layers.1.post_attention_layernorm.weight"] == \
        "llamarmsnorm_3.weight"
    assert tnames["llama.layers.1.self_attn.o_proj"] == \
        "llamaattention_1.o_proj"

    class Owner(jlayers.Layer):
        pass

    class TOwner(tlayer.Layer):
        pass

    TOwner.__name__ = "Owner"
    ja, jb = Owner(), Owner()
    ja.w = JParameter(jnp.ones([2]))
    jb.w = ja.w
    jb.v = JParameter(jnp.ones([2]))
    ta, tb = TOwner(), TOwner()
    ta.w = torch.nn.Parameter(torch.ones(2))
    tb.w = ta.w
    tb.v = torch.nn.Parameter(torch.ones(2))
    assert (ta.w.auto_name, tb.w.auto_name, tb.v.auto_name) == \
        (ja.w.name, jb.w.name, jb.v.name) == \
        ("owner_0.w", "owner_0.w", "owner_1.v")


def test_not_ported_options_raise():
    # recompute is ported; an unknown granularity is refused
    LlamaForCausalLM(llama_tiny_config(recompute=True), device="cpu")
    with pytest.raises(ValueError, match="recompute_granularity"):
        LlamaForCausalLM(llama_tiny_config(
            recompute=True, recompute_granularity="core_attn"), device="cpu")
    with pytest.raises(NotImplementedError):
        LlamaForCausalLM(llama_tiny_config(moe_num_experts=4), device="cpu")
    _, tm = _pair()
    with pytest.raises(NotImplementedError):
        AdamW(1e-3, parameters=tm.parameters(), grad_clip=object())
    with pytest.raises(NotImplementedError):
        AdamW(lambda: 1e-3, parameters=tm.parameters())


def test_train_step_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m = LlamaForCausalLM(llama_tiny_config())
        TrainStep(m, m.compute_loss, AdamW(1e-3, parameters=m.parameters()))


@pytest.mark.parametrize("granularity,layers", [("full", None),
                                                ("selective", 1),
                                                ("selective", None)])
def test_recompute_matches_no_recompute_and_reference(granularity, layers):
    """Full and selective recompute (torch.utils.checkpoint) replay the
    same ops: loss and gradients equal the step without recompute
    exactly, and match paddle_tpu's recomputed model (jax.checkpoint)
    to the fp32 tolerances above."""
    rc = dict(recompute=True, recompute_granularity=granularity,
              recompute_layers=layers)
    jm, tm = _pair(seed=7, **rc)
    _, plain = _pair(seed=7)
    assert [l._recompute for l in tm.llama.layers] == \
        [layers is None or i < layers for i in range(2)]
    ids = torch.from_numpy(_batch(np.random.RandomState(8)))
    grads = {}
    for name, m in (("recompute", tm), ("plain", plain)):
        loss = m.compute_loss(m(ids), ids)
        loss.backward()
        grads[name] = (loss.item(), {n: p.grad.clone()
                                     for n, p in m.named_parameters()})
    assert grads["recompute"][0] == grads["plain"][0]
    for n, g in grads["plain"][1].items():
        assert torch.equal(grads["recompute"][1][n], g), n

    names = [n for n, _ in jm.named_parameters()]
    vals = [jm.state_dict()[n]._value for n in names]
    jids = JTensor(jnp.asarray(ids.numpy()))

    def loss_of(param_vals):
        with _swapped_state(jm, names, list(param_vals)):
            return jm.compute_loss(jm(jids), jids).value

    jloss, jgrads = jax.value_and_grad(loss_of)(vals)
    np.testing.assert_allclose(grads["recompute"][0], float(jloss),
                               rtol=1e-5)
    for n, g in zip(names, jgrads):
        ref = np.asarray(g)
        np.testing.assert_allclose(grads["recompute"][1][n].numpy(), ref,
                                   atol=1e-5 + 1e-4 * np.abs(ref).max(),
                                   err_msg=n)


def test_recompute_replays_the_regions(monkeypatch):
    """What a backward replays: selective layers run region A (input
    norm, rope) and region B (fused add + norm) twice and attention once;
    a full layer replays attention too."""
    from paddle_tpu_torch import ops as tops
    calls = {"rms_norm": 0, "apply_rope": 0, "fused_add_rms_norm": 0,
             "attention": 0}
    llama_mod = __import__("paddle_tpu_torch.models.llama",
                           fromlist=["ops"])

    def counting(name):
        real = getattr(tops, name)

        def f(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        return f

    class _Ops:
        def __getattr__(self, n):
            return counting(n) if n in calls else getattr(tops, n)
    monkeypatch.setattr(llama_mod, "ops", _Ops())
    ids = torch.from_numpy(_batch(np.random.RandomState(9)))
    # L = 2 layers, the first recomputed: forward L + 1 norms, L ropes,
    # L fused add + norms, L attentions, plus the replays
    for gran, want in (("selective", {"rms_norm": 3 + 1, "apply_rope": 2 + 1,
                                      "fused_add_rms_norm": 2 + 1,
                                      "attention": 2}),
                       ("full", {"rms_norm": 3 + 1, "apply_rope": 2 + 1,
                                 "fused_add_rms_norm": 2 + 1,
                                 "attention": 2 + 1})):
        _, tm = _pair(recompute=True, recompute_granularity=gran,
                      recompute_layers=1)
        for k in calls:
            calls[k] = 0
        tm.compute_loss(tm(ids), ids).backward()
        assert calls == want, (gran, calls)
