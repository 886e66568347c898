"""The port's BERT and ERNIE against paddle_tpu's, on the CPU.

The same numpy weights (made from a seed) go into both packages through
their state dicts, at `bert_tiny_config` / `ernie_tiny_config` (2
layers, hidden 64, 4 heads, vocab 128); the same token batches (made
with numpy) go through both.  On the CPU the port runs its ops' plain
versions; the kernels are held on the card by chip_smoke.py phase 15.
Tolerances, with their reasons:

  * fp32 outputs (sequence output, pooled output, logits): 1e-5
    absolute and relative — the packages' fp32 matmuls and LayerNorm
    statistics sum in other orders;
  * bf16 compute (fp32 masters): 2^-4 absolute and 2e-2 relative —
    both round to bf16 at the same ops, but XLA and PyTorch's CPU
    kernels accumulate bf16 operands differently, so single roundings
    flip by a bf16 ulp (2^-7 at 1) and the next layers carry them: a
    few ulps at the outputs' scale of 1-4 (measured worst 0.047 at
    |value| 3.5, and 0.021 in the tanh-bounded pooled output; one op
    alone is held to tests/op_test.py's 2e-2 in
    tests/test_torch_nn_layers.py);
  * fp32 losses rtol 1e-5; fp32 gradients 1e-5 + 1e-4 of each tensor's
    largest entry (tests/test_torch_llama_train.py's limits);
  * 5 AdamW steps (lr 1e-3, weight decay 0.01) through ShardedTrainStep
    stage 1 `run_steps`, fp32: losses rtol 1e-5; parameters within 2e-5
    for 99.9% of each tensor's entries (measured: 9.0e-6, a query bias)
    and within 2 lr steps for all.  The attention's key bias is left out
    of the 99.9% rule: its gradient is zero in exact arithmetic (softmax
    over keys ignores a shift that is the same for every key), so both
    packages hand Adam rounding noise, which it normalises to updates of
    ~lr of either sign (measured: 6.5e-4 apart);
  * the same in bf16 compute: losses rtol 1e-3 (measured 3.7e-4),
    each tensor's mean |difference| under lr / 5 (measured 8.7e-5; a
    port that drops the update lands at ~5e-3), every entry within 2 lr
    steps.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cpu import one_cpu_thread  # noqa: F401 (autouse)

import paddle_tpu
import paddle_tpu.nn.layer.layers as jlayers
from paddle_tpu.distributed.topology import build_mesh as j_build_mesh
from paddle_tpu.framework import flags as jflags
from paddle_tpu.framework.tensor import Tensor as JTensor
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.jit import _swapped_state
from paddle_tpu.models.bert import BertForMaskedLM as JBertMLM
from paddle_tpu.models.bert import BertModel as JBertModel
from paddle_tpu.models.bert import bert_tiny_config as j_bert_tiny
from paddle_tpu.models.ernie import ErnieForMaskedLM as JErnieMLM
from paddle_tpu.models.ernie import \
    ErnieForSequenceClassification as JErnieCls
from paddle_tpu.models.ernie import ErnieModel as JErnieModel
from paddle_tpu.models.ernie import ernie_tiny_config as j_ernie_tiny
from paddle_tpu.parallel.sharded_trainer import ShardedTrainStep as JStep

import paddle_tpu_torch.nn.layer as tlayer
from paddle_tpu_torch import nn
from paddle_tpu_torch.distributed import build_mesh
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (BertForMaskedLM, BertModel,
                                     ErnieForMaskedLM,
                                     ErnieForSequenceClassification,
                                     ErnieModel, bert_tiny_config,
                                     ernie_tiny_config,
                                     load_numpy_state_dict, numpy_state_dict)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import ShardedTrainStep

B, S, V = 2, 16, 128
FP32_TOL = 1e-5
BF16_ATOL, BF16_RTOL = 2.0 ** -4, 2e-2
LR, WD, STEPS = 1e-3, 0.01, 5

# name: (reference class, port class, reference config, port config)
MODELS = {
    "bert_model": (JBertModel, BertModel, j_bert_tiny, bert_tiny_config),
    "bert_mlm": (JBertMLM, BertForMaskedLM, j_bert_tiny, bert_tiny_config),
    "ernie_model": (JErnieModel, ErnieModel, j_ernie_tiny,
                    ernie_tiny_config),
    "ernie_mlm": (JErnieMLM, ErnieForMaskedLM, j_ernie_tiny,
                  ernie_tiny_config),
    "ernie_cls": (JErnieCls, ErnieForSequenceClassification, j_ernie_tiny,
                  ernie_tiny_config),
}


@pytest.fixture
def fused_ce():
    """Set FLAGS_fused_ce in both packages; off again afterwards."""
    def set_both(on):
        jflags.set_flags({"FLAGS_fused_ce": on})
        tflags.set_flags({"FLAGS_fused_ce": on})
    yield set_both
    set_both(False)


def _numpy_weights(jmodel, seed):
    """1-D parameters (norm scales, biases) 1 + 0.1 N(0, 1), matrices and
    tables N(0, 1) / sqrt(rows)."""
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


def _pair(name, seed=0, **cfg):
    jcls, tcls, jcfg, tcfg = MODELS[name]
    jm = jcls(jcfg(**cfg))
    w = _numpy_weights(jm, seed)
    jm.set_state_dict(w)
    tm = tcls(tcfg(**cfg), device="cpu")
    load_numpy_state_dict(tm, w)
    return jm, tm


def _inputs(seed=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, V, (B, S)).astype(np.int32)
    types = rng.randint(0, 2, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 11:] = 0                        # row 1: 5 padding positions
    labels = ids.copy()
    labels[:, ::3] = -100                   # ignore_index
    labels[0, 1] = -7                       # any negative label is ignored
    return ids, types, mask, labels


def _j(a):
    return JTensor(jnp.asarray(a))


def _t(a):
    return torch.from_numpy(a)


def _outputs(out):
    return list(out) if isinstance(out, tuple) else [out]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_matches_reference(name, dtype, masked):
    """Sequence and pooled outputs of the backbones, the MLM logits and
    the classifier's logits, with token types, with and without a 2-D
    keep-mask."""
    jm, tm = _pair(name, dtype=dtype)
    ids, types, mask, _ = _inputs()
    kw = dict(attention_mask=mask) if masked else {}
    jout = _outputs(jm(_j(ids), _j(types),
                       **{k: _j(v) for k, v in kw.items()}))
    tout = _outputs(tm(_t(ids), _t(types),
                       **{k: _t(v) for k, v in kw.items()}))
    atol, rtol = (FP32_TOL, FP32_TOL) if dtype == "float32" \
        else (BF16_ATOL, BF16_RTOL)
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        assert str(t.dtype) == "torch." + str(j.value.dtype)
        np.testing.assert_allclose(t.detach().float().numpy(),
                                   np.asarray(j.value, np.float32),
                                   atol=atol, rtol=rtol)


def test_mask_changes_only_the_padded_rows_view():
    """A keep-mask with every position kept changes nothing; masking the
    tail of row 1 changes row 1 and leaves row 0 bit-identical."""
    _, tm = _pair("bert_model")
    ids, types, mask, _ = _inputs()
    plain = tm(_t(ids), _t(types))[0]
    ones = tm(_t(ids), _t(types), attention_mask=torch.ones(B, S))[0]
    masked = tm(_t(ids), _t(types), attention_mask=_t(mask))[0]
    assert torch.equal(plain, ones)
    assert torch.equal(masked[0], plain[0])
    assert not torch.allclose(masked[1], plain[1])


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------
def _ref_loss_and_grads(jm, args, labels):
    names = [n for n, _ in jm.named_parameters()]
    vals = [jm.state_dict()[n]._value for n in names]

    def loss_of(param_vals):
        with _swapped_state(jm, names, list(param_vals)):
            out = jm(*[_j(a) for a in args])
            return jm.compute_loss(out, _j(labels)).value

    loss, grads = jax.value_and_grad(loss_of)(vals)
    return float(loss), dict(zip(names, grads))


def _check_loss_and_grads(jm, tm, args, labels):
    jloss, jgrads = _ref_loss_and_grads(jm, args, labels)
    tloss = tm.compute_loss(tm(*[_t(a) for a in args]), _t(labels))
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), jloss, rtol=FP32_TOL)
    params = dict(tm.named_parameters())
    assert sorted(params) == sorted(jgrads)
    for n, g in jgrads.items():
        ref = np.asarray(g)
        got = params[n].grad
        got = np.zeros_like(ref) if got is None else got.numpy()
        tol = 1e-5 + 1e-4 * np.abs(ref).max()
        np.testing.assert_allclose(got, ref, atol=tol, err_msg=n)
    return tloss, params


@pytest.mark.parametrize("fused", [False, True], ids=["logits", "fused_ce"])
@pytest.mark.parametrize("name", ["bert_mlm", "ernie_mlm"])
def test_mlm_loss_and_grads_match_reference(name, fused, fused_ce):
    """The masked-LM loss with ignored labels, in both modes (BERT's
    forward returns hidden states under FLAGS_fused_ce and the loss folds
    the tied decoder; ERNIE's forward returns logits in both, as in the
    reference), and every gradient against jax.grad.  The pooler, which
    the loss does not reach, has no gradient in the port and a zero one
    in the reference."""
    fused_ce(fused)
    jm, tm = _pair(name)
    ids, types, _, labels = _inputs()
    tloss, params = _check_loss_and_grads(jm, tm, (ids, types), labels)
    hidden = fused and name == "bert_mlm"
    assert tm(_t(ids), _t(types)).shape[-1] == (64 if hidden else V)
    assert params["bert.pooler.weight"].grad is None
    # the tied decoder: one parameter, its gradient from both uses
    assert not any("decoder" in n and "bias" not in n for n in params)


@pytest.mark.parametrize("route", ["plain", "flash_function"])
def test_masked_mlm_loss_and_grads_match_reference(monkeypatch, route):
    """The MLM loss and every gradient with a 2-D keep-mask that pads the
    tail of row 0 and all of row 1 (a fully padded sequence, which the
    reference's attention weighs uniformly), against jax.grad.  "plain":
    the CPU's plain attention under native autograd; "flash_function":
    `ops.attention` through the flash kernels' autograd Function with
    `_launch_fwd` / `_launch_bwd` standing in as the plain versions (the
    kernels' math: the saved lse, its +inf mark on the padded row, 1/sk
    in dv)."""
    import paddle_tpu_torch.ops as tops
    if route == "flash_function":
        fa = tops.kernel_module("flash_attention")
        # the launches take the call's keys (`_key_bias`), the plain
        # versions its mask
        monkeypatch.setattr(fa, "_launch_fwd", lambda *a:
                            tops.plain_flash_fwd(*a[:-1], a[-1].mask))
        monkeypatch.setattr(fa, "_launch_bwd", lambda *a:
                            tops.plain_flash_bwd(*a[:-1], a[-1].mask))
        monkeypatch.setattr(
            tops, "attention",
            lambda q, k, v, mask=None, causal=False, scale=None:
            fa._FlashAttention.apply(q, k, v, causal,
                                     float(fa._scale(q, scale)), mask))
    jm, tm = _pair("bert_mlm")
    ids, types, mask, labels = _inputs()
    mask[0, 11:] = 0
    mask[1, :] = 0
    _check_loss_and_grads(jm, tm, (ids, types, mask), labels)


def test_classification_loss_and_grads_match_reference():
    jm, tm = _pair("ernie_cls")
    ids, types, _, _ = _inputs()
    cls = np.array([1, 0], np.int32)
    _check_loss_and_grads(jm, tm, (ids, types), cls)


def test_fused_and_logits_losses_agree():
    """The fused-CE loss of the port equals its logits-path loss on the
    same weights, ignored labels included."""
    _, tm = _pair("bert_mlm")
    ids, types, _, labels = _inputs()
    ref = tm.compute_loss(tm(_t(ids), _t(types)), _t(labels))
    tflags.set_flags({"FLAGS_fused_ce": True})
    try:
        hidden = tm(_t(ids), _t(types))
        fused = tm.compute_loss(hidden, _t(labels))
        tm.eval()           # the gate is the flag AND training
        assert tm(_t(ids), _t(types)).shape[-1] == V
    finally:
        tflags.set_flags({"FLAGS_fused_ce": False})
    assert hidden.shape[-1] == 64
    np.testing.assert_allclose(fused.item(), ref.item(), rtol=FP32_TOL)


# ---------------------------------------------------------------------------
# training: 5 AdamW steps through ShardedTrainStep stage 1 run_steps
# ---------------------------------------------------------------------------
def _stacked(seed=3):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, V, (STEPS, 4, 32)).astype(np.int32)
    labels = ids.copy()
    labels[:, :, ::3] = -100
    return ids, labels


def _jparams(jm):
    return {k: np.asarray(v.value, np.float32)
            for k, v in jm.state_dict().items()}


@pytest.mark.parametrize("fused", [False, True], ids=["logits", "fused_ce"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stage1_run_steps_match_reference(dtype, fused, fused_ce):
    """bench_bert's trainer (bench.py:780-790): AdamW with fp32 moments,
    ShardedTrainStep(sharding_stage=1, batch_axes=("dp", "sharding")) on
    one device, K steps through run_steps, against the reference's
    ShardedTrainStep.run_steps; under FLAGS_fused_ce against its
    jit.TrainStep.run_steps (the reference's ShardedTrainStep under the
    flag fails the suite's fused-CE lint here: ROADMAP queue 3), whose
    numerics its ZeRO stages keep."""
    fused_ce(fused)
    jm, tm = _pair("bert_mlm", seed=4, dtype=dtype)
    before = numpy_state_dict(tm)
    ids, labels = _stacked()
    jopt = paddle_tpu.optimizer.AdamW(LR, parameters=jm.parameters(),
                                      weight_decay=WD)
    if fused:
        jstep = JTrainStep(jm, jm.compute_loss, jopt)
    else:
        jstep = JStep(jm, jopt, j_build_mesh(sharding=1,
                                             devices=jax.devices()[:1]),
                      sharding_stage=1, batch_axes=("dp", "sharding"))
    jlosses = np.asarray(jstep.run_steps(paddle_tpu.to_tensor(ids),
                                         paddle_tpu.to_tensor(labels)).value)
    step = ShardedTrainStep(tm, AdamW(LR, parameters=tm.parameters(),
                                      weight_decay=WD),
                            build_mesh(devices=[torch.device("cpu")]),
                            sharding_stage=1, batch_axes=("dp", "sharding"))
    tlosses = step.run_steps(ids, labels)
    assert tlosses.shape == (STEPS,)
    # the tied embedding: one parameter, one optimizer state
    assert len(step._opt_states) == len(list(tm.parameters())) \
        == len(jm.state_dict())
    got, want = numpy_state_dict(tm), _jparams(jm)
    assert sorted(got) == sorted(want)
    bound = 2 * LR * STEPS
    if dtype == "float32":
        np.testing.assert_allclose(tlosses.numpy(), jlosses, rtol=FP32_TOL)
    else:
        np.testing.assert_allclose(tlosses.numpy(), jlosses, rtol=1e-3)
    for n in want:
        d = np.abs(got[n] - want[n])
        assert d.max() <= bound, (n, d.max())
        if ".attention.key.bias" in n:
            continue
        if dtype == "float32":
            assert np.quantile(d, 0.999) <= 2e-5, (n, np.quantile(d, 0.999))
        else:
            assert d.mean() <= LR / 5, (n, d.mean())
        assert np.abs(got[n] - before[n]).max() > 0, n
    # the pooler: a zero gradient, still decayed (Adam's moments stay 0,
    # so each step multiplies the weight by 1 - lr wd), in both packages
    decay = (1.0 - LR * WD) ** STEPS
    for params in (got, want):
        for n in ("bert.pooler.weight", "bert.pooler.bias"):
            np.testing.assert_allclose(params[n], before[n] * decay,
                                       rtol=1e-6, err_msg=n)


def test_train_step_and_sharded_step_agree():
    """One device and no process group: ShardedTrainStep stage 1 is
    jit.TrainStep, step for step and bit for bit."""
    _, a = _pair("bert_mlm", seed=5)
    _, b = _pair("bert_mlm", seed=5)
    ids, labels = _stacked(6)
    sa = ShardedTrainStep(a, AdamW(LR, parameters=a.parameters(),
                                   weight_decay=WD),
                          build_mesh(devices=[torch.device("cpu")]),
                          sharding_stage=1)
    sb = TrainStep(b, b.compute_loss, AdamW(LR, parameters=b.parameters(),
                                            weight_decay=WD))
    assert sa.run_steps(ids[:2], labels[:2]).tolist() == \
        [sb(i, lb).item() for i, lb in zip(ids[:2], labels[:2])]
    pa, pb = numpy_state_dict(a), numpy_state_dict(b)
    for n in pb:
        np.testing.assert_array_equal(pa[n], pb[n], err_msg=n)


# ---------------------------------------------------------------------------
# structure: names, compute dtype, weight carry-over, the device rule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(MODELS))
def test_names_and_compute_dtype_count_match_reference(name, monkeypatch):
    """Structural and automatic parameter names equal, in order (counters
    reset in both packages); set_compute_dtype switches as many layers as
    the reference's (ERNIE-MLM's `ernie` alias counted twice), and leaves
    the parameters fp32."""
    monkeypatch.setattr(jlayers, "_layer_name_counters",
                        collections.defaultdict(int))
    monkeypatch.setattr(tlayer, "_layer_name_counters",
                        collections.defaultdict(int))
    jcls, tcls, jcfg, tcfg = MODELS[name]
    jm, tm = jcls(jcfg()), tcls(tcfg(), device="cpu")
    jnames = [(n, p.name) for n, p in jm.named_parameters()]
    tnames = [(n, p.auto_name) for n, p in tm.named_parameters()]
    assert tnames == jnames
    n = nn.set_compute_dtype(tm, "bfloat16")
    assert n == paddle_tpu.nn.set_compute_dtype(jm, "bfloat16")
    assert n == {"bert_model": 21, "bert_mlm": 23, "ernie_model": 22,
                 "ernie_mlm": 46, "ernie_cls": 23}[name]
    assert all(p.dtype == torch.float32 for p in tm.parameters())


@pytest.mark.parametrize("name", ["bert_mlm", "ernie_mlm"])
def test_weights_carry_over_both_ways(name):
    """numpy_state_dict of the port loads into the reference by name and
    gives the same logits; a state with a name missing or extra
    raises."""
    jcls, tcls, jcfg, tcfg = MODELS[name]
    tm = tcls(tcfg(), device="cpu", seed=7)
    sd = numpy_state_dict(tm)
    jm = jcls(jcfg())
    assert sorted(sd) == sorted(jm.state_dict())
    missing, unexpected = jm.set_state_dict(sd)
    assert not missing and not unexpected
    ids, types, _, _ = _inputs()
    np.testing.assert_allclose(
        tm(_t(ids), _t(types)).detach().numpy(),
        np.asarray(jm(_j(ids), _j(types)).value), atol=FP32_TOL,
        rtol=FP32_TOL)
    with pytest.raises(KeyError, match="missing"):
        load_numpy_state_dict(tm, {k: v for k, v in sd.items()
                                   if k != "decoder_bias"})
    with pytest.raises(KeyError, match="unexpected"):
        load_numpy_state_dict(tm, dict(sd, **{"ernie.pooler.bias":
                                              sd["bert.pooler.bias"]}))


def test_seeded_init_is_reproducible():
    a = BertForMaskedLM(bert_tiny_config(), device="cpu", seed=3)
    b = BertForMaskedLM(bert_tiny_config(), device="cpu", seed=3)
    c = BertForMaskedLM(bert_tiny_config(), device="cpu", seed=4)
    sa, sb, sc = (numpy_state_dict(m) for m in (a, b, c))
    assert all(np.array_equal(sa[n], sb[n]) for n in sa)
    assert not np.array_equal(sa["bert.pooler.weight"],
                              sc["bert.pooler.weight"])
    assert not sa["decoder_bias"].any() \
        and np.array_equal(sa["transform_norm.weight"], np.ones(64))


@pytest.mark.parametrize("make", [
    lambda **kw: BertModel(bert_tiny_config(), **kw),
    lambda **kw: BertForMaskedLM(bert_tiny_config(), **kw),
    lambda **kw: ErnieModel(ernie_tiny_config(), **kw),
    lambda **kw: ErnieForMaskedLM(ernie_tiny_config(), **kw),
    lambda **kw: ErnieForSequenceClassification(ernie_tiny_config(), **kw),
], ids=["bert_model", "bert_mlm", "ernie_model", "ernie_mlm", "ernie_cls"])
def test_constructors_follow_the_device_rule(make, monkeypatch):
    make(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    with pytest.raises(RuntimeError, match="no CUDA"):
        make(device="cuda")


def test_attention_mask_off_the_cpu_raises(monkeypatch):
    """Off the CPU a 2-D keep-mask reaches the flash kernels' launch as
    the bool key-padding mask [b, 1, 1, sk] (a model on the `meta` device
    stands in for the card here): the plain version never runs, and the
    kernel path raises for the meta tensors, as for any tensor that is
    not a CUDA one."""
    import paddle_tpu_torch.ops as tops
    fa = tops.kernel_module("flash_attention")
    seen, launch = [], fa._launch_fwd

    def spy(q, k, v, causal, scale, keys):
        seen.append(keys.mask)
        return launch(q, k, v, causal, scale, keys)

    def never(*a, **k):
        raise AssertionError("the plain attention ran off the CPU")

    monkeypatch.setattr(fa, "_launch_fwd", spy)
    monkeypatch.setattr(fa, "plain_attention", never)
    tm = BertForMaskedLM(bert_tiny_config(), device="cpu").to("meta")
    ids = torch.zeros((B, S), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tm(ids, attention_mask=torch.ones((B, S), device="meta"))
    (mask,) = seen
    assert mask.dtype == torch.bool and tuple(mask.shape) == (B, 1, 1, S)
