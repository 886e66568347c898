"""The port's Vision Transformer against paddle_tpu's, on the CPU.

`vit_tiny_patch4` (32x32 images, 4x4 patches, width 64, 2 pre-LN blocks
of 4 heads: head dim 16) with the reference's own initial weights (its
state as numpy, `cls_token` and `pos_embed` included) in both packages:
the logits, the cross-entropy loss and every gradient (against
`jax.value_and_grad`, jitted with the weights as arguments), and 2 AdamW
`TrainStep` steps against the reference's `jit.TrainStep`.  On the CPU
the port's attention is the plain version; the kernels are held on the
card by chip_smoke.py phase 17 (ViT-B/16).  The constructors' shapes are
checked for `vit_b_16` and `vit_s_16` too (head dims 64).

Tolerances, with their reasons: logits 1e-5 of the largest |logit|
(fp32 matmuls and LayerNorm statistics sum in other orders); the loss
rtol 1e-5; gradients 1e-5 + 1e-4 of each tensor's largest entry
(tests/test_torch_llama_train.py's limits); after 2 AdamW steps (lr
1e-3) the losses rtol 1e-5 and each parameter within 2e-5 of the
reference for 99.9% of its entries and within 2 lr steps for all (Adam
turns a gradient that is rounding noise in both packages into ~lr
updates of either sign); the key third of each qkv bias, whose gradient
is zero in exact arithmetic, is held to the 2 lr steps only, as
tests/test_torch_bert.py holds BERT's key bias.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cpu import one_cpu_thread  # noqa: F401 (autouse)

import paddle_tpu
import paddle_tpu.nn.functional as JF
from paddle_tpu.framework.tensor import Tensor as JTensor
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.jit import _swapped_state
from paddle_tpu.vision import models as jmodels

from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import load_numpy_state_dict, numpy_state_dict
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.vision import models

TOL = 1e-5
LR, STEPS = 1e-3, 2


def _pair(seed=0):
    paddle_tpu.seed(seed)
    jm = jmodels.vit_tiny_patch4()
    w = {k: np.array(v.value, np.float32) for k, v in jm.state_dict().items()}
    tm = models.vit_tiny_patch4(device="cpu")
    load_numpy_state_dict(tm, w)
    return jm, tm


def _batch(seed, b=4):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, 3, 32, 32).astype(np.float32),
            rng.randint(0, 10, b).astype(np.int64))


def test_vit_names_and_shapes():
    jm, tm = _pair()
    assert sorted(n for n, _ in tm.named_parameters()) == \
        sorted(jm.state_dict())
    assert tm.pos_embed.shape == (1, 65, 64)
    assert float(tm.cls_token.abs().max()) == 0.0
    for name, dim, heads in (("vit_b_16", 768, 12), ("vit_s_16", 384, 6)):
        m = getattr(models, name)(depth=1, num_classes=10, device="cpu")
        assert m.pos_embed.shape == (1, 197, dim)
        assert m.blocks[0].attn.head_dim == 64
        assert m.blocks[0].attn.num_heads == heads
        assert m(torch.zeros(1, 3, 224, 224)).shape == (1, 10)
    with pytest.raises(ValueError):
        models.VisionTransformer(image_size=30, patch_size=4, device="cpu")


def test_vit_logits_loss_and_grads_match_reference():
    jm, tm = _pair()
    x, y = _batch(1)
    names = [n for n, _ in jm.named_parameters()]
    sd = jm.state_dict()

    def loss_of(vals, xv, yv):
        with _swapped_state(jm, names, list(vals)):
            out = jm(JTensor(xv))
            return JF.cross_entropy(out, JTensor(yv)).value, out.value
    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(loss_of,
                                                       has_aux=True))(
        [sd[n]._value for n in names], jnp.asarray(x), jnp.asarray(y))
    jout = np.asarray(jout)
    out = tm(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=TOL,
                               atol=TOL * np.abs(jout).max())
    loss = F.cross_entropy(out, torch.from_numpy(y))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    loss.backward()
    params = dict(tm.named_parameters())
    for n, g in zip(names, jgrads):
        ref = np.asarray(g)
        np.testing.assert_allclose(params[n].grad.numpy(), ref,
                                   atol=1e-5 + 1e-4 * np.abs(ref).max(),
                                   err_msg=n)


def test_vit_adamw_train_steps_match_reference():
    jm, tm = _pair(seed=5)
    jstep = JTrainStep(jm, lambda o, t: JF.cross_entropy(o, t),
                       paddle_tpu.optimizer.AdamW(
                           LR, parameters=jm.parameters()))
    step = TrainStep(tm, F.cross_entropy,
                     AdamW(LR, parameters=tm.parameters()))
    jl, tl = [], []
    for i in range(STEPS):
        x, y = _batch(10 + i)
        jl.append(float(np.asarray(jstep(paddle_tpu.to_tensor(x),
                                         paddle_tpu.to_tensor(y)).value)))
        tl.append(step(x, y).item())
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    got = numpy_state_dict(tm)
    want = {k: np.asarray(v.value, np.float32)
            for k, v in jm.state_dict().items()}
    assert sorted(got) == sorted(want)
    for n in want:
        d = np.abs(got[n] - want[n])
        assert d.max() <= 2 * LR * STEPS, (n, d.max())
        if n.endswith("attn.qkv.bias"):
            # the key third's gradient is zero in exact arithmetic
            # (softmax ignores a shift that is the same for every key)
            d = np.concatenate([d[:64], d[128:]])
        assert np.quantile(d, 0.999) <= 2e-5, (n, np.quantile(d, 0.999))
