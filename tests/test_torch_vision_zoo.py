"""The port's vision zoo against paddle_tpu's, on the CPU: LeNet, AlexNet,
VGG (with and without BatchNorm), MobileNetV1, MobileNetV2 (depthwise
`groups`, ReLU6), ResNeXt-50 (grouped 3x3) and wide ResNet-50.

Each model's reference state (tests/torch_vision_pair.py: its initial
weights, the BatchNorm scales, shifts and running statistics moved off
1 / 0) goes into both packages, and a small batch of 2 goes through
both in eval mode (the reference's forward jitted): Dropout is the
identity there and BatchNorm uses the carried running statistics, so
the two compute one function.  Held to
1e-5 of the largest |logit| plus 1e-5 relative (fp32 convolutions and
matmuls summed in other orders).  Inputs: 1 x 28 x 28 for LeNet (its
400-wide head), 3 x 64 x 64 for AlexNet (its 11x11 stride-4 stem and
three stride-2 pools need 63 pixels), 3 x 32 x 32 for the rest.
"""
import gc

import numpy as np
import pytest
import torch
from torch_cpu import one_cpu_thread  # noqa: F401 (autouse)
from torch_vision_pair import pair, ref_eval

from paddle_tpu_torch import nn
from paddle_tpu_torch.vision import models

TOL = 1e-5

# name: (constructor, kwargs, input shape)
ZOO = {
    "lenet": ("LeNet", {}, (2, 1, 28, 28)),
    "alexnet": ("alexnet", {}, (2, 3, 64, 64)),
    "vgg11": ("vgg11", {}, (2, 3, 32, 32)),
    "vgg11_bn": ("vgg11", dict(batch_norm=True), (2, 3, 32, 32)),
    "mobilenet_v1": ("mobilenet_v1", {}, (2, 3, 32, 32)),
    "mobilenet_v2": ("mobilenet_v2", {}, (2, 3, 32, 32)),
    "resnext50_32x4d": ("resnext50_32x4d", {}, (2, 3, 32, 32)),
    "wide_resnet50_2": ("wide_resnet50_2", {}, (2, 3, 32, 32)),
}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_eval_forward_matches_reference(name):
    ctor, kw, shape = ZOO[name]
    jm, tm, w = pair(ctor, seed=1, num_classes=10, **kw)
    assert sorted(tm.state_dict()) == sorted(w)
    jm.eval()
    tm.eval()
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    want = ref_eval(jm, x)
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * np.abs(want).max())
    del jm, tm, w
    gc.collect()


def test_zoo_layers_are_the_ported_ones():
    """MobileNetV1's depthwise convs and MobileNetV2's ReLU6: the layers
    the reference builds them from."""
    v1 = models.mobilenet_v1(num_classes=10, device="cpu")
    dw = [m for m in v1.modules() if isinstance(m, nn.Conv2D)
          and m._groups > 1]
    assert len(dw) == 13 and all(m._groups == m._in_channels for m in dw)
    v2 = models.mobilenet_v2(num_classes=10, device="cpu")
    assert sum(isinstance(m, nn.ReLU6) for m in v2.modules()) == 35
    assert not any(isinstance(m, nn.ReLU) for m in v2.modules())


@pytest.mark.parametrize("ctor", ["alexnet", "vgg11", "mobilenet_v1",
                                  "mobilenet_v2", "LeNet"])
def test_zoo_constructors_follow_the_device_rule(ctor, monkeypatch):
    """pretrained=True raises (no weights to download); with no CUDA
    device and no device="cpu" the constructor raises."""
    if ctor != "LeNet":
        with pytest.raises(RuntimeError, match="pretrained"):
            getattr(models, ctor)(pretrained=True, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(models, ctor)(num_classes=10)


def test_dropout_draws_from_the_model_generator():
    """In training mode AlexNet's Dropout masks come from the model's
    generator: the same seed, the same masks; the logits differ from
    eval mode's."""
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(3))
    outs = []
    for _ in range(2):
        m = models.alexnet(num_classes=10, device="cpu", seed=4)
        outs.append(m(x))
    assert torch.equal(outs[0], outs[1])
    m.eval()
    assert not torch.equal(m(x), outs[1])
