"""The port's resnet18 against paddle_tpu's, on the CPU: logits, loss,
gradients and running statistics (resnet50's in
tests/test_torch_resnet50.py), the state dict's names and buffers, the
constructors.

The reference's own initial weights (its `state_dict()` as numpy, with
the BatchNorm scales, shifts and running statistics moved off 1 / 0 so
that eval mode means something: tests/torch_vision_pair.py) go into
both packages; the same images, made like bench.py's
`_class_correlated_images` from a seed, go through both.  Each run is
computed once per module (a module-scoped fixture a case).

In eval mode the packages agree to fp32 summation order and are held
to fixed tolerances: logits 1e-5 of the largest |logit| plus 1e-5
relative, the loss 1e-5 of the largest |logit|, each gradient 1e-5 +
1e-4 of its largest |entry| (tests/test_torch_llama_train.py's
limits).  In training mode
each tensor is held to the reference's rounding spread
(tests/torch_vision_pair.py: 4x the distance of the reference run on
the batch in another order), and the loss to rtol 1e-4.  A gradient
that misses a path or a wrong BatchNorm momentum is off by O(1) of the
tensor, where the spread is ~1e-2 or less.
"""
import collections

import numpy as np
import pytest
import torch
from torch_cpu import one_cpu_thread  # noqa: F401 (autouse)
from torch_vision_pair import (check_logits, check_loss_and_grads,
                               check_running_stats, forward_backward, pair)

from paddle_tpu.vision import models as jmodels

from paddle_tpu_torch.models import load_numpy_state_dict, numpy_state_dict
from paddle_tpu_torch.vision import models

# name: (model, mode, batch)
CASES = {
    "resnet18-train": ("resnet18", "train", 8),
    "resnet18-eval": ("resnet18", "eval", 8),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request):
    return forward_backward(*CASES[request.param])


def test_logits_match_reference(run):
    check_logits(run)


def test_loss_and_grads_match_reference(run):
    check_loss_and_grads(run)


def test_running_stats_match_reference(run):
    check_running_stats(run)


def test_state_dict_must_carry_every_buffer():
    """A missing or an extra buffer raises before anything is written,
    as a parameter does."""
    _, tm, w = pair("resnet18", seed=10, num_classes=10)
    before = numpy_state_dict(tm)
    short = {k: v for k, v in w.items() if k != "layer1.0.bn1._mean"}
    with pytest.raises(KeyError, match="layer1.0.bn1._mean"):
        load_numpy_state_dict(tm, short)
    extra = dict(w, **{"layer1.0.bn1._extra": np.zeros(64, np.float32)})
    with pytest.raises(KeyError, match="_extra"):
        load_numpy_state_dict(tm, extra)
    bad = dict(w, **{"bn1._variance": np.ones(65, np.float32)})
    with pytest.raises(ValueError, match="bn1._variance"):
        load_numpy_state_dict(tm, bad)
    after = numpy_state_dict(tm)
    assert all(np.array_equal(before[k], after[k]) for k in before)


def test_state_dict_names_match_reference():
    """102 entries for resnet18, as the reference's: parameters and the
    BatchNorm buffers under the same structural names.  pretrained=True
    raises in both packages."""
    with pytest.raises(RuntimeError, match="pretrained"):
        jmodels.resnet18(pretrained=True)
    jm = jmodels.resnet18(num_classes=10)
    tm = models.resnet18(num_classes=10, device="cpu")
    assert sorted(tm.state_dict()) == sorted(jm.state_dict())
    assert len(tm.state_dict()) == 102
    assert collections.Counter(k.rsplit(".", 1)[-1] for k in tm.state_dict()) \
        == collections.Counter(k.rsplit(".", 1)[-1] for k in jm.state_dict())


@pytest.mark.parametrize("name", ["resnet18", "resnet34", "resnet50",
                                  "resnet101", "resnet152",
                                  "resnext50_32x4d", "resnext101_32x8d",
                                  "wide_resnet50_2", "wide_resnet101_2"])
def test_constructors_follow_the_device_rule(name, monkeypatch):
    """No CUDA device and no device="cpu": the constructor raises;
    pretrained=True raises as the reference's does."""
    with pytest.raises(RuntimeError, match="pretrained"):
        getattr(models, name)(pretrained=True, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(models, name)(num_classes=10)
    with pytest.raises(RuntimeError, match="no CUDA"):
        getattr(models, name)(num_classes=10, device="cuda")


def test_seed_and_generator_make_the_weights():
    """The same seed gives the same weights, another seed others; a
    generator given is drawn from instead."""
    a = numpy_state_dict(models.resnet18(num_classes=10, device="cpu"))
    b = numpy_state_dict(models.resnet18(num_classes=10, device="cpu",
                                         seed=0))
    c = numpy_state_dict(models.resnet18(num_classes=10, device="cpu",
                                         seed=1))
    d = numpy_state_dict(models.resnet18(
        num_classes=10, device="cpu",
        generator=torch.Generator().manual_seed(1)))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["conv1.weight"], c["conv1.weight"])
    assert all(np.array_equal(c[k], d[k]) for k in c)
