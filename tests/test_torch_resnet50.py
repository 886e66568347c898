"""The port's resnet50 (bench_resnet's model) against paddle_tpu's, on
the CPU: logits, loss, every gradient and the running statistics of one
forward and backward, in eval mode at batch 2 and in training mode at
batch 16 (tests/torch_vision_pair.py holds the weights, the images and
the checks).

Tolerances, with their reasons: in eval mode 1e-5 of the largest
|logit| plus 1e-5 relative, the loss 1e-5 of the largest |logit| (the
reference jitted: the loss measured 8.0e-5 apart), each
gradient 1e-5 + 1e-4 of its largest |entry| (measured within 2.2e-5 of
it); in
training mode each tensor within 4x the reference's own rounding spread
(the reference run on the batch in another order; measured: gradients
1.04x median, 1.83x worst) and the loss rtol 1e-4 (measured 1.6e-5).
At initialisation resnet50's training-mode fp32 gradients are
ill-conditioned: both packages' lie ~0.8% (median tensor, in the
largest entry) and up to ~14% from an fp64 evaluation of the same
weights, so no fixed fp32 tolerance is both safe and sharp there.
Training runs at batch 16, not 2: at 32x32 the last stage sees 1x1
maps, so at batch 2 each channel's batch statistics come from two
values, and normalizing two values that nearly agree leaves no useful
spread.
"""
import pytest
from torch_cpu import one_cpu_thread  # noqa: F401 (autouse)
from torch_vision_pair import (check_logits, check_loss_and_grads,
                               check_running_stats, forward_backward)

# name: (model, mode, batch)
CASES = {
    "resnet50-train": ("resnet50", "train", 16),
    "resnet50-eval": ("resnet50", "eval", 2),
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
