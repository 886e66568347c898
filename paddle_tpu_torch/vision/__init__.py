"""paddle_tpu_torch.vision — the model zoo's CNNs.

Counterpart of `paddle_tpu/vision/__init__.py`: the models only
(`transforms` and `datasets` are not ported yet, ROADMAP queue 1 item
11)."""
from . import models
from .models import (LeNet, ResNet, resnet18, resnet34, resnet50,
                     resnet101, resnet152)

__all__ = ["models", "ResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152", "LeNet"]
