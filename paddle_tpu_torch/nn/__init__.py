"""paddle_tpu_torch.nn — the functional pieces the training slice uses."""
from . import functional

__all__ = ["functional"]
