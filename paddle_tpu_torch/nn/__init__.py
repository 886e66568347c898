"""paddle_tpu_torch.nn — the functional pieces the training slice uses,
and `Layer`, the module base that names parameters as the reference."""
from . import functional
from .layer import Layer

__all__ = ["functional", "Layer"]
