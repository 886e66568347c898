"""paddle_tpu_torch.distributed — the pieces the ported slices use."""
from . import fleet

__all__ = ["fleet"]
