from .base import DistributedStrategy
from .recompute import recompute

__all__ = ["DistributedStrategy", "recompute"]
