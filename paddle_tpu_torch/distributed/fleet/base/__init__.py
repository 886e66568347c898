from .distributed_strategy import DistributedStrategy, HybridConfigError

__all__ = ["DistributedStrategy", "HybridConfigError"]
