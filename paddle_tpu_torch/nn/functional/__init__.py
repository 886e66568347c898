from .loss import fused_cross_entropy

__all__ = ["fused_cross_entropy"]
