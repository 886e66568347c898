from .activation import gelu, tanh
from .common import dropout, embedding, linear
from .loss import cross_entropy, fused_cross_entropy
from .norm import layer_norm

__all__ = ["linear", "embedding", "dropout", "gelu", "tanh", "layer_norm",
           "cross_entropy", "fused_cross_entropy"]
