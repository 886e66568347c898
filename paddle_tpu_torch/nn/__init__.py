"""paddle_tpu_torch.nn — `Layer` (the module base that names parameters
as the reference), the layers the encoder models are built from
(Linear, Embedding, Dropout, LayerNorm, LayerList, Sequential), the
initializers, the functional ops and `set_compute_dtype`."""
from ..framework.dtypes import to_torch
from . import functional, initializer
from .layer import Layer
from .layer.common import Dropout, Embedding, Linear
from .layer.container import LayerList, Sequential
from .layer.norm import LayerNorm

__all__ = ["functional", "initializer", "Layer", "Linear", "Embedding",
           "Dropout", "LayerNorm", "LayerList", "Sequential",
           "set_compute_dtype"]


def set_compute_dtype(layer, dtype):
    """Counterpart of `paddle_tpu/nn/__init__.py::set_compute_dtype`
    (:19-37): the parameters stay fp32 (each IS its master weight) while
    every Linear, Embedding and LayerNorm under `layer` computes in
    `dtype`.  Returns the number of layers switched, counted as the
    reference walks them: a sublayer reachable under two names (ERNIE's
    `ernie` alias of `bert`) counts twice."""
    dt, n = to_torch(dtype), 0
    for _, sub in layer.named_modules(remove_duplicate=False):
        if hasattr(type(sub), "_compute_dtype"):
            sub._compute_dtype = dt
            n += 1
    return n
