"""paddle_tpu_torch.nn — `Layer` (the module base that names parameters
as the reference), the layers the encoder models and the vision CNNs
are built from (Linear, Embedding, Dropout, LayerNorm, the BatchNorm
family, GroupNorm, the convolutions, the pools, ReLU, ReLU6, LayerList,
Sequential), the initializers, the functional ops and
`set_compute_dtype`."""
from ..framework.dtypes import to_torch
from . import functional, initializer
from .layer import Layer
from .layer.activation import ReLU, ReLU6
from .layer.common import Dropout, Embedding, Linear
from .layer.container import LayerList, Sequential
from .layer.conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose,
                         Conv3D, Conv3DTranspose)
from .layer.norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                         GroupNorm, LayerNorm, SyncBatchNorm)
from .layer.pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,
                            AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                            AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
                            AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D,
                            MaxPool3D)

__all__ = ["functional", "initializer", "Layer", "Linear", "Embedding",
           "Dropout", "LayerNorm", "GroupNorm", "LayerList", "Sequential",
           "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
           "ReLU", "ReLU6", "set_compute_dtype"]


def set_compute_dtype(layer, dtype):
    """Counterpart of `paddle_tpu/nn/__init__.py::set_compute_dtype`
    (:19-37): the parameters stay fp32 (each IS its master weight) while
    every Linear, Embedding, LayerNorm, GroupNorm and convolution under
    `layer` computes in `dtype`.  Returns the number of layers switched, counted
    as the reference walks them: a sublayer reachable under two names
    (ERNIE's `ernie` alias of `bert`) counts twice."""
    dt, n = to_torch(dtype), 0
    for _, sub in layer.named_modules(remove_duplicate=False):
        if hasattr(type(sub), "_compute_dtype"):
            sub._compute_dtype = dt
            n += 1
    return n
