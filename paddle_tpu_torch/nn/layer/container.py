"""LayerList and Sequential.

Counterpart of `paddle_tpu/nn/layer/container.py`: `Sequential` (:12)
and `LayerList` (:45), as thin subclasses of `torch.nn.Sequential` and
`torch.nn.ModuleList` that keep the reference's names and constructor
forms (sublayers "0", "1", ...; `Sequential` also from an OrderedDict or
(name, layer) pairs).  A ZeRO-3 `parallel.ShardedTrainStep` treats each
child of a LayerList as a unit, as it does a ModuleList's.
"""
from __future__ import annotations

import collections

from torch import nn

__all__ = ["LayerList", "Sequential"]


class LayerList(nn.ModuleList):
    def __init__(self, sublayers=None):
        super().__init__(sublayers)


class Sequential(nn.Sequential):
    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            super().__init__(layers[0])
        elif layers and isinstance(layers[0], (list, tuple)) \
                and len(layers[0]) == 2 and isinstance(layers[0][0], str):
            super().__init__(collections.OrderedDict(layers))
        else:
            super().__init__(*layers)
