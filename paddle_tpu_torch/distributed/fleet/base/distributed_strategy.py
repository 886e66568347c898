"""DistributedStrategy: the fleet configuration object.

Copied and adapted from `paddle_tpu/distributed/fleet/base/
distributed_strategy.py` (reference: Paddle's
`python/paddle/distributed/fleet/base/distributed_strategy.py:284`,
backed there by `distributed_strategy.proto`).  Plain Python: the knobs
map onto mesh degrees and trainer options;
`parallel.ShardedTrainStep.from_strategy` reads `sharding` and
`sharding_configs`.

`hybrid_configs` validates on assignment, as the reference's does: a
(possibly partial) dict is merged into the defaults, and unknown keys
or malformed degrees raise HybridConfigError at once.  The reference
borrows its validator from `parallel/hybrid_engine.py`, which is not
ported; the checks are kept here.
"""
from __future__ import annotations

__all__ = ["DistributedStrategy", "HybridConfigError"]

_DEGREE_KEYS = ("dp_degree", "mp_degree", "pp_degree", "sep_degree",
                "sharding_degree")
_CONFIG_KEYS = ("mp_configs", "pp_configs", "sharding_configs")
_HYBRID_DEFAULTS = {
    "dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
    "sep_degree": 1, "sharding_degree": 1,
    "mp_configs": {}, "pp_configs": {}, "sharding_configs": {},
}


class HybridConfigError(ValueError):
    """An unknown hybrid_configs key or a degree that is not a positive
    int."""


def _validate_hybrid_configs(configs) -> dict:
    if not isinstance(configs, dict):
        raise HybridConfigError(f"hybrid_configs must be a dict, got "
                                f"{type(configs).__name__}")
    allowed = set(_DEGREE_KEYS) | set(_CONFIG_KEYS)
    unknown = sorted(set(configs) - allowed)
    if unknown:
        raise HybridConfigError(f"unknown hybrid_configs key(s) {unknown} "
                                f"- allowed: {sorted(allowed)}")
    out = {}
    for k in _DEGREE_KEYS:
        v = configs.get(k, 1)
        if isinstance(v, bool) or not isinstance(v, int) or v < 1:
            raise HybridConfigError(f"hybrid_configs[{k!r}] must be a "
                                    f"positive int, got {v!r}")
        out[k] = v
    for k in _CONFIG_KEYS:
        sub = configs.get(k, {})
        if not isinstance(sub, dict):
            raise HybridConfigError(f"hybrid_configs[{k!r}] must be a "
                                    f"dict, got {sub!r}")
        out[k] = dict(sub)
    return out


class DistributedStrategy:
    def __init__(self):
        self.hybrid_configs = dict(_HYBRID_DEFAULTS)
        self.amp = False
        self.amp_configs = {"init_loss_scaling": 32768.0,
                            "use_pure_fp16": False, "use_bf16": True}
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        self.sharding = False
        # read by ShardedTrainStep.from_strategy when `sharding` is on:
        # stage, offload (not ported: the trainer raises), comm_overlap
        # (not ported: the trainer raises)
        self.sharding_configs = {"sharding_degree": 1, "stage": 1,
                                 "offload": False,
                                 "offload_prefetch_depth": 1,
                                 "offload_cast_dtype": "bfloat16",
                                 "comm_overlap": False}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "micro_batch_size": 1,
                                 "schedule_mode": "1F1B",
                                 "overlap_p2p_comm": None}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.lamb = False
        self.dgc = False
        self.heter_ccl_mode = False
        self.find_unused_parameters = False
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1
        self.gradient_scale_configs = {"scale_strategy": "avg"}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {}
        self.without_graph_optimization = True

    @property
    def hybrid_configs(self):
        return self._hybrid_configs

    @hybrid_configs.setter
    def hybrid_configs(self, value):
        merged = dict(_HYBRID_DEFAULTS)
        merged.update(getattr(self, "_hybrid_configs", None) or {})
        merged.update(dict(value or {}))
        self._hybrid_configs = _validate_hybrid_configs(merged)

    def __repr__(self):
        keys = ["hybrid_configs", "amp", "recompute", "sharding", "pipeline"]
        return "DistributedStrategy(" + ", ".join(
            f"{k}={getattr(self, k)}" for k in keys) + ")"
