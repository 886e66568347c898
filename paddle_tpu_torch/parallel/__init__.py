"""paddle_tpu_torch.parallel — the ZeRO trainer over torch.distributed."""
from .sharded_trainer import ShardedTrainStep, shard_batch

__all__ = ["ShardedTrainStep", "shard_batch"]
