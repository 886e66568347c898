from .jit_update import (apply_shard_updates, apply_update, apply_updates,
                         maybe_master_state, wants_master)
from .optimizer import Adam, AdamW, Optimizer

__all__ = ["Optimizer", "Adam", "AdamW", "apply_update", "apply_updates",
           "apply_shard_updates", "maybe_master_state", "wants_master"]
