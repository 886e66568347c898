"""paddle_tpu_torch.distributed — the pieces the ported slices use:
the process-group environment, the mesh, fleet's DistributedStrategy
and recompute; the fault-injection registry (`fault`), the host-side
hang watchdog (`watchdog.watched`) and the SIGTERM drain protocol
(`guard`) that the serving batcher reads."""
from . import fault, fleet, guard, watchdog
from .env import (ParallelEnv, get_rank, get_world_size, init_parallel_env,
                  is_initialized)
from .topology import AXIS_ORDER, Mesh, batch_partition_spec, build_mesh

__all__ = ["fault", "fleet", "guard", "watchdog", "init_parallel_env",
           "is_initialized", "get_rank", "get_world_size", "ParallelEnv",
           "AXIS_ORDER", "Mesh", "build_mesh", "batch_partition_spec"]
