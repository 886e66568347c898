from .generation import generate, sample_filter
from .paged_kv import AdmitPlan, PageAllocator
from .router import ServeRouter, pick_replica
from .serving import (SLO_CLASSES, ContinuousBatcher, Request, pack_handoff,
                      unpack_handoff)

__all__ = ["generate", "sample_filter", "AdmitPlan", "PageAllocator",
           "ContinuousBatcher", "Request", "SLO_CLASSES", "ServeRouter",
           "pick_replica", "fleet_serve", "pack_handoff", "unpack_handoff"]


def fleet_serve(model=None, replicas=None, **kw) -> ServeRouter:
    """The serve-fleet entry point (`paddle_tpu/inference/__init__.py:41`):
    a `ServeRouter` fronting N `ContinuousBatcher` replicas over `model`,
    N from `replicas`, else FLAGS_serve_replicas (0 -> 2).  Keyword args
    go to the router (kv=, job_id=, roles=) and the batchers (the rest:
    max_batch_size, max_len, chunk, ..., device — None means CUDA, and
    raises without one).

        router = inference.fleet_serve(model, replicas=2, max_batch_size=4)
        gid = router.submit(ids, 128, slo="interactive")
        outs = router.run()
    """
    return ServeRouter(model, replicas=replicas, **kw)
