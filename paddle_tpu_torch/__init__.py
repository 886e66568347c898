"""paddle_tpu_torch — the PyTorch/CUDA port of `paddle_tpu`, for an
NVIDIA H100.

The JAX package `paddle_tpu` beside it is the reference; this package
imports neither `jax` nor `paddle_tpu` and keeps its own copy of every
host-side piece it needs.  The layout mirrors the reference so a reader
finds counterparts by path:

  framework/   flags and the device rule
  ops/         the op layer: plain PyTorch versions beside hand-written
               Hopper kernels (csrc/*.cu, bound through ctypes), with
               autograd Functions whose backward is a kernel too
  nn/          the LM cross-entropy loss (logits or fused linear + CE)
  models/      Llama training forward (recompute, fused-CE mode) and
               decode surface, weight and optimizer-state carry-over
  optimizer/   Adam / AdamW: the fused AdamW kernel or the pure rule,
               in place
  distributed/ the process-group environment, the mesh
               (DeviceMesh), fleet's DistributedStrategy and recompute
  jit/         TrainStep
  parallel/    ShardedTrainStep: ZeRO stages 0-3 over torch.distributed
  inference/   paged KV allocator, greedy generate, ContinuousBatcher

Device rule: entry points (model constructors, ContinuousBatcher,
generate) run on `cuda` unless the caller passes `device="cpu"`; with no
CUDA device and no explicit CPU request they raise.  A TrainStep runs
where its model lives; `distributed.init_parallel_env` starts NCCL on
the rank's card, and gloo only for `device="cpu"`.

Importing this package builds nothing and touches no GPU: kernels are
compiled on first launch (ops/_build.py).
"""
from __future__ import annotations

__all__ = ["framework", "ops", "nn", "models", "optimizer", "jit",
           "inference", "distributed", "parallel"]
