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
  nn/          Layer (the reference's automatic names, buffers),
               Linear, Embedding, Dropout, LayerNorm, the BatchNorm
               family, the convolutions and their transposes, the pools,
               ReLU, ReLU6, LayerList, Sequential, the initializers,
               set_compute_dtype, and the functional ops: linear,
               embedding, dropout, gelu, tanh, relu, relu6, layer_norm,
               batch_norm, conv*d, the pools, cross_entropy and the LM
               loss (logits or fused linear + CE)
  models/      Llama training forward (recompute, fused-CE mode) and
               decode surface; BERT and ERNIE (masked LM, sequence
               classification); weight and optimizer-state carry-over
  optimizer/   SGD, Momentum, Adam / AdamW: the fused AdamW kernel or
               the pure rules, in place
  distributed/ the process-group environment, the mesh
               (DeviceMesh), fleet's DistributedStrategy and recompute
  jit/         TrainStep (run_steps), to_static
  parallel/    ShardedTrainStep: ZeRO stages 0-3 over torch.distributed
  inference/   paged KV allocator, generate, ContinuousBatcher (roles and
               the KV hand-off), the serve-fleet router
  fleet/       the SLO-driven autoscaler over the router
  vision/      the model zoo's CNNs: ResNet (ResNeXt, wide), LeNet,
               AlexNet, VGG, MobileNetV1 and V2

Device rule: entry points (model constructors, the zoo's too, and the
nn layers, ContinuousBatcher, generate, ServeRouter and fleet_serve) run
on `cuda` unless the caller passes `device="cpu"`; with no CUDA device
and no explicit CPU request they raise.  A TrainStep runs
where its model lives; `distributed.init_parallel_env` starts NCCL on
the rank's card, and gloo only for `device="cpu"`.

Importing this package builds nothing and touches no GPU: kernels are
compiled on first launch (ops/_build.py).
"""
from __future__ import annotations

__all__ = ["framework", "ops", "nn", "models", "optimizer", "jit",
           "inference", "fleet", "distributed", "parallel", "vision"]
