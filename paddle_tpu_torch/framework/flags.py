"""Flag registry — the subset the ported slices read.

Counterpart of `paddle_tpu/framework/flags.py`: the same flag names and
defaults, the same `FLAGS_<name>` environment pickup at import, and
`get_flag`/`set_flags` with the reference's semantics.  Defined here:
the three paged-KV flags (reference :179-190), the weight-only
quantization flags `weight_only_dtype` and `weight_only_group_size`
(:216-226), the training fusions
`fused_ce` and `bf16_adamw_moments` (:150-161), the fused-AdamW
dispatch flags `use_fused_adamw` and `multi_tensor_adamw`
(`paddle_tpu/optimizer/jit_update.py:42-56`), and the flags
`ShardedTrainStep` reads at construction: `skip_nonfinite_steps`
(:109), `comm_overlap` (:120), `comm_bucket_mb` (:127) and
`grad_comm_dtype` (:141); the serving tier's request plane:
`serve_queue_depth` and `serve_default_deadline_ms` (:200, :205),
`serve_spec_tokens` and `serve_draft_layers` (:228, :236),
`serve_retry_budget` (:334) and `fault_injection` (:104), with the
watchdog's `stop_check_timeout` and `comm_watchdog_abort`
(`paddle_tpu/distributed/watchdog.py:31-35`).  The reference's
`fused_adamw_interpret` (Pallas interpret mode off the TPU) has no
counterpart: a CPU tensor already takes the kernel's plain version.
"""
from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["define_flag", "set_flags", "get_flag"]

_registry: Dict[str, dict] = {}


def define_flag(name: str, default: Any, help_str: str = ""):
    env_name = name if name.startswith("FLAGS_") else "FLAGS_" + name
    key = env_name[len("FLAGS_"):]
    value = default
    if env_name in os.environ:
        raw = os.environ[env_name]
        if isinstance(default, bool):
            value = raw.lower() in ("1", "true", "yes", "on")
        elif isinstance(default, int):
            value = int(raw)
        elif isinstance(default, float):
            value = float(raw)
        else:
            value = raw
    _registry[key] = {"value": value, "default": default, "help": help_str}
    return value


def _norm(name: str) -> str:
    return name[len("FLAGS_"):] if name.startswith("FLAGS_") else name


def set_flags(flags: Dict[str, Any]):
    """set_flags({'FLAGS_kv_page_size': 8})"""
    for k, v in flags.items():
        key = _norm(k)
        if key not in _registry:
            _registry[key] = {"value": v, "default": None, "help": ""}
        else:
            _registry[key]["value"] = v


def get_flag(name: str, default=None):
    key = _norm(name)
    if key in _registry:
        return _registry[key]["value"]
    return default


# paged KV cache (inference/serving.py + ops.paged_attention): the
# serving tier's KV pool layout and precision
define_flag("kv_cache_dtype", "auto",
            "storage dtype of the serving paged KV pool: 'auto' (the "
            "model compute dtype), 'bfloat16', 'float16', 'float32' or "
            "'int8' (per-page per-head fp32 scales beside the pool; pages "
            "requantize against their running amax as rows land, and "
            "paged attention dequantizes inside the kernel)")
define_flag("kv_page_size", 16,
            "rows (token positions) per KV page in the serving paged "
            "pool; prefix sharing operates at page granularity")
define_flag("kv_pool_pages", 0,
            "total pages in the serving KV pool (page 0 is a reserved "
            "null page); 0 sizes the pool to dense-equivalent capacity "
            "(every slot fully backed)")

# weight-only quantization of the decode matmuls (quantization/
# weight_only.py, ops/quant_matmul.py): off by default, as in the
# reference
define_flag("weight_only_dtype", "none",
            "weight-only quantization for the DECODE path: 'int8' "
            "(per-output-channel scales) or 'int4' (group-wise packed, "
            "two nibbles per byte, FLAGS_weight_only_group_size rows "
            "per scale group).  A ContinuousBatcher constructed under "
            "this flag packs the model's linear weights in place "
            "(quantization.weight_only.quantize_model) — decode HBM "
            "traffic per token drops ~2x/~4x.  'none' disables")
define_flag("weight_only_group_size", 64,
            "rows (input-channel positions) per int4 scale group in "
            "the weight-only packed layout; must divide half the "
            "input dimension of every quantized weight")

# training-step fusions (optimizer/jit_update.py, nn/functional/loss.py,
# models/llama.py): both off by default, as in the reference
define_flag("fused_ce", False,
            "causal/masked LM losses compute from the HIDDEN states via "
            "the chunked fused linear+cross-entropy "
            "(nn.functional.fused_cross_entropy): the [B, S, vocab] fp32 "
            "logits tensor is never materialized — the model's training "
            "forward returns hidden states and compute_loss folds the "
            "lm-head matmul into the loss")
define_flag("bf16_adamw_moments", False,
            "store Adam/AdamW moments in bfloat16 with an error-feedback "
            "residual for the second moment (state key 'ef'): moment HBM "
            "traffic halves (8->4 bytes/param) plus a 2-byte residual; "
            "update math stays fp32 via the v+ef reconstruction")
define_flag("use_fused_adamw", True,
            "dispatch Adam/AdamW updates to the fused AdamW kernel "
            "(csrc/fused_adamw.cu on the card, its plain version for CPU "
            "tensors); off = the pure update rule")
define_flag("multi_tensor_adamw", False,
            "flatten same-(wd, dtype, state-layout) SMALL params into one "
            "fused AdamW call (reference: fused_adam_kernel.cu "
            "multi-tensor); large params keep per-param calls.  Default "
            "OFF, as in the reference")

# read by parallel/sharded_trainer.py at construction, with the
# reference's names and defaults; the nonfinite-step guard and the
# comm-overlap engine (whose buckets and wire dtype the last two shape)
# are not ported yet, so the trainer raises when skip_nonfinite_steps or
# comm_overlap is on, or comm_bucket_mb or grad_comm_dtype differs from
# its default
define_flag("skip_nonfinite_steps", False,
            "train steps whose loss or grad-norm is nonfinite leave "
            "params and optimizer state untouched (skip-step)")
define_flag("comm_overlap", False,
            "bucket gradient collectives and issue them with the "
            "backward (Paddle sharding_configs comm_overlap)")
define_flag("comm_bucket_mb", 32.0,
            "size target in MB for one fused gradient bucket "
            "(Paddle's DistributedStrategy.fuse_grad_size_in_MB)")
define_flag("grad_comm_dtype", "auto",
            "wire dtype for fused gradient collectives: 'auto' keeps "
            "each grad's own width")

# serving request plane (inference/serving.py): SLO-aware admission,
# deadlines, load shedding, fault recovery and speculative decoding —
# all off by default, as in the reference
define_flag("serve_queue_depth", 0,
            "bound on the serving admission queue (all SLO classes "
            "combined); a submit() past the bound load-sheds the "
            "lowest-SLO newest-arrival queued request (best_effort "
            "first, never an in-flight decode).  0 = unbounded")
define_flag("serve_default_deadline_ms", 0.0,
            "default arrival deadline for serving requests that don't "
            "pass deadline_ms: a request still QUEUED when its "
            "deadline passes is shed (serve.deadline_miss).  In-flight "
            "requests are never deadline-shed.  0 disables")
define_flag("serve_spec_tokens", 0,
            "speculative decoding: draft tokens per verify step in the "
            "serving decode scan.  K>0 drafts K tokens with the draft "
            "model and verifies them in ONE target pass of width K+1 "
            "through the same compiled chunked scan; the longest "
            "matching prefix (plus the target's bonus token) is "
            "accepted per step.  Greedy output is bit-exact vs "
            "non-speculative decode.  0 disables")
define_flag("serve_draft_layers", 0,
            "self-drafting: build the speculative draft from the "
            "target model's own first N layers (early exit) instead "
            "of a separate draft model — no extra weights resident.  "
            "Used when FLAGS_serve_spec_tokens > 0 and no draft_model "
            "is passed; 0 requires an explicit draft_model")
define_flag("serve_retry_budget", 3,
            "per-request bound on serve-plane fault recoveries "
            "(injected/real admission faults retried FIFO-in-place, "
            "faulted-slot requeues): past the budget the request is "
            "shed instead of retried — a poisoned request cannot spin "
            "the batch forever")
define_flag("fault_injection", "",
            "deterministic fault-injection spec(s), e.g. "
            "\"ckpt.write:step=3:mode=truncate\" — see "
            "paddle_tpu_torch/distributed/fault.py for the grammar; empty "
            "disables injection entirely")

# the host-side watchdog (distributed/watchdog.py)
define_flag("stop_check_timeout", 0,
            "seconds before an in-flight host-side collective/step is "
            "declared hung (0 disables the watchdog; reference "
            "FLAGS_stop_check_timeout)")
define_flag("comm_watchdog_abort", False,
            "abort the process when a watched task times out (reference "
            "CommTaskManager abort-on-timeout behavior)")
