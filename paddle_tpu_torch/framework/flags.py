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
(`paddle_tpu/distributed/watchdog.py:31-35`); and the serve fleet:
the router's `serve_replicas`, `router_prefix_weight`,
`router_rebalance_ms` and `router_attainment_floor` (:282-298), the
autoscaler's `autoscale`, `autoscale_min_replicas`,
`autoscale_max_replicas`, `autoscale_window` and `autoscale_cooldown`
(:311-329) with the four `paddle_tpu/fleet/autoscaler.py:69-78` defines
(`autoscale_queue_high`, `autoscale_queue_low`, `autoscale_shed_high`,
`autoscale_lease_ttl_s`), and disaggregated serving's `serve_disagg`,
`serve_digest_entries`, `router_migration_budget` and
`autoscale_role_imbalance` (:347-369).  The reference's
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

# serve-fleet router (inference/router.py): N batcher replicas behind a
# prefix-aware, SLO-aware router; host-plane scheduling only
define_flag("serve_replicas", 0,
            "replica count for inference.fleet_serve() when none is "
            "passed explicitly: the router fronts N ContinuousBatcher "
            "replicas (in-process handles; replica-per-rank workers "
            "publish their views over the launch KV plane).  0 falls "
            "back to 2")
define_flag("router_prefix_weight", 1.0,
            "weight on a replica's prefix_hit_tokens (prompt tokens "
            "already resident in its prefix cache — prefill work the "
            "route would skip) in the routing score; 0 disables "
            "prefix affinity and routes purely by load/SLO balance")
define_flag("router_rebalance_ms", 0.0,
            "interval for the router's queued-request rebalance sweep: "
            "every N ms a QUEUED request on an overloaded replica "
            "migrates to an idle one (lossless — only never-started "
            "requests move).  0 (default) disables rebalancing")
define_flag("router_attainment_floor", 0.9,
            "interactive SLO floor for routing: an interactive request "
            "never routes to a replica whose interactive attainment "
            "sits below the floor while another candidate has "
            "headroom (at/above it, or no attainment signal yet).  0 "
            "disables the floor")

# SLO-driven elastic autoscaler (fleet/autoscaler.py): off by default,
# when tick() returns on one flag read
define_flag("autoscale", False,
            "master switch for the SLO-driven elastic autoscaler "
            "(fleet.autoscaler.AutoscalerDaemon): off (default), "
            "tick() is a no-op — no decisions, no KV traffic, no "
            "lease.  On, the lease-holding daemon polls the fleet "
            "view and executes scale-out/scale-in/role-flip via the "
            "lossless drain + re-form path")
define_flag("autoscale_min_replicas", 1,
            "scale-in floor: the autoscaler never drains the fleet "
            "below this many routable replicas")
define_flag("autoscale_max_replicas", 4,
            "scale-out ceiling: the autoscaler never grows the fleet "
            "past this many live replicas")
define_flag("autoscale_window", 2,
            "hysteresis window in polls: pressure (or idleness) must "
            "persist for this many CONSECUTIVE daemon ticks before an "
            "action is taken — a one-tick load spike never moves the "
            "fleet")
define_flag("autoscale_cooldown", 4,
            "per-action-kind cooldown in polls: after an executed "
            "scale action, the opposite kind is additionally blocked "
            "for this many ticks — oscillating load can never flap "
            "the fleet (autoscale_report asserts flap count 0)")
define_flag("autoscale_queue_high", 1.5,
            "fleet occupancy ((active+queued)/slots) above which a "
            "tick counts as PRESSURED toward a scale-out")
define_flag("autoscale_queue_low", 0.25,
            "fleet occupancy below which a tick counts as IDLE toward "
            "a scale-in")
define_flag("autoscale_shed_high", 0.05,
            "max per-replica sliding-window shed rate above which a "
            "tick counts as pressured regardless of occupancy")
define_flag("autoscale_lease_ttl_s", 5.0,
            "autoscaler KV lease TTL (master-clock seconds); an "
            "expired lease is taken over by the next daemon tick")

# disaggregated prefill/decode serving and the fleet-tier prefix cache
# (inference/serving.py roles, inference/router.py hand-off): all
# host-plane, all off by default
define_flag("serve_disagg", False,
            "role-split default for inference.fleet_serve(): on, a "
            "fleet built without explicit roles= splits its replicas "
            "into prefill workers (chunked-prefill-only programs; "
            "finished prompts freeze and hand their KV pages to a "
            "decode worker) and decode workers (admit at pos = "
            "prompt_len — no prefill recompute).  Off (default), "
            "replicas stay unified/symmetric; explicit roles= always "
            "wins over the flag")
define_flag("serve_digest_entries", 32,
            "bounded trie-digest size a replica publishes in its "
            "router_view(digest=True): up to N [depth, chain-hash] "
            "entries over the prefix cache, MRU-first, so peers can "
            "score cross-replica prefix affinity from the KV plane "
            "without a token-level probe.  0 publishes no digest")
define_flag("router_migration_budget", 0,
            "hot-prefix replication budget: max KV pages the router "
            "copies per step() sweep when a prefix-affine route has "
            "to land AWAY from the replica holding the prefix (cache "
            "placement follows traffic).  Bounded per sweep so "
            "placement never starves serving; 0 (default) disables "
            "replication")
define_flag("autoscale_role_imbalance", 2.0,
            "sustained prefill-vs-decode pressure ratio that arms the "
            "autoscaler's dynamic role repair: when one side's "
            "pressure (queued+active+handoff backlog per slot) "
            "exceeds the other's by this factor for autoscale_window "
            "consecutive ticks, decide() emits a role_flip toward the "
            "starved side (never below one replica per role).  0 "
            "disables dynamic role repair")
