"""One gloo rank of tests/test_torch_sharded_trainer.py.

Run as a script, one process a rank, by that test's fixture:

    python tests/torch_sharded_worker.py WORLD OUTDIR

The rank and the rendezvous come from the environment, as
`paddle_tpu_torch.distributed.init_parallel_env` reads it (the
reference's PADDLE_* variables or torchrun's).  OUTDIR holds the
numpy weights (`<dtype>:<name>`) and batches the test wrote
(`inputs.npz`); each rank trains every case of `cases(world)` through
`ShardedTrainStep` and pickles what it saw to OUTDIR/rank<r>.pkl.  It imports nothing of JAX
or of `paddle_tpu`, and runs torch on one CPU thread (the first
multi-threaded `exp` of a process can be wrong: tests/torch_cpu.py).
"""
import gc
import os
import pickle
import sys
import weakref

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from paddle_tpu_torch.distributed import (build_mesh,  # noqa: E402
                                          init_parallel_env)
from paddle_tpu_torch.framework.flags import set_flags  # noqa: E402
from paddle_tpu_torch.models import (LlamaForCausalLM,  # noqa: E402
                                     llama_tiny_config,
                                     load_numpy_state_dict, numpy_state_dict)
from paddle_tpu_torch.nn import functional as F  # noqa: E402
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402
from paddle_tpu_torch.parallel import sharded_trainer  # noqa: E402

# the reference test's model (tests/test_distributed.py:180-192)
TINY = dict(num_hidden_layers=2, hidden_size=64, intermediate_size=128,
            num_attention_heads=4, num_key_value_heads=4, vocab_size=128)
STEPS, LR = 3, 1e-2


def port_ce(logits, labels):
    """A loss_fn of the user's, on the port's masked mean."""
    return F.fused_cross_entropy(logits, labels, shift=True)


def torch_ce(logits, labels):
    """A loss_fn of the user's, on torch's masked mean."""
    return torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, logits.shape[-1]).float(),
        labels[:, 1:].reshape(-1).long(), ignore_index=-1)


LOSSES = {"port_ce": port_ce, "torch_ce": torch_ce}


def cases(world):
    """name -> (stage, mesh axes, options).  Options: dtype (the model's),
    multi_precision, flags, cfg (extra model config), remat, labels
    (the name of the label batch in inputs.npz), loss (a LOSSES key)."""
    out = {f"stage{s}": (s, {"sharding": world}, {}) for s in range(4)}
    out["ignored0"] = (0, {"sharding": world}, {"labels": "ignored"})
    out["ignored3"] = (3, {"sharding": world}, {"labels": "ignored"})
    for loss in LOSSES:
        out[f"ignored_{loss}3"] = (3, {"sharding": world},
                                   {"labels": "ignored", "loss": loss})
    if world == 4:
        out["dp2_sharding2"] = (3, {"dp": 2, "sharding": 2}, {})
        return out
    for s in (1, 3):
        out[f"bf16_moments{s}"] = (
            s, {"sharding": world},
            {"flags": {"FLAGS_bf16_adamw_moments": True}})
        out[f"bf16_model{s}"] = (
            s, {"sharding": world},
            {"dtype": "bfloat16", "multi_precision": True})
    out["fused_ce3"] = (3, {"sharding": world},
                        {"flags": {"FLAGS_fused_ce": True}})
    out["selective3"] = (3, {"sharding": world},
                         {"cfg": dict(recompute=True, recompute_layers=1,
                                      recompute_granularity="selective")})
    out["remat3"] = (3, {"sharding": world}, {"remat": True})
    # the rematerialized forward replays the loss in the backward
    out["ignored_remat3"] = (3, {"sharding": world},
                             {"labels": "ignored", "remat": True})
    return out


def run_case(world, inputs, stage, axes, opts):
    dtype = opts.get("dtype", "float32")
    flags = opts.get("flags", {})
    set_flags(flags)
    model = LlamaForCausalLM(
        llama_tiny_config(dtype=dtype, **TINY, **opts.get("cfg", {})),
        device="cpu")
    load_numpy_state_dict(model, {k[len(dtype) + 1:]: v
                                  for k, v in inputs.items()
                                  if k.startswith(dtype + ":")})
    opt = AdamW(LR, parameters=model.parameters(),
                multi_precision=opts.get("multi_precision", False))
    mesh = build_mesh(devices=[torch.device("cpu")] * world, **axes)
    step = sharded_trainer.ShardedTrainStep(
        model, opt, mesh, sharding_stage=stage,
        rematerialize=opts.get("remat", False),
        loss_fn=LOSSES.get(opts.get("loss")))
    seen = []                          # what the sharded update was given
    real = sharded_trainer.apply_shard_updates

    def spy(upd, shards, grads, states, *a, **k):
        seen.append([(g.numel(), None if g._base is None
                      else g._base.numel()) for g in grads])
        return real(upd, shards, grads, states, *a, **k)

    sharded_trainer.apply_shard_updates = spy
    ids, labels = inputs["ids"], inputs[opts.get("labels", "ids")]
    try:
        losses = [step(ids, labels).item() for _ in range(STEPS)]
    finally:
        sharded_trainer.apply_shard_updates = real
        set_flags({k: False for k in flags})
    names = step._names
    shards = {names[i]: s for i, s in step._shards.items()}
    params = numpy_state_dict(model)
    rec = dict(
        losses=losses,
        params=params,
        numel={n: p.numel() for n, p in zip(names, step._params)},
        moments={n: st["moment1"].numel()
                 for n, st in zip(names, step._opt_states)},
        state_keys={n: sorted(st) for n, st in zip(names, step._opt_states)},
        sharded=sorted(shards),
        # bytes each parameter's own storage holds between steps
        storage={n: p.untyped_storage().nbytes()
                 for n, p in zip(names, step._params)},
        comm=dict(step.comm_counts),
        update_grads=dict(zip([names[i] for i in sorted(step._shards)],
                              seen[-1] if seen else [])),
        # the flat buffer a shard lies in (its unit's at stage 3)
        shard_base={n: s.local._base.numel() for n, s in shards.items()})
    # close(): the model whole again, no hook or zero_shard left on it,
    # and nothing else holds the step (it is freed without the collector)
    step.close()
    closed = numpy_state_dict(model)
    rec["closed"] = dict(
        same=all(np.array_equal(closed[n], v) for n, v in params.items()),
        storage={n: p.untyped_storage().nbytes()
                 for n, p in zip(names, step._params)},
        hooks=sum(len(m._forward_pre_hooks) + len(m._forward_hooks)
                  for m in model.modules()),
        zero_shards=sum(hasattr(p, "zero_shard")
                        for p in model.parameters()))
    ref, model_ref = weakref.ref(step), weakref.ref(model)
    gc.disable()
    del step, opt
    rec["closed"]["freed"] = ref() is None
    del model
    rec["closed"]["model_freed"] = model_ref() is None
    gc.enable()
    return rec


def main():
    world, outdir = int(sys.argv[1]), sys.argv[2]
    torch.set_num_threads(1)
    env = init_parallel_env(device="cpu")
    inputs = dict(np.load(os.path.join(outdir, "inputs.npz")))
    out = {name: run_case(world, inputs, *case)
           for name, case in cases(world).items()}
    out["env"] = dict(rank=env.rank, world=env.world_size)
    # meshes the process group cannot hold: larger than the world, and
    # smaller than it
    out["mesh_errors"] = {}
    for name, sharding in (("larger", 2 * world), ("smaller", 1)):
        try:
            build_mesh(devices=[torch.device("cpu")] * world,
                       sharding=sharding)
            out["mesh_errors"][name] = None
        except ValueError as e:
            out["mesh_errors"][name] = str(e)
    with open(os.path.join(outdir, f"rank{env.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
