"""ShardedTrainStep: ZeRO stages 0-3 over torch.distributed.

Counterpart of `paddle_tpu/parallel/sharded_trainer.py`:
`ShardedTrainStep` (:144) with `from_strategy` (:231-258) and
`run_steps` (:906, jit.TrainStep's), `shard_batch` (:81) and
`_add_axis_to_spec` (:113).
The reference states its strategy as array shardings and lets XLA place
the collectives; here every rank is a process with one device, and the
step issues the collectives itself (NCCL on the card, gloo on the CPU)
over the mesh's groups (`distributed.topology.build_mesh`):

  stage 0: parameters and optimizer state replicated; the gradients
           all-reduced (their mean over dp x sharding);
  stage 1: each rank keeps the optimizer state (moments, master, ef) of
           its 1/n of each parameter, updates that slice of the
           all-reduced gradient, and the parameters are all-gathered;
  stage 2: stage 1 with the gradients reduce-scattered to the state's
           shard;
  stage 3: every matrix parameter (ndim >= 2) is held as its shard at
           rest.  A decoder layer's weights are gathered before its
           forward, freed after it, gathered again when its output's
           gradient arrives (the recomputed regions replay inside that
           window), and freed once every one of its gradients has been
           reduce-scattered.  The parameters outside the layers (the
           embedding, the final norm, the lm head that `compute_loss`
           reads after the forward, a tied embedding) are gathered on
           the model's forward and freed at the end of the step.

n is the `sharding` axis's size; a parameter is sharded where
`_add_axis_to_spec` finds a dim that n divides (the reference's policy;
a parameter with none stays replicated), and cut flat: rank k holds
elements [k c, (k + 1) c) of its row-major order, c = numel / n, so the
shard, its gradient and every state tensor are contiguous tensors of
one shape (the fused AdamW kernel's contract).  The reference cuts
along a dim; the numerics do not depend on which.

Units of stage 3 are the children of the model's `nn.ModuleList`s
(Llama's decoder layers), split by dtype; the rest of the sharded
parameters form the root.  A unit's shards lie end to end in one flat
buffer, so it moves with one collective: one all-gather into a
[n, sum c] buffer whose columns are copied into the parameters, and one
reduce-scatter of the gradients laid out the same way.  A sharded
parameter's own storage holds it whole while gathered and is resized to
0 at rest (so the autograd graph's references to it stay valid), and
`param.zero_shard` is its `_Shard`: `models.numpy_state_dict` gathers
through it (a collective: every rank calls it).  `close()` gathers the
model whole again and takes the step's hooks off it.

Batch and loss: every rank receives the same global batch and keeps its
rows (`shard_batch`: dim 0 over the data axes when it divides, else the
whole batch).  The forward, the loss and the backward run inside
`framework.data_parallel.loss_mean_scope`, under which the port's masked
token means (`nn.functional.fused_cross_entropy` and
`ops.fused_linear_cross_entropy`, so every `compute_loss` of the port's
models) divide by the group's count of valid labels: the mean over ranks
of the losses and gradients is then the global masked mean and its
gradient however the ignored labels fall.  A `loss_fn` built on another
mean (for example `torch.nn.functional.cross_entropy`) gives each
rank's own mean, and the step the mean of those: the global mean only
when every rank holds as many valid labels.  The returned loss is the
mean over ranks, the same on every rank.

One device: with no process group (bench.py's
`build_mesh(devices=[dev])`) the step is `jit.TrainStep`'s, of which
this class is a subclass: no collective, every parameter replicated and
updated by `apply_updates`.  With a process group, even of one rank,
the stage's collectives run.  `comm_counts` holds the step's parameter
all-gathers, gradient reduce-scatters and gradient all-reduces (the
loss's two scalar all-reduces are not counted).  Every rank starts from
rank 0's parameters (broadcast at construction).

Not ported yet (they raise NotImplementedError, naming ROADMAP queue 1's
item): offload and the train-state checkpoint hooks (item 9),
FLAGS_skip_nonfinite_steps (item 9's guard), grad_scaler (item 7),
comm_overlap, a bucket size or wire dtype other than the defaults
(`comm_bucket_mb` / `grad_comm_dtype` and their flags: the overlap
engine's buckets) and seq_axis (item 8), preflight / lint /
compiled_hlo / collective_schedule (item 10).
"""
from __future__ import annotations

import weakref

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..distributed.fleet.recompute import recompute
from ..distributed.topology import batch_partition_spec
from ..framework.data_parallel import loss_mean_scope
from ..framework.flags import get_flag
from ..jit import TrainStep
from ..optimizer.jit_update import (apply_shard_updates, apply_updates,
                                    maybe_master_state)

__all__ = ["ShardedTrainStep", "shard_batch"]

# newer torch names the single-tensor collectives *_single and deprecates
# the *_tensor names; the card's torch may predate the new names
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor

_COMM_KINDS = ("all_gather", "reduce_scatter", "all_reduce")
# the reference's defaults of the overlap engine's knobs (flags.py)
_BUCKET_MB, _COMM_DTYPE = 32.0, "auto"


def _not_ported(what, item):
    raise NotImplementedError(
        f"ShardedTrainStep: {what} is not ported yet (ROADMAP queue 1 "
        f"item {item})")


def shard_batch(mesh, arr, batch_axes=("dp", "sharding"), seq_axis=None):
    """This rank's block of a global batch array (tensor or array-like),
    on the mesh's device: dim 0 split over the data axes present, in
    mesh order, when it divides evenly, else the whole array."""
    if seq_axis is not None:
        _not_ported("seq_axis (sequence-parallel batches)", 8)
    t = arr if torch.is_tensor(arr) else torch.from_numpy(np.asarray(arr))
    axes = batch_partition_spec(mesh, tuple(t.shape), batch_axes)[:1]
    if axes and axes[0] is not None:
        idx, n = 0, 1
        for a in axes[0]:
            idx = idx * mesh.shape[a] + mesh.coordinate(a)
            n *= mesh.shape[a]
        rows = t.shape[0] // n
        t = t[idx * rows:(idx + 1) * rows]
    return t.to(mesh.device)


def _add_axis_to_spec(spec, axis_name, shape, axis_size):
    """Put `axis_name` on the largest free dim that `axis_size` divides
    (the reference's preference 2); leave the spec as it is if none
    does.  The reference first stacks the axis onto a tensor-parallel
    dim, which waits for tensor parallelism (ROADMAP queue 1 item 8)."""
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if spec[i] is None and shape[i] % axis_size == 0 and shape[i] > 1:
            spec = list(spec)
            spec[i] = axis_name
            return spec
    return spec


def _weak_hook(method):
    """`method` as a hook that holds its object weakly.  A tensor keeps
    its post-accumulate-grad hooks on its C++ side, where the garbage
    collector cannot see them: a hook holding a unit, which holds the
    parameter, would keep both alive for good."""
    ref = weakref.WeakMethod(method)

    def hook(*args):
        bound = ref()
        if bound is not None:
            bound(*args)
    return hook


def _owns_storage(p):
    return (p.is_contiguous() and p.storage_offset() == 0
            and p.untyped_storage().nbytes() == p.numel() * p.element_size())


class _Shard:
    """This rank's flat 1/n of one parameter (see the module docstring).
    `full` is the whole parameter, flat, on the parameter's own storage;
    `local` is this rank's elements: a view into `full` at stages 1-2,
    into its unit's flat buffer at stage 3, where `full` holds data only
    while gathered.  `step` is a weak proxy: the step owns its shards,
    and a parameter's `zero_shard` must not keep the step alive."""

    def __init__(self, step, param):
        mesh = step.mesh
        n, k = mesh.shape["sharding"], mesh.coordinate("sharding")
        if not _owns_storage(param):
            param.data = param.detach().clone()
        self.step = step
        self.param = param
        self.full = param.data.view(-1)
        c = param.numel() // n
        self.local = self.full[k * c:(k + 1) * c]
        self.grad = None
        self.gathered = True

    def fill(self, rows):
        """Stage 3: hold the parameter whole again, from `rows`, its
        [n, c] columns of a unit's gathered buffer."""
        self.full.untyped_storage().resize_(
            self.full.numel() * self.full.element_size())
        self.full.view(rows.shape).copy_(rows)
        self.gathered = True

    def free(self):
        if self.gathered:
            self.full.untyped_storage().resize_(0)
            self.gathered = False

    def reduce_grad(self):
        """Stage 2: this rank's shard of the parameter's gradient, meaned
        over the mesh (a reduce-scatter over `sharding`, an all-reduce
        over `dp`); the full gradient is dropped."""
        g = self.param.grad
        if g is None:
            g = torch.zeros_like(self.full)
        out = torch.empty_like(self.local)
        self.step._comm("reduce_scatter", out, g.reshape(-1))
        if self.step._dp_group is not None:
            self.step._comm("all_reduce", out, group=self.step._dp_group)
        self.param.grad = None
        return self.step._mean(out)

    def slice(self, g):
        """This rank's elements of a whole gradient (a view)."""
        c = self.local.numel()
        k = self.step.mesh.coordinate("sharding")
        return g.reshape(-1)[k * c:(k + 1) * c]

    def publish(self):
        """Stages 1-2, after the update: all-gather the parameter from
        the ranks' updated slices (in place: `local` is a view into
        `full`)."""
        self.step._comm("all_gather", self.full, self.local)

    def gathered_copy(self):
        """The whole parameter (a collective over the sharding group)."""
        if self.gathered:
            return self.param.detach().clone()
        out = torch.empty(self.full.numel(), dtype=self.local.dtype,
                          device=self.local.device)
        _all_gather(out, self.local, group=self.step._shard_group)
        return out.view(self.param.shape)


class _Unit:
    """Stage 3: the sharded parameters of one decoder layer (or of the
    root) of one dtype.  Their shards lie end to end in `local`, so the
    unit is gathered by one all-gather and its gradients reduced by one
    reduce-scatter."""

    def __init__(self, step, shards):
        self.step = step
        self.shards = shards
        self.n = step.mesh.shape["sharding"]
        self.sizes = [s.local.numel() for s in shards]
        self.local = torch.cat([s.local for s in shards])
        for s, view in zip(shards, self.local.split(self.sizes)):
            s.local = view
            s.param.zero_shard = s
            s.free()
        self.pending = len(shards)
        self.reduced = False

    def start_step(self):
        self.pending, self.reduced = len(self.shards), False

    def gather(self, *_):
        if self.shards[0].gathered:
            return
        buf = torch.empty(self.n * self.local.numel(), dtype=self.local.dtype,
                          device=self.local.device)
        self.step._comm("all_gather", buf, self.local)
        cols = buf.view(self.n, -1).split(self.sizes, dim=1)
        for s, rows in zip(self.shards, cols):
            s.fill(rows)

    def free(self):
        for s in self.shards:
            s.free()

    def after_forward(self, module, args, out):
        """Free the weights; gather them again when the output's
        gradient arrives, before the layer's backward and the replay of
        its recomputed regions."""
        self.free()
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for t in outs:
            if torch.is_tensor(t) and t.requires_grad:
                t.register_hook(self._gather_hook)

    def _gather_hook(self, grad):
        self.gather()

    def grad_ready(self, param):
        """A parameter's gradient landed; once the last of the unit's
        has, reduce-scatter them all and free the weights."""
        if not self.step._in_backward:
            return
        self.pending -= 1
        if self.pending == 0:
            self.reduce()

    def reduce(self):
        """The unit's gradients, laid out as the gathered buffer ([n, sum
        c]: rank k's row holds every parameter's k-th block), reduce-
        scattered to this rank's flat shard and meaned over the mesh;
        each shard's `grad` is its view into it."""
        step = self.step
        cols = []
        for s in self.shards:
            g = s.param.grad
            cols.append(torch.zeros_like(s.full) if g is None else g)
            s.param.grad = None
        buf = torch.cat([g.reshape(self.n, -1) for g in cols], dim=1)
        del cols
        out = torch.empty_like(self.local)
        step._comm("reduce_scatter", out, buf.view(-1))
        del buf
        if step._dp_group is not None:
            step._comm("all_reduce", out, group=step._dp_group)
        step._mean(out)
        for s, g in zip(self.shards, out.split(self.sizes)):
            s.grad = g
        self.free()
        self.reduced = True


class ShardedTrainStep(TrainStep):
    def __init__(self, model, optimizer, mesh, loss_fn=None,
                 sharding_stage: int = 0, rematerialize: bool = False,
                 batch_axes=("dp", "sharding"), seq_axis=None, offload=False,
                 grad_scaler=None, comm_overlap=None, comm_bucket_mb=None,
                 grad_comm_dtype=None):
        if offload:
            _not_ported(f"offload={offload!r}", 9)
        if get_flag("skip_nonfinite_steps"):
            _not_ported("FLAGS_skip_nonfinite_steps (the nonfinite-step "
                        "guard)", 9)
        if grad_scaler is not None:
            _not_ported("grad_scaler", 7)
        if get_flag("comm_overlap") if comm_overlap is None \
                else comm_overlap:
            _not_ported("comm_overlap (the bucketed overlap engine)", 8)
        bucket = get_flag("comm_bucket_mb") if comm_bucket_mb is None \
            else comm_bucket_mb
        if float(bucket) != _BUCKET_MB:
            _not_ported(f"comm_bucket_mb={bucket!r} (the overlap engine's "
                        f"buckets)", 8)
        wire = get_flag("grad_comm_dtype") if grad_comm_dtype is None \
            else grad_comm_dtype
        if str(wire) != _COMM_DTYPE:
            _not_ported(f"grad_comm_dtype={wire!r} (the overlap engine's "
                        f"wire dtype)", 8)
        if seq_axis is not None:
            _not_ported("seq_axis (sequence parallelism)", 8)
        if sharding_stage not in (0, 1, 2, 3):
            raise ValueError(f"sharding_stage must be 0-3, not "
                             f"{sharding_stage!r}")
        super().__init__(model, model.compute_loss if loss_fn is None
                         else loss_fn, optimizer)
        self.mesh = mesh
        self.stage = sharding_stage
        self.remat = rematerialize
        self.batch_axes = batch_axes
        if self.device != mesh.device:
            raise ValueError(f"the model lives on {self.device}, this "
                             f"rank's mesh device is {mesh.device}")
        self.comm_counts = dict.fromkeys(_COMM_KINDS, 0)
        self._in_backward = False
        self._shards = {}               # parameter index -> _Shard
        self._units = []
        self._hooks = []
        self._group = None
        if mesh.device_mesh is not None:
            self._setup_sharding()

    @classmethod
    def from_strategy(cls, model, optimizer, mesh, strategy, **kw):
        """Build from a fleet DistributedStrategy: when the
        `strategy.sharding` switch is on, sharding_configs supplies
        {stage, offload, comm_overlap}, and fuse_grad_size_in_MB the
        bucket size."""
        sc = dict(getattr(strategy, "sharding_configs", {}) or {}) \
            if getattr(strategy, "sharding", False) else {}
        kw.setdefault("sharding_stage", sc.get("stage", 0 if not sc
                                               else 1))
        kw.setdefault("offload", sc.get("offload", False))
        if "comm_overlap" in sc:
            kw.setdefault("comm_overlap", bool(sc["comm_overlap"]))
        fuse_mb = getattr(strategy, "fuse_grad_size_in_MB", None)
        if fuse_mb:
            kw.setdefault("comm_bucket_mb", float(fuse_mb))
        return cls(model, optimizer, mesh, **kw)

    # -- sharding ----------------------------------------------------------
    def _setup_sharding(self):
        mesh = self.mesh
        me = weakref.proxy(self)        # what shards and hooks hold
        self._group = dist.group.WORLD  # the mesh spans the world
        self._ranks = mesh.size
        self._shard_group = mesh.group("sharding")
        self._dp_group = mesh.group("dp") if mesh.shape["dp"] > 1 else None
        with torch.no_grad():
            for p in self._params:
                dist.broadcast(p.data, src=0)
        n = mesh.shape["sharding"]
        for i, p in enumerate(self._params):
            if self.stage == 0 or (self.stage >= 3 and p.ndim < 2):
                continue
            spec = _add_axis_to_spec([None] * p.ndim, "sharding",
                                     tuple(p.shape), n)
            if "sharding" in spec:
                self._shards[i] = _Shard(me, p)
        if self.stage >= 3:
            self._install_units(me)

    def _install_units(self, me):
        """One unit a child of each outermost nn.ModuleList and dtype,
        the rest of the sharded parameters the root (gathered on the
        model's forward, freed at the end of the step)."""
        index = {id(p): i for i, p in enumerate(self._params)}
        blocks, inside = [], set()
        for m in self.model.modules():
            if id(m) in inside or not isinstance(m, nn.ModuleList):
                continue
            for b in m:
                blocks.append(b)
                inside.update(id(x) for x in b.modules())

        def units(shards):
            by_dtype = {}
            for s in shards:
                by_dtype.setdefault(s.param.dtype, []).append(s)
            return [_Unit(me, group) for group in by_dtype.values()]

        taken = set()
        for b in blocks:
            shards = []
            for p in b.parameters():
                i = index.get(id(p))
                if i in self._shards and i not in taken:
                    taken.add(i)
                    shards.append(self._shards[i])
            for unit in units(shards):
                self._hooks += [
                    b.register_forward_pre_hook(unit.gather),
                    b.register_forward_hook(unit.after_forward)]
                self._hooks += [
                    s.param.register_post_accumulate_grad_hook(
                        _weak_hook(unit.grad_ready)) for s in unit.shards]
                self._units.append(unit)
        for root in units([s for i, s in self._shards.items()
                           if i not in taken]):
            self._hooks.append(self.model.register_forward_pre_hook(
                root.gather))
            self._units.append(root)

    def close(self):
        """Give the model back whole: gather every stage-3 parameter
        (a collective: every rank calls it) and take the step's hooks
        and `zero_shard`s off the model.  The step is not called again
        afterwards.  Without it a stage-3 model stays sharded after its
        step is gone (the step itself is freed as its last name goes)."""
        for unit in self._units:
            unit.gather()
        for h in self._hooks:
            h.remove()
        for s in self._shards.values():
            s.param.__dict__.pop("zero_shard", None)
        self._units, self._hooks, self._shards = [], [], {}
        self._opt_states = None

    def _comm(self, kind, out, inp=None, group=None):
        self.comm_counts[kind] += 1
        if kind == "all_gather":
            _all_gather(out, inp, group=self._shard_group)
        elif kind == "reduce_scatter":
            _reduce_scatter(out, inp, group=self._shard_group)
        else:
            dist.all_reduce(out, group=group or self._group)

    def _mean(self, t):
        return t.div_(self._ranks) if self._ranks > 1 else t

    # -- the step: jit.TrainStep's, with these parts extended --------------
    def _init_opt_states(self):
        opt = self.optimizer
        states = []
        for i, p in enumerate(self._params):
            t = self._shards[i].local if i in self._shards else p
            states.append(maybe_master_state(opt, t, opt._init_state(t)))
        return states

    def _to_device(self, b):
        return shard_batch(self.mesh, b, self.batch_axes)

    def _loss(self, inputs, label):
        if not self.remat:
            return TrainStep._loss(self, inputs, label)
        return recompute(lambda *xs: TrainStep._loss(self, xs, label),
                         *inputs)

    def _forward_backward(self, inputs, label):
        if self._group is None:
            return super()._forward_backward(inputs, label)
        self.comm_counts.update(dict.fromkeys(_COMM_KINDS, 0))
        for unit in self._units:
            unit.start_step()
        # the backward too runs in the scope: a rematerialized forward
        # replays the loss there, and must divide by the group's count
        with loss_mean_scope(self._group, self._ranks):
            loss = self._loss(inputs, label)
            self._in_backward = True
            loss.backward()
            self._in_backward = False
        loss = loss.detach()
        dist.all_reduce(loss, group=self._group)
        return self._mean(loss)

    def _grads(self):
        """Each parameter's gradient as its update takes it: meaned over
        the mesh, whole for a replicated parameter, this rank's slice
        for a sharded one."""
        if self._group is None:
            return super()._grads()
        for unit in self._units:        # stage 3: the root, and any unit
            if not unit.reduced:        # a gradient never reached
                unit.reduce()
        grads = []
        for i, p in enumerate(self._params):
            sh = self._shards.get(i)
            if sh is not None and self.stage >= 2:
                if sh.grad is None:     # stage 2
                    sh.grad = sh.reduce_grad()
                grads.append(sh.grad)
                continue
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            self._comm("all_reduce", g)
            self._mean(g)
            grads.append(g if sh is None else sh.slice(g))
        return grads

    def _apply_updates(self, upd, grads, lr, step_i, hp):
        if not self._shards:
            return super()._apply_updates(upd, grads, lr, step_i, hp)
        rep = [i for i in range(len(self._params)) if i not in self._shards]
        shd = sorted(self._shards)
        apply_updates(upd, [self._params[i] for i in rep],
                      [grads[i] for i in rep],
                      [self._opt_states[i] for i in rep], lr,
                      [self._wds[i] for i in rep], step_i, hp)
        apply_shard_updates(upd, [self._shards[i].local for i in shd],
                            [grads[i] for i in shd],
                            [self._opt_states[i] for i in shd], lr,
                            [self._wds[i] for i in shd], step_i, hp)
        for i in shd:
            sh = self._shards[i]
            sh.grad = None
            if self.stage < 3:
                sh.publish()

    # -- not ported yet ----------------------------------------------------
    def train_state(self):
        _not_ported("train_state (training checkpoints)", 9)

    def load_train_state(self, arrays, meta):
        _not_ported("load_train_state (training checkpoints)", 9)

    def preflight(self, *batch, **kw):
        _not_ported("preflight (the static sentinel)", 10)

    def lint(self, *batch, **kw):
        _not_ported("lint (the step lints)", 10)

    def compiled_hlo(self, *batch, **kw):
        _not_ported("compiled_hlo", 10)

    def collective_schedule(self, *batch):
        _not_ported("collective_schedule", 10)
