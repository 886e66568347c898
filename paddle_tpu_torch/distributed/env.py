"""Distributed environment: one process a rank over torch.distributed.

Counterpart of `paddle_tpu/distributed/env.py` (:24-106):
`init_parallel_env`, `is_initialized`, `get_rank`, `get_world_size`
and `ParallelEnv`.  The reference joins one controller process per host
through `jax.distributed`; here every rank is a process with one device,
and the process group is the rendezvous.

`init_parallel_env` reads the rank and world from the reference's
variables (`PADDLE_TRAINER_ID`, `PADDLE_TRAINERS_NUM`, `PADDLE_MASTER`
as host:port) or torchrun's (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
`MASTER_ADDR`, `MASTER_PORT`), the reference's first.  A single rank
with no master given rendezvouses on a free port of 127.0.0.1.

The device rule holds: with no `device=` the rank runs on
`cuda:LOCAL_RANK` over NCCL, and raises when no CUDA device is
available; gloo starts only when the caller asks for `device="cpu"`.
NCCL is given `device_id=`, so its communicator binds to the rank's
card at once.
"""
from __future__ import annotations

import os
import socket
from datetime import timedelta

import torch
import torch.distributed as dist

from ..framework.device import resolve_device

__all__ = ["init_parallel_env", "get_rank", "get_world_size",
           "is_initialized", "ParallelEnv"]


def _env_int(*names, default):
    for n in names:
        if os.environ.get(n):
            return int(os.environ[n])
    return default


def _master(world):
    """host:port of the rendezvous."""
    master = os.environ.get("PADDLE_MASTER")
    if master:
        return master
    addr = os.environ.get("MASTER_ADDR")
    if addr:
        return f"{addr}:{os.environ.get('MASTER_PORT', '12355')}"
    if world > 1:
        raise RuntimeError(
            f"{world} ranks need a rendezvous: set PADDLE_MASTER "
            f"(host:port) or MASTER_ADDR and MASTER_PORT")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def init_parallel_env(device=None, timeout_s: float = 600.0):
    """Start the process group of this rank (once; later calls return
    the environment).  device None: `cuda:LOCAL_RANK` over NCCL (raises
    with no CUDA device); device="cpu": gloo."""
    if dist.is_initialized():
        return ParallelEnv()
    rank = _env_int("PADDLE_TRAINER_ID", "RANK", default=0)
    world = _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE", default=1)
    local = _env_int("LOCAL_RANK", default=rank)
    if device is None:
        resolve_device(None)            # raises without CUDA
        dev = torch.device("cuda", local)
    else:
        dev = resolve_device(device)
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        backend, kw["device_id"] = "nccl", dev
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{_master(world)}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s), **kw)
    return ParallelEnv()


def is_initialized():
    return dist.is_initialized()


def get_rank(group=None):
    if not dist.is_initialized():
        return _env_int("PADDLE_TRAINER_ID", "RANK", default=0)
    return dist.get_rank(group)


def get_world_size(group=None):
    if not dist.is_initialized():
        return _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE", default=1)
    return dist.get_world_size(group)


class ParallelEnv:
    """Reference: parallel.py ParallelEnv."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def device_id(self):
        return _env_int("LOCAL_RANK", default=self.rank)

    @property
    def dev_id(self):
        return self.device_id

    @property
    def current_endpoint(self):
        eps = self.trainer_endpoints
        r = self.rank
        return eps[r] if r < len(eps) else ""

    @property
    def trainer_endpoints(self):
        return os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")

    @property
    def nranks(self):
        return self.world_size

    @property
    def local_rank(self):
        return self.device_id
