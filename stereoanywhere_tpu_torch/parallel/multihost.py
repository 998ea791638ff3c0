"""Training over several processes on `torch.distributed`: the JAX package's
`parallel/multihost.py` (the mesh's axes are in `mesh.py`).

JAX runs one SPMD program over a global mesh, and its collectives follow
from the sharding.  Here every rank runs the step on its own slice of the
global batch and calls the collectives itself, so that N ranks compute
the one-process step on the whole batch: the loss's denominators and its
logs, BatchNorm's batch statistics, the volume corruption's max, the
gradients (SUM), the gt-as-mono condition and the stop flag.  The helpers
below are the identity when no process group is initialized.

- `initialize_distributed`: `torch.distributed.init_process_group`, NCCL
  for `cuda:LOCAL_RANK` and gloo on the CPU, from torchrun's environment
  (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR` / `MASTER_PORT`) or
  from explicit arguments; a gloo group beside an NCCL one carries the
  host's flags, so that reading them waits for no device.
- `global_batch_from_host_shards` has no counterpart: each rank keeps its
  own slice of the batch (the loader's shard) and no global array is ever
  assembled.
"""
from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

from stereoanywhere_tpu_torch.parallel.mesh import check_data_axis

_host_group = None  # the gloo group of the host's flags, beside an NCCL group


def distributed() -> bool:
    """Whether a process group is initialized."""
    return dist.is_available() and dist.is_initialized()


def rank_and_world() -> tuple[int, int]:
    """(this process's rank, the number of ranks); (0, 1) without a group."""
    return (dist.get_rank(), dist.get_world_size()) if distributed() else (0, 1)


def free_port() -> int:
    """A free TCP port on localhost, for a local rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize_distributed(device: str | torch.device = "cuda", rank: int | None = None,
                           world_size: int | None = None, init_method: str | None = None,
                           backend: str | None = None) -> torch.device:
    """Join the process group and return this rank's device.

    `rank`, `world_size` and `init_method` default to torchrun's environment
    (`env://`).  Given `world_size=1` it does nothing, as the JAX package's
    does given one process; from the environment it makes the group
    whatever its size, so that a launch of one process runs the collectives
    of a launch of N.  A "cuda" device without an index becomes
    `cuda:LOCAL_RANK`.  `backend` defaults to NCCL on the card and gloo on
    the CPU; gloo also takes CUDA tensors (two ranks on one card)."""
    global _host_group
    dev = torch.device(device)
    local_rank = int(os.environ.get("LOCAL_RANK", rank if rank is not None else os.environ.get("RANK", 0)))
    if dev.type == "cuda" and dev.index is None:
        check_data_axis(local_rank + 1, dev)
        dev = torch.device("cuda", local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if world_size == 1 or distributed():
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {} if rank is None else {"rank": rank}
    if world_size is not None:
        kw["world_size"] = world_size
    dist.init_process_group(backend, init_method=init_method or "env://", **kw)
    _host_group = dist.new_group(backend="gloo") if backend != "gloo" else None
    return dev


def destroy_distributed() -> None:
    """Leave the process group, if there is one."""
    global _host_group
    if distributed():
        dist.destroy_process_group()
    _host_group = None


def host_local_batch_size(global_batch: int) -> int:
    """The samples this rank loads a step: the global batch over the ranks."""
    n = rank_and_world()[1]
    if global_batch % n != 0:
        raise ValueError(f"--batch-size {global_batch} must be divisible by the total device count {n} "
                         "for multi-host data parallelism")
    return global_batch // n


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The SUM over ranks of a tensor, detached (a copy; `t` itself without
    a group)."""
    if not distributed():
        return t
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def all_reduce_max(t: torch.Tensor) -> torch.Tensor:
    """The MAX over ranks of a tensor, detached (`t` itself without a group)."""
    if not distributed():
        return t
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX)
    return out


class _SumOverRanks(torch.autograd.Function):
    """SUM over ranks whose backward is the SUM of the gradients: the
    gradient that reaches each rank's addend is the global one."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM)
        return grad


def sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """The SUM over ranks of a tensor, with autograd through it (`t` itself
    without a group)."""
    return _SumOverRanks.apply(t) if distributed() else t


def any_rank(flag: bool) -> bool:
    """Whether `flag` is set on some rank: an all-reduce MAX on the host
    (the gloo group), so that it waits for no device."""
    if not distributed():
        return flag
    t = torch.tensor([float(flag)])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_host_group)
    return bool(t.item())


# the JAX CLI's name for the stop flag's consensus (`cli.py:244-249`): a
# SIGTERM reaches one rank; all of them must leave the loop at one step
stop_consensus = any_rank


def barrier() -> None:
    """Wait for every rank, on the host."""
    if distributed():
        dist.barrier(group=_host_group)
