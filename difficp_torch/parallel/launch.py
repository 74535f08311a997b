"""Process-group set-up and the collectives the point-sharded path uses
(counterpart of ``difficp_tpu/parallel/launch.py``).

``init_distributed`` starts ``torch.distributed``: NCCL when the device is a
CUDA card (the default), gloo only when the caller asks for the CPU, never one
in place of the other.  The world comes from the usual ``RANK`` /
``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` variables or from an
``init_method`` (``tcp://localhost:<port>``, or a ``file://`` store as the
tests use); a single process with neither gets a world of one through an
in-memory ``HashStore``.  Nothing here reads a cluster's environment beyond
those variables.

``all_reduce`` is the out-of-place sum or maximum over a group, outside
autograd: the GMM statistics (``models/gmm.py``) and the L-BFGS scalars
(``utils/lbfgs.py``) reduce through it.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from difficp_torch.utils.spec import resolve_device

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def init_distributed(device=None, init_method=None, world_size=None, rank=None):
    """Start the default process group and return ``(group, size, rank)``.

    ``device``: None or "cuda" -> NCCL (raises without a card), "cpu" ->
    gloo.  ``world_size`` / ``rank`` default to ``WORLD_SIZE`` / ``RANK``
    (1 and 0).  Called again in the same process, it returns the running
    group if its backend is the one asked for, and raises otherwise."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_distributed: unsupported device {dev}")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"a {dist.get_backend()} process group is running; "
                               f"{backend} was asked for")
        return dist.group.WORLD, dist.get_world_size(), dist.get_rank()
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    if dev.type == "cuda" and dev.index is None:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK",
                                                 rank % torch.cuda.device_count())))
    if init_method is None and world_size == 1 and "MASTER_ADDR" not in os.environ:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    else:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world_size, rank=rank)
    return dist.group.WORLD, dist.get_world_size(), dist.get_rank()


def world(group) -> int:
    """Ranks in ``group``; None is a world of one with no communication."""
    return 1 if group is None else dist.get_world_size(group)


def rank_of(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce(t, group, op: str = "sum"):
    """A new tensor holding ``t`` reduced over ``group`` ("sum" or "max"),
    the same on every rank; not differentiated."""
    out = t.detach().clone(memory_format=torch.contiguous_format)
    if group is not None:
        dist.all_reduce(out, op=_OPS[op], group=group)
    return out
