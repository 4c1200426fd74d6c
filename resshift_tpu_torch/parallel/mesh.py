"""Data parallelism across processes and across a process's cards.

The counterpart of the JAX package's `parallel/mesh.py`.  JAX drives every
chip from one controller through SPMD sharding; the port follows PyTorch's
idiom instead:

  * one process per card for training and for folder inference, started by
    `torchrun` (NCCL between cards, gloo on the CPU): `maybe_init_distributed`
    brings the process group up from torchrun's environment, `rank` and
    `world_size` replace `jax.process_index` / `process_count`;
  * one process driving its own cards through per-card model replicas for
    sampling and serving (`local_devices`): the counterpart of a single-host
    `make_mesh()`.  Each image's or tile's chain is local to its card, so
    this needs no collective; the shards run one after another on the
    caller's thread (launches are asynchronous, so each card works while
    the next card's shard is launched);
  * DP training averages the gradients over the ranks with one all-reduce
    of the flattened tensors (`all_reduce_mean_`): with equal local batches
    that is JAX's SPMD mean over the global batch, so every rank takes the
    same AdamW step and keeps the same EMA;
  * FSDP shards the train state with `fully_shard` (`shard_module`): the
    parameters (so their AdamW moments and the EMA, which follow their
    layout) are cut along dim 0 over the ranks and gathered for the forward,
    the gradients reduce-scattered: the math of JAX's `fsdp_shardings`,
    which shards them over the mesh's data axis.
"""

from __future__ import annotations

import datetime
import os
from typing import Sequence

import torch
import torch.distributed as dist

__all__ = ["maybe_init_distributed", "rank", "world_size", "local_rank", "process_device",
           "local_devices", "all_reduce_mean_", "shard_module", "full_tensor", "shard_like"]


def maybe_init_distributed(force: bool = False, device: str | torch.device | None = None,
                           timeout_s: float = 600.0, backend: str | None = None) -> bool:
    """Bring up the process group where the environment names one (torchrun's
    `WORLD_SIZE` and `MASTER_ADDR`, with `RANK` and `MASTER_PORT`), or where
    `force` asks for it; a no-op otherwise, and where the group is already up.

    The backend is NCCL where the process computes on a card (`device`, by
    default CUDA where present), on `cuda:LOCAL_RANK` (or the card `device`
    names), which becomes the current card; gloo on the CPU.  `backend`
    overrides the choice: gloo ranks may share a card, which NCCL refuses.
    `timeout_s` bounds the rendezvous too.  Returns whether more than one process
    runs.  Raises where a group is asked for but cannot be formed (a missing
    variable, an unreachable rendezvous within `timeout_s`): degrading to N
    independent rank-0 jobs would train N copies on one shard each and write
    the same files N times."""
    env = os.environ
    if not (force or (env.get("WORLD_SIZE") and env.get("MASTER_ADDR"))):
        return False
    if dist.is_initialized():
        return dist.get_world_size() > 1
    dev = torch.device(device if device is not None
                       else "cuda" if torch.cuda.is_available() else "cpu")
    try:
        if dev.type == "cuda":
            torch.cuda.set_device(local_rank() if dev.index is None else dev.index)
        dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                                init_method="env://",
                                timeout=datetime.timedelta(seconds=timeout_s))
    except (RuntimeError, ValueError, OSError) as e:
        raise RuntimeError(
            "a multi-process run is indicated (WORLD_SIZE / MASTER_ADDR or --distributed) but "
            f"torch.distributed could not be initialised: {e}") from e
    return dist.get_world_size() > 1


def rank() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The number of processes; 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """This process's index on its host (torchrun's `LOCAL_RANK`; 0 without)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def process_device(device: str | torch.device | None) -> torch.device:
    """The card a process computes on: `cuda:LOCAL_RANK` under a launcher
    that starts several processes on a host, else `device` as it is (CUDA by
    default)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", local_rank())
    return device


def local_devices(n: int | None = None) -> list[torch.device]:
    """The cards this process owns: its own one when a launcher runs several
    processes on the host (`LOCAL_WORLD_SIZE` > 1), else every visible card
    (the first `n`); the CPU where there is none."""
    if not torch.cuda.is_available():
        return [torch.device("cpu")]
    if int(os.environ.get("LOCAL_WORLD_SIZE", 1)) > 1:
        return [torch.device("cuda", local_rank())]
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return devs if n is None else devs[:n]


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Average `tensors` over the ranks, in place, through one all-reduce of
    their concatenation (every rank ends with the same bits); a no-op without
    a process group (a group of one still runs the collective)."""
    if not dist.is_initialized() or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat /= world_size()
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


def shard_module(module: torch.nn.Module) -> torch.nn.Module:
    """FSDP over the default process group (FSDP2's `fully_shard`, in place):
    every parameter becomes a DTensor cut along dim 0 over the ranks, gathered
    whole before the module's forward and freed after it, its gradient
    reduce-scattered and averaged.  One group for the whole module, so that
    a parameter that a parent's forward reads from a child is gathered too."""
    from torch.distributed.fsdp import fully_shard

    return fully_shard(module)


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole (a collective: every rank calls it); any other
    tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def shard_like(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """`full` on `like`'s device and dtype, cut as `like` is where that is a
    DTensor (this rank's piece of the same full tensor, no communication)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(like, DTensor):
        full = full.to(like.to_local().device, like.dtype)
        return distribute_tensor(full, like.device_mesh, like.placements, src_data_rank=None)
    return full.to(like.device, like.dtype)
