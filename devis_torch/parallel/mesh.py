"""Data parallelism over processes (port of `devis_tpu/parallel/mesh.py`).

The JAX package is single-controller SPMD: one mesh over `TPU.MESH_DP`
devices, the batch sharded over its `data` axis and XLA inserting the
gradient sums. The port runs one process a GPU under `torchrun` (reference
`main.py:131`, `src/util/misc.py:437-460`), wraps the model in
`DistributedDataParallel` and sums gradients with its bucketed all-reduce:
NCCL on the card, gloo on the CPU.

Every rank draws the same global batch from the same seed and keeps items
rank, rank + world, ... of it (`shard_items`), so one process and n
processes see the same clips and the same augmentation draws.
"""
from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


def is_distributed() -> bool:
    """True inside an initialised process group, of any size: the step, the
    evaluations and the metrics then take the group's collectives (at one
    rank they change no number)."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main_process() -> bool:
    return rank() == 0


def init_process_group(device: Optional[torch.device] = None,
                       timeout_s: float = 1800.0) -> Optional[torch.device]:
    """Joins the process group `torchrun` describes in the environment
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT). NCCL when
    `device` is a GPU, each rank on the GPU of its LOCAL_RANK; gloo on the
    CPU. Returns the rank's device, or None (and does nothing) outside
    `torchrun` or with a group already set up. Raises where NCCL is asked
    for and this PyTorch has none."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return None
    device = torch.device(device) if device is not None else torch.device("cuda")
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("NCCL is not available in this PyTorch build; "
                               "the port's DDP needs it on the GPU")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return device


def destroy_process_group() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def comm_device() -> torch.device:
    """Where the group's collectives take their tensors: the current GPU
    under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def local_batch_size(global_batch: int, world: Optional[int] = None) -> int:
    """A rank's share of a global batch, which the world must divide."""
    n = world_size() if world is None else world
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by world size {n}")
    return global_batch // n


def shard_items(items: Sequence, rank_: Optional[int] = None,
                world: Optional[int] = None) -> List:
    """Items rank, rank + world, ... of a global batch."""
    r = rank() if rank_ is None else rank_
    n = world_size() if world is None else world
    return list(items[r::n])


def data_parallel(model: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """`model` in `DistributedDataParallel` inside a process group, else
    `model` itself. Buffers (frozen batch norms, tables)
    never change, so they are not broadcast each step; `static_graph` lets a
    configuration leave parameters out of its loss and suits recomputation."""
    if not is_distributed():
        return model
    return torch.nn.parallel.DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        broadcast_buffers=False, static_graph=True)


def padded_shard(n_items: int, rank_: Optional[int] = None,
                 world: Optional[int] = None) -> List[int]:
    """The indices an evaluation rank takes (DistributedSampler without
    shuffle): rank, rank + world, ... over the items repeated to a multiple
    of the world, so every rank takes as many; none without items."""
    r = rank() if rank_ is None else rank_
    n = world_size() if world is None else world
    if not n_items:
        return []
    per_rank = -(-n_items // n)
    return [(r + k * n) % n_items for k in range(per_rank)]
