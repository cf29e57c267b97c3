"""The data-parallel group, the port's counterpart of the reference's
``parallel/mesh.py``.

The reference builds a 1-D device mesh over its ``data`` axis and lets XLA
place the batch. With one process per device (PyTorch's idiom) there is no
mesh object: a ``DataGroup`` names the process group, its size, this
process's rank and its device, and ``shard_batch`` takes this process's
contiguous rows of a global batch onto that device.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataGroup:
    group: Any            # the process group (None: the default group)
    world_size: int
    rank: int
    device: torch.device


def local_device(device=None) -> torch.device:
    """This process's device: the card of its local rank (``LOCAL_RANK``,
    else its rank modulo the cards) unless ``device`` is the CPU."""
    dev = torch.device(device or "cuda")
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = os.environ.get("LOCAL_RANK")
    rank = int(local) if local else (dist.get_rank()
                                     if dist.is_initialized() else 0)
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


def create_mesh(device=None, group: Any = None) -> DataGroup:
    """The data-parallel group of ``group`` (the default group; a single
    process without one), on this process's device."""
    if dist.is_initialized():
        ws, rank = dist.get_world_size(group), dist.get_rank(group)
    elif group is not None:
        raise RuntimeError("a process group needs torch.distributed "
                           "initialised (parallel.initialize_distributed)")
    else:
        ws, rank = 1, 0
    return DataGroup(group=group, world_size=ws, rank=rank,
                     device=local_device(device))


def shard_batch(batch: dict[str, np.ndarray], mesh: DataGroup
                ) -> dict[str, torch.Tensor]:
    """This process's contiguous rows of a global batch (its size a
    multiple of the group's), as tensors on the group's device."""
    n = len(next(iter(batch.values())))
    if n % mesh.world_size:
        raise ValueError(f"global batch {n} not divisible by "
                         f"{mesh.world_size} processes")
    per = n // mesh.world_size
    rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
    return {k: torch.as_tensor(np.ascontiguousarray(v[rows])).to(
        mesh.device) for k, v in batch.items()}
