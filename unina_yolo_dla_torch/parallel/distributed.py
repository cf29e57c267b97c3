"""Multi-process initialisation and rank-0 semantics, the port's
counterpart of the reference's ``parallel/distributed.py``.

The reference connects its hosts with one ``jax.distributed.initialize``
and then runs one program over the global device mesh. PyTorch's idiom is
one process per device: ``initialize_distributed`` joins this process to
the job through ``torch.distributed.init_process_group`` (NCCL on the
card, gloo on the CPU), and every process runs the same training loop on
its own device and its own rows of each global batch
(``data.dataset.batch_iterator``'s ``process_slice``); ``parallel/dp.py``
reduces across the processes what the reference's SPMD program computes
over the whole batch.

``is_main_process()`` gates every artifact write (checkpoints, history,
calibration caches, exports) on rank 0.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

# env channel for launchers that cannot pass flags per process
ENV_COORDINATOR = "UNINA_COORDINATOR"
ENV_NUM_PROCESSES = "UNINA_NUM_PROCESSES"
ENV_PROCESS_ID = "UNINA_PROCESS_ID"


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v else None


def initialize_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
) -> bool:
    """Join this process to the training job. Returns True if a
    multi-process group was initialised, False for a single process.

    ``coordinator``: ``host:port`` of rank 0 (a ``tcp://`` init; any
    ``scheme://`` address is taken as it is, e.g. ``file://``), or
    ``"auto"`` for the environment a launcher such as ``torchrun`` sets
    (``env://``). Arguments fall back to UNINA_COORDINATOR /
    UNINA_NUM_PROCESSES / UNINA_PROCESS_ID; with neither, or one process,
    this is a no-op. ``device``: where the process computes (the card by
    default: NCCL; ``"cpu"``: gloo)."""
    coordinator = coordinator or os.environ.get(ENV_COORDINATOR)
    num_processes = num_processes or _env_int(ENV_NUM_PROCESSES)
    process_id = process_id if process_id is not None \
        else _env_int(ENV_PROCESS_ID)
    backend = ("gloo" if torch.device(device or "cuda").type == "cpu"
               else "nccl")

    if coordinator == "auto":
        dist.init_process_group(backend, init_method="env://")
        return dist.get_world_size() > 1
    if not coordinator or not num_processes or num_processes <= 1:
        return False
    if process_id is None:
        raise ValueError("a multi-process job needs this process's rank "
                         "(--process-id or UNINA_PROCESS_ID)")
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id)
    return True


def is_main_process() -> bool:
    """Rank-0 gate for artifact writes (True without a process group)."""
    return process_index() == 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def make_global_batch(batch: dict[str, np.ndarray], device,
                      global_batch_size: int | None = None
                      ) -> dict[str, torch.Tensor]:
    """This process's rows of a global batch (``global_batch_size /
    process_count()`` of them, as ``batch_iterator``'s ``process_slice``
    yields them) -> tensors on this process's ``device``; the step's
    reductions (``parallel/dp.py``) make them one global batch."""
    rows = len(next(iter(batch.values())))
    if global_batch_size is not None and \
            rows * process_count() != global_batch_size:
        raise ValueError(f"{rows} rows a process x {process_count()} "
                         f"processes is not the global batch "
                         f"{global_batch_size}")
    dev = torch.device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group's processes; its gradient is the sum of every
    process's incoming gradient (each process's term of the global loss
    reaches every process's input)."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group: Any) -> torch.Tensor:
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(t: torch.Tensor, group: Any) -> torch.Tensor:
    """``t`` summed over ``group``'s processes, differentiable."""
    return _AllReduceSum.apply(t, group)
