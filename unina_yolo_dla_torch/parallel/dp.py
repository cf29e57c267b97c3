"""Data-parallel train and eval steps, the port's counterpart of the
reference's ``parallel/dp.py``.

The reference jits its step over a batch sharded across the mesh: the
program computes the GLOBAL batch. The port's step (``train/trainer.py``)
takes a process group and computes the same numbers from each process's
rows:

- BatchNorm's batch mean and E[x^2] are summed over the processes before
  use and before the running update (``models/blocks.py BatchNorm``;
  differentiable, so each process's gradient holds every process's terms);
- the loss normaliser (the sum of the target scores) is the global sum;
- the gradients are summed over the processes, not averaged, in one
  all-reduce of one flat buffer that also carries the aux values (loss
  terms, num_fg), which come out global; the gradient norm is the summed
  gradients'.

``DistributedDataParallel`` averages gradients and ``SyncBatchNorm`` keeps
an unbiased running variance: neither gives these numbers.
"""
from __future__ import annotations

from typing import Callable

from .mesh import DataGroup


def _group_of(mesh: DataGroup):
    import torch.distributed as dist

    return mesh.group if mesh.group is not None else dist.group.WORLD


def make_parallel_train_step(train_step: Callable, mesh: DataGroup
                             ) -> Callable:
    """``(state, batch) -> (state, aux)`` over ``mesh``'s processes:
    ``batch`` holds this process's rows on its device, ``state`` is the
    same on every process before and after."""
    group = _group_of(mesh)

    def step(state, batch):
        return train_step(state, batch, group=group)

    return step


def make_parallel_eval_step(eval_step: Callable, mesh: DataGroup
                            ) -> Callable:
    """``(state, batch) -> (outputs, aux)``: this process's outputs and
    the global aux."""
    group = _group_of(mesh)

    def step(state, batch):
        return eval_step(state, batch, group=group)

    return step
