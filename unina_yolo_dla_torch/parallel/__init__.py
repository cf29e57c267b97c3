"""Data parallelism over processes, one per device (``torch.distributed``:
NCCL on the card, gloo on the CPU)."""
from .distributed import (
    initialize_distributed,
    is_main_process,
    make_global_batch,
    process_count,
    process_index,
)
from .dp import make_parallel_eval_step, make_parallel_train_step
from .mesh import DataGroup, create_mesh, shard_batch

__all__ = [
    "DataGroup", "create_mesh", "shard_batch",
    "make_parallel_eval_step", "make_parallel_train_step",
    "initialize_distributed", "is_main_process", "make_global_batch",
    "process_count", "process_index",
]
