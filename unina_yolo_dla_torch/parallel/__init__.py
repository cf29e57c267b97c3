"""Data parallelism over processes, one per device (``torch.distributed``:
NCCL on the card, gloo on the CPU), and fleet serving over devices from
one process with no collective (``serving.py``)."""
from .distributed import (
    initialize_distributed,
    is_main_process,
    make_global_batch,
    process_count,
    process_index,
)
from .dp import make_parallel_eval_step, make_parallel_train_step
from .mesh import DataGroup, create_mesh, shard_batch
from .serving import make_sharded_batch_serving_fn, shard_streams

__all__ = [
    "DataGroup", "create_mesh", "shard_batch",
    "make_parallel_eval_step", "make_parallel_train_step",
    "initialize_distributed", "is_main_process", "make_global_batch",
    "process_count", "process_index",
    "make_sharded_batch_serving_fn", "shard_streams",
]
