"""Sharded multi-stream serving: a camera fleet over several devices.

The reference shard-maps its batch serving program over a device mesh's
``data`` axis with the weights replicated: every chip runs its own
complete program on its slice of the streams, with no collective and no
cross-chip synchronisation, so each slice is served at single-chip
latency and throughput grows with the number of chips.

The port's counterpart in PyTorch's idiom: one independent serving
program per device, each with its own copy of the weights, its own stream
and, on a card, its own stream and captured CUDA graph
(``runtime/pipeline.py`` ``build_batch_serving_fn`` under
``runtime/aot.py`` ``capture_serving_fn``).
A call splits the (B, ...) stream batch into ``len(devices)`` contiguous
shards, launches every shard's program on its stream before it waits on
any, and returns the ``Detections`` with the stream axis kept. Nothing
here builds a process group or calls a collective: one host thread drives
every device. A device may be listed more than once (two programs on one
card, on two streams).
"""
from __future__ import annotations

import copy
from typing import Callable, Sequence

import numpy as np
import torch

from ..models.config import (
    DEFAULT_CONF_THRESHOLD,
    DEFAULT_CP_Q,
    DEFAULT_IOU_THRESHOLD,
    MAX_DETECTIONS,
    ModelConfig,
)
from ..ops.decode import Detections


class _Program:
    """One device's serving program: its own weights and, on a card, its
    own stream and graph, captured at the first call at that call's shard
    shape."""

    def __init__(self, model, cfg: ModelConfig, device: torch.device,
                 kw: dict) -> None:
        # runtime/ imports the models, which import this package
        from ..runtime.pipeline import build_batch_serving_fn

        self.device = device
        self.model = copy.deepcopy(model).to(device)
        self.serve = build_batch_serving_fn(self.model, cfg, **kw)
        self.graph = None

    def launch(self, frames: torch.Tensor) -> Detections:
        """Enqueue this shard on the program's stream; no wait."""
        if self.device.type != "cuda":
            return self.serve(frames)
        if self.graph is None:
            from ..runtime.aot import capture_serving_fn

            self.graph = capture_serving_fn(self.serve, tuple(frames.shape),
                                            self.device)
        # the shard's input, and the previous call's reads of the static
        # outputs, are ordered before this launch
        self.graph.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.graph.stream), torch.inference_mode():
            self.graph.frame.copy_(frames, non_blocking=True)
            self.graph.replay()
            return self.graph.dets

    def join(self) -> None:
        """Order the caller's stream after this program's work."""
        if self.graph is not None:
            torch.cuda.current_stream(self.device).wait_stream(
                self.graph.stream)


def shard_streams(frames, devices: Sequence) -> list[torch.Tensor]:
    """A (B, ...) frame batch (numpy or a tensor) -> ``len(devices)``
    contiguous shards, shard ``i`` on ``devices[i]``. ``B`` must be a
    multiple of ``len(devices)``."""
    devices = [torch.device(d) for d in devices]
    frames = torch.as_tensor(np.asarray(frames) if not
                             isinstance(frames, torch.Tensor) else frames)
    n = len(devices)
    if frames.shape[0] % n:
        raise ValueError(f"{frames.shape[0]} streams do not split over "
                         f"{n} devices")
    per = frames.shape[0] // n
    return [frames[i * per:(i + 1) * per].to(d, non_blocking=True)
            for i, d in enumerate(devices)]


def make_sharded_batch_serving_fn(
    model,
    cfg: ModelConfig,
    devices: Sequence,
    conf_threshold: float = DEFAULT_CONF_THRESHOLD,
    iou_threshold: float = DEFAULT_IOU_THRESHOLD,
    q_factor: float = DEFAULT_CP_Q,
    max_detections: int = MAX_DETECTIONS,
) -> Callable[..., Detections]:
    """Returns ``serve(frames) -> Detections`` over ``devices``.

    ``model`` is a deploy model (``models.detector.from_jax_variables``)
    on any device; each program takes its own copy of it onto its device.
    ``frames``: uint8 frames (B, *``staged_shape(cfg)``) as a tensor or
    numpy array, or the shards ``shard_streams`` made of them; ``B`` a
    multiple of ``len(devices)``. On a card each program is one CUDA graph
    over its shard, captured at the first call (later calls keep that
    shard shape). The result's fields keep the leading stream axis, on
    ``devices[0]``.
    """
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("no devices")
    kw = dict(conf_threshold=conf_threshold, iou_threshold=iou_threshold,
              q_factor=q_factor, max_detections=max_detections)
    programs = [_Program(model, cfg, d, kw) for d in devices]

    def serve(frames) -> Detections:
        shards = (list(frames) if isinstance(frames, (list, tuple))
                  else shard_streams(frames, devices))
        if len(shards) != len(devices):
            raise ValueError(f"{len(shards)} shards for {len(devices)} "
                             "devices")
        results = [p.launch(s) for p, s in zip(programs, shards)]
        for p in programs:
            p.join()
        with torch.inference_mode():
            return Detections(*(
                torch.cat([r[i].to(devices[0], non_blocking=True)
                           for r in results])
                for i in range(len(results[0]))))

    serve.programs = programs
    return serve
