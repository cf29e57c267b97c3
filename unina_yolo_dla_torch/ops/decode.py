"""Anchor-free head decode and compaction into a fixed detection set.

The decode kernel (``ops/cuda/decode_kernel.py``) takes every level of
every image of a batch in one launch and writes each image's
``max_detections`` slots: the valid cells by score descending, ties to the
lower cell index (as a stable sort and ``lax.top_k`` order them; sigmoid
saturates to exactly 1.0 in f32, so ties among confident cones are real),
then the first invalid cells in index order.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..models.config import (
    DEFAULT_CONF_THRESHOLD,
    DEFAULT_CP_Q,
    MAX_DETECTIONS,
)
from .cuda.decode_kernel import decode_topk


class Detections(NamedTuple):
    """Fixed-capacity detection set of one image, or of a batch (every
    field with a leading B axis)."""

    boxes: torch.Tensor    # ([B,] K, 4) xyxy, pixels
    scores: torch.Tensor   # ([B,] K)
    classes: torch.Tensor  # ([B,] K) int32
    valid: torch.Tensor    # ([B,] K) bool

    @property
    def count(self) -> int:
        """Valid detections of one image (a batch of one counts too)."""
        if self.valid.ndim > 1 and self.valid.shape[0] != 1:
            raise ValueError("count of a batch: use counts()")
        return int(self.valid.sum())

    def counts(self) -> torch.Tensor:
        """(B,) valid detections per image ((1,) for one image)."""
        return self.valid.reshape(-1, self.valid.shape[-1]).sum(dim=-1)


def decode_batch(outputs: Sequence[tuple[torch.Tensor, torch.Tensor]],
                 strides: Sequence[int] = (4, 8, 16),
                 conf_threshold: float = DEFAULT_CONF_THRESHOLD,
                 q_factor: float = DEFAULT_CP_Q,
                 max_detections: int = MAX_DETECTIONS) -> Detections:
    """Decode all levels of B images and compact each to
    ``max_detections`` slots: one kernel launch on the card.

    ``outputs`` is the model's ``[(cls (B, H, W, C), reg (B, H, W, 4)),
    ...]``; every field of the result has a leading B axis."""
    return Detections(*decode_topk(outputs, strides, conf_threshold,
                                   q_factor, max_detections))


def decode_outputs(outputs: Sequence[tuple[torch.Tensor, torch.Tensor]],
                   strides: Sequence[int] = (4, 8, 16),
                   conf_threshold: float = DEFAULT_CONF_THRESHOLD,
                   q_factor: float = DEFAULT_CP_Q,
                   max_detections: int = MAX_DETECTIONS) -> Detections:
    """Decode all levels of ONE image and compact to ``max_detections``.

    ``outputs`` is the model's ``[(cls, reg), ...]`` with a leading batch
    dim of 1 or none."""
    outputs = [(c, r) if c.ndim == 4 else (c[None], r[None])
               for c, r in outputs]
    if outputs[0][0].shape[0] != 1:
        raise ValueError("decode_outputs takes one image: use decode_batch")
    dets = decode_batch(outputs, strides, conf_threshold, q_factor,
                        max_detections)
    return Detections(*(f[0] for f in dets))
