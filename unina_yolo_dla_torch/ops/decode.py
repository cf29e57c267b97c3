"""Anchor-free head decode and compaction into a fixed detection set.

Per level the decode kernel (``ops/cuda/decode_kernel.py``) writes packed
rows ``[x1, y1, x2, y2, score, class, valid]``; the levels are
concatenated, invalid cells sink to score -1 and a STABLE descending sort
keeps the first ``max_detections`` rows (ties keep the lower cell index
first, as ``lax.top_k`` does; sigmoid saturates to exactly 1.0 in f32, so
ties among confident cones are real). One row gather returns the set.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..models.config import (
    DEFAULT_CONF_THRESHOLD,
    DEFAULT_CP_Q,
    MAX_DETECTIONS,
)
from .cuda.decode_kernel import decode_level_packed


class Detections(NamedTuple):
    """Fixed-capacity detection set."""

    boxes: torch.Tensor    # (K, 4) xyxy, pixels
    scores: torch.Tensor   # (K,)
    classes: torch.Tensor  # (K,) int32
    valid: torch.Tensor    # (K,) bool

    @property
    def count(self) -> int:
        return int(self.valid.sum())


def decode_level(cls_logits: torch.Tensor, reg: torch.Tensor, stride: int,
                 conf_threshold: float = DEFAULT_CONF_THRESHOLD,
                 q_factor: float = DEFAULT_CP_Q):
    """One pyramid level -> flat per-cell (boxes (HW,4), scores (HW,),
    classes (HW,) int32, valid (HW,) bool)."""
    rows = decode_level_packed(cls_logits, reg, stride, conf_threshold,
                               q_factor)
    return (rows[:, :4], rows[:, 4], rows[:, 5].to(torch.int32),
            rows[:, 6] > 0.5)


def decode_outputs(outputs: Sequence[tuple[torch.Tensor, torch.Tensor]],
                   strides: Sequence[int] = (4, 8, 16),
                   conf_threshold: float = DEFAULT_CONF_THRESHOLD,
                   q_factor: float = DEFAULT_CP_Q,
                   max_detections: int = MAX_DETECTIONS) -> Detections:
    """Decode all levels of ONE image and compact to ``max_detections``.

    ``outputs`` is the model's ``[(cls, reg), ...]`` with a leading batch
    dim of 1 or none."""
    packed = []
    for (cls_l, reg_l), s in zip(outputs, strides):
        if cls_l.ndim == 4:
            cls_l, reg_l = cls_l[0], reg_l[0]
        packed.append(decode_level_packed(cls_l.contiguous(),
                                          reg_l.contiguous(), s,
                                          conf_threshold, q_factor))
    rows = torch.cat(packed, dim=0)
    valid = rows[:, 6] > 0.5
    masked = torch.where(valid, rows[:, 4], torch.full_like(rows[:, 4], -1.0))
    k = min(max_detections, masked.shape[0])
    top_scores, order = torch.sort(masked, descending=True, stable=True)
    top_scores, top_idx = top_scores[:k], order[:k]
    top = rows[top_idx]
    return Detections(
        boxes=top[:, :4].contiguous(),
        scores=top[:, 4].contiguous(),
        classes=top[:, 5].to(torch.int32),
        valid=(top[:, 6] > 0.5) & (top_scores > -0.5),
    )
