"""Box utilities: area and IoU of xyxy boxes (reference semantics:
degenerate intersections give 0, union floored at ``eps``)."""
from __future__ import annotations

import torch


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-9
            ) -> torch.Tensor:
    """Elementwise IoU of broadcastable xyxy boxes."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a) + box_area(b) - inter
    return inter / torch.clamp(union, min=eps)


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 4) x (M, 4) -> (N, M) IoU matrix."""
    return box_iou(a[:, None, :], b[None, :, :])
