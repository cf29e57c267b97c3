"""Box utilities: format conversion and the IoU family of xyxy boxes
(reference semantics: degenerate intersections give 0, union floored at
``eps``)."""
from __future__ import annotations

import math

import torch


def _floor(x: torch.Tensor, lo: float) -> torch.Tensor:
    """max(x, lo), the gradient split at a tie as the reference's clip
    splits it (``torch.clamp`` passes all of it)."""
    return torch.maximum(x, x.new_tensor(lo))


def xywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """[cx, cy, w, h] -> [x1, y1, x2, y2] (last dim 4)."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy_to_xywh(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


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


def box_ciou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7
             ) -> torch.Tensor:
    """Complete-IoU between broadcastable xyxy boxes (the regression
    loss's). The aspect-ratio weight ``alpha`` is a constant for the
    gradient, as the reference's ``stop_gradient`` makes it."""
    iou = box_iou(a, b, eps)
    # enclosing box diagonal
    enc_lt = torch.minimum(a[..., :2], b[..., :2])
    enc_rb = torch.maximum(a[..., 2:], b[..., 2:])
    enc_wh = _floor(enc_rb - enc_lt, 0.0)
    c2 = enc_wh[..., 0] ** 2 + enc_wh[..., 1] ** 2 + eps
    # centre distance
    a_c = (a[..., :2] + a[..., 2:]) / 2
    b_c = (b[..., :2] + b[..., 2:]) / 2
    rho2 = ((a_c - b_c) ** 2).sum(-1)
    # aspect-ratio consistency
    a_wh = _floor(a[..., 2:] - a[..., :2], eps)
    b_wh = _floor(b[..., 2:] - b[..., :2], eps)
    v = (4 / math.pi ** 2) * (
        torch.atan(b_wh[..., 0] / b_wh[..., 1])
        - torch.atan(a_wh[..., 0] / a_wh[..., 1])) ** 2
    alpha = (v / _floor(1.0 - iou + v, eps)).detach()
    return iou - rho2 / c2 - alpha * v
