"""Task-aligned (TAL) anchor-free label assignment, batched and static
in shape (the reference's ``train/assigner.py``):

- anchor points: the centre of every P2, P3 and P4 cell, ``(x + 0.5) *
  stride``, level after level, row-major;
- candidates: anchors whose centre lies strictly inside a GT box;
- alignment t = score^alpha * iou^beta (alpha 0.5, beta 6);
- the top k (10) candidates of each GT by t, the lower anchor index first
  among equal t (as ``lax.top_k``); an anchor claimed by several GTs goes
  to the one with the highest IoU, the first GT among equals;
- target scores: one-hot(label) * t * max_iou / max_t of its GT.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..utils.boxes import box_iou


class AssignResult(NamedTuple):
    fg_mask: torch.Tensor         # (B, A) bool: the anchor has a target
    target_boxes: torch.Tensor    # (B, A, 4) xyxy px
    target_scores: torch.Tensor   # (B, A, C) soft class targets in [0, 1]
    target_gt_idx: torch.Tensor   # (B, A) int32 index into the GT axis


def make_anchors(grid_sizes: Sequence[int], strides: Sequence[int],
                 device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat anchor centres (A, 2) in pixels and each anchor's stride (A,),
    float32."""
    centers, strs = [], []
    for g, s in zip(grid_sizes, strides):
        r = torch.arange(g, dtype=torch.float32, device=device)
        ys, xs = torch.meshgrid(r, r, indexing="ij")
        centers.append(torch.stack([(xs + 0.5) * s, (ys + 0.5) * s],
                                   -1).reshape(-1, 2))
        strs.append(torch.full((g * g,), float(s), device=device))
    return torch.cat(centers), torch.cat(strs)


def decode_ltrb(reg: torch.Tensor, anchors: torch.Tensor,
                strides: torch.Tensor) -> torch.Tensor:
    """(..., A, 4) raw ltrb in stride units -> xyxy pixels at the anchor
    centres (the serving decode's geometry)."""
    ltrb = reg * strides[..., None]
    return torch.stack([anchors[..., 0] - ltrb[..., 0],
                        anchors[..., 1] - ltrb[..., 1],
                        anchors[..., 0] + ltrb[..., 2],
                        anchors[..., 1] + ltrb[..., 3]], -1)


def _topk_mask(align: torch.Tensor, k: int, eps: float) -> torch.Tensor:
    """(B, G, A) -> bool mask of each row's top ``k`` entries above
    ``eps``, ties to the lower index. ``align`` is non-negative float32,
    whose bits order as its values: the key (bits, A - 1 - index) is
    distinct in every entry, so ``topk`` has no tie to break."""
    a = align.shape[-1]
    idx = torch.arange(a, device=align.device)
    key = (align.contiguous().view(torch.int32).long() << 32) | (a - 1 - idx)
    top = torch.topk(key, k, dim=-1).indices
    vals = torch.gather(align, -1, top)
    in_topk = torch.zeros_like(align, dtype=torch.bool)
    return in_topk.scatter(-1, top, vals > eps)


def _one_hot(idx: torch.Tensor, n: int, dim: int = -1) -> torch.Tensor:
    """``jax.nn.one_hot`` as a bool mask: an index outside [0, n) gives a
    row of zeros."""
    r = torch.arange(n, device=idx.device)
    if dim != -1:
        return idx.unsqueeze(dim) == r.view(-1, *([1] * (idx.dim() - dim)))
    return idx[..., None] == r


@torch.no_grad()
def assign(pred_scores: torch.Tensor, pred_boxes: torch.Tensor,
           anchors: torch.Tensor, gt_boxes: torch.Tensor,
           gt_labels: torch.Tensor, gt_mask: torch.Tensor, num_classes: int,
           topk: int = 10, alpha: float = 0.5, beta: float = 6.0,
           eps: float = 1e-9) -> AssignResult:
    """pred_scores (B, A, C) sigmoid probabilities, pred_boxes (B, A, 4)
    xyxy px, anchors (A, 2), gt_boxes (B, G, 4) xyxy px, gt_labels (B, G)
    int, gt_mask (B, G) bool (real vs padding)."""
    b, a, _ = pred_scores.shape
    g = gt_boxes.shape[1]
    # (B, G, A) IoU of each GT with each predicted box
    iou = box_iou(gt_boxes[:, :, None, :], pred_boxes[:, None, :, :])
    iou = torch.clamp(iou, min=0.0)
    # each anchor's score at each GT's label
    labels = torch.clamp(gt_labels.long(), 0, num_classes - 1)
    score_at_label = torch.gather(pred_scores.transpose(1, 2), 1,
                                  labels[:, :, None].expand(b, g, a))
    align = score_at_label ** alpha * iou ** beta
    # candidates: anchor centre strictly inside the GT box
    cx, cy = anchors[None, None, :, 0], anchors[None, None, :, 1]
    inside = ((cx > gt_boxes[..., 0:1]) & (cx < gt_boxes[..., 2:3])
              & (cy > gt_boxes[..., 1:2]) & (cy < gt_boxes[..., 3:4]))
    mask = inside & gt_mask[:, :, None]
    zero = align.new_zeros(())
    align = torch.where(mask, align, zero)
    mask = mask & _topk_mask(align, min(topk, a), eps)
    # an anchor claimed by several GTs keeps the max-IoU one
    claimed = mask.sum(1)                                     # (B, A)
    best_gt = torch.where(mask, iou, iou.new_tensor(-1.0)).argmax(1)
    keep = _one_hot(best_gt, g, dim=1)                        # (B, G, A)
    mask = torch.where((claimed > 1)[:, None, :], mask & keep, mask)

    fg_mask = mask.any(1)
    target_gt_idx = mask.to(torch.uint8).argmax(1).to(torch.int32)
    gather = target_gt_idx.long()
    target_boxes = torch.gather(gt_boxes, 1,
                                gather[..., None].expand(b, a, 4))
    target_labels = torch.gather(gt_labels.long(), 1, gather)
    onehot = _one_hot(target_labels, num_classes).float()
    # normalised soft scores: per GT t * max_iou / max_t
    align = torch.where(mask, align, zero)
    max_align = align.amax(2, keepdim=True)
    max_iou = torch.where(mask, iou, zero).amax(2, keepdim=True)
    norm = align * max_iou / torch.clamp(max_align, min=eps)
    anchor_score = norm.amax(1)
    target_scores = onehot * anchor_score[..., None]
    target_scores = torch.where(fg_mask[..., None], target_scores, zero)
    return AssignResult(fg_mask, target_boxes, target_scores, target_gt_idx)
