"""Detection loss: BCE classification + CIoU regression of the raw TLBR
head (the reference's ``train/losses.py``):

  L = w_cls * BCE(cls_logits, target_scores) / sum(target_scores)
    + w_box * sum(score * (1 - CIoU(pred, target))) / sum(target_scores)

with the TAL assignment (``assigner.py``) made on detached predictions.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ..models.config import ModelConfig
from ..utils.boxes import box_ciou
from .assigner import assign, decode_ltrb, make_anchors


class LossConfig(NamedTuple):
    cls_weight: float = 0.5
    box_weight: float = 7.5
    assigner_topk: int = 10
    assigner_alpha: float = 0.5
    assigner_beta: float = 6.0


def flatten_outputs(outputs) -> tuple[torch.Tensor, torch.Tensor]:
    """Model ``[(cls, reg) x 3]`` NHWC -> ((B, A, C), (B, A, 4))."""
    cls_flat = [c.reshape(c.shape[0], -1, c.shape[-1]) for c, _ in outputs]
    reg_flat = [r.reshape(r.shape[0], -1, 4) for _, r in outputs]
    return torch.cat(cls_flat, 1), torch.cat(reg_flat, 1)


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                                 ) -> torch.Tensor:
    """Elementwise -y log sigmoid(x) - (1 - y) log sigmoid(-x)."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(
        -logits)


def detection_loss(outputs, gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                   gt_mask: torch.Tensor, cfg: ModelConfig,
                   loss_cfg: LossConfig = LossConfig(),
                   grid_sizes: Sequence[int] | None = None
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(scalar loss, aux {loss, cls_loss, box_loss, num_fg}); gt_boxes
    (B, G, 4) xyxy px, gt_labels (B, G) int, gt_mask (B, G) bool."""
    cls_logits, reg = flatten_outputs(outputs)
    anchors, strides = make_anchors(tuple(grid_sizes or cfg.grid_sizes),
                                    cfg.strides, cls_logits.device)
    pred_boxes = decode_ltrb(reg, anchors, strides)
    res = assign(torch.sigmoid(cls_logits).detach(), pred_boxes.detach(),
                 anchors, gt_boxes, gt_labels, gt_mask, cfg.num_classes,
                 topk=loss_cfg.assigner_topk, alpha=loss_cfg.assigner_alpha,
                 beta=loss_cfg.assigner_beta)
    score_sum = torch.clamp(res.target_scores.sum(), min=1.0)
    cls_loss = sigmoid_binary_cross_entropy(
        cls_logits, res.target_scores).sum() / score_sum
    ciou = box_ciou(pred_boxes, res.target_boxes)
    weight = res.target_scores.sum(-1)
    box_loss = torch.where(res.fg_mask, (1.0 - ciou) * weight,
                           ciou.new_zeros(())).sum() / score_sum
    total = loss_cfg.cls_weight * cls_loss + loss_cfg.box_weight * box_loss
    aux = {"loss": total.detach(), "cls_loss": cls_loss.detach(),
           "box_loss": box_loss.detach(), "num_fg": res.fg_mask.sum()}
    return total, aux
