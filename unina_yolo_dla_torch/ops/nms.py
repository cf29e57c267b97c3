"""Class-aware NMS over a score-sorted detection set.

``nms`` runs the NMS kernel (``ops/cuda/nms_kernel.py``) on one image's
``Detections`` or on a batch of them (one launch either way): exact greedy
suppression, the same keep mask as the reference's fixpoint ``nms`` (per
image, ``jax.vmap`` of it) and its sequential ``nms_reference``.
``nms_fast`` is the reference's one-pass matrix form, for serving that
opts out of greedy suppression.
"""
from __future__ import annotations

import torch

from ..models.config import DEFAULT_IOU_THRESHOLD
from ..utils.boxes import box_iou
from .cuda.nms_kernel import nms_keep, nms_keep_plain
from .decode import Detections


def nms(dets: Detections,
        iou_threshold: float = DEFAULT_IOU_THRESHOLD) -> Detections:
    """Greedy NMS; each image's ``dets`` must be sorted by score
    descending."""
    keep = nms_keep(dets.boxes.contiguous(), dets.classes.contiguous(),
                    dets.valid.contiguous(), iou_threshold)
    return dets._replace(valid=keep)


def nms_reference(dets: Detections,
                  iou_threshold: float = DEFAULT_IOU_THRESHOLD
                  ) -> Detections:
    """The literal sequential scan (the plain version), any device."""
    keep = nms_keep_plain(dets.boxes, dets.classes, dets.valid,
                          iou_threshold)
    return dets._replace(valid=keep)


def nms_fast(dets: Detections,
             iou_threshold: float = DEFAULT_IOU_THRESHOLD) -> Detections:
    """One-pass matrix NMS (the reference's ``nms_fast``): a box is
    dropped where any valid, higher-scored box of its class overlaps it by
    more than ``iou_threshold``, whether or not that box survives itself.
    It differs from greedy ``nms`` only in chains (A suppresses B, B would
    have suppressed C: here A alone decides C). Plain PyTorch on the
    detections' device, one image's ``Detections`` or a batch of them; the
    reference has no kernel for it. Each image's ``dets`` must be sorted
    by score descending."""
    boxes = dets.boxes.float()
    k = boxes.shape[-2]
    # [..., i, j]: the IoU of box j with box i, as the reference's
    # ``pairwise_iou(...).T``
    iou = box_iou(boxes[..., None, :, :], boxes[..., :, None, :])
    same = dets.classes[..., :, None] == dets.classes[..., None, :]
    earlier = torch.ones((k, k), dtype=torch.bool,
                         device=boxes.device).tril(diagonal=-1)
    suppressed_by = (iou > iou_threshold) & same & earlier \
        & dets.valid[..., None, :]
    return dets._replace(valid=dets.valid & ~suppressed_by.any(dim=-1))
