"""Class-aware greedy NMS over a score-sorted detection set.

``nms`` runs the NMS kernel (``ops/cuda/nms_kernel.py``) on one image's
``Detections`` or on a batch of them (one launch either way): exact greedy
suppression, the same keep mask as the reference's fixpoint ``nms`` (per
image, ``jax.vmap`` of it) and its sequential ``nms_reference``.
"""
from __future__ import annotations

from ..models.config import DEFAULT_IOU_THRESHOLD
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
