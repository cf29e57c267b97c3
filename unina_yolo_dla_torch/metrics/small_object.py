"""Small-object precision/recall/F1 (numpy), a copy of the reference's
``metrics/small_object.py``:

- a GT box is "small" iff its width AND height are under
  ``size_threshold`` px in image space (boxes normalised; 15 px at
  ``image_size`` 640 by default: the distant-cone regime);
- predictions, in confidence order, greedily claim an unmatched small GT of
  their class at IoU >= ``iou_threshold``;
- an unmatched prediction is a false positive only if it is small itself;
- an unmatched small GT is a false negative.
"""
from __future__ import annotations

import numpy as np


def _iou_xywh(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of two normalised [cx, cy, w, h] boxes."""
    ax1, ay1 = a[0] - a[2] / 2, a[1] - a[3] / 2
    ax2, ay2 = a[0] + a[2] / 2, a[1] + a[3] / 2
    bx1, by1 = b[0] - b[2] / 2, b[1] - b[3] / 2
    bx2, by2 = b[0] + b[2] / 2, b[1] + b[3] / 2
    iw = max(0.0, min(ax2, bx2) - max(ax1, bx1))
    ih = max(0.0, min(ay2, by2) - max(ay1, by1))
    inter = iw * ih
    union = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter
    if union <= 0:
        return 0.0
    return float(inter / union)


class SmallObjectMetric:
    """Accumulates TP/FP/FN for small (<15 px) objects."""

    def __init__(
        self,
        size_threshold: int = 15,
        iou_threshold: float = 0.5,
        image_size: int = 640,
    ) -> None:
        self.size_threshold = size_threshold
        self.iou_threshold = iou_threshold
        self.image_size = image_size
        self.reset()

    def reset(self) -> None:
        self.true_positives = 0
        self.false_positives = 0
        self.false_negatives = 0

    def _is_small(self, w_norm: float, h_norm: float) -> bool:
        return (w_norm * self.image_size < self.size_threshold
                and h_norm * self.image_size < self.size_threshold)

    def update(self, predictions, ground_truths) -> None:
        """Accumulate one batch.

        ``predictions``: list of (N, 6) arrays [cx, cy, w, h, conf, cls]
        (normalised). ``ground_truths``: list of (M, 5) arrays
        [cls, cx, cy, w, h] (normalised).
        """
        for preds, gts in zip(predictions, ground_truths):
            preds = np.asarray(preds, np.float32).reshape(-1, 6)
            gts = np.asarray(gts, np.float32).reshape(-1, 5)

            small_mask = np.array(
                [self._is_small(g[3], g[4]) for g in gts], dtype=bool)
            small_gts = gts[small_mask]
            if len(small_gts) == 0:
                continue

            matched: set[int] = set()
            if preds.shape[0] == 0:
                self.false_negatives += len(small_gts)
                continue

            order = np.argsort(-preds[:, 4])
            for pred in preds[order]:
                pred_cls = int(pred[5])
                best_iou, best_idx = 0.0, -1
                for i, gt in enumerate(small_gts):
                    if i in matched or int(gt[0]) != pred_cls:
                        continue
                    iou = _iou_xywh(pred[:4], gt[1:5])
                    if iou > best_iou:
                        best_iou, best_idx = iou, i
                if best_iou >= self.iou_threshold:
                    self.true_positives += 1
                    matched.add(best_idx)
                elif self._is_small(pred[2], pred[3]):
                    self.false_positives += 1

            self.false_negatives += len(small_gts) - len(matched)

    def compute(self) -> dict[str, float]:
        tp, fp, fn = (self.true_positives, self.false_positives,
                      self.false_negatives)
        precision = tp / (tp + fp) if (tp + fp) > 0 else 0.0
        recall = tp / (tp + fn) if (tp + fn) > 0 else 0.0
        f1 = (2 * precision * recall / (precision + recall)
              if (precision + recall) > 0 else 0.0)
        return {
            "small_object_precision": precision,
            "small_object_recall": recall,
            "small_object_f1": f1,
            "small_object_tp": tp,
            "small_object_fp": fp,
            "small_object_fn": fn,
        }
