"""mAP@50 / mAP@50-95 detection metric (COCO-style 101-point interpolation).

A copy of the reference's numpy-only ``metrics/map.py`` (the port imports
nothing of the JAX package): per-class confidence-ranked greedy matching
at each IoU threshold, precision envelope, 101-point AP integration.
"""
from __future__ import annotations

import numpy as np

IOU_THRESHOLDS_COCO = np.round(np.arange(0.5, 1.0, 0.05), 2)


def average_precision(recall: np.ndarray, precision: np.ndarray) -> float:
    """101-point interpolated AP (COCO-style: mean of the precision
    envelope sampled at 101 recall points; precision is 0 beyond the
    maximum achieved recall)."""
    if len(recall) == 0:
        return 0.0
    p = np.maximum.accumulate(precision[::-1])[::-1]  # precision envelope
    x = np.linspace(0, 1, 101)
    # left of the first recall point the envelope extends flat (interp
    # 'left' default); beyond max achieved recall precision is 0
    return float(np.mean(np.interp(x, recall, p, right=0.0)))


def compute_map(
    predictions: list[np.ndarray],
    ground_truths: list[np.ndarray],
    num_classes: int,
    iou_thresholds: np.ndarray = IOU_THRESHOLDS_COCO,
) -> dict[str, float]:
    """predictions: per-image (N, 6) [x1, y1, x2, y2, conf, cls];
    ground_truths: per-image (M, 5) [cls, x1, y1, x2, y2]. Pixel units.

    Returns {"map50", "map50_95", "map75", "ap_per_class_50"}.
    """
    num_imgs = len(predictions)
    aps = np.zeros((len(iou_thresholds), num_classes))
    valid_class = np.zeros(num_classes, bool)

    for c in range(num_classes):
        # gather per-class predictions across images
        confs, img_ids, boxes = [], [], []
        n_gt = 0
        gts_per_img = []
        for i in range(num_imgs):
            g = np.asarray(ground_truths[i], np.float32).reshape(-1, 5)
            g = g[g[:, 0] == c]
            gts_per_img.append(g[:, 1:5])
            n_gt += len(g)
            p = np.asarray(predictions[i], np.float32).reshape(-1, 6)
            p = p[p[:, 5] == c]
            boxes.append(p[:, :4])
            confs.append(p[:, 4])
            img_ids.append(np.full(len(p), i))
        if n_gt == 0:
            continue
        valid_class[c] = True
        confs = np.concatenate(confs)
        order = np.argsort(-confs)
        boxes_all = np.concatenate(boxes)[order]
        img_ids = np.concatenate(img_ids)[order]

        for t, thr in enumerate(iou_thresholds):
            tp = np.zeros(len(order), bool)
            # per-image greedy matching in global confidence order
            taken = [np.zeros(len(g), bool) for g in gts_per_img]
            for k in range(len(order)):
                i = int(img_ids[k])
                g = gts_per_img[i]
                if len(g) == 0:
                    continue
                b = boxes_all[k]
                lt = np.maximum(b[:2], g[:, :2])
                rb = np.minimum(b[2:], g[:, 2:])
                wh = np.clip(rb - lt, 0, None)
                inter = wh[:, 0] * wh[:, 1]
                area_b = max((b[2] - b[0]) * (b[3] - b[1]), 0)
                area_g = np.prod(np.clip(g[:, 2:] - g[:, :2], 0, None), 1)
                iou = inter / np.maximum(area_b + area_g - inter, 1e-9)
                iou = np.where(taken[i], 0.0, iou)
                j = int(np.argmax(iou))
                if iou[j] >= thr:
                    tp[k] = True
                    taken[i][j] = True
            cum_tp = np.cumsum(tp)
            cum_fp = np.cumsum(~tp)
            recall = cum_tp / n_gt
            precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-9)
            aps[t, c] = average_precision(recall, precision)

    if not valid_class.any():
        return {"map50": 0.0, "map50_95": 0.0, "map75": 0.0,
                "ap_per_class_50": [0.0] * num_classes}
    vc = valid_class
    i75 = int(np.argmin(np.abs(iou_thresholds - 0.75)))
    return {
        "map50": float(aps[0, vc].mean()),
        "map50_95": float(aps[:, vc].mean()),
        "map75": float(aps[i75, vc].mean()),
        "ap_per_class_50": [float(aps[0, c]) if vc[c] else float("nan")
                            for c in range(num_classes)],
    }
