"""Conformal-prediction calibration of the box dilation ``q_hat``, the
port's counterpart of the reference's ``train/conformal.py``:

- the detector runs over the validation set at confidence 0.001, so recall
  is near exhaustive, and without dilation (q = 0: q is what is
  calibrated);
- predictions, in confidence order, greedily match a GT box of their class
  at IoU >= 0.5; each matched pair scores 1 - IoU;
- ``q_hat`` is the finite-sample conformal quantile of the scores,
  ``ceil((n + 1)(1 - alpha)) / n`` (alpha 0.10: 90% coverage);
- zero matches is an error: a silent default would ship an uncalibrated
  safety margin;
- the artifact ``cp_calibration.json`` holds ``q_hat`` and the scores'
  statistics; the export bakes ``q_hat`` into the serving artifact, whose
  decode dilates each box side by q_hat times its width or height.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable

import numpy as np


def match_nonconformity_scores(
    pred_boxes: np.ndarray,   # (N, 4) xyxy, conf-sorted desc
    pred_cls: np.ndarray,
    gt_boxes: np.ndarray,     # (M, 4) xyxy
    gt_cls: np.ndarray,
    iou_threshold: float = 0.5,
) -> list[float]:
    scores: list[float] = []
    taken = np.zeros(len(gt_boxes), bool)
    for i in range(len(pred_boxes)):
        same = (gt_cls == pred_cls[i]) & ~taken
        if not same.any():
            continue
        g = gt_boxes
        b = pred_boxes[i]
        lt = np.maximum(b[:2], g[:, :2])
        rb = np.minimum(b[2:], g[:, 2:])
        wh = np.clip(rb - lt, 0, None)
        inter = wh[:, 0] * wh[:, 1]
        area_b = max((b[2] - b[0]) * (b[3] - b[1]), 0.0)
        area_g = np.prod(np.clip(g[:, 2:] - g[:, :2], 0, None), 1)
        iou = inter / np.maximum(area_b + area_g - inter, 1e-9)
        iou = np.where(same, iou, 0.0)
        j = int(np.argmax(iou))
        if iou[j] >= iou_threshold:
            scores.append(float(1.0 - iou[j]))
            taken[j] = True
    return scores


def calibrate_conformal_prediction(
    model,
    variables,
    batches: Iterable[dict[str, np.ndarray]],
    alpha: float = 0.10,
    conf_threshold: float = 0.001,
    iou_match: float = 0.5,
    max_detections: int = 300,
    output_path: str | Path | None = None,
) -> dict:
    """Returns the cp_calibration payload; optionally writes the JSON.

    ``batches``: evaluation batches (``data.dataset.batch_iterator``);
    the forward, decode and NMS are ``evaluate.predict_batches``' (one
    decode and one NMS launch a batch), tail-padding slots left out."""
    from ..evaluate import predict_batches

    scores: list[float] = []
    n_images = 0
    for pred, gt, _idx in predict_batches(
            model, variables, batches, conf_threshold=conf_threshold,
            iou_threshold=0.45, q_factor=0.0,
            max_detections=max_detections):
        n_images += 1
        # predictions come conf-sorted (top-K slot order)
        scores.extend(match_nonconformity_scores(
            pred[:, :4], pred[:, 5], gt[:, 1:5], gt[:, 0], iou_match))

    if not scores:
        raise RuntimeError(
            "conformal calibration found zero matched predictions: the "
            "model and the validation set do not fit together")

    arr = np.asarray(scores)
    n = len(arr)
    # finite-sample conformal quantile: ceil((n+1)(1-alpha))/n
    level = min(np.ceil((n + 1) * (1 - alpha)) / n, 1.0)
    q_hat = float(np.quantile(arr, level, method="higher"))
    payload = {
        "q_hat": q_hat,
        "alpha": alpha,
        "coverage_target": 1 - alpha,
        "num_scores": n,
        "num_images": n_images,
        "score_mean": float(arr.mean()),
        "score_std": float(arr.std()),
        "score_p50": float(np.percentile(arr, 50)),
        "score_p90": float(np.percentile(arr, 90)),
        "conf_threshold": conf_threshold,
        "iou_match": iou_match,
    }
    if output_path is not None:
        Path(output_path).write_text(json.dumps(payload, indent=2))
    return payload


def load_cp_q(path: str | Path, default: float = 0.1) -> float:
    """Read q_hat from a cp_calibration.json; ``default`` where the file
    or its key is missing."""
    p = Path(path)
    if not p.exists():
        return default
    return float(json.loads(p.read_text()).get("q_hat", default))
