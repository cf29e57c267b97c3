"""Training-time augmentation: flip, HSV jitter, mosaic, mixup (numpy and
cv2 on the host), a copy of the reference's ``data/augment.py``: the same
transforms drawing the same random numbers in the same order, so a seeded
batch pipeline gives the same bytes in both packages. Copy-paste
augmentation lives in ``curation/copy_paste.py``.
"""
from __future__ import annotations

import numpy as np


def hflip(img: np.ndarray, boxes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Horizontal flip of image (H,W,3) and xyxy pixel boxes."""
    w = img.shape[1]
    img = img[:, ::-1]
    if boxes.shape[0]:
        boxes = boxes.copy()
        x1 = w - boxes[:, 2]
        x2 = w - boxes[:, 0]
        boxes[:, 0], boxes[:, 2] = x1, x2
    return np.ascontiguousarray(img), boxes


def hsv_jitter(
    rng: np.random.Generator,
    img: np.ndarray,
    h_gain: float = 0.015,
    s_gain: float = 0.7,
    v_gain: float = 0.4,
) -> np.ndarray:
    """Random HSV colour jitter on an RGB uint8 image (gains as fractions)."""
    import cv2

    r = rng.uniform(-1, 1, 3) * (h_gain, s_gain, v_gain) + 1
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV).astype(np.float32)
    hsv[..., 0] = (hsv[..., 0] * r[0]) % 180
    hsv[..., 1] = np.clip(hsv[..., 1] * r[1], 0, 255)
    hsv[..., 2] = np.clip(hsv[..., 2] * r[2], 0, 255)
    return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)


def augment_sample(
    rng: np.random.Generator,
    img: np.ndarray,
    boxes: np.ndarray,
    classes: np.ndarray,
    flip_p: float = 0.5,
    hsv_p: float = 1.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Standard per-sample augmentation (flip + HSV)."""
    if rng.uniform() < flip_p:
        img, boxes = hflip(img, boxes)
    if rng.uniform() < hsv_p:
        img = hsv_jitter(rng, img)
    return img, boxes, classes


def mosaic4(
    rng: np.random.Generator,
    samples: list[tuple[np.ndarray, np.ndarray, np.ndarray]],
    out_size: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """4-image mosaic: tiles 4 letterboxed samples into a 2x2 canvas with a
    jittered center, rescales to ``out_size``, merges labels."""
    import cv2

    assert len(samples) == 4
    s = out_size
    cx = int(rng.uniform(0.35, 0.65) * 2 * s)
    cy = int(rng.uniform(0.35, 0.65) * 2 * s)
    canvas = np.full((2 * s, 2 * s, 3), 114, np.uint8)
    all_boxes, all_classes = [], []
    corners = [(0, 0, cx, cy), (cx, 0, 2 * s, cy),
               (0, cy, cx, 2 * s), (cx, cy, 2 * s, 2 * s)]
    for (img, boxes, classes), (x1, y1, x2, y2) in zip(samples, corners):
        tw, th = x2 - x1, y2 - y1
        if tw <= 1 or th <= 1:
            continue
        scale = min(tw / img.shape[1], th / img.shape[0])
        nw, nh = max(int(img.shape[1] * scale), 1), max(
            int(img.shape[0] * scale), 1)
        tile = cv2.resize(img, (nw, nh))
        canvas[y1:y1 + nh, x1:x1 + nw] = tile
        if boxes.shape[0]:
            b = boxes * scale
            b[:, [0, 2]] += x1
            b[:, [1, 3]] += y1
            all_boxes.append(b)
            all_classes.append(classes)

    if all_boxes:
        boxes = np.concatenate(all_boxes) / 2.0   # 2s x 2s -> s x s
        classes = np.concatenate(all_classes)
        boxes = np.clip(boxes, 0, s - 1)
        wh = boxes[:, 2:] - boxes[:, :2]
        keep = (wh > 2).all(axis=1)
        boxes, classes = boxes[keep], classes[keep]
    else:
        boxes = np.zeros((0, 4), np.float32)
        classes = np.zeros((0,), np.int32)

    out = cv2.resize(canvas, (s, s))
    return out, boxes.astype(np.float32), classes


def mixup(
    rng: np.random.Generator,
    a: tuple[np.ndarray, np.ndarray, np.ndarray],
    b: tuple[np.ndarray, np.ndarray, np.ndarray],
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Beta(32,32) image blend; labels are unioned (YOLO convention)."""
    lam = rng.beta(32.0, 32.0)
    img = (a[0].astype(np.float32) * lam
           + b[0].astype(np.float32) * (1 - lam)).astype(np.uint8)
    boxes = np.concatenate([a[1], b[1]]) if a[1].size or b[1].size else a[1]
    classes = np.concatenate([a[2], b[2]]) if a[2].size or b[2].size else a[2]
    return img, boxes, classes
