"""Dataset-side image geometry. Only the letterbox the serve CLI needs is
here so far; the YOLO dataset and its batch pipeline come with the
training slice."""
from __future__ import annotations

import numpy as np


def letterbox_image(
    img: np.ndarray, size: int, pad_value: int = 114
) -> tuple[np.ndarray, float, int, int]:
    """Aspect-preserving resize onto a ``size``x``size`` canvas.

    The Ultralytics LetterBox semantics the reference uses everywhere
    (mine_data.py:48-86): returns (canvas uint8 (S,S,3), scale, pad_x,
    pad_y); a box in original pixels maps to canvas pixels as
    ``xy * scale + pad`` and back as ``(xy - pad) / scale``.
    """
    import cv2

    h, w = img.shape[:2]
    scale = min(size / h, size / w)
    nh, nw = round(h * scale), round(w * scale)
    if (nh, nw) != (h, w):
        img = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    pad_y, pad_x = (size - nh) // 2, (size - nw) // 2
    canvas = np.full((size, size, 3), pad_value, np.uint8)
    canvas[pad_y:pad_y + nh, pad_x:pad_x + nw] = img
    return canvas, scale, pad_x, pad_y
