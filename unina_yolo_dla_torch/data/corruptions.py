"""Corruptions for robustness stress tests and corruption-robust QAT, a
copy of the reference's ``data/corruptions.py``.

Quantised engines tend to break first under input corruption (blur and
noise push activations into poorly calibrated ranges), so evaluation can
run every engine under the conditions below, and the QAT phase can mix
them into its calibration and training batches (``maybe_corrupt``,
``train --qat-corruption-aug P``). All transforms are uint8 (H, W, 3) ->
uint8 (H, W, 3), severity 1-3; the arithmetic ones are numpy, blur and
JPEG use cv2. The random draws are the reference's, in its order.
"""
from __future__ import annotations

from typing import Callable

import numpy as np


def gaussian_blur(img: np.ndarray, severity: int,
                  rng: np.random.Generator | None = None) -> np.ndarray:
    import cv2

    sigma = {1: 1.0, 2: 2.0, 3: 4.0}[severity]
    return cv2.GaussianBlur(img, ksize=(0, 0), sigmaX=sigma)


def gaussian_noise(img: np.ndarray, severity: int,
                   rng: np.random.Generator | None = None) -> np.ndarray:
    rng = rng or np.random.default_rng(0)
    sigma = {1: 8.0, 2: 18.0, 3: 32.0}[severity]
    noisy = img.astype(np.float32) + rng.normal(0, sigma, img.shape)
    return np.clip(noisy, 0, 255).astype(np.uint8)


def low_light(img: np.ndarray, severity: int,
              rng: np.random.Generator | None = None) -> np.ndarray:
    """Brightness reduction + sensor-noise floor (dusk/indoor)."""
    rng = rng or np.random.default_rng(0)
    gain = {1: 0.6, 2: 0.4, 3: 0.25}[severity]
    dark = img.astype(np.float32) * gain
    dark += rng.normal(0, 4.0, img.shape)  # read noise dominates when dark
    return np.clip(dark, 0, 255).astype(np.uint8)


def overexposure(img: np.ndarray, severity: int,
                 rng: np.random.Generator | None = None) -> np.ndarray:
    gain = {1: 1.4, 2: 1.8, 3: 2.4}[severity]
    return np.clip(img.astype(np.float32) * gain, 0, 255).astype(np.uint8)


def jpeg_compression(img: np.ndarray, severity: int,
                     rng: np.random.Generator | None = None) -> np.ndarray:
    import cv2

    quality = {1: 40, 2: 20, 3: 10}[severity]
    # the frames are RGB and cv2's codec BGR: convert both ways so the
    # chroma subsampling hits the channels as a camera's would
    ok, enc = cv2.imencode(".jpg", img[..., ::-1],
                           [cv2.IMWRITE_JPEG_QUALITY, quality])
    if not ok:
        return img
    return cv2.imdecode(enc, cv2.IMREAD_COLOR)[..., ::-1]


CORRUPTIONS: dict[str, Callable] = {
    "gaussian_blur": gaussian_blur,
    "gaussian_noise": gaussian_noise,
    "low_light": low_light,
    "overexposure": overexposure,
    "jpeg": jpeg_compression,
}


def maybe_corrupt(rng: np.random.Generator, img: np.ndarray, p: float,
                  severities: tuple[int, ...] = (1, 2)) -> np.ndarray:
    """With probability ``p``, one random corruption at a random severity
    (the QAT corruption augmentation). Severity 3 is left out by default:
    it destroys the small-object signal for the float model too."""
    if p <= 0 or rng.uniform() >= p:
        return img
    name = list(CORRUPTIONS)[int(rng.integers(len(CORRUPTIONS)))]
    sev = int(severities[int(rng.integers(len(severities)))])
    return CORRUPTIONS[name](img, sev, rng)


def corrupt_batches(batches_fn, name: str, severity: int, seed: int = 0):
    """Wrap a zero-argument ``batches_fn`` (the ``evaluate_model``
    contract) so every image is corrupted deterministically; returns a new
    zero-argument callable."""
    fn = CORRUPTIONS[name]

    def gen():
        rng = np.random.default_rng(seed)
        for batch in batches_fn():
            batch = dict(batch)
            imgs = batch["images"].copy()
            for i in range(len(imgs)):
                imgs[i] = fn(imgs[i], severity, rng)
            batch["images"] = imgs
            yield batch

    return gen
