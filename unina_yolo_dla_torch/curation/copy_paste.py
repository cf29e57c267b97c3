"""Copy-paste augmentation from segmented object assets, a copy of the
reference's ``curation/copy_paste.py`` (numpy and cv2; the same random
draws in the same order): RGBA .png / .npy cut-out assets, the class read
from the file name (``yellow_cone_012.png`` -> ``yellow_cone``), a random
scale, horizontal flip and HSV jitter per paste, an occupancy-mask check
against the existing boxes and earlier pastes, alpha blending (optionally
``cv2.seamlessClone``), and the pasted boxes appended to the labels.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..models.config import DEFAULT_CLASS_NAMES


def class_from_filename(path: Path,
                        class_names=DEFAULT_CLASS_NAMES) -> int | None:
    stem = path.stem.lower()
    # longest-name-first so "large_orange_cone" wins over "orange_cone"
    for idx, name in sorted(enumerate(class_names),
                            key=lambda t: -len(t[1])):
        if name.lower() in stem:
            return idx
    return None


def load_asset(path: Path) -> np.ndarray | None:
    """Load an RGBA asset (H, W, 4) uint8 from .png/.npy."""
    import cv2

    if path.suffix == ".npy":
        arr = np.load(path)
        if arr.ndim == 3 and arr.shape[-1] == 4:
            return arr.astype(np.uint8)
        return None
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img is None or img.ndim != 3:
        return None
    if img.shape[-1] == 4:
        b, g, r, a = cv2.split(img)
        return np.dstack([r, g, b, a])
    # RGB asset: fully opaque alpha
    return np.dstack([img[..., ::-1], np.full(img.shape[:2], 255, np.uint8)])


class CopyPasteAugmentor:
    """Paste segmented cone assets into training images."""

    def __init__(
        self,
        asset_dir: str | Path,
        class_names=DEFAULT_CLASS_NAMES,
        max_pastes: int = 3,
        scale_range: tuple[float, float] = (0.5, 1.5),
        flip_p: float = 0.5,
        hsv_jitter: float = 0.1,
        use_seamless_clone: bool = False,
        seed: int = 0,
    ) -> None:
        self.asset_dir = Path(asset_dir)
        self.class_names = class_names
        self.max_pastes = max_pastes
        self.scale_range = scale_range
        self.flip_p = flip_p
        self.hsv_jitter = hsv_jitter
        self.use_seamless_clone = use_seamless_clone
        self.rng = np.random.default_rng(seed)

        self.assets: list[tuple[np.ndarray, int]] = []
        if self.asset_dir.exists():
            for p in sorted(self.asset_dir.iterdir()):
                if p.suffix not in (".png", ".npy"):
                    continue
                cls = class_from_filename(p, class_names)
                if cls is None:
                    continue
                asset = load_asset(p)
                if asset is not None and asset.shape[0] > 3:
                    self.assets.append((asset, cls))

    def _transform_asset(self, asset: np.ndarray) -> np.ndarray:
        import cv2

        rng = self.rng
        scale = rng.uniform(*self.scale_range)
        h = max(int(asset.shape[0] * scale), 4)
        w = max(int(asset.shape[1] * scale), 4)
        out = cv2.resize(asset, (w, h), interpolation=cv2.INTER_LINEAR)
        if rng.uniform() < self.flip_p:
            out = out[:, ::-1]
        if self.hsv_jitter > 0:
            rgb = out[..., :3]
            hsv = cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV).astype(np.float32)
            hsv[..., 1:] *= rng.uniform(1 - self.hsv_jitter,
                                        1 + self.hsv_jitter, 2)
            rgb = cv2.cvtColor(np.clip(hsv, 0, 255).astype(np.uint8),
                               cv2.COLOR_HSV2RGB)
            out = np.dstack([rgb, out[..., 3]])
        return np.ascontiguousarray(out)

    def __call__(
        self,
        img: np.ndarray,          # (H, W, 3) RGB uint8
        boxes: np.ndarray,        # (N, 4) xyxy px
        classes: np.ndarray,      # (N,)
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        if not self.assets:
            return img, boxes, classes
        rng = self.rng
        H, W = img.shape[:2]
        occupancy = np.zeros((H, W), bool)
        for x1, y1, x2, y2 in boxes.astype(int):
            occupancy[max(y1, 0):min(y2, H), max(x1, 0):min(x2, W)] = True

        img = img.copy()
        new_boxes, new_classes = list(boxes), list(classes)
        n_pastes = int(rng.integers(1, self.max_pastes + 1))
        for _ in range(n_pastes):
            asset, cls = self.assets[int(rng.integers(len(self.assets)))]
            patch = self._transform_asset(asset)
            ph, pw = patch.shape[:2]
            if ph >= H or pw >= W:
                continue
            for _attempt in range(10):
                x = int(rng.integers(0, W - pw))
                y = int(rng.integers(0, H - ph))
                if not occupancy[y:y + ph, x:x + pw].any():
                    break
            else:
                continue

            alpha = patch[..., 3:4].astype(np.float32) / 255.0
            region = img[y:y + ph, x:x + pw].astype(np.float32)
            if self.use_seamless_clone:
                import cv2

                mask = (patch[..., 3] > 127).astype(np.uint8) * 255
                center = (x + pw // 2, y + ph // 2)
                try:
                    img = cv2.seamlessClone(
                        patch[..., :3], img, mask, center, cv2.NORMAL_CLONE)
                except Exception:
                    img[y:y + ph, x:x + pw] = (
                        alpha * patch[..., :3] + (1 - alpha) * region
                    ).astype(np.uint8)
            else:
                img[y:y + ph, x:x + pw] = (
                    alpha * patch[..., :3] + (1 - alpha) * region
                ).astype(np.uint8)

            occupancy[y:y + ph, x:x + pw] = True
            new_boxes.append(np.asarray([x, y, x + pw, y + ph], np.float32))
            new_classes.append(cls)

        return (img,
                np.asarray(new_boxes, np.float32).reshape(-1, 4),
                np.asarray(new_classes, np.int32))
