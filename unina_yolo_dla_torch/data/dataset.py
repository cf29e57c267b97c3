"""YOLO-format dataset and the host-side batch pipeline (numpy; cv2 and
PyYAML imported where they are used), the port's copy of the reference's
``data/dataset.py``:

- ``YoloDataset``: the images/ and labels/ twin trees of a dataset YAML
  (``path``, ``train``, ``val``, ``names``, ``nc``), letterboxed to the
  static input size with the labels transformed;
- difficulty-weighted sampling with replacement (minimum weight 0.1, images
  the map does not name weigh 1.0);
- labels padded to ``max_boxes``, so every batch has one shape.

Batches are dicts of numpy arrays: images (B, S, S, 3) uint8 RGB NHWC,
normalised on the card by ``ops.preprocess.ensure_normalized`` (uint8
crosses to the device at a quarter of float32's bytes), boxes (B, G, 4)
xyxy pixels, labels (B, G) int32, mask (B, G), sample_valid (B,) and
indices (B,) (the dataset row of each sample, -1 for tail padding). The
random draws are the reference's, in its order: a seeded iterator gives
the same bytes in both packages.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator

import numpy as np

from ..models.config import IMAGENET_MEAN, IMAGENET_STD


def load_dataset_yaml(yaml_path: str | Path) -> dict:
    import yaml

    with open(yaml_path) as f:
        spec = yaml.safe_load(f)
    root = Path(spec.get("path", Path(yaml_path).parent))
    return {
        "root": root,
        "train": root / spec.get("train", "images/train"),
        "val": root / spec.get("val", "images/val"),
        "names": spec.get("names", {}),
        "nc": spec.get("nc", len(spec.get("names", {}))),
    }


def _label_path(img_path: Path) -> Path:
    """images/<split>/x.jpg -> labels/<split>/x.txt (YOLO convention)."""
    parts = list(img_path.parts)
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == "images":
            parts[i] = "labels"
            break
    return Path(*parts).with_suffix(".txt")


def letterbox_image(
    img: np.ndarray, size: int, pad_value: int = 114
) -> tuple[np.ndarray, float, int, int]:
    """Aspect-preserving resize onto a ``size``x``size`` canvas.

    The Ultralytics LetterBox semantics: returns (canvas uint8 (S,S,3),
    scale, pad_x, pad_y); a box in original pixels maps to canvas pixels as
    ``xy * scale + pad`` and back as ``(xy - pad) / scale``. An image
    already at the size needs no cv2.
    """
    h, w = img.shape[:2]
    scale = min(size / h, size / w)
    nh, nw = round(h * scale), round(w * scale)
    if (nh, nw) != (h, w):
        import cv2

        img = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    pad_y, pad_x = (size - nh) // 2, (size - nw) // 2
    canvas = np.full((size, size, 3), pad_value, np.uint8)
    canvas[pad_y:pad_y + nh, pad_x:pad_x + nw] = img
    return canvas, scale, pad_x, pad_y


class YoloDataset:
    """Image + YOLO-txt label pairs with letterbox preprocessing."""

    IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")

    def __init__(
        self,
        image_dir: str | Path,
        img_size: int = 640,
        max_boxes: int = 100,
        class_offset: int = 0,
    ) -> None:
        self.image_dir = Path(image_dir)
        self.img_size = img_size
        self.max_boxes = max_boxes
        self.class_offset = class_offset
        self.image_paths = sorted(
            p for p in self.image_dir.rglob("*")
            if p.suffix.lower() in self.IMG_EXTS)
        if not self.image_paths:
            raise FileNotFoundError(f"no images under {self.image_dir}")

    def __len__(self) -> int:
        return len(self.image_paths)

    def load_raw(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        """Returns (RGB uint8 HWC, labels (N, 5) [cls, cx, cy, w, h] norm)."""
        import cv2

        path = self.image_paths[idx]
        img = cv2.imread(str(path))
        if img is None:
            raise IOError(f"failed to read {path}")
        img = img[..., ::-1]  # BGR -> RGB

        lp = _label_path(path)
        labels = []
        if lp.exists():
            for line in lp.read_text().splitlines():
                parts = line.split()
                if len(parts) == 5:
                    labels.append([float(v) for v in parts])
        labels = (np.asarray(labels, np.float32)
                  if labels else np.zeros((0, 5), np.float32))
        return np.ascontiguousarray(img), labels

    def load_letterboxed(
        self, idx: int
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(img_uint8 (S,S,3), boxes_xyxy_px (N,4), classes (N,))."""
        img, labels = self.load_raw(idx)
        s = self.img_size
        h, w = img.shape[:2]
        canvas, scale, pad_x, pad_y = letterbox_image(img, s)

        if labels.shape[0]:
            cx = labels[:, 1] * w * scale + pad_x
            cy = labels[:, 2] * h * scale + pad_y
            bw = labels[:, 3] * w * scale
            bh = labels[:, 4] * h * scale
            boxes = np.stack(
                [cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
            classes = labels[:, 0].astype(np.int32) + self.class_offset
        else:
            boxes = np.zeros((0, 4), np.float32)
            classes = np.zeros((0,), np.int32)
        return canvas, boxes.astype(np.float32), classes


def normalize_images(images_uint8: np.ndarray) -> np.ndarray:
    """(B,S,S,3) uint8 -> ImageNet-normalised float32 (on the host)."""
    x = images_uint8.astype(np.float32) / 255.0
    return (x - np.asarray(IMAGENET_MEAN, np.float32)) / np.asarray(
        IMAGENET_STD, np.float32)


def load_difficulty_weights(
    dataset: YoloDataset,
    difficulty_map: dict[str, float] | str | Path | None,
    min_weight: float = 0.1,
) -> np.ndarray:
    """Per-image sampling weights from a difficulty map (a dict or its
    JSON file): keys are image stems, names or paths, missing entries weigh
    1.0, every weight at least ``min_weight``."""
    n = len(dataset)
    if difficulty_map is None:
        return np.ones(n, np.float64)
    if isinstance(difficulty_map, (str, Path)):
        difficulty_map = json.loads(Path(difficulty_map).read_text())
    weights = np.ones(n, np.float64)
    for i, p in enumerate(dataset.image_paths):
        for key in (str(p), p.name, p.stem):
            if key in difficulty_map:
                weights[i] = float(difficulty_map[key])
                break
    return np.maximum(weights, min_weight)


def batch_iterator(
    dataset: YoloDataset,
    batch_size: int,
    rng: np.random.Generator,
    steps: int | None = None,
    weights: np.ndarray | None = None,
    augment: bool = False,
    shuffle: bool = True,
    mosaic_p: float = 0.0,
    mixup_p: float = 0.0,
    copy_paste=None,
    corruption_p: float = 0.0,
    process_slice: tuple[int, int] | None = None,
) -> Iterator[dict[str, np.ndarray]]:
    """Yields batches of one shape: weighted sampling with replacement
    where ``weights`` is given, else epoch shuffling (``steps`` None: one
    epoch, the tail padded with invalid slots, so evaluation never counts
    an image twice).

    With ``augment``: ``mosaic_p`` the probability of a 4-image mosaic,
    ``copy_paste`` an optional ``curation.CopyPasteAugmentor``, then flip
    and HSV jitter, then ``mixup_p`` the probability of a Beta(32, 32)
    blend with a second augmented sample (labels unioned); the QAT phase
    turns them all off. ``corruption_p`` corrupts images whether or not
    ``augment`` is set (labels unchanged).

    ``process_slice=(rank, world_size)``: every process draws the same
    global sample order from ``rng`` but loads only its contiguous rows of
    each batch (``batch_size / world_size`` of them); each sample's
    augmentation draws from a seed drawn up front for its (step, global
    row), so it does not depend on how many processes share the work.
    """
    from .augment import augment_sample, mixup, mosaic4

    n = len(dataset)
    g = dataset.max_boxes
    s = dataset.img_size

    def sample_indices(count: int) -> np.ndarray:
        if weights is not None:
            p = np.asarray(weights, np.float64)
            return rng.choice(n, size=count, replace=True, p=p / p.sum())
        idx = rng.permutation(n) if shuffle else np.arange(n)
        if steps is None:
            pad = (-np.ones(count - n, np.int64) if count > n
                   else np.empty(0, np.int64))
            return np.concatenate([idx, pad])
        reps = int(np.ceil(count / n))
        return np.tile(idx, reps)[:count]

    total = steps if steps is not None else int(np.ceil(n / batch_size))
    order = sample_indices(total * batch_size)

    if process_slice is not None:
        pid, pcount = process_slice
        if batch_size % pcount:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{pcount} processes")
        local_rows = range(pid * (batch_size // pcount),
                           (pid + 1) * (batch_size // pcount))
        row_seeds = rng.integers(0, 2**63 - 1, size=(total, batch_size))
    else:
        local_rows = range(batch_size)
        row_seeds = None

    rows = list(local_rows)
    local_b = len(rows)

    for step in range(total):
        images = np.zeros((local_b, s, s, 3), np.uint8)
        boxes = np.zeros((local_b, g, 4), np.float32)
        labels = np.zeros((local_b, g), np.int32)
        mask = np.zeros((local_b, g), bool)
        sample_valid = np.zeros(local_b, bool)
        indices = -np.ones(local_b, np.int64)
        for out_b, b in enumerate(rows):
            i = int(order[step * batch_size + b])
            if i < 0:
                continue  # tail padding slot
            indices[out_b] = i
            srng = (np.random.default_rng(row_seeds[step, b])
                    if row_seeds is not None else rng)
            img, bx, cl = dataset.load_letterboxed(i)
            if augment:
                if mosaic_p > 0 and srng.uniform() < mosaic_p:
                    extra = [dataset.load_letterboxed(int(srng.integers(n)))
                             for _ in range(3)]
                    img, bx, cl = mosaic4(srng, [(img, bx, cl)] + extra, s)
                if copy_paste is not None:
                    img, bx, cl = copy_paste(img, bx, cl)
                img, bx, cl = augment_sample(srng, img, bx, cl)
                if mixup_p > 0 and srng.uniform() < mixup_p:
                    j = int(srng.integers(n))
                    img2, bx2, cl2 = dataset.load_letterboxed(j)
                    img2, bx2, cl2 = augment_sample(srng, img2, bx2, cl2)
                    img, bx, cl = mixup(
                        srng, (img, bx, cl), (img2, bx2, cl2))
            if corruption_p > 0:
                from .corruptions import maybe_corrupt

                img = maybe_corrupt(srng, img, corruption_p)
            k = min(len(bx), g)
            images[out_b] = img
            boxes[out_b, :k] = bx[:k]
            labels[out_b, :k] = cl[:k]
            mask[out_b, :k] = True
            sample_valid[out_b] = True
        yield {
            "images": images,
            "boxes": boxes,
            "labels": labels,
            "mask": mask,
            "sample_valid": sample_valid,
            "indices": indices,
        }
