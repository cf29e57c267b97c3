"""Offline auto-labeling: SAHI tiling -> open-vocab detector -> mask
refinement -> per-class NMS -> YOLO txt, the port's copy of the
reference's (numpy on the host: offline labeling, not the serving path).

Overlapping 640x640 slicing, text-prompted detector boxes per slice,
global per-class NMS merge, mask refinement to tight boxes, YOLO-format
output. The heavyweight external models (GroundingDINO, Segment Anything)
are injected as callables and gated behind lazy imports
(``load_groundingdino_detector``, ``load_sam_refiner`` raise
``ImportError`` where the packages are missing), so the pipeline runs
with any detector callable: ``AutoLabeler(detector)``.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Protocol, Sequence

import numpy as np

DEFAULT_PROMPTS = ("yellow traffic cone", "blue traffic cone",
                   "orange traffic cone", "large orange traffic cone")


class Detector(Protocol):
    """(rgb_tile (h,w,3) uint8, prompts) -> (boxes_xyxy (N,4), scores (N,),
    classes (N,)) in tile pixels."""

    def __call__(self, tile: np.ndarray, prompts: Sequence[str]
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]: ...


class Refiner(Protocol):
    """(rgb_image, boxes_xyxy) -> refined boxes_xyxy (mask-tightened)."""

    def __call__(self, image: np.ndarray, boxes: np.ndarray) -> np.ndarray: ...


def slice_image(
    img: np.ndarray,
    tile: int = 640,
    overlap: float = 0.2,
) -> list[tuple[np.ndarray, int, int]]:
    """Overlapping tiles covering the image: [(tile_img, x_off, y_off)]."""
    h, w = img.shape[:2]
    stride = max(int(tile * (1 - overlap)), 1)
    xs = list(range(0, max(w - tile, 0) + 1, stride)) or [0]
    ys = list(range(0, max(h - tile, 0) + 1, stride)) or [0]
    if xs[-1] + tile < w:
        xs.append(w - tile)
    if ys[-1] + tile < h:
        ys.append(h - tile)
    tiles = []
    for y in ys:
        for x in xs:
            y0, x0 = max(y, 0), max(x, 0)
            tiles.append((img[y0:y0 + tile, x0:x0 + tile], x0, y0))
    return tiles


def nms_per_class(
    boxes: np.ndarray, scores: np.ndarray, classes: np.ndarray,
    iou_threshold: float = 0.5,
) -> np.ndarray:
    """Greedy per-class NMS; returns kept indices (host-side numpy —
    offline labeling, not the serving path)."""
    keep: list[int] = []
    order = np.argsort(-scores)
    suppressed = np.zeros(len(boxes), bool)
    areas = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        rest = order[(order != i) & ~suppressed[order]
                     & (classes[order] == classes[i])]
        if len(rest) == 0:
            continue
        xx1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
        iou = inter / np.maximum(areas[i] + areas[rest] - inter, 1e-9)
        suppressed[rest[iou > iou_threshold]] = True
    return np.asarray(keep, np.int64)


class AutoLabeler:
    """SAHI-sliced open-vocabulary labeling to YOLO txt."""

    def __init__(
        self,
        detector: Detector,
        refiner: Refiner | None = None,
        prompts: Sequence[str] = DEFAULT_PROMPTS,
        tile: int = 640,
        overlap: float = 0.2,
        conf_threshold: float = 0.3,
        nms_iou: float = 0.5,
    ) -> None:
        self.detector = detector
        self.refiner = refiner
        self.prompts = prompts
        self.tile = tile
        self.overlap = overlap
        self.conf_threshold = conf_threshold
        self.nms_iou = nms_iou

    def label_image(self, img: np.ndarray) -> np.ndarray:
        """(H,W,3) RGB uint8 -> YOLO labels (N, 5) [cls, cx, cy, w, h] norm."""
        h, w = img.shape[:2]
        all_boxes, all_scores, all_classes = [], [], []
        for tile_img, x0, y0 in slice_image(img, self.tile, self.overlap):
            boxes, scores, classes = self.detector(tile_img, self.prompts)
            boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
            if boxes.shape[0] == 0:
                continue
            boxes[:, [0, 2]] += x0
            boxes[:, [1, 3]] += y0
            all_boxes.append(boxes)
            all_scores.append(np.asarray(scores, np.float32))
            all_classes.append(np.asarray(classes, np.int64))

        if not all_boxes:
            return np.zeros((0, 5), np.float32)
        boxes = np.concatenate(all_boxes)
        scores = np.concatenate(all_scores)
        classes = np.concatenate(all_classes)

        conf_mask = scores >= self.conf_threshold
        boxes, scores, classes = (boxes[conf_mask], scores[conf_mask],
                                  classes[conf_mask])
        if boxes.shape[0] == 0:
            return np.zeros((0, 5), np.float32)

        keep = nms_per_class(boxes, scores, classes, self.nms_iou)
        boxes, classes = boxes[keep], classes[keep]

        if self.refiner is not None:
            boxes = self.refiner(img, boxes)

        boxes = np.clip(boxes, 0, [[w, h, w, h]])
        cx = (boxes[:, 0] + boxes[:, 2]) / 2 / w
        cy = (boxes[:, 1] + boxes[:, 3]) / 2 / h
        bw = (boxes[:, 2] - boxes[:, 0]) / w
        bh = (boxes[:, 3] - boxes[:, 1]) / h
        ok = (bw > 1e-4) & (bh > 1e-4)
        return np.stack([classes[ok].astype(np.float32),
                         cx[ok], cy[ok], bw[ok], bh[ok]], axis=1)

    def label_directory(self, image_dir: str | Path,
                        label_dir: str | Path) -> int:
        import cv2

        image_dir, label_dir = Path(image_dir), Path(label_dir)
        label_dir.mkdir(parents=True, exist_ok=True)
        n = 0
        for p in sorted(image_dir.iterdir()):
            if p.suffix.lower() not in (".jpg", ".jpeg", ".png", ".bmp"):
                continue
            img = cv2.imread(str(p))
            if img is None:
                continue
            labels = self.label_image(img[..., ::-1])
            lines = [f"{int(c)} {cx:.6f} {cy:.6f} {w:.6f} {h:.6f}"
                     for c, cx, cy, w, h in labels]
            (label_dir / f"{p.stem}.txt").write_text("\n".join(lines) + "\n"
                                                     if lines else "")
            n += 1
        return n


def mask_refiner_from_masks(
    mask_fn: Callable[[np.ndarray, np.ndarray], np.ndarray]
) -> Refiner:
    """Wrap a (image, boxes)->masks predictor (e.g. SAM) into a box
    tightener: each box becomes the bounding rect of its mask."""

    def refine(image: np.ndarray, boxes: np.ndarray) -> np.ndarray:
        masks = mask_fn(image, boxes)  # (N, H, W) bool
        out = boxes.copy()
        for i, m in enumerate(masks):
            ys, xs = np.nonzero(m)
            if len(ys) > 0:
                out[i] = (xs.min(), ys.min(), xs.max() + 1, ys.max() + 1)
        return out

    return refine


def load_groundingdino_detector(
    config_path: str, checkpoint_path: str,
    box_threshold: float = 0.3, text_threshold: float = 0.25,
) -> Detector:
    """Real GroundingDINO detector (requires the external package +
    checkpoint; gated import so the rest of the pipeline works without)."""
    try:
        from groundingdino.util.inference import Model  # type: ignore
    except ImportError as e:  # pragma: no cover - external dependency
        raise ImportError(
            "groundingdino is not installed; pass a custom detector or "
            "install GroundingDINO to use open-vocabulary auto-labeling"
        ) from e

    model = Model(model_config_path=config_path,
                  model_checkpoint_path=checkpoint_path)

    def detect(tile, prompts):
        dets = model.predict_with_classes(
            image=tile[..., ::-1], classes=list(prompts),
            box_threshold=box_threshold, text_threshold=text_threshold)
        return dets.xyxy, dets.confidence, dets.class_id

    return detect


def load_sam_refiner(checkpoint_path: str,
                     model_type: str = "vit_b") -> Refiner:
    """Real SAM refiner (gated import)."""
    try:
        from segment_anything import (  # type: ignore
            SamPredictor,
            sam_model_registry,
        )
    except ImportError as e:  # pragma: no cover - external dependency
        raise ImportError(
            "segment_anything is not installed; omit the refiner or "
            "install SAM to use mask-tightened boxes") from e

    sam = sam_model_registry[model_type](checkpoint=checkpoint_path)
    predictor = SamPredictor(sam)

    def mask_fn(image, boxes):
        predictor.set_image(image)
        masks = []
        for b in boxes:
            m, _, _ = predictor.predict(box=b, multimask_output=False)
            masks.append(m[0])
        return np.asarray(masks)

    return mask_refiner_from_masks(mask_fn)


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="Auto-label images (SAHI + "
                                "GroundingDINO + SAM)")
    p.add_argument("--images", required=True)
    p.add_argument("--labels", required=True)
    p.add_argument("--dino-config", required=True)
    p.add_argument("--dino-checkpoint", required=True)
    p.add_argument("--sam-checkpoint", default=None)
    p.add_argument("--tile", type=int, default=640)
    p.add_argument("--overlap", type=float, default=0.2)
    p.add_argument("--conf", type=float, default=0.3)
    args = p.parse_args(argv)

    detector = load_groundingdino_detector(args.dino_config,
                                           args.dino_checkpoint)
    refiner = (load_sam_refiner(args.sam_checkpoint)
               if args.sam_checkpoint else None)
    labeler = AutoLabeler(detector, refiner, tile=args.tile,
                          overlap=args.overlap, conf_threshold=args.conf)
    n = labeler.label_directory(args.images, args.labels)
    print(f"labeled {n} images -> {args.labels}")


if __name__ == "__main__":
    main()
