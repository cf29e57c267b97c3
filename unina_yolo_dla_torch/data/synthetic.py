"""Synthetic FSD cone scenes (numpy only): noise background, four cone
classes drawn as triangles, sizes down to ~8 px, YOLO-format labels.

A copy of the reference generator's ``SynthConfig``/``generate_image``
(same drawing, same random stream for the same seed), so the port can make
its test scenes without the JAX package. Images are BGR (cv2 convention).
"""
from __future__ import annotations

import dataclasses

import numpy as np

# BGR colours per class (yellow, blue, orange, large_orange)
CLASS_COLORS = (
    (40, 220, 230),
    (200, 90, 30),
    (30, 110, 240),
    (10, 80, 250),
)
CLASS_NAMES = ("yellow_cone", "blue_cone", "orange_cone", "large_orange_cone")


@dataclasses.dataclass
class SynthConfig:
    image_size: int = 640
    # rectangular (camera-aspect) rendering: width defaults to image_size
    # (square). Set e.g. image_size=540, image_width=960 for a 16:9
    # camera-geometry set (the letterbox-vs-stretch A/B needs GT in real
    # camera aspect; labels normalise per-axis)
    image_width: int | None = None
    min_cones: int = 3
    max_cones: int = 12
    min_height: int = 8       # small-object regime included
    max_height: int = 90
    large_class_scale: float = 1.5
    seed: int = 42
    # --- hard-regime knobs (all off by default; see HARD preset) ---
    # fraction of cones forced into the small-object band — the 20 m+
    # cone mission profile (reference README.md:19: 10-15 px)
    small_fraction: float = 0.0
    # the forced small-cone height band, px (xhard narrows it to 5-12 px
    # so the small-object metric leaves its ceiling and can falsify)
    small_band: tuple[float, float] = (8.0, 15.0)
    # unlabeled distractor shapes (false-positive bait): gray rocks,
    # white line fragments, grass patches
    clutter: int = 0
    # probability a cone's lower part is occluded after drawing (label
    # keeps the full extent — localisation must infer it)
    occlusion_p: float = 0.0
    # background noise amplitude (+/-)
    noise: int = 18


# The "hard" evaluation regime (VERDICT r1 weakness #3: the default set
# saturates at mAP50 ~0.99, where the int8 "within 1 pt" acceptance bar
# cannot fail). Dominantly 8-15 px cones, dense scenes, clutter and
# occlusion; pair with a >=200-image val split.
HARD = SynthConfig(
    min_cones=6, max_cones=18,
    min_height=8, max_height=60,
    small_fraction=0.7,
    clutter=12,
    occlusion_p=0.3,
    noise=26,
)

# The "xhard" regime (VERDICT r2 weak #6: on HARD, small-object F1 still
# ceilings at 0.98 for every engine — a metric that cannot fail is not
# measuring the mission). Dominant band pushed to 5-12 px (several cones
# below one P2 stride cell), denser scenes, heavier clutter/occlusion/
# noise — tuned until engines measurably separate on small-F1.
XHARD = SynthConfig(
    min_cones=10, max_cones=24,
    min_height=5, max_height=48,
    small_fraction=0.85,
    small_band=(5.0, 12.0),
    clutter=20,
    occlusion_p=0.45,
    noise=32,
)


def _draw_triangle(img: np.ndarray, cx: float, by: float, w: float, h: float,
                   color: tuple[int, int, int]) -> None:
    """Filled isoceles triangle (apex up) via barycentric half-plane masks."""
    hgt, wid = img.shape[:2]
    x0 = max(int(cx - w / 2) - 1, 0)
    x1 = min(int(cx + w / 2) + 2, wid)
    y0 = max(int(by - h) - 1, 0)
    y1 = min(int(by) + 2, hgt)
    if x0 >= x1 or y0 >= y1:
        return
    ys, xs = np.mgrid[y0:y1, x0:x1]
    # apex (cx, by-h), base corners (cx±w/2, by)
    ax, ay = cx, by - h
    lx, rx = cx - w / 2, cx + w / 2
    # inside if below both slanted edges and above the base
    left_edge = (xs - ax) * (by - ay) - (ys - ay) * (lx - ax)
    right_edge = (xs - ax) * (by - ay) - (ys - ay) * (rx - ax)
    inside = (left_edge >= 0) & (right_edge <= 0) & (ys <= by) & (ys >= ay)
    img[y0:y1, x0:x1][inside] = color


def _add_stripe(img: np.ndarray, cx: float, by: float, w: float, h: float
                ) -> None:
    """White band across the cone midsection (visual realism cue)."""
    hgt, wid = img.shape[:2]
    y_mid0 = int(by - 0.55 * h)
    y_mid1 = int(by - 0.40 * h)
    x0 = max(int(cx - w * 0.3), 0)
    x1 = min(int(cx + w * 0.3), wid)
    y_mid0, y_mid1 = max(y_mid0, 0), min(y_mid1, hgt)
    if y_mid0 < y_mid1 and x0 < x1:
        region = img[y_mid0:y_mid1, x0:x1]
        region[region.sum(-1) > 90] = (240, 240, 240)


def generate_image(
    rng: np.random.Generator,
    cfg: SynthConfig = SynthConfig(),
) -> tuple[np.ndarray, list[tuple[int, float, float, float, float]]]:
    """One image + YOLO labels [(cls, cx, cy, w, h) normalised]."""
    s = cfg.image_size
    sw = cfg.image_width or s
    # textured background: low-frequency gradient + noise
    base = rng.integers(60, 140)
    img = np.full((s, sw, 3), base, np.uint8)
    grad = np.linspace(0, rng.integers(10, 50), s, dtype=np.int16)
    img = np.clip(img.astype(np.int16) + grad[:, None, None]
                  + rng.integers(-cfg.noise, cfg.noise, (s, sw, 3),
                                 dtype=np.int16),
                  0, 255).astype(np.uint8)

    n = int(rng.integers(cfg.min_cones, cfg.max_cones + 1))
    labels: list[tuple[int, float, float, float, float]] = []
    occupied: list[tuple[float, float, float, float]] = []

    # clamp cone size so placement is always feasible at small image sizes
    max_h = min(cfg.max_height, s // 3)
    min_h = min(cfg.min_height, max(max_h - 1, 2))

    # unlabeled clutter first, so cones may partially overlay it (the
    # false-positive bait of real scenes: rocks, track lines, grass)
    for _ in range(cfg.clutter):
        kind = int(rng.integers(0, 3))
        ch = float(rng.uniform(4, 26))
        cx = float(rng.uniform(ch, sw - ch))
        cy = float(rng.uniform(ch, s - ch))
        if kind == 0:    # gray rock (rectangle)
            color = tuple(int(v) for v in rng.integers(70, 130, 3))
            x0, y0 = int(cx - ch / 2), int(cy - ch / 3)
            img[max(y0, 0):int(cy + ch / 3),
                max(x0, 0):int(cx + ch / 2)] = color
        elif kind == 1:  # white line fragment
            y0 = int(cy)
            img[max(y0, 0):min(y0 + 3, s),
                max(int(cx - ch), 0):min(int(cx + ch), sw)] = (235, 235, 235)
        else:            # grass/vegetation patch (greenish triangle)
            _draw_triangle(img, cx, cy, ch * 1.4, ch * 0.8,
                           (40, int(rng.integers(120, 180)), 50))

    for _ in range(n):
        cls = int(rng.integers(0, 4))
        if cfg.small_fraction > 0 and rng.uniform() < cfg.small_fraction:
            # the 20 m+ band (mAP_small regime, <15 px; xhard: 5-12 px)
            h = float(rng.uniform(*cfg.small_band))
        else:
            h = float(rng.uniform(min_h, max_h))
        w = h * (0.85 if cls != 3 else cfg.large_class_scale * 0.6)
        for _attempt in range(20):
            cx = float(rng.uniform(w / 2 + 2, sw - w / 2 - 2))
            by = float(rng.uniform(h + 2, s - 2))
            x1b, y1b = cx - w / 2, by - h
            x2b, y2b = cx + w / 2, by
            clash = any(not (x2b < ox1 or x1b > ox2 or y2b < oy1 or y1b > oy2)
                        for ox1, oy1, ox2, oy2 in occupied)
            if not clash:
                break
        else:
            continue
        occupied.append((x1b, y1b, x2b, y2b))
        _draw_triangle(img, cx, by, w, h, CLASS_COLORS[cls])
        if h > 14:
            _add_stripe(img, cx, by, w, h)
        if cfg.occlusion_p > 0 and rng.uniform() < cfg.occlusion_p:
            # occlude the cone's lower band with a background-ish block;
            # the label keeps the full extent
            occ_h = h * float(rng.uniform(0.15, 0.4))
            color = tuple(int(v) for v in rng.integers(60, 140, 3))
            img[max(int(by - occ_h), 0):min(int(by) + 1, s),
                max(int(cx - w / 2) - 1, 0):min(int(cx + w / 2) + 1, sw)] = \
                color
        labels.append((cls, cx / sw, (y1b + y2b) / 2 / s, w / sw, h / s))

    return img, labels
