"""Many-scene accuracy of the port on one NVIDIA GPU against its own CPU
path (PyTorch/CUDA port; imports no JAX).

    python3 tools/torch_scene_accuracy.py [--seeds N]

Serves the synthetic scenes of seeds 1..N (``data/synthetic.py``,
default N = 16) through three engines from the committed int8 weights:

- the shipped artifact (``artifacts/serving_artifact``): on the card its
  captured CUDA graph (``ServingArtifact``), on the CPU the plain path;
- ``int8_s2dm_fc`` (the same weights with the fused C3k2 and head
  kernels, no fused stem): on the card ``build_serving_fn`` captured by
  ``runtime/aot.py``, on the CPU the plain path;
- the camera artifact (``artifacts/serving_artifact_cam``) on 1080x1920
  BGRA scenes as ``chip_smoke.py`` builds them (boxes and ground truth in
  camera pixels): on the card its captured graph, on the CPU the plain
  path.

The first two take the 640² RGB scenes.

For each engine it reports the worst box and score gap between card and
CPU over detections matched one to one by class and box, the scenes whose
detection counts differ, and mAP@50 and mAP@50-95 against the scenes'
ground truth for both (``metrics/map.py``, a numpy copy of the
reference's). It checks nothing against a limit: it measures. Prints one
JSON object and writes it to ``chiprun_out/torch_scene_accuracy.json``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from unina_yolo_dla_torch.data.synthetic import (  # noqa: E402
    SynthConfig,
    generate_image,
)
from unina_yolo_dla_torch.metrics.map import compute_map  # noqa: E402
from unina_yolo_dla_torch.models.config import ModelConfig  # noqa: E402
from unina_yolo_dla_torch.models.detector import (  # noqa: E402
    from_jax_variables,
)
from unina_yolo_dla_torch.ops.preprocess import merged_frame_np  # noqa: E402
from unina_yolo_dla_torch.quant.fake_quant import (  # noqa: E402
    PERF_EXCLUDE,
    QuantSpec,
)
from unina_yolo_dla_torch.runtime.aot import capture_serving_fn  # noqa: E402
from unina_yolo_dla_torch.runtime.artifact import (  # noqa: E402
    ServingArtifact,
)
from unina_yolo_dla_torch.runtime.pipeline import (  # noqa: E402
    build_serving_fn,
)
from unina_yolo_dla_torch.utils.checkpoint import (  # noqa: E402
    load_msgpack_raw,
)

ARTIFACT = REPO / "artifacts" / "serving_artifact"
ARTIFACT_CAM = REPO / "artifacts" / "serving_artifact_cam"
SIZE = 640
CAMERA = (1080, 1920)


def scene(seed: int):
    """(RGB frame, ground truth (M, 5) [cls, x1, y1, x2, y2] pixels)."""
    img, labels = generate_image(np.random.default_rng(seed),
                                 SynthConfig(image_size=SIZE, seed=seed))
    gt = np.array([[c, (cx - w / 2) * SIZE, (cy - h / 2) * SIZE,
                    (cx + w / 2) * SIZE, (cy + h / 2) * SIZE]
                   for c, cx, cy, w, h in labels], np.float32).reshape(-1, 5)
    return np.ascontiguousarray(img[..., ::-1]), gt


def camera_scene(seed: int):
    """(1080x1920 BGRA frame as a camera ring delivers it, ground truth
    (M, 5) [cls, x1, y1, x2, y2] in camera pixels)."""
    h, w = CAMERA
    bgr, labels = generate_image(np.random.default_rng(seed), SynthConfig(
        image_size=h, image_width=w, seed=seed))
    frame = np.concatenate([bgr, np.full((h, w, 1), 255, np.uint8)],
                           axis=-1)
    gt = np.array([[c, (cx - bw / 2) * w, (cy - bh / 2) * h,
                    (cx + bw / 2) * w, (cy + bh / 2) * h]
                   for c, cx, cy, bw, bh in labels],
                  np.float32).reshape(-1, 5)
    return frame, gt


def valid_set(dets) -> np.ndarray:
    """Detections -> (N, 6) [x1, y1, x2, y2, score, cls] of the valid."""
    v = dets.valid.cpu().numpy()
    return np.concatenate([dets.boxes.cpu().numpy()[v],
                           dets.scores.cpu().numpy()[v, None],
                           dets.classes.cpu().numpy()[v, None]], axis=1)


def gaps(a: np.ndarray, b: np.ndarray) -> tuple[float, float, int]:
    """Worst box and score gap over a one-to-one match of ``a`` into
    ``b`` by class and nearest box; and the detections left unmatched."""
    used, box, score, unmatched = set(), 0.0, 0.0, 0
    for row in a:
        cand = [j for j in range(len(b))
                if j not in used and b[j, 5] == row[5]]
        if not cand:
            unmatched += 1
            continue
        j = min(cand, key=lambda j: np.abs(b[j, :4] - row[:4]).max())
        used.add(j)
        box = max(box, float(np.abs(b[j, :4] - row[:4]).max()))
        score = max(score, float(abs(b[j, 4] - row[4])))
    return box, score, unmatched + len(b) - len(used)


def engines():
    """name -> (card frame fn, CPU frame fn), each RGB -> Detections."""
    card = ServingArtifact(ARTIFACT)
    cpu = ServingArtifact(ARTIFACT, device="cpu")
    c = card.config
    kw = dict(conf_threshold=c["conf_threshold"],
              iou_threshold=c["iou_threshold"], q_factor=c["q_factor"],
              max_detections=c["max_detections"])
    cfg = ModelConfig(
        quant=QuantSpec("int8_fused", exclude=PERF_EXCLUDE), deploy=True,
        stem_s2d=True, s2d_host=True, stage1_s2d=True, s2d_merged=True,
        fused_c3k2=True, fused_head=True)
    variables = load_msgpack_raw(ARTIFACT / "variables.msgpack")
    fc_graph = capture_serving_fn(
        build_serving_fn(from_jax_variables(variables, cfg), cfg, **kw),
        card.staged_shape, card.device)
    fc_cpu = build_serving_fn(from_jax_variables(variables, cfg, "cpu"),
                              cfg, **kw)

    def fc_card(rgb):
        return fc_graph(card.stage(rgb))

    def fc_plain(rgb):
        return fc_cpu(torch.from_numpy(merged_frame_np(rgb)))

    return {"shipped": (card, cpu), "int8_s2dm_fc": (fc_card, fc_plain),
            "camera": (ServingArtifact(ARTIFACT_CAM),
                       ServingArtifact(ARTIFACT_CAM, device="cpu"))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_scene_accuracy: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    seeds = range(1, args.seeds + 1)
    square = [scene(s) for s in seeds]
    camera = [camera_scene(s) for s in seeds]
    result = {"seeds": [1, args.seeds], "engines": {}}
    for name, (on_card, on_cpu) in engines().items():
        scenes = camera if name == "camera" else square
        per_scene, card_sets, cpu_sets = [], [], []
        for seed, (frame, gt) in enumerate(scenes, start=1):
            with torch.inference_mode():
                a, b = valid_set(on_card(frame)), valid_set(on_cpu(frame))
            card_sets.append(a)
            cpu_sets.append(b)
            box, score, unmatched = gaps(a, b)
            per_scene.append({"seed": seed, "gt": len(gt), "card": len(a),
                              "cpu": len(b), "max_box_err_px": box,
                              "max_score_err": score,
                              "unmatched": unmatched})
        gts = [gt for _, gt in scenes]
        maps = {w: compute_map(sets, gts, 4) for w, sets in
                (("card", card_sets), ("cpu", cpu_sets))}
        result["engines"][name] = {
            "max_box_err_px": max(s["max_box_err_px"] for s in per_scene),
            "max_score_err": max(s["max_score_err"] for s in per_scene),
            "count_differs": [s["seed"] for s in per_scene
                              if s["card"] != s["cpu"]],
            "map50": {w: m["map50"] for w, m in maps.items()},
            "map50_95": {w: m["map50_95"] for w, m in maps.items()},
            "scenes": per_scene}
    result["seconds"] = time.perf_counter() - t0
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "torch_scene_accuracy.json").write_text(json.dumps(result,
                                                              indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
