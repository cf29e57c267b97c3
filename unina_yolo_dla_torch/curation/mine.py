"""Difficulty-map mining CLI: run the detector over an unlabeled image
directory, score each image by prediction uncertainty (entropy /
loc_var), write ``difficulty_map.json`` for difficulty-weighted sampling
in the next training round (``data.dataset.load_difficulty_weights``).

    python -m unina_yolo_dla_torch.curation.mine --weights ckpt.msgpack \
        --images DIR [--mode entropy|loc_var] [--output difficulty_map.json]

The model is the train form of the checkpoint (``--weights``, read by
``utils/checkpoint.py``) in eval mode, on the card unless ``--device
cpu``; it returns raw (cls, reg) per level, so mining is a plain batched
forward.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator

import numpy as np

from ..data.dataset import YoloDataset, normalize_images
from .active_learning import ActiveLearner


def unlabeled_batches(
    image_dir: str | Path,
    img_size: int,
    batch_size: int = 8,
) -> Iterator[tuple[np.ndarray, list[str]]]:
    """Letterboxed, normalised image batches + their paths (labels absent
    is fine)."""
    ds = YoloDataset(image_dir, img_size=img_size)
    n = len(ds)
    for start in range(0, n, batch_size):
        idx = range(start, min(start + batch_size, n))
        imgs = np.stack([ds.load_letterboxed(i)[0] for i in idx])
        paths = [str(ds.image_paths[i]) for i in idx]
        yield normalize_images(imgs), paths


def mine_difficulty_map(
    model,
    variables,
    image_dir: str | Path,
    output_path: str | Path = "difficulty_map.json",
    mode: str = "entropy",
    batch_size: int = 8,
) -> dict[str, float]:
    """Score every image of ``image_dir`` with the port's train-form
    ``model`` (``variables``: port variables copied into it, or None for
    its own) and write the map, keyed by image stem."""
    learner = ActiveLearner(model, variables)
    img_size = model.config.input_size
    scores = learner.compute_difficulty_scores(
        unlabeled_batches(image_dir, img_size, batch_size), mode=mode)
    # keys by stem for robust matching in load_difficulty_weights
    out = {Path(k).stem: v for k, v in scores.items()}
    Path(output_path).write_text(json.dumps(out, indent=2, sort_keys=True))
    return out


def main(argv=None) -> None:
    import argparse

    from ..models.config import ModelConfig
    from ..models.detector import from_jax_variables
    from ..utils.checkpoint import load_msgpack_raw
    from ..utils.device import resolve_device

    p = argparse.ArgumentParser(
        description="Mine difficulty map from unlabeled images")
    p.add_argument("--weights", required=True, help=".msgpack variables")
    p.add_argument("--images", required=True)
    p.add_argument("--output", default="difficulty_map.json")
    p.add_argument("--mode", choices=("entropy", "loc_var"),
                   default="entropy")
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--base-channels", type=int, default=32)
    p.add_argument("--num-classes", type=int, default=4)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    cfg = ModelConfig(num_classes=args.num_classes,
                      base_channels=args.base_channels,
                      input_size=args.imgsz)
    tree = load_msgpack_raw(args.weights)
    tree.pop("calib_meta", None)
    model = from_jax_variables(tree, cfg, resolve_device(args.device))
    scores = mine_difficulty_map(model, None, args.images, args.output,
                                 args.mode, args.batch)
    print(f"mined {len(scores)} images -> {args.output}")


if __name__ == "__main__":
    main()
