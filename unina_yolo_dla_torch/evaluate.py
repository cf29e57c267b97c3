"""Offline evaluation: mAP50 / mAP50-95 and small-object P/R/F1, the port's
counterpart of the reference's ``evaluate.py``.

One pass over the validation set: per batch the model in eval mode (its
uint8 images normalised on the device by ``ensure_normalized``), then one
decode launch for every level and image (``ops/decode.py decode_batch``,
exact top-K into ``max_detections`` slots, as ``lax.top_k`` orders them)
and one NMS launch (``ops/nms.py``), and one copy of the packed result to
the host. ``--save-json`` writes the ``predictions.json`` artifact with
each prediction and ground truth marked matched or not, for error triage
and mining.

The reference compiles its forward, decode and NMS once per (model config,
thresholds) into a module-level jit cache and counts its traces; the port
runs eagerly and has nothing to compile or cache, so neither exists here.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from .metrics.map import compute_map
from .metrics.small_object import SmallObjectMetric
from .models.config import ModelConfig
from .models.detector import model_inputs
from .ops.decode import decode_batch
from .ops.nms import nms
from .ops.preprocess import ensure_normalized
from .runtime.aot import pack_detections


def model_device(model: torch.nn.Module) -> torch.device:
    """The device a model's tensors live on."""
    for t in model.parameters():
        return t.device
    return next(model.buffers()).device


def predict_batches(
    model,
    variables,
    batches: Iterable[dict[str, np.ndarray]],
    conf_threshold: float = 0.25,
    iou_threshold: float = 0.45,
    q_factor: float = 0.0,
    max_detections: int = 300,
):
    """Yields (pred (N,6) [x1,y1,x2,y2,conf,cls] px, gt (M,5) [cls,xyxy]
    px, dataset index or -1) per valid image of each batch, the
    predictions in slot order (score descending).

    ``model``: the port's detector on its device; ``variables``: port
    variables it reads (params, batch statistics, the ``quant``
    collection), or None for its own."""
    cfg: ModelConfig = model.config
    dev = model_device(model)
    inputs = model_inputs(model, variables)
    model.eval()
    for batch in batches:
        B = batch["images"].shape[0]
        with torch.no_grad():
            images = torch.from_numpy(np.ascontiguousarray(
                batch["images"])).to(dev)
            outputs = functional_call(model, inputs,
                                      (ensure_normalized(images),))
            dets = nms(decode_batch(outputs, cfg.strides, conf_threshold,
                                    q_factor, max_detections),
                       iou_threshold)
            packed = pack_detections(dets).cpu().numpy()
        sample_valid = batch.get("sample_valid", np.ones(B, bool))
        indices = batch.get("indices", -np.ones(B, np.int64))
        for b in range(B):
            if not sample_valid[b]:
                continue
            valid = packed[b, :, 6] > 0
            pred = (packed[b, valid, :6] if valid.any()
                    else np.zeros((0, 6), np.float32))
            m = np.asarray(batch["mask"][b])
            gt = np.concatenate([
                np.asarray(batch["labels"][b])[m, None].astype(np.float32),
                np.asarray(batch["boxes"][b])[m],
            ], axis=1) if m.any() else np.zeros((0, 5), np.float32)
            yield pred, gt, int(indices[b])


def match_predictions(pred: np.ndarray, gt: np.ndarray,
                      iou_threshold: float = 0.5
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Greedy class-aware matching: (pred_matched, gt_matched) bool masks.

    Score-descending predictions claim the highest-IoU unmatched GT of
    their class at IoU >= threshold (the ``predictions.json``
    breakdown)."""
    pm = np.zeros(len(pred), bool)
    gm = np.zeros(len(gt), bool)
    if not len(pred) or not len(gt):
        return pm, gm
    px1, py1, px2, py2 = pred[:, 0], pred[:, 1], pred[:, 2], pred[:, 3]
    gx1, gy1, gx2, gy2 = gt[:, 1], gt[:, 2], gt[:, 3], gt[:, 4]
    ix1 = np.maximum(px1[:, None], gx1[None, :])
    iy1 = np.maximum(py1[:, None], gy1[None, :])
    ix2 = np.minimum(px2[:, None], gx2[None, :])
    iy2 = np.minimum(py2[:, None], gy2[None, :])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    pa = np.clip(px2 - px1, 0, None) * np.clip(py2 - py1, 0, None)
    ga = np.clip(gx2 - gx1, 0, None) * np.clip(gy2 - gy1, 0, None)
    iou = inter / np.maximum(pa[:, None] + ga[None, :] - inter, 1e-9)
    same_cls = pred[:, 5][:, None] == gt[:, 0][None, :]
    iou = np.where(same_cls, iou, 0.0)
    for i in np.argsort(-pred[:, 4]):
        j = int(np.argmax(np.where(gm, -1.0, iou[i])))
        if iou[i, j] >= iou_threshold and not gm[j]:
            pm[i], gm[j] = True, True
    return pm, gm


def _gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return out


def _allgather_records(records: list[tuple[np.ndarray, np.ndarray, int]],
                       group=None
                       ) -> list[tuple[np.ndarray, np.ndarray, int]]:
    """Combine every process's validation slice into the global record
    list, the same on every process (so the best-checkpoint decision stays
    in lockstep while each process predicted 1/P of the images): each
    contributes arrays padded to the gathered maxima."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    lims = torch.tensor([len(records),
                         max((len(p) for p, _, _ in records), default=0),
                         max((len(g) for _, g, _ in records), default=0)],
                        dtype=torch.int64, device=dev)
    L, D, G = (int(v) for v in torch.stack(_gather(lims, group)).amax(0))
    preds = np.zeros((L, max(D, 1), 6), np.float32)
    gts = np.zeros((L, max(G, 1), 5), np.float32)
    counts = np.zeros((L, 2), np.int64)
    idxs = np.full((L,), -2, np.int64)  # -2 == padding slot
    for i, (p, g, idx) in enumerate(records):
        preds[i, :len(p)] = p
        gts[i, :len(g)] = g
        counts[i] = (len(p), len(g))
        idxs[i] = idx
    gathered = {k: [t.cpu().numpy() for t in _gather(
        torch.from_numpy(v).to(dev), group)] for k, v in (
        ("preds", preds), ("gts", gts), ("counts", counts), ("idxs", idxs))}
    out = []
    for proc in range(len(gathered["idxs"])):
        for i in range(L):
            idx = int(gathered["idxs"][proc][i])
            if idx == -2:
                continue
            np_, ng = (int(v) for v in gathered["counts"][proc][i])
            out.append((gathered["preds"][proc][i, :np_],
                        gathered["gts"][proc][i, :ng], idx))
    out.sort(key=lambda r: r[2])
    return out


def save_predictions_json(records, path, image_paths=None,
                          small_size_threshold: int = 15,
                          match_iou: float = 0.5,
                          conf_threshold: float | None = None) -> None:
    """The ``predictions.json`` artifact: per image its predictions and
    ground truth with the matched and small flags."""
    images = []
    for pred, gt, idx in records:
        pm, gm = match_predictions(pred, gt, match_iou)
        name = (str(image_paths[idx]) if image_paths is not None and idx >= 0
                else int(idx))
        images.append({
            "image": name,
            "predictions": [
                {"bbox": [round(float(v), 2) for v in p[:4]],
                 "score": round(float(p[4]), 4),
                 "class": int(p[5]),
                 "matched": bool(pm[i]),
                 "small": bool(max(p[2] - p[0], p[3] - p[1])
                               < small_size_threshold)}
                for i, p in enumerate(pred)],
            "ground_truth": [
                {"bbox": [round(float(v), 2) for v in g[1:5]],
                 "class": int(g[0]),
                 "matched": bool(gm[i]),
                 "small": bool(max(g[3] - g[1], g[4] - g[2])
                               < small_size_threshold)}
                for i, g in enumerate(gt)],
        })
    payload = {
        "match_iou": match_iou,
        "conf_threshold": conf_threshold,
        "small_size_threshold": small_size_threshold,
        "num_images": len(images),
        "images": images,
    }
    Path(path).write_text(json.dumps(payload, indent=1))


def evaluate_model(
    model,
    variables,
    batches_fn,
    conf_threshold: float = 0.25,
    iou_threshold: float = 0.45,
    small_size_threshold: int = 15,
    process_gather: bool = False,
    save_json: str | Path | None = None,
    image_paths=None,
    group=None,
) -> dict[str, float]:
    """Full evaluation dict: mAP + small-object metrics.

    ``process_gather=True`` (several processes in ``group``, the default
    group where None): ``batches_fn`` yields only this process's slice of
    the validation set; the records are gathered so every process computes
    the same metrics from the global set. ``save_json`` writes
    predictions.json (on rank 0 only when gathering)."""
    cfg: ModelConfig = model.config
    img_size = cfg.input_size
    records = list(predict_batches(model, variables, batches_fn(),
                                   conf_threshold, iou_threshold))
    evaluate_model.last_local_images = len(records)

    gathering = (process_gather and dist.is_initialized()
                 and dist.get_world_size(group) > 1)
    if gathering:
        records = _allgather_records(records, group)

    small = SmallObjectMetric(size_threshold=small_size_threshold,
                              image_size=img_size)
    preds, gts = [], []
    for pred, gt, _idx in records:
        preds.append(pred)
        gts.append(gt)
        # SmallObjectMetric consumes normalised cxcywh
        if len(pred):
            p = pred.copy()
            cx = (p[:, 0] + p[:, 2]) / 2 / img_size
            cy = (p[:, 1] + p[:, 3]) / 2 / img_size
            w = (p[:, 2] - p[:, 0]) / img_size
            h = (p[:, 3] - p[:, 1]) / img_size
            p_n = np.stack([cx, cy, w, h, p[:, 4], p[:, 5]], 1)
        else:
            p_n = np.zeros((0, 6), np.float32)
        if len(gt):
            g = gt.copy()
            gx = (g[:, 1] + g[:, 3]) / 2 / img_size
            gy = (g[:, 2] + g[:, 4]) / 2 / img_size
            gw = (g[:, 3] - g[:, 1]) / img_size
            gh = (g[:, 4] - g[:, 2]) / img_size
            g_n = np.stack([g[:, 0], gx, gy, gw, gh], 1)
        else:
            g_n = np.zeros((0, 5), np.float32)
        small.update([p_n], [g_n])

    if save_json is not None and (not gathering
                                  or dist.get_rank(group) == 0):
        save_predictions_json(records, save_json, image_paths=image_paths,
                              small_size_threshold=small_size_threshold,
                              conf_threshold=conf_threshold)

    out = compute_map(preds, gts, cfg.num_classes)
    out.update(small.compute())
    return out


evaluate_model.last_local_images = 0


def load_checkpoint(model, path: str | Path, device=None) -> dict:
    """Port variables of ``model`` read from a flax msgpack checkpoint
    (every variable the model holds must be there; other entries, such
    as a ``quant`` collection the float model lacks, are dropped)."""
    from .models.detector import to_jax_variables, variables_from_jax
    from .utils.checkpoint import load_msgpack

    tree = load_msgpack(path, to_jax_variables(model))
    return variables_from_jax(tree, device or model_device(model))


def main(argv=None) -> None:
    import argparse

    from .data.dataset import YoloDataset, batch_iterator, load_dataset_yaml
    from .models.detector import create_model
    from .utils.device import resolve_device

    p = argparse.ArgumentParser(description="Evaluate a checkpoint "
                                "(mAP50/50-95 + small-object P/R/F1)")
    p.add_argument("--weights", required=True)
    p.add_argument("--data", required=True, help="dataset YAML")
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--base-channels", type=int, default=32)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--iou", type=float, default=0.45)
    p.add_argument("--save-json", default=None, metavar="PATH",
                   help="write predictions.json (per-image predictions + "
                        "matched/unmatched breakdown)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (the plain versions of the "
                        "kernels)")
    args = p.parse_args(argv)

    spec = load_dataset_yaml(args.data)
    ds = YoloDataset(spec["val"], img_size=args.imgsz)
    cfg = ModelConfig(num_classes=spec["nc"],
                      base_channels=args.base_channels,
                      input_size=args.imgsz)
    model = create_model(cfg, device=resolve_device(args.device))
    variables = load_checkpoint(model, args.weights)

    def batches():
        return batch_iterator(ds, args.batch, np.random.default_rng(0),
                              shuffle=False, augment=False)

    results = evaluate_model(model, variables, batches,
                             conf_threshold=args.conf,
                             iou_threshold=args.iou,
                             save_json=args.save_json,
                             image_paths=ds.image_paths)
    for k, v in results.items():
        print(f"  {k}: {v}")
    if args.save_json:
        print(f"  predictions written to {args.save_json}")


if __name__ == "__main__":
    main()
