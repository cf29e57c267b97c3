"""Offline activation calibration (the reference's ``quant/calibrate.py``):

1. pass 1 (``calib_max``): eval-mode forwards accumulating the running
   max|x| of every activation quantiser;
2. pass 2 (``calib_hist``, for "entropy" and "percentile"): the same
   batches again, filling a 2048-bin |x| histogram over [0, max];
3. on the host, each quantiser's amax: "max" the running max,
   "percentile" the p-th percentile of the |x| mass, "entropy" the
   TensorRT-style KL minimum, floored at the 99.9th percentile.

The result is a ``quant`` collection (nested dicts, a float32 amax a
quantiser, the reference's layout) for the QAT model and the int8
engine; ``save_calibration_cache`` writes it as the reference's JSON.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable, Iterable

import numpy as np
import torch
from torch.func import functional_call

from ..models.detector import UninaYoloDla, to_jax_variables, variables_of
from ..ops.preprocess import ensure_normalized


def _run_calib_pass(model, variables: dict[str, torch.Tensor],
                    calib: dict[str, torch.Tensor], batches: Iterable[Any],
                    max_batches: int, get_images: Callable[[Any], Any]
                    ) -> int:
    """Eval-mode forwards of ``model`` (a calibration mode) over at most
    ``max_batches`` batches; its quantisers accumulate into ``calib`` in
    place. Returns the number of images seen."""
    n = n_images = 0
    model.eval()
    with torch.no_grad():
        for batch in batches:
            images = get_images(batch)
            functional_call(model, {**variables, **calib},
                            (ensure_normalized(images),))
            n += 1
            n_images += int(images.shape[0])
            if n >= max_batches:
                break
    if n == 0:
        raise ValueError("calibration requires at least one batch "
                         "(parity: export_trt.py:155-157 hard-fails on "
                         "empty calibration data)")
    return n_images


def entropy_amax(hist: np.ndarray, upper: float,
                 num_quant_levels: int = 128,
                 start_bin: int = 128) -> float:
    """KL-minimising clip threshold from an |x| histogram.

    TensorRT-style: for each candidate bin count i, the clipped distribution
    P (outlier mass folded into the last bin) is compared to Q, the same
    distribution re-quantised to ``num_quant_levels`` uniform levels; the i
    minimising KL(P||Q) wins. The zero bin is dropped first (post-ReLU
    activations put most of their mass at exactly 0).
    """
    nbins = len(hist)
    hist = hist.astype(np.float64)
    hist = hist.copy()
    hist[0] = 0.0
    if hist.sum() <= 0 or upper <= 0:
        return float(upper)

    best_i, best_kl = nbins, np.inf
    total_tail = np.concatenate([np.cumsum(hist[::-1])[::-1][1:], [0.0]])
    for i in range(start_bin, nbins + 1):
        p = hist[:i].copy()
        p[i - 1] += total_tail[i - 1]  # clamp outliers into last bin
        psum = p.sum()
        if psum <= 0:
            continue

        # quantise first i bins into num_quant_levels groups
        idx = (np.arange(i) * num_quant_levels // i)
        q = np.zeros(num_quant_levels)
        np.add.at(q, idx, hist[:i])
        counts = np.zeros(num_quant_levels)
        np.add.at(counts, idx, (hist[:i] > 0).astype(np.float64))
        # expand Q back to i bins, spreading mass over occupied bins
        q_expanded = np.where(
            (counts[idx] > 0) & (hist[:i] > 0),
            q[idx] / np.maximum(counts[idx], 1), 0.0)

        mask = (p > 0) & (q_expanded > 0)
        if not mask.any():
            continue
        pm = p[mask] / psum
        qm = q_expanded[mask] / q_expanded.sum()
        kl = float(np.sum(pm * np.log(pm / qm)))
        if kl < best_kl:
            best_kl, best_i = kl, i

    return float(upper * best_i / nbins)


def percentile_amax(hist: np.ndarray, upper: float,
                    percentile: float = 99.99) -> float:
    if hist.sum() <= 0 or upper <= 0:
        return float(upper)
    cdf = np.cumsum(hist) / hist.sum()
    i = int(np.searchsorted(cdf, percentile / 100.0)) + 1
    return float(upper * min(i, len(hist)) / len(hist))


def _leaves(tree: dict, path: tuple = ()):
    """(path, leaf) in sorted-key order, as the reference's tree
    utilities flatten a dict."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def select_amax(calib_tree: dict[str, Any], method: str = "entropy",
                percentile: float = 99.99) -> dict[str, Any]:
    """``quant_calib`` collection (each quantiser {'amax': running max,
    ['hist': (2048,)]}) -> ``quant`` collection (each {'amax'})."""
    groups: dict[tuple, dict[str, np.ndarray]] = {}
    for keys, leaf in _leaves(calib_tree):
        groups.setdefault(keys[:-1], {})[keys[-1]] = np.asarray(leaf)

    out: dict[str, Any] = {}
    for parent, leaves in groups.items():
        upper = float(leaves.get("amax", np.zeros(())))
        hist = leaves.get("hist")
        if method == "max" or hist is None:
            amax = upper
        elif method == "percentile":
            amax = percentile_amax(hist, upper, percentile)
        else:
            # KL optimum floored at the p99.9 mass point (against
            # over-clipping spiky activation distributions)
            amax = max(entropy_amax(hist, upper),
                       percentile_amax(hist, upper, 99.9))
        node = out
        for k in parent:
            node = node.setdefault(k, {})
        node["amax"] = np.float32(amax)
    return out


def calibrate(model, variables: dict[str, dict[str, torch.Tensor]],
              batches_fn: Callable[[], Iterable[Any]],
              get_images: Callable[[Any], Any] = lambda b: b["images"],
              method: str = "entropy", max_batches: int = 30,
              min_images: int = 50) -> dict[str, Any]:
    """Two-pass calibration of ``variables`` (port variables: params and
    batch statistics) -> the ``quant`` collection.

    ``model``: the ``calib_max`` model (its own parameters unused), whose
    config gives the architecture and exclusions; pass 2 runs its
    ``calib_hist`` twin.
    ``batches_fn`` makes the batch iterable anew for each pass.
    ``min_images``: a hard floor on pass 1's images (the reference refuses
    to build an int8 engine from short calibration data); 0 only in
    tests and deliberate smoke runs."""
    cfg = model.config
    if cfg.quant is None or cfg.quant.mode != "calib_max":
        raise ValueError("calibrate takes the calib_max model")
    base = {name: t for coll in ("params", "batch_stats")
            for name, t in variables.get(coll, {}).items()}
    dev = next(iter(variables["params"].values())).device
    m_max = model
    m_hist = UninaYoloDla(None, cfg.with_quant("calib_hist")).to(dev)

    def fresh(m):
        return {k: torch.zeros_like(t)
                for k, t in variables_of(m).get("quant_calib", {}).items()}

    calib1 = fresh(m_max)
    n_images = _run_calib_pass(m_max, base, calib1, batches_fn(),
                               max_batches, get_images)
    if n_images < min_images:
        raise ValueError(
            f"calibration saw only {n_images} images; >= {min_images} "
            "required for a trustworthy int8 engine (parity: "
            "export_trt.py:547-551 hard-fails short calibration data). "
            "Add data / raise --calib-batches, or pass min_images=0 "
            "(--calib-min-images 0) for a deliberate smoke run.")
    if method == "max":
        return select_amax(to_jax_variables({"q": calib1})["q"], "max")

    calib2 = fresh(m_hist)
    for k, t in calib1.items():
        calib2[k].copy_(t)
    _run_calib_pass(m_hist, base, calib2, batches_fn(), max_batches,
                    get_images)
    return select_amax(to_jax_variables({"q": calib2})["q"], method)


def save_calibration_cache(quant_tree: dict[str, Any],
                           path: str | Path) -> None:
    """JSON calibration cache ({"a/b/amax": value}), the reference's
    ``calibration.cache`` analogue."""
    data = {"/".join(keys): float(v) for keys, v in _leaves(quant_tree)}
    Path(path).write_text(json.dumps(data, indent=2, sort_keys=True))


def load_calibration_cache(path: str | Path) -> dict[str, Any]:
    data = json.loads(Path(path).read_text())
    tree: dict[str, Any] = {}
    for key, val in data.items():
        node = tree
        parts = key.split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = np.float32(val)
    return tree
