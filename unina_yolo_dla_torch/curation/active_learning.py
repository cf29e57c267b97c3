"""Active learning: uncertainty scoring + coreset selection, the port's
counterpart of the reference's:

- entropy mode: max per-pixel-per-class binary sigmoid entropy over all
  pyramid levels.
- loc_var mode: max of ``1 - 2*|max_class_conf - 0.5|``.
- embeddings: global-average-pool of the backbone's P4+SPPF feature map,
  in float32.
- K-Center Greedy and MiniBatchKMeans coreset selection, with embedding
  caching.

Scoring runs on the model's device, one batched forward and reduction a
batch; only the (B,) score vector leaves the device. The coresets are
numpy on the host. ``kmeans_select`` imports scikit-learn when called:
where it is not installed it raises ``ImportError``; the K-Center method
needs nothing beyond numpy.
"""
from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from ..models.detector import load_variables


def binary_entropy_map(probs: torch.Tensor, eps: float = 1e-10
                       ) -> torch.Tensor:
    """Elementwise binary entropy of sigmoid probabilities."""
    return -(probs * torch.log(probs + eps)
             + (1.0 - probs) * torch.log(1.0 - probs + eps))


def entropy_scores(outputs) -> torch.Tensor:
    """Per-image difficulty: max binary entropy over levels x classes x HW."""
    per_level = []
    for cls_l, _reg in outputs:
        ent = binary_entropy_map(torch.sigmoid(cls_l.float()))
        per_level.append(ent.reshape(ent.shape[0], -1).amax(dim=1))
    return torch.stack(per_level).amax(dim=0)


def loc_var_scores(outputs) -> torch.Tensor:
    """Per-image difficulty: max closeness-to-0.5 of the top class conf."""
    per_level = []
    for cls_l, _reg in outputs:
        conf = torch.sigmoid(cls_l.float()).amax(dim=-1)   # (B, H, W)
        unc = 1.0 - (conf - 0.5).abs() * 2.0
        per_level.append(unc.reshape(unc.shape[0], -1).amax(dim=1))
    return torch.stack(per_level).amax(dim=0)


def kcenter_greedy(embeddings: np.ndarray, k: int,
                   seed: int = 0) -> list[int]:
    """K-Center Greedy: iteratively add the point farthest from the
    selected set."""
    n = len(embeddings)
    k = min(k, n)
    rng = np.random.default_rng(seed)
    emb = np.asarray(embeddings, np.float64)
    selected = [int(rng.integers(n))]
    dists = np.linalg.norm(emb - emb[selected[0]], axis=1)
    for _ in range(k - 1):
        nxt = int(np.argmax(dists))
        selected.append(nxt)
        dists = np.minimum(dists, np.linalg.norm(emb - emb[nxt], axis=1))
    return selected


def kmeans_select(embeddings: np.ndarray, k: int, seed: int = 0) -> list[int]:
    """MiniBatchKMeans: the sample nearest each centroid (needs
    scikit-learn)."""
    from sklearn.cluster import MiniBatchKMeans

    n = len(embeddings)
    k = min(k, n)
    km = MiniBatchKMeans(n_clusters=k, random_state=seed, n_init=3)
    km.fit(embeddings)
    selected = []
    for c in km.cluster_centers_:
        idx = int(np.argmin(np.linalg.norm(embeddings - c, axis=1)))
        if idx not in selected:
            selected.append(idx)
    # fill duplicates-removed slots with farthest remaining points
    i = 0
    while len(selected) < k and i < n:
        if i not in selected:
            selected.append(i)
        i += 1
    return selected[:k]


class ActiveLearner:
    """Uncertainty + diversity driven sample selection over a train-form
    model of the port (``models.detector``), in eval mode on its device.

    The reference pairs a model with its variables; the port's model
    holds its own: ``variables`` (port variables ``{collection: {name:
    tensor}}``, e.g. ``variables_from_jax`` of a checkpoint's tree) are
    copied into it (``load_variables``) where given."""

    def __init__(self, model, variables=None) -> None:
        if variables is not None:
            load_variables(model, variables)
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self._cached_embeddings: np.ndarray | None = None
        self._cached_paths: list[str] | None = None

    def _input(self, images: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(images, np.float32)).to(
            self.device)

    @torch.inference_mode()
    def _scores(self, images: np.ndarray, mode: str) -> np.ndarray:
        score_fn: Callable = (entropy_scores if mode == "entropy"
                              else loc_var_scores)
        return score_fn(self.model(self._input(images))).cpu().numpy()

    @torch.inference_mode()
    def _embed(self, images: np.ndarray) -> np.ndarray:
        _p2, _p3, _p4, p4_sppf = self.model.backbone(self._input(images))
        return p4_sppf.float().mean(dim=(1, 2)).cpu().numpy()

    def compute_difficulty_scores(
        self,
        batches: Iterable[tuple[np.ndarray, list[str]]],
        mode: str = "entropy",
    ) -> dict[str, float]:
        """``batches`` yields (images (B,H,W,3) normalised float32, paths).

        Returns {path: score} — the ``difficulty_map.json`` payload consumed
        by difficulty-weighted sampling (data.load_difficulty_weights).
        """
        scores: dict[str, float] = {}
        for images, paths in batches:
            for p, v in zip(paths, self._scores(images, mode)):
                scores[p] = float(v)
        return scores

    def query_uncertain_samples(
        self,
        batches: Iterable[tuple[np.ndarray, list[str]]],
        top_k: int = 100,
        mode: str = "entropy",
    ) -> list[str]:
        scores = self.compute_difficulty_scores(batches, mode)
        return sorted(scores, key=scores.get, reverse=True)[:top_k]

    def extract_embeddings(
        self, batches: Iterable[tuple[np.ndarray, list[str]]]
    ) -> tuple[np.ndarray, list[str]]:
        embs, paths = [], []
        for images, batch_paths in batches:
            embs.append(self._embed(images))
            paths.extend(batch_paths)
        return np.concatenate(embs), paths

    def coreset_selection(
        self,
        batches_fn: Callable[[], Iterable[tuple[np.ndarray, list[str]]]],
        target_size: int,
        method: str = "kcenter",
    ) -> list[str]:
        if self._cached_embeddings is None:
            self._cached_embeddings, self._cached_paths = (
                self.extract_embeddings(batches_fn()))
        select = kmeans_select if method == "kmeans" else kcenter_greedy
        idx = select(self._cached_embeddings, target_size)
        return [self._cached_paths[i] for i in idx]

    def invalidate_cache(self) -> None:
        self._cached_embeddings = None
        self._cached_paths = None
