"""Frame preprocessing: ImageNet normalisation and the host-side
space-to-depth staging of the merged serving layout.

The serving engine takes the (S, S, 3) RGB frame blocked 2x2 on the host,
``(S/2, S/2, 12)`` in (di, dj, c) channel order, and viewed with adjacent
column pairs merged into channels, ``(S/2, S/4, 24)`` (a free reshape of
the same bytes). The normalize kernel then applies mean/std tiled 8x.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..models.config import IMAGENET_MEAN, IMAGENET_STD


def normalize(rgb01: torch.Tensor, mean: Sequence[float] = IMAGENET_MEAN,
              std: Sequence[float] = IMAGENET_STD) -> torch.Tensor:
    """(..., C) RGB in [0, 1] -> ImageNet-normalised float32."""
    dev = rgb01.device
    m = torch.tensor(mean, dtype=torch.float32, device=dev)
    s = torch.tensor(std, dtype=torch.float32, device=dev)
    return (rgb01.float() - m) / s


def space_to_depth_np(x: np.ndarray, block: int = 2) -> np.ndarray:
    """(..., H, W, C) -> (..., H/b, W/b, b*b*C), channels in (di, dj, c)
    order; one numpy transpose-copy on the host."""
    *lead, h, w, c = x.shape
    y = x.reshape(*lead, h // block, block, w // block, block, c)
    nd = len(lead)
    perm = (*range(nd), nd, nd + 2, nd + 1, nd + 3, nd + 4)
    return np.ascontiguousarray(np.transpose(y, perm)).reshape(
        *lead, h // block, w // block, block * block * c)


def merged_frame_np(frame: np.ndarray) -> np.ndarray:
    """(..., S, S, 3) uint8 RGB -> (..., S/2, S/4, 24) merged host view."""
    blocked = space_to_depth_np(np.asarray(frame))
    *lead, hh, hw, c = blocked.shape
    return blocked.reshape(*lead, hh, hw // 2, 2 * c)
