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


def _blocked_view(x: np.ndarray, block: int) -> np.ndarray:
    """(..., H, W, C) -> a strided (..., H/b, W/b, b, b, C) view whose
    C-order copy is the space-to-depth layout."""
    *lead, h, w, c = x.shape
    y = x.reshape(*lead, h // block, block, w // block, block, c)
    nd = len(lead)
    return np.transpose(y, (*range(nd), nd, nd + 2, nd + 1, nd + 3, nd + 4))


def space_to_depth_np(x: np.ndarray, block: int = 2) -> np.ndarray:
    """(..., H, W, C) -> (..., H/b, W/b, b*b*C), channels in (di, dj, c)
    order; one numpy transpose-copy on the host."""
    *lead, h, w, c = x.shape
    return np.ascontiguousarray(_blocked_view(x, block)).reshape(
        *lead, h // block, w // block, block * block * c)


def merged_frame_np(frame: np.ndarray, out: np.ndarray | None = None
                    ) -> np.ndarray:
    """(..., S, S, 3) uint8 RGB -> (..., S/2, S/4, 24) merged host view.

    ``out``: a contiguous uint8 array of the merged shape (a pinned
    staging buffer) written in place, with no intermediate copy."""
    frame = np.asarray(frame)
    if out is None:
        blocked = space_to_depth_np(frame)
        *lead, hh, hw, c = blocked.shape
        return blocked.reshape(*lead, hh, hw // 2, 2 * c)
    view = _blocked_view(frame, 2)
    np.copyto(out.reshape(view.shape), view)
    return out


def nv12_to_rgb(y_plane: torch.Tensor, uv_plane: torch.Tensor
                ) -> torch.Tensor:
    """NV12 -> RGB float32 in [0, 255], BT.601 (the reference's
    ``nv12_to_rgb``).

    ``y_plane``: (H, W) uint8; ``uv_plane``: (H/2, W/2, 2) interleaved
    U, V, upsampled 2x nearest."""
    y = y_plane.float()
    uv = uv_plane.float()
    u = uv[..., 0].repeat_interleave(2, 0).repeat_interleave(2, 1) - 128.0
    v = uv[..., 1].repeat_interleave(2, 0).repeat_interleave(2, 1) - 128.0
    u = u[:y.shape[0], :y.shape[1]]
    v = v[:y.shape[0], :y.shape[1]]
    c = y - 16.0
    r = 1.164 * c + 1.596 * v
    g = 1.164 * c - 0.392 * u - 0.813 * v
    b = 1.164 * c + 2.017 * u
    return torch.stack([r, g, b], dim=-1).clamp(0.0, 255.0)
