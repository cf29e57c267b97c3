"""Frame preprocessing: ImageNet normalisation (``ensure_normalized``,
the training batch's, on the card through the normalize kernel), the
space-to-depth
staging of the s2d serving layouts, and the plain forms of the camera
path's bilinear resize and letterbox geometry.

The merged serving engine takes the (S, S, 3) RGB frame blocked 2x2 on
the host, ``(S/2, S/2, 12)`` in (di, dj, c) channel order, and viewed with
adjacent column pairs merged into channels, ``(S/2, S/4, 24)`` (a free
reshape of the same bytes). The normalize kernel then applies mean/std
tiled 8x (4x for the unmerged blocked frame of an ``s2d_host`` engine).

A camera engine takes the raw camera frame instead; its preprocessing
(colour, resize, pad, normalise) is one kernel
(``ops/cuda/camera_kernel.py``) whose plain version is built from the
functions here.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..models.config import IMAGENET_MEAN, IMAGENET_STD
from .cuda.preprocess_kernel import normalize as normalize_kernel


def normalize(rgb01: torch.Tensor, mean: Sequence[float] = IMAGENET_MEAN,
              std: Sequence[float] = IMAGENET_STD) -> torch.Tensor:
    """(..., C) RGB in [0, 1] -> ImageNet-normalised float32."""
    dev = rgb01.device
    m = torch.tensor(mean, dtype=torch.float32, device=dev)
    s = torch.tensor(std, dtype=torch.float32, device=dev)
    return (rgb01.float() - m) / s


def ensure_normalized(images: torch.Tensor) -> torch.Tensor:
    """uint8 RGB frames -> ImageNet-normalised float32, ``(x / 255 -
    mean) / std``; a float batch passes through (already normalised).

    On the card the uint8 batch goes through the normalize kernel in its
    float32 form (``ops/cuda/preprocess_kernel.py``), on the CPU through
    its plain version: the same formula, divisions included."""
    if images.dtype != torch.uint8:
        return images
    return normalize_kernel(images, out_dtype=torch.float32)


def _blocked_view(x: np.ndarray, block: int) -> np.ndarray:
    """(..., H, W, C) -> a strided (..., H/b, W/b, b, b, C) view whose
    C-order copy is the space-to-depth layout."""
    *lead, h, w, c = x.shape
    y = x.reshape(*lead, h // block, block, w // block, block, c)
    nd = len(lead)
    return np.transpose(y, (*range(nd), nd, nd + 2, nd + 1, nd + 3, nd + 4))


def space_to_depth_np(x: np.ndarray, block: int = 2,
                      out: np.ndarray | None = None) -> np.ndarray:
    """(..., H, W, C) -> (..., H/b, W/b, b*b*C), channels in (di, dj, c)
    order; one numpy transpose-copy on the host (into ``out``, a contiguous
    array of the blocked shape, where given)."""
    *lead, h, w, c = x.shape
    view = _blocked_view(x, block)
    if out is not None:
        np.copyto(out.reshape(view.shape), view)
        return out
    return np.ascontiguousarray(view).reshape(
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


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(..., H, W, C) -> (..., H/b, W/b, b*b*C), channels in (di, dj, c)
    order, as strided slices concatenated along channels: the on-device
    shuffle of a ``stem_s2d`` engine without ``s2d_host``."""
    parts = [x[..., di::block, dj::block, :]
             for di in range(block) for dj in range(block)]
    return torch.cat(parts, dim=-1)


def space_to_depth_rt(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(..., H, W, C) -> (..., H/b, W/b, b*b*C) by reshape and transpose,
    channels in (di, dj, c) order (the reference's on-device form)."""
    *lead, h, w, c = x.shape
    y = x.reshape(*lead, h // block, block, w // block, block, c)
    nd = len(lead)
    perm = (*range(nd), nd, nd + 2, nd + 1, nd + 3, nd + 4)
    return y.permute(perm).reshape(*lead, h // block, w // block,
                                   block * block * c)


def _bilinear_coords(dst: int, src: int, device=None):
    """Half-pixel source coordinates of one axis in float32: (i0, i1,
    frac), i0/i1 as int64 indices."""
    scale = src / dst
    coords = (torch.arange(dst, dtype=torch.float32, device=device)
              + 0.5) * scale - 0.5
    coords = coords.clamp(0.0, src - 1.0)
    i0 = torch.floor(coords).long()
    i1 = torch.clamp(i0 + 1, max=src - 1)
    return i0, i1, coords - i0.float()


def resize_bilinear(img: torch.Tensor, dst_h: int, dst_w: int
                    ) -> torch.Tensor:
    """(H, W, C) -> (dst_h, dst_w, C) float32 bilinear, the gather form:
    rows first, then columns."""
    src_h, src_w = img.shape[0], img.shape[1]
    img = img.float()
    y0, y1, fy = _bilinear_coords(dst_h, src_h, img.device)
    x0, x1, fx = _bilinear_coords(dst_w, src_w, img.device)
    top, bot = img[y0], img[y1]
    rows = top + (bot - top) * fy[:, None, None]
    left, right = rows[:, x0], rows[:, x1]
    return left + (right - left) * fx[None, :, None]


def interp_matrix(dst: int, src: int) -> np.ndarray:
    """(dst, src) float32 bilinear interpolation matrix, two nonzeros a
    row at most (one where the two taps coincide at the clamped edge and
    their weights add), the coordinates of ``_bilinear_coords`` in
    float64 as the reference computes them."""
    scale = src / dst
    coords = (np.arange(dst) + 0.5) * scale - 0.5
    coords = np.clip(coords, 0.0, src - 1.0)
    i0 = np.floor(coords).astype(np.int64)
    i1 = np.minimum(i0 + 1, src - 1)
    frac = (coords - i0).astype(np.float32)
    m = np.zeros((dst, src), np.float32)
    m[np.arange(dst), i0] += 1.0 - frac
    m[np.arange(dst), i1] += frac
    return m


def resize_bilinear_mxu(img: torch.Tensor, dst_h: int, dst_w: int
                        ) -> torch.Tensor:
    """(H, W, C) -> (dst_h, dst_w, C) float32 bilinear as two float32
    interpolation matmuls, ``Ry @ img @ Rx^T`` (rows first); the same
    function as ``resize_bilinear`` up to summation order."""
    src_h, src_w = img.shape[0], img.shape[1]
    ry = torch.from_numpy(interp_matrix(dst_h, src_h)).to(img.device)
    rx = torch.from_numpy(interp_matrix(dst_w, src_w)).to(img.device)
    x = img.float()
    # full float32 products, no TF32, as the reference pins
    # Precision.HIGHEST; the caller's setting is restored after
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        rows = torch.einsum("dh,hwc->dwc", ry, x)
        return torch.einsum("ew,dwc->dec", rx, rows)
    finally:
        torch.set_float32_matmul_precision(before)


def letterbox_geometry(ch: int, cw: int, s: int
                       ) -> tuple[float, int, int, int, int]:
    """A (ch, cw) camera frame letterboxed into an (s, s) canvas: (scale,
    new_h, new_w, pad_y, pad_x), the aspect-preserving resize and the
    centred pad, computed as the reference's camera program does."""
    scale = min(s / ch, s / cw)
    new_h, new_w = round(ch * scale), round(cw * scale)
    return scale, new_h, new_w, (s - new_h) // 2, (s - new_w) // 2
