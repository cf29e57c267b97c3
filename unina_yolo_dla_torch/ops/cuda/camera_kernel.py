"""Kernel 9: raw camera frame -> letterboxed (or stretched), normalised
model input, one pass.

CUDA source: ``csrc/camera.cu``. The reference's camera program converts
the colour of the whole frame (BGRA, RGB or NV12), resizes it with two
float32 interpolation matmuls, pads it into the (S, S) canvas with 114,
divides by 255 and normalises (``runtime/pipeline.py`` and
``ops/preprocess.py`` of the JAX package). ``CameraPreprocess`` does the
same for one camera geometry: on a CUDA frame one kernel launch, one
thread per canvas pixel reading its 2x2 taps through per-axis tables; on a
CPU frame the plain version, the reference's formula step by step.

The tables hold, for each output row (column) of the resized window, the
two source indices and float32 weights of that row of the interpolation
matrix (``ops.preprocess.interp_matrix``): where the two taps coincide at
the clamped edge, the one index with the two weights added, as the
matrix holds it. They are built on the host once, at configure time.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ...models.config import IMAGENET_MEAN, IMAGENET_STD
from ..preprocess import (
    interp_matrix,
    letterbox_geometry,
    nv12_to_rgb,
    resize_bilinear_mxu,
)
from ._lib import I, Kernel, P, check_cuda, stream_ptr

KERNEL = Kernel("unina_camera_preprocess",
                [P, P, I, I, I, I, I, I, I, I, P, P, P, P, P, P, I, P])
FORMATS = {"rgb": 0, "bgra": 1, "nv12": 2}
OUT_DTYPES = (torch.float32, torch.bfloat16)
PAD_VALUE = 114.0


@dataclasses.dataclass(frozen=True)
class CameraGeometry:
    """A camera of ``height`` x ``width`` in ``fmt`` served at an
    ``size`` x ``size`` model input, letterboxed or stretched."""

    height: int
    width: int
    fmt: str
    size: int
    letterbox: bool

    def __post_init__(self):
        if self.fmt not in FORMATS:
            raise ValueError(f"unknown camera format {self.fmt!r} "
                             f"(one of {', '.join(FORMATS)})")
        if self.fmt == "nv12" and (self.height % 2 or self.width % 2):
            raise ValueError("NV12 camera dims must be even")

    @property
    def frame_shape(self) -> tuple[int, ...]:
        """The raw frame: rgb (H, W, 3), bgra (H, W, 4), nv12 (H*3/2, W)
        (planar Y, then interleaved UV)."""
        h, w = self.height, self.width
        return {"rgb": (h, w, 3), "bgra": (h, w, 4),
                "nv12": (h * 3 // 2, w)}[self.fmt]

    @property
    def window(self) -> tuple[float, int, int, int, int]:
        """(scale, new_h, new_w, pad_y, pad_x) of the resized window in
        the canvas (scale 0 and no pad when stretched)."""
        if self.letterbox:
            return letterbox_geometry(self.height, self.width, self.size)
        return 0.0, self.size, self.size, 0, 0


def axis_taps(dst: int, src: int) -> tuple[np.ndarray, np.ndarray]:
    """The two nonzeros of each row of ``interp_matrix(dst, src)``:
    ((dst, 2) int32 source indices, (dst, 2) float32 weights); a row with
    one nonzero gets it twice, the second time with weight 0."""
    m = interp_matrix(dst, src)
    idx = np.zeros((dst, 2), np.int32)
    wts = np.zeros((dst, 2), np.float32)
    for d in range(dst):
        nz = np.flatnonzero(m[d])
        if not 1 <= len(nz) <= 2:
            raise AssertionError(f"row {d}: {len(nz)} nonzeros")
        idx[d] = (nz[0], nz[-1])
        wts[d] = (m[d, nz[0]], m[d, nz[1]] if len(nz) == 2 else 0.0)
    return idx, wts


def camera_rgb_plain(frame: torch.Tensor, geom: CameraGeometry
                     ) -> torch.Tensor:
    """The raw frame -> (H, W, 3) float32 RGB on [0, 255]: B/R swapped and
    alpha dropped, or NV12 converted (BT.601, clipped)."""
    if geom.fmt == "bgra":
        return frame[..., [2, 1, 0]].float()
    if geom.fmt == "nv12":
        h, w = geom.height, geom.width
        return nv12_to_rgb(frame[:h].reshape(h, w),
                           frame[h:].reshape(h // 2, w // 2, 2))
    return frame.float()


def camera_preprocess_plain(frame: torch.Tensor, geom: CameraGeometry,
                            mean: Sequence[float] = IMAGENET_MEAN,
                            std: Sequence[float] = IMAGENET_STD,
                            out_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """Plain PyTorch version, the reference's camera formula: colour,
    the two interpolation matmuls, the 114 canvas, ``/ 255``, then
    ``(x - mean) / std`` in float32, cast to ``out_dtype``."""
    dev = frame.device
    rgb = camera_rgb_plain(frame, geom)
    s = geom.size
    _, new_h, new_w, pad_y, pad_x = geom.window
    resized = resize_bilinear_mxu(rgb, new_h, new_w)
    if geom.letterbox:
        canvas = torch.full((s, s, 3), PAD_VALUE, dtype=torch.float32,
                            device=dev)
        canvas[pad_y:pad_y + new_h, pad_x:pad_x + new_w] = resized
        resized = canvas
    # tensor divisors: on CUDA a Python-number divisor becomes a multiply
    # by its reciprocal, which is not the reference's division
    x = resized / torch.tensor(255.0, device=dev)
    m = torch.tensor(mean, dtype=torch.float32, device=dev)
    sd = torch.tensor(std, dtype=torch.float32, device=dev)
    return ((x - m) / sd).to(out_dtype)


class CameraPreprocess(nn.Module):
    """One camera geometry's preprocessing: raw uint8 frame ->
    (S, S, 3) normalised model input in ``out_dtype``.

    The per-axis tap tables are buffers, built once here; the module
    follows ``.to(device)``. A CUDA frame launches the kernel (one launch
    a call), a CPU frame runs ``camera_preprocess_plain``."""

    def __init__(self, geom: CameraGeometry,
                 out_dtype: torch.dtype = torch.float32,
                 mean: Sequence[float] = IMAGENET_MEAN,
                 std: Sequence[float] = IMAGENET_STD) -> None:
        super().__init__()
        if out_dtype not in OUT_DTYPES:
            raise ValueError(f"out_dtype: float32 or bfloat16, got "
                             f"{out_dtype}")
        if len(mean) != 3 or len(std) != 3:
            raise ValueError("mean/std: three channels")
        self.geom, self.out_dtype = geom, out_dtype
        self.mean, self.std = tuple(mean), tuple(std)
        _, new_h, new_w, _, _ = geom.window
        src_h, src_w = geom.height, geom.width
        for name, (idx, wts) in (("y", axis_taps(new_h, src_h)),
                                 ("x", axis_taps(new_w, src_w))):
            self.register_buffer(f"{name}_idx", torch.from_numpy(idx))
            self.register_buffer(f"{name}_wts", torch.from_numpy(wts))

    def forward(self, frame: torch.Tensor) -> torch.Tensor:
        g = self.geom
        if tuple(frame.shape) != g.frame_shape or frame.dtype != torch.uint8:
            raise ValueError(f"expected a {g.frame_shape} uint8 {g.fmt} "
                             f"frame, got {tuple(frame.shape)} "
                             f"{frame.dtype}")
        if not frame.is_cuda:
            return camera_preprocess_plain(frame, g, self.mean, self.std,
                                           self.out_dtype)
        check_cuda(frame, "frame", torch.uint8)
        for name in ("y_idx", "x_idx"):
            check_cuda(getattr(self, name), name, torch.int32)
        for name in ("y_wts", "x_wts"):
            check_cuda(getattr(self, name), name, torch.float32)
        _, new_h, new_w, pad_y, pad_x = g.window
        s = g.size
        out = torch.empty((s, s, 3), dtype=self.out_dtype,
                          device=frame.device)
        fa = ctypes.c_float * 3
        KERNEL.launch(frame.data_ptr(), out.data_ptr(), FORMATS[g.fmt],
                      g.height, g.width, s, new_h, new_w, pad_y, pad_x,
                      self.y_idx.data_ptr(), self.y_wts.data_ptr(),
                      self.x_idx.data_ptr(), self.x_wts.data_ptr(),
                      fa(*self.mean), fa(*self.std),
                      int(self.out_dtype == torch.bfloat16),
                      stream_ptr(frame.device))
        return out
