"""Kernel 9: raw camera frame -> letterboxed (or stretched), normalised
model input, one pass.

CUDA source: ``csrc/camera.cu``. The reference's camera program converts
the colour of the whole frame (BGRA, RGB or NV12), resizes it with two
float32 interpolation matmuls, pads it into the (S, S) canvas with 114,
divides by 255 and normalises (``runtime/pipeline.py`` and
``ops/preprocess.py`` of the JAX package). ``CameraPreprocess`` does the
same for one camera geometry: on a CUDA frame one kernel launch (where
every tap weight is 0 or 1, one block a canvas row, the source row staged
in shared memory, 16-byte stores; else one thread a canvas pixel); on a
CPU frame the plain version, the reference's formula step by step.

The tables hold, for each output row (column) of the resized window, the
two source indices and float32 weights of that row of the interpolation
matrix (``ops.preprocess.interp_matrix``): where the two taps coincide at
the clamped edge, the one index with the two weights added, as the
matrix holds it. They are built on the host once, at configure time, with
the rest of the launch: the 3 x 256 table of the normalising formula
(``formula_table``, used where every weight is 0 or 1: ``lookup_form``),
in that form the canvas pixels a kernel step takes, the source columns
each step reads (``window_chunk``, ``step_spans``) and the tap indices as
an affine map where they are one (``affine_map``), and the launch
arguments themselves (``_Args``).
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
from ._lib import F, I, Kernel, P, check_cuda, stream_ptr

KERNEL = Kernel("unina_camera_preprocess", [P, P, P, P])
FORMATS = {"rgb": 0, "bgra": 1, "nv12": 2}
BYTES_PER_PIXEL = {"rgb": 3, "bgra": 4}   # the lookup form's formats
OUT_DTYPES = (torch.float32, torch.bfloat16)
PAD_VALUE = 114
# csrc/camera.cu: bytes of one staged source row run, canvas pixels
# staged per step
SRC_TILE = 8192
OUT_TILE = 640


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


def formula_table(mean: Sequence[float] = IMAGENET_MEAN,
                  std: Sequence[float] = IMAGENET_STD) -> torch.Tensor:
    """(3, 256) float32: ``camera_preprocess_plain``'s normalisation of
    every byte value v, ``(v / 255 - mean) / std`` per channel, with the
    plain version's own operations (IEEE float32 divisions: the same bits
    on the CPU and on the card)."""
    v = torch.arange(256, dtype=torch.float32).expand(3, 256)
    x = v / torch.tensor(255.0)
    m = torch.tensor(mean, dtype=torch.float32)[:, None]
    sd = torch.tensor(std, dtype=torch.float32)[:, None]
    return ((x - m) / sd).contiguous()


def lookup_form(geom: CameraGeometry, y_wts: np.ndarray,
                x_wts: np.ndarray) -> bool:
    """Whether the kernel normalises by ``formula_table``: RGB and BGRA
    frames whose every table weight is 0 or 1 (the first tap's 1, the
    second's 0), so that each interpolated value is one source byte. NV12
    never (BT.601 with the clip is not integral)."""
    return geom.fmt != "nv12" and all(
        bool((w[:, 0] == 1).all() and (w[:, 1] == 0).all())
        for w in (y_wts, x_wts))


def window_chunk(x_idx: np.ndarray, fmt: str) -> int:
    """Canvas pixels a step of the lookup form takes: the most, up to
    OUT_TILE, such that any run of as many consecutive window columns
    reads at most SRC_TILE bytes of a source row."""
    lo, hi = x_idx[:, 0].astype(np.int64), x_idx[:, 1].astype(np.int64)
    # the last column a run starting at each column may reach
    reach = np.searchsorted(hi, lo + SRC_TILE // BYTES_PER_PIXEL[fmt] - 1,
                            side="right")
    cut = reach < len(lo)   # runs that end before the window does
    runs = reach[cut] - np.flatnonzero(cut)
    return int(min([OUT_TILE, *runs.tolist()]))


def step_spans(geom: CameraGeometry, x_idx: np.ndarray, chunk: int
               ) -> np.ndarray:
    """(steps, 2) int32: the first and last source column each step of
    ``chunk`` canvas pixels of the lookup form reads, (0, -1) for a step
    with no window column."""
    _, _, new_w, _, pad_x = geom.window
    spans = []
    for p0 in range(0, geom.size, chunk):
        w0, w1 = max(p0, pad_x), min(p0 + chunk, pad_x + new_w)
        if w0 >= w1:
            spans.append((0, -1))
            continue
        lo, hi = int(x_idx[w0 - pad_x, 0]), int(x_idx[w1 - 1 - pad_x, 1])
        if (hi - lo + 1) * BYTES_PER_PIXEL[geom.fmt] > SRC_TILE:
            raise AssertionError(f"step at {p0}: {lo}..{hi} > SRC_TILE")
        spans.append((lo, hi))
    return np.asarray(spans, np.int32)


def affine_map(idx: np.ndarray) -> tuple[int, int]:
    """(i0, step) with ``idx[d] == (i0 + step * d, i0 + step * d)`` for
    every d, where the taps of a lookup form's (dst, 2) table are affine;
    else (0, -1)."""
    d = np.arange(len(idx))
    i0 = int(idx[0, 0])
    step = int(idx[1, 0]) - i0 if len(idx) > 1 else 0
    if step >= 0 and (idx == (i0 + step * d)[:, None]).all():
        return i0, step
    return 0, -1


class _Args(ctypes.Structure):
    """The kernel's launch arguments (``csrc/camera.cu`` ``Args``)."""

    _fields_ = [("cam_h", I), ("cam_w", I), ("size", I), ("new_h", I),
                ("new_w", I), ("pad_y", I), ("pad_x", I), ("chunk", I),
                ("fmt", I), ("table", I), ("out_bf16", I),
                ("y_i0", I), ("y_step", I), ("x_i0", I), ("x_step", I),
                ("y_idx", P), ("y_wts", P), ("x_idx", P), ("x_wts", P),
                ("spans", P), ("lut", P), ("mean", F * 3), ("std", F * 3),
                ("pad", F * 3)]


class CameraPreprocess(nn.Module):
    """One camera geometry's preprocessing: raw uint8 frame ->
    (S, S, 3) normalised model input in ``out_dtype``.

    The per-axis tap tables, the formula's table and, in the lookup form
    (``table``), each step's source span are buffers, built once here with
    the rest of the launch (``chunk``: canvas pixels a step of the lookup
    form, 0 in the division form, which has no steps; ``y_map``/``x_map``:
    the lookup form's tap indices as an affine map where they are one,
    which the kernel computes instead of loading). The launch
    arguments are built once, and again whenever ``.to``/``.cuda``/
    ``.cpu`` replace the buffers (``_apply``), where the buffers are also
    checked, so a call checks only its frame. A CUDA frame launches the
    kernel (one launch a call), a CPU frame runs
    ``camera_preprocess_plain``."""

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
        taps = {"y": axis_taps(new_h, src_h), "x": axis_taps(new_w, src_w)}
        for name, (idx, wts) in taps.items():
            self.register_buffer(f"{name}_idx", torch.from_numpy(idx))
            self.register_buffer(f"{name}_wts", torch.from_numpy(wts))
        self.table = lookup_form(geom, taps["y"][1], taps["x"][1])
        spans = np.zeros((0, 2), np.int32)
        self.chunk, self.y_map, self.x_map = 0, (0, -1), (0, -1)
        if self.table:
            self.chunk = window_chunk(taps["x"][0], geom.fmt)
            spans = step_spans(geom, taps["x"][0], self.chunk)
            self.y_map = affine_map(taps["y"][0])
            self.x_map = affine_map(taps["x"][0])
        self.register_buffer("spans", torch.from_numpy(spans))
        self.register_buffer("lut", formula_table(mean, std))
        self._frame_shape = torch.Size(geom.frame_shape)
        self._out_shape = (geom.size, geom.size, 3)
        self._build_args()

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        self._build_args()
        return self

    def _build_args(self) -> None:
        """The launch arguments of the buffers as they are now; on the
        card, the buffers are checked here, once."""
        g = self.geom
        _, new_h, new_w, pad_y, pad_x = g.window
        tables = {"y_idx": (torch.int32, (new_h, 2)),
                  "y_wts": (torch.float32, (new_h, 2)),
                  "x_idx": (torch.int32, (new_w, 2)),
                  "x_wts": (torch.float32, (new_w, 2)),
                  "spans": (torch.int32, tuple(self.spans.shape)),
                  "lut": (torch.float32, (3, 256))}
        self._device = self.lut.device
        if self._device.type == "cuda":
            for name, (dtype, shape) in tables.items():
                t = getattr(self, name)
                check_cuda(t, name, dtype, shape)
                if t.device != self._device:
                    raise ValueError(f"{name} on {t.device}, lut on "
                                     f"{self._device}")
        self._args = _Args(
            g.height, g.width, g.size, new_h, new_w, pad_y, pad_x,
            self.chunk, FORMATS[g.fmt], int(self.table),
            int(self.out_dtype == torch.bfloat16), *self.y_map, *self.x_map,
            *(getattr(self, name).data_ptr() for name in tables),
            (F * 3)(*self.mean), (F * 3)(*self.std),
            (F * 3)(*self.lut[:, PAD_VALUE].tolist()))
        self._args_ptr = ctypes.addressof(self._args)

    def forward(self, frame: torch.Tensor) -> torch.Tensor:
        if frame.shape != self._frame_shape or frame.dtype != torch.uint8:
            g = self.geom
            raise ValueError(f"expected a {g.frame_shape} uint8 {g.fmt} "
                             f"frame, got {tuple(frame.shape)} "
                             f"{frame.dtype}")
        if not frame.is_cuda:
            return camera_preprocess_plain(frame, self.geom, self.mean,
                                           self.std, self.out_dtype)
        # the cached device object: building frame.device costs more than
        # the comparison of indices
        if frame.get_device() != self._device.index:
            raise ValueError(f"frame on {frame.device}, the module's tables "
                             f"on {self._device}")
        if not frame.is_contiguous():
            raise ValueError("frame: expected a contiguous tensor")
        out = torch.empty(self._out_shape, dtype=self.out_dtype,
                          device=self._device)
        KERNEL.launch(frame.data_ptr(), out.data_ptr(), self._args_ptr,
                      stream_ptr(self._device))
        return out
