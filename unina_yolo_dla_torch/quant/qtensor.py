"""QTensor: an int8 activation tensor carrying its quantisation amax.

The tensor that flows between layers of the fused int8 engine. ``q`` is
int8 NHWC on the device; ``amax`` is a float32 value held on the HOST
(a numpy scalar): every amax of the shipped engine is a calibrated
constant, so each scale and rescale ratio is computed once in numpy f32
and reaches the device only as an exact f32 multiplier or as a 0-d
divisor tensor.

Scale convention: symmetric, the reference's ``scale = max(amax, 1e-9) /
127`` as its jitted program computes it: XLA turns the division by the
constant 127 into ``max(amax, 1e-9) * f32(1 / 127)``, with the amax a
constant or an argument of the graph alike, one f32 step from the IEEE
quotient at some amaxes (18.0 and 21.875 among the shipped ones). A
quotient of two values (``requantize``'s ratio, ``qadd``'s, ``v /
scale``) stays an IEEE division, as XLA computes it.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

QMAX = 127.0


# f32(1 / 127): the multiplier jitted XLA puts in place of the division
QMAX_RECIPROCAL = np.float32(1) / np.float32(QMAX)


def scale_of(amax) -> np.float32:
    """The reference's ``max(amax, 1e-9) / 127`` as jitted XLA computes it:
    ``max(amax, 1e-9) * f32(1 / 127)`` in float32 (``QTensor.scale``)."""
    return np.float32(max(np.float32(amax), np.float32(1e-9))) * \
        QMAX_RECIPROCAL


def scale_tensor(amax, device) -> torch.Tensor:
    """0-d f32 tensor of ``scale_of(amax)`` on ``device``.

    Dividing by a tensor on the same device is a true IEEE division; a
    Python-number divisor on CUDA becomes a multiply by its reciprocal,
    which rounds differently."""
    return torch.full((), float(scale_of(amax)), dtype=torch.float32,
                      device=device)


def _round_clip_int8(y: torch.Tensor) -> torch.Tensor:
    return torch.round(y).clamp_(-QMAX, QMAX).to(torch.int8)


@dataclasses.dataclass
class QTensor:
    """int8 values + the amax they were quantised with."""

    q: torch.Tensor      # int8, NHWC
    amax: np.float32     # host scalar

    @property
    def shape(self):
        return self.q.shape

    @property
    def scale(self) -> np.float32:
        return scale_of(self.amax)

    def dequant(self, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """QTensor -> float tensor (``(q * scale)`` in f32, then ``dtype``)."""
        return (self.q.float() * float(self.scale)).to(dtype)


def quantize(x: torch.Tensor, amax, scale: torch.Tensor | None = None
             ) -> QTensor:
    """float tensor -> QTensor: ``clip(round(x / scale), -127, 127)``.

    ``scale``: optional cached ``scale_tensor(amax, x.device)``."""
    amax = np.float32(amax)
    if scale is None:
        scale = scale_tensor(amax, x.device)
    return QTensor(_round_clip_int8(x.float() / scale), amax)


def requantize(x: QTensor, amax) -> QTensor:
    """Rescale an int8 tensor to a new amax (concat scale matching)."""
    amax = np.float32(amax)
    ratio = x.scale / scale_of(amax)
    return QTensor(_round_clip_int8(x.q.float() * float(ratio)), amax)


def qconcat(xs: list[QTensor], dim: int = -1) -> QTensor:
    """Concat on a common scale: the max of the input amaxes. Parts
    already at that amax are taken as they are (the rescale ratio would
    be exactly 1)."""
    target = max(np.float32(x.amax) for x in xs)
    parts = [x.q if np.float32(x.amax) == target else
             requantize(x, target).q for x in xs]
    return QTensor(torch.cat(parts, dim=dim), target)


def concat_float(xs, dim: int = -1) -> torch.Tensor:
    """Concat with any float input, as the reference's ``concat_features``:
    int8 inputs dequantised to bf16 first, the parts cast to their
    promoted type."""
    xs = [x.dequant(torch.bfloat16) if isinstance(x, QTensor) else x
          for x in xs]
    dt = functools.reduce(torch.promote_types, [x.dtype for x in xs])
    return torch.cat([x.to(dt) for x in xs], dim=dim)


def fma_f32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add.

    XLA's CPU backend contracts these epilogues into FMAs (measured:
    every element of its ``acc * s + b`` equals the FMA result); the
    product of two f32 values is exact in f64, so the f64 sum rounded to
    f32 reproduces the FMA (up to double rounding, rarer than 1 in 2^29)."""
    return (a.double() * (b.double() if torch.is_tensor(b) else float(b))
            + c.double()).float()


def qadd(a: QTensor, b: QTensor, out_amax) -> QTensor:
    """Residual add of two int8 tensors, requantised to ``out_amax``."""
    out_amax = np.float32(out_amax)
    out_scale = scale_of(out_amax)
    ra = float(a.scale / out_scale)
    rb = float(b.scale / out_scale)
    y = fma_f32(a.q.float(), ra, b.q.float() * rb)
    return QTensor(_round_clip_int8(y), out_amax)


def qmaxpool(x: QTensor, window: int, stride: int = 1) -> QTensor:
    """Max-pool on int8 values (scale-preserving). Runs in float32, which
    holds every int8 exactly; its -inf padding equals the reference's
    -128 padding because every window holds a real element."""
    pad = window // 2
    y = F.max_pool2d(x.q.float().permute(0, 3, 1, 2), window, stride, pad)
    return QTensor(y.permute(0, 2, 3, 1).to(torch.int8), x.amax)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of an NHWC tensor (any dtype)."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(
        b, 2 * h, 2 * w, c)


def upsample_nearest_2x_q(x: QTensor) -> QTensor:
    """Nearest 2x upsample on int8 (pure layout, scale-preserving)."""
    return QTensor(upsample_nearest_2x(x.q), x.amax)
