"""The int8 engine's conv and activation quantiser (inference only).

``QuantSpec`` and the exclusion lists follow the reference; of the
quantisation modes only the deployed ``int8_fused`` engine is ported:

- ``ActQuant``: float -> QTensor boundary at a calibrated amax
  (``in_q``, ``out_q``, ``add_q``).
- ``QuantConv``: the int8 branch (int8 x int8 -> int32, then
  ``acc * (x_scale * w_scale) + bias`` in f32) and the float branch
  (excluded layers, in the compute dtype).

The int8 conv is im2col plus one integer matrix product (``torch._int_mm``
on the card and on the CPU alike); a hand-written Hopper int8 conv is
later work.
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .qtensor import QTensor, fma_f32, quantize, scale_tensor

# Full-precision layers of the QAT model: stem + P2 head.
DEFAULT_EXCLUDE = ("backbone/stem", "backbone/stage1_conv", "head_p2")

# The deployed int8 engine additionally keeps every 160^2 layer in bf16
# (chosen by the export CLI for ``--int8``).
PERF_EXCLUDE = DEFAULT_EXCLUDE + (
    "backbone/stage1_block",
    "backbone/stage2_conv",
    "neck/lateral_p2",
    "neck/fpn_c3k2_2",
    "neck/down1",
)


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Quantisation behaviour: ``mode`` is "off" or "int8_fused"."""

    mode: str = "off"
    exclude: tuple[str, ...] = DEFAULT_EXCLUDE
    # int8 weight scales per output channel (the last axis of an HWIO
    # kernel), or one per tensor (quant/deploy.py quantize_weights_int8)
    per_channel_weights: bool = True

    def __post_init__(self):
        if self.mode not in ("off", "int8_fused"):
            raise ValueError(f"unsupported quant mode {self.mode!r} "
                             "(the port serves 'off' and 'int8_fused')")

    def excluded(self, path: str) -> bool:
        return any(re.search(pat, path) for pat in self.exclude)

    def active(self, path: str) -> bool:
        return self.mode != "off" and not self.excluded(path)


class ActQuant(nn.Module):
    """float -> QTensor at a calibrated amax (the ``int8_fused`` branch)."""

    def __init__(self, amax) -> None:
        super().__init__()
        self.amax = np.float32(amax)
        if not self.amax > 0:
            raise ValueError(f"activation amax must be positive, got {amax}")
        self.register_buffer("scale", scale_tensor(self.amax, "cpu"))

    def forward(self, x: torch.Tensor) -> QTensor:
        return quantize(x, self.amax, self.scale)


def _pads(padding) -> tuple[int, int, int, int]:
    """int or ((top, bottom), (left, right)) -> (top, bottom, left, right)."""
    if isinstance(padding, int):
        return (padding,) * 4
    (t, b), (l, r) = padding
    return (t, b, l, r)


def im2col_nhwc(x: torch.Tensor, kh: int, kw: int, stride: int,
                padding) -> torch.Tensor:
    """(B, H, W, C) -> (B*Ho*Wo, kh*kw*C) patches in (kh, kw, c) order,
    the row order of an HWIO kernel reshaped to (kh*kw*C, O). Built from
    shifted strided slices of the zero-padded tensor (any dtype)."""
    t, b, l, r = _pads(padding)
    bsz, h, w, c = x.shape
    ho = (h + t + b - kh) // stride + 1
    wo = (w + l + r - kw) // stride + 1
    if kh == kw == 1 and stride == 1 and t == b == l == r == 0:
        return x.reshape(bsz * h * w, c)
    xp = F.pad(x, (0, 0, l, r, t, b))
    parts = [xp[:, i:i + stride * (ho - 1) + 1:stride,
                j:j + stride * (wo - 1) + 1:stride, :]
             for i in range(kh) for j in range(kw)]
    return torch.cat(parts, dim=-1).reshape(bsz * ho * wo, kh * kw * c)


def int8_conv2d(xq: torch.Tensor, w_nk: torch.Tensor, kh: int, kw: int,
                stride: int, padding) -> torch.Tensor:
    """int8 NHWC conv -> int32 NHWC accumulators.

    ``w_nk``: (N, kh*kw*C) int8, N a multiple of 8 (the CUDA integer
    product needs K and N multiples of 8 and more than 16 rows)."""
    bsz, h, w, _ = xq.shape
    t, b, l, r = _pads(padding)
    ho = (h + t + b - kh) // stride + 1
    wo = (w + l + r - kw) // stride + 1
    a = im2col_nhwc(xq, kh, kw, stride, padding)
    acc = torch._int_mm(a, w_nk.t())
    return acc.reshape(bsz, ho, wo, w_nk.shape[0])


class QuantConv(nn.Module):
    """Conv of the deployed engine; int8 branch when ``kernel`` is int8.

    Args:
        kernel: HWIO kernel (numpy; int8 for the int8 branch).
        bias: (O,) f32 folded bias, or None.
        stride, padding: conv geometry (``padding`` int or
            ((top, bottom), (left, right))).
        w_scale: (O,) per-output-channel weight scales (int8 branch).
        in_amax: calibrated input amax; the branch quantises a float
            input with it (a QTensor input carries its own scale).
        dtype: compute dtype of the float branch.
    """

    def __init__(self, kernel: np.ndarray, bias: np.ndarray | None,
                 stride: int = 1, padding=0, *,
                 w_scale: np.ndarray | None = None, in_amax=None,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        kh, kw, cin, cout = kernel.shape
        self.kh, self.kw, self.stride, self.padding = kh, kw, stride, padding
        self.cout = cout
        self.dtype = dtype
        self.int8 = kernel.dtype == np.int8
        bias = (np.zeros(cout, np.float32) if bias is None
                else np.array(bias, np.float32))
        if self.int8:
            if w_scale is None:
                raise ValueError("int8 kernel without w_scale")
            n8 = -(-cout // 8) * 8  # pad N to the integer product's 8
            w = np.zeros((n8, kh * kw * cin), np.int8)
            w[:cout] = kernel.reshape(kh * kw * cin, cout).T
            ws = np.zeros(n8, np.float32)
            ws[:cout] = w_scale
            bp = np.zeros(n8, np.float32)
            bp[:cout] = bias
            self.register_buffer("weight", torch.from_numpy(w))
            self.register_buffer("w_scale", torch.from_numpy(ws))
            self.register_buffer("bias", torch.from_numpy(bp))
            self.in_q = ActQuant(in_amax) if in_amax is not None else None
        else:
            if not isinstance(padding, int):
                raise ValueError("float branch takes symmetric int padding")
            w = torch.from_numpy(np.ascontiguousarray(
                kernel.astype(np.float32).transpose(3, 2, 0, 1)))
            self.register_buffer("weight", w.to(dtype))
            self.register_buffer("bias", torch.from_numpy(bias).to(dtype))

    def forward(self, x) -> torch.Tensor:
        if self.int8:
            if isinstance(x, QTensor):
                xq, xs = x.q, x.scale
            elif self.in_q is not None:
                qt = self.in_q(x)
                xq, xs = qt.q, qt.scale
            else:
                raise ValueError("float input to an int8 conv without in_q")
            acc = int8_conv2d(xq.contiguous(), self.weight, self.kh,
                              self.kw, self.stride, self.padding)
            comb = self.w_scale * float(xs)
            y = fma_f32(acc.float(), comb, self.bias)
            return y[..., :self.cout] if y.shape[-1] != self.cout else y
        if isinstance(x, QTensor):
            x = x.dequant(self.dtype)
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), self.weight,
                     stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1) + self.bias
