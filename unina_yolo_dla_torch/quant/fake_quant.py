"""Int8 quantisation: the deployed engine's conv and activation
quantiser, and the fake-quantisation of the train form (calibration and
QAT).

``QuantSpec`` and the exclusion lists follow the reference. The deployed
engines (inference only, BatchNorm folded):

- ``int8_fused``: ``ActQuant``, the float -> QTensor boundary at a
  calibrated amax (``in_q``, ``out_q``, ``add_q``); ``QuantConv``'s int8
  branch (int8 x int8 -> int32, then ``acc * (x_scale * w_scale) + bias``
  in f32) and its float branch (excluded layers, in the compute dtype).
- ``int8`` (the unfused int8 engine): the same int8 branch, its result in
  the compute dtype; every quantised conv quantises its float input
  through its own ``in_q``, and activations are float between layers.
- ``quantize`` (the folded QAT model): the float branch with the input
  fake-quantised at its calibrated ``in_q`` amax (``FakeQuant``) and the
  weights fake-quantised per output channel once at load, as the
  reference recomputes them every call.

The train form (``models/blocks.py`` ``Train*`` blocks), in the modes
``calib_max`` / ``calib_hist`` (pass-through, collecting a running max|x|
and a 2048-bin |x| histogram per quantiser: the ``quant_calib``
collection) and ``quantize`` (QAT: symmetric per-tensor fake-quant of each
conv input at its calibrated amax, the ``quant`` collection, and of its
weight per output channel at max|w|, with a straight-through round):

- ``TrainActQuant``: one quantiser and its collection's buffers.
- ``TrainQuantConv``: an HWIO ``kernel`` parameter (and ``bias``), its
  input quantiser ``in_q`` where the layer is quantised.

Numerics as the reference computes them: the clip's gradient is split at
a tie (``torch.clamp`` would pass all of it), and a bf16 activation is
quantised in float32 against its float32 amax, then cast back.

Each int8 conv is one launch of the hand-written Hopper kernel on the
card (``ops/cuda/int8_conv_kernel.py``, ``csrc/int8_conv.cu``), its
dequant, ReLU and ``out_q`` requant fused, and in a bottleneck's ``cv2``
the residual sum and its ``add_q`` requant too; on the CPU the same layer
runs as the kernel's plain version: im2col, one integer matrix product
(``torch._int_mm``), the float64-emulated FMA, ReLU and the requants.
"""
from __future__ import annotations

import dataclasses
import math
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda.int8_conv_kernel import int8_conv
from ..ops.cuda.qconcat_kernel import quantize_concat
from .qtensor import QTensor

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


HIST_BINS = 2048
# quant modes of the train form, and those that collect calibration stats
TRAIN_MODES = ("off", "calib_max", "calib_hist", "quantize")
CALIB_MODES = ("calib_max", "calib_hist")
# the deployed integer engines: dequantised between layers, or int8 chained
INT8_MODES = ("int8", "int8_fused")


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Quantisation behaviour: ``mode`` is "off", "calib_max",
    "calib_hist", "quantize" (the train form, and the folded QAT model),
    "int8" (the unfused int8 engine) or "int8_fused" (the fused int8
    engine)."""

    mode: str = "off"
    exclude: tuple[str, ...] = DEFAULT_EXCLUDE
    # int8 weight scales per output channel (the last axis of an HWIO
    # kernel), or one per tensor (quant/deploy.py quantize_weights_int8)
    per_channel_weights: bool = True
    num_bits: int = 8

    def __post_init__(self):
        if self.mode not in TRAIN_MODES + INT8_MODES:
            raise ValueError(f"unknown quant mode {self.mode!r}")

    @property
    def qmax(self) -> float:
        return float(2 ** (self.num_bits - 1) - 1)

    def excluded(self, path: str) -> bool:
        return any(re.search(pat, path) for pat in self.exclude)

    def active(self, path: str) -> bool:
        return self.mode != "off" and not self.excluded(path)


class ActQuant(nn.Module):
    """float -> QTensor at a calibrated amax (the ``int8_fused`` branch,
    and an int8 conv's ``in_q``): ``quantize_concat`` of one part, one
    kernel launch on the card."""

    def __init__(self, amax) -> None:
        super().__init__()
        self.amax = np.float32(amax)
        if not self.amax > 0:
            raise ValueError(f"activation amax must be positive, got {amax}")

    def forward(self, x: torch.Tensor) -> QTensor:
        return quantize_concat([x], self.amax)


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
    """int8 NHWC conv -> int32 NHWC accumulators: the product of the int8
    conv kernel's plain version (``int8_conv_kernel.int8_conv_plain``),
    which the port runs on the CPU; on the card the kernel computes it.

    ``w_nk``: (N, kh*kw*C) int8, N a multiple of 8 (``torch._int_mm`` on
    CUDA needs K and N multiples of 8 and more than 16 rows)."""
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
        in_amax: calibrated input amax; the int8 branch quantises a float
            input with it (a QTensor input carries its own scale).
        dtype: compute dtype of the float branch.
        int8_out: dtype of the int8 branch's result: float32 where the
            fused chain requantises it (``int8_fused``), the compute dtype
            in the unfused engine (``int8``).
        fake_in: float branch only: the ``FakeQuant`` the input goes
            through first (the folded QAT model's ``in_q``).

    The int8 branch is one ``int8_conv`` (the kernel on the card, its plain
    version on the CPU). ``out_amax`` (set by ``ConvBlock`` through
    ``fuse_requant``) fuses the block's ReLU and ``out_q`` requant: the
    result is then a QTensor; a call with ``res`` (a QTensor of the output's
    shape) and ``add_amax`` also adds the residual and requantises the sum
    (``Bottleneck``'s ``cv2``). ``comb = w_scale * x_scale`` is computed
    once for each input amax and kept (``_comb``): the layer's input amax is
    a calibrated constant.
    """

    def __init__(self, kernel: np.ndarray, bias: np.ndarray | None,
                 stride: int = 1, padding=0, *,
                 w_scale: np.ndarray | None = None, in_amax=None,
                 dtype: torch.dtype = torch.bfloat16,
                 int8_out: torch.dtype = torch.float32,
                 fake_in: nn.Module | None = None) -> None:
        super().__init__()
        self.int8_out = int8_out
        self.fake_in = fake_in
        kh, kw, cin, cout = kernel.shape
        self.kh, self.kw, self.stride, self.padding = kh, kw, stride, padding
        self.cout = cout
        self.dtype = dtype
        self.int8 = kernel.dtype == np.int8
        self.out_amax: np.float32 | None = None
        self._combs: dict[float, torch.Tensor] = {}
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

    def fuse_requant(self, out_amax) -> None:
        """Fuse ReLU and the requant at ``out_amax`` into the int8 branch."""
        if not self.int8:
            raise ValueError("only the int8 branch fuses a requant")
        self.out_amax = np.float32(out_amax)

    def _comb(self, xs) -> torch.Tensor:
        """``w_scale * x_scale`` (f32), kept for each input scale."""
        key = float(xs)
        comb = self._combs.get(key)
        if comb is None:
            comb = self._combs[key] = self.w_scale * key
        return comb

    def _apply(self, fn, *args, **kwargs):
        self._combs = {}   # the kept products follow the buffers
        return super()._apply(fn, *args, **kwargs)

    def forward(self, x, res: QTensor | None = None, add_amax=None):
        if self.int8:
            if isinstance(x, QTensor):
                xq, xs = x.q, x.scale
            elif self.in_q is not None:
                qt = self.in_q(x)
                xq, xs = qt.q, qt.scale
            else:
                raise ValueError("float input to an int8 conv without in_q")
            args = (xq.contiguous(), self.weight, self._comb(xs), self.bias,
                    self.kh, self.kw, self.stride, self.padding, self.cout)
            if self.out_amax is None:
                return int8_conv(*args).to(self.int8_out)
            if res is None:
                return QTensor(int8_conv(*args, self.out_amax),
                               self.out_amax)
            return QTensor(int8_conv(*args, self.out_amax, res.q.contiguous(),
                                     res.amax, add_amax), np.float32(add_amax))
        if isinstance(x, QTensor):
            x = x.dequant(self.dtype)
        if self.fake_in is not None:
            x = self.fake_in(x)
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), self.weight,
                     stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1) + self.bias


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round half to even, with a straight-through gradient."""
    return x + (torch.round(x) - x).detach()


def _const(like: torch.Tensor, value: float) -> torch.Tensor:
    """A 0-d tensor of ``value`` in ``like``'s dtype and device, filled on
    the device (no host copy: a captured CUDA graph can hold it)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """clip(x, lo, hi) as min(max(x, lo), hi): at a bound the gradient is
    split in half, as the reference's ``jnp.clip`` splits it."""
    return torch.minimum(torch.maximum(x, _const(x, lo)), _const(x, hi))


def fake_quant_tensor(x: torch.Tensor, amax: torch.Tensor, qmax: float
                      ) -> torch.Tensor:
    """Symmetric fake-quant at ``amax`` (0-d, or per channel broadcast
    against ``x``); amax <= 1e-8 passes ``x`` through. The scale in
    ``amax``'s dtype, the rest in the promoted type of ``x`` and ``amax``
    (float32 for a bf16 activation), the result in ``x``'s dtype. The
    gradient reaches ``amax`` where it carries one (the weights'
    max|w|)."""
    dt = torch.promote_types(x.dtype, amax.dtype)
    amax = torch.maximum(amax, _const(amax, 1e-9))
    scale = amax / _const(amax, qmax)
    q = ste_round(_clip(x.to(dt) / scale, -qmax, qmax)) * scale
    return torch.where(amax > 1e-8, q, x.to(dt)).to(x.dtype)


class FakeQuant(nn.Module):
    """The folded QAT model's activation quantiser: fake-quant at a
    calibrated amax (``quant/<path>/amax``), as the train form's
    ``TrainActQuant`` in ``quantize`` mode computes it."""

    def __init__(self, amax, num_bits: int = 8) -> None:
        super().__init__()
        self.qmax = float(2 ** (num_bits - 1) - 1)
        self.register_buffer("amax", torch.tensor(np.float32(amax)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fake_quant_tensor(x, self.amax, self.qmax)


def quant_weight(w: torch.Tensor, spec: QuantSpec, path: str
                 ) -> torch.Tensor:
    """The QAT weight fake-quant: amax = max|w| per output channel (the
    last axis of an HWIO kernel) or per tensor, not detached; ``w`` as it
    is outside ``quantize`` mode or on an excluded path."""
    if spec.mode != "quantize" or spec.excluded(path):
        return w
    if spec.per_channel_weights:
        amax = torch.amax(w.abs(), dim=(0, 1, 2), keepdim=True).float()
    else:
        amax = w.abs().max().float()
    return fake_quant_tensor(w, amax, spec.qmax)


class TrainActQuant(nn.Module):
    """An activation quantiser of the train form.

    ``calib_max``: passes ``x`` through, ``amax`` (0-d) takes the running
    max|x|. ``calib_hist``: passes ``x`` through, ``hist`` (2048 bins over
    [0, amax], a strided subsample of at most 2^21 elements a call) counts
    |x|. Both buffers form the ``quant_calib`` collection. ``quantize``:
    fake-quant at ``amax``, the calibrated threshold of the ``quant``
    collection (frozen: not a parameter)."""

    def __init__(self, spec: QuantSpec) -> None:
        super().__init__()
        if spec.mode not in TRAIN_MODES[1:]:
            raise ValueError(f"no activation quantiser in mode {spec.mode!r}")
        self.mode = spec.mode
        self.qmax = spec.qmax
        self.collection = ("quant_calib" if spec.mode in CALIB_MODES
                           else "quant")
        self.register_buffer("amax", torch.zeros((), dtype=torch.float32))
        if spec.mode == "calib_hist":
            self.register_buffer("hist", torch.zeros(HIST_BINS,
                                                     dtype=torch.float32))

    @staticmethod
    def at(spec: QuantSpec | None, path: str,
           modes: tuple[str, ...] = TRAIN_MODES[1:]
           ) -> "TrainActQuant | None":
        """The quantiser at ``path``, or None where ``spec``'s mode is not
        in ``modes`` or the path is excluded."""
        if spec is None or spec.mode not in modes or spec.excluded(path):
            return None
        return TrainActQuant(spec)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "quantize":
            return fake_quant_tensor(x, self.amax, self.qmax)
        with torch.no_grad():
            if self.mode == "calib_max":
                self.amax.copy_(torch.maximum(self.amax,
                                              x.abs().max().float()))
                return x
            absx = x.float().abs().reshape(-1)
            n, cap = absx.numel(), 1 << 21
            if n > cap:
                absx = absx[::-(-n // cap)]
            upper = torch.maximum(self.amax, self.amax.new_tensor(1e-9))
            idx = (absx / upper * HIST_BINS).to(torch.int32).clamp(
                0, HIST_BINS - 1)
            self.hist.add_(torch.bincount(idx, minlength=HIST_BINS).float())
        return x


class TrainQuantConv(nn.Module):
    """Conv of the train form: an HWIO ``kernel`` (float32 parameter,
    lecun-normal) and optional ``bias``, computed in ``dtype`` (input and
    kernel cast to it, the bias added in it). Where ``spec`` quantises
    ``path`` (any mode but "off", the path not excluded), the input goes
    through the ``in_q`` quantiser and, in ``quantize`` mode, the float32
    kernel through ``quant_weight`` before the cast."""

    def __init__(self, cin: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, *, use_bias: bool = False,
                 bias_init: float = 0.0, dtype: torch.dtype = torch.bfloat16,
                 spec: QuantSpec | None = None, path: str = "") -> None:
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.spec, self.path = spec or QuantSpec(), path
        self.kernel = nn.Parameter(torch.empty(k, k, cin, features))
        self.bias_init = bias_init
        self.bias = (nn.Parameter(torch.full((features,), bias_init))
                     if use_bias else None)
        self.in_q = TrainActQuant.at(self.spec, path + "/in_q")
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None
                         ) -> None:
        """lecun_normal (variance 1/fan_in, truncated at 2 sigma, as the
        reference initialises), the bias at its constant."""
        kh, kw, cin, _ = self.kernel.shape
        std = math.sqrt(1.0 / (kh * kw * cin)) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.kernel, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if self.bias is not None:
                self.bias.fill_(self.bias_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = self.kernel
        if self.in_q is not None:
            x = self.in_q(x)
            kernel = quant_weight(kernel, self.spec, self.path)
        w = kernel.to(self.dtype).permute(3, 2, 0, 1)
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), w,
                     stride=self.stride, padding=self.padding)
        y = y.permute(0, 2, 3, 1)
        return y + self.bias.to(self.dtype) if self.bias is not None else y
