"""Kernel 10: the int8 convolution with its epilogue fused, one launch a
layer of the int8 engines.

CUDA source: ``csrc/int8_conv.cu`` (an implicit GEMM on the int8 tensor
cores). ``int8_conv`` launches it for a CUDA tensor and runs
``int8_conv_plain`` for a CPU tensor. The plain version is the port's
composition of the reference's XLA layer
(``unina_yolo_dla_tpu/quant/fake_quant.py:235-265`` and the ``out_q`` /
``add_q`` requants of ``models/blocks.py``), step by step:

    acc  = im2col(x) @ w.T                      int8 x int8 -> int32
    y    = fma(f32(acc), comb, bias)[..., :cout]
    out  = y                                    (no ``out_amax``)
    q1   = clip(round(relu(y) / s_out))         (``out_amax``: ConvBlock)
    out  = clip(round(fma(q1, s_out, res * s_res) / s_add))
                                                (``res``: Bottleneck cv2)

with ``s = max(amax, 1e-9) / 127`` for each amax. The kernel computes the
same single-precision steps (fmaf, IEEE division, round half to even), so
both agree bit for bit; the plain version emulates the FMA in float64
(``qtensor.fma_f32``), which can differ from a true FMA only by a double
rounding.

Geometries: 1x1 stride 1, 3x3 stride 1 and 3x3 stride 2, padding k // 2.
The kernel takes int8 NHWC ``x`` (C a multiple of 16), the weights as
``QuantConv`` holds them, (N, kh*kw*C) int8 with N a multiple of 8, f32
``comb`` and ``bias`` (N,), and ``cout <= N`` channels out.
"""
from __future__ import annotations

import torch

from ...quant.qtensor import fma_f32, quantize, scale_of
from ._lib import F, I, Kernel, P, check_cuda, stream_ptr

KERNEL = Kernel("unina_int8_conv",
                [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, F, F, F, P])
# (kernel size, stride) the kernel is compiled for; padding is k // 2
GEOMETRIES = ((1, 1), (3, 1), (3, 2))
# the epilogue: f32 out, ReLU + requant, and that plus the residual requant
F32, Q, QRES = 0, 1, 2


def _geometry(kh: int, kw: int, stride: int, padding) -> tuple[int, int]:
    """(kernel size, padding) of a square kernel with symmetric padding."""
    pads = ((padding,) * 4 if isinstance(padding, int) else
            tuple(p for pair in padding for p in pair))
    if kh != kw or len(set(pads)) != 1:
        return -1, -1
    return kh, pads[0]


def kernel_takes(kh: int, kw: int, stride: int, padding, c: int,
                 n: int) -> bool:
    """Whether the CUDA kernel computes this layer."""
    k, pad = _geometry(kh, kw, stride, padding)
    return ((k, stride) in GEOMETRIES and pad == k // 2 and c % 16 == 0
            and n % 8 == 0)


def out_size(h: int, w: int, k: int, stride: int) -> tuple[int, int]:
    pad = k // 2
    return (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1


def int8_conv_plain(xq: torch.Tensor, w: torch.Tensor, comb: torch.Tensor,
                    bias: torch.Tensor, kh: int, kw: int, stride: int,
                    padding, cout: int, out_amax=None,
                    res: torch.Tensor | None = None, res_amax=None,
                    add_amax=None) -> torch.Tensor:
    """Plain PyTorch version: im2col, ``torch._int_mm``, the float64-
    emulated FMA, then ReLU and the requant at ``out_amax`` and, with
    ``res``, the residual sum requantised at ``add_amax``. Returns the f32
    ``y`` (no ``out_amax``) or the int8 values."""
    from ...quant.fake_quant import int8_conv2d

    acc = int8_conv2d(xq, w, kh, kw, stride, padding)
    y = fma_f32(acc.float(), comb, bias)
    y = y[..., :cout] if y.shape[-1] != cout else y
    if out_amax is None:
        return y
    q1 = quantize(torch.relu(y), out_amax)
    if res is None:
        return q1.q
    s = fma_f32(q1.q.float(), float(q1.scale),
                res.float() * float(scale_of(res_amax)))
    return quantize(s, add_amax).q


def int8_conv(xq: torch.Tensor, w: torch.Tensor, comb: torch.Tensor,
              bias: torch.Tensor, kh: int, kw: int, stride: int, padding,
              cout: int, out_amax=None, res: torch.Tensor | None = None,
              res_amax=None, add_amax=None) -> torch.Tensor:
    """One int8 layer, its epilogue fused: (B, H, W, C) int8 -> (B, Ho, Wo,
    cout), f32 without ``out_amax``, else int8 (ReLU and requant at
    ``out_amax``; with ``res``, an int8 (B, Ho, Wo, cout) tensor at
    ``res_amax``, the residual sum requantised at ``add_amax``). For a
    CUDA tensor the kernel, for a CPU tensor ``int8_conv_plain``."""
    if not xq.is_cuda:
        return int8_conv_plain(xq, w, comb, bias, kh, kw, stride, padding,
                               cout, out_amax, res, res_amax, add_amax)
    check_cuda(xq, "xq", torch.int8)
    bsz, h, wd, c = xq.shape
    n = w.shape[0]
    if not kernel_takes(kh, kw, stride, padding, c, n):
        raise ValueError(
            f"int8 conv kernel takes k x k stride s in {GEOMETRIES}, "
            f"padding k // 2, C % 16 == 0, N % 8 == 0; got {kh}x{kw} "
            f"stride {stride} padding {padding}, C {c}, N {n}")
    if not 0 < cout <= n:
        raise ValueError(f"cout {cout} outside 1..{n}")
    check_cuda(w, "w", torch.int8, (n, kh * kw * c))
    check_cuda(comb, "comb", torch.float32, (n,))
    check_cuda(bias, "bias", torch.float32, (n,))
    for t, name in ((xq, "xq"), (w, "w")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: expected 16-byte aligned data")
    ho, wo = out_size(h, wd, kh, stride)
    shape = (bsz, ho, wo, cout)
    s_out = s_res = s_add = 0.0
    if out_amax is None:
        if res is not None:
            raise ValueError("a residual needs out_amax")
        mode, dtype = F32, torch.float32
    else:
        s_out = float(scale_of(out_amax))
        mode, dtype = Q, torch.int8
        if res is not None:
            check_cuda(res, "res", torch.int8, shape)
            s_res, s_add = float(scale_of(res_amax)), float(scale_of(
                add_amax))
            mode = QRES
    out = torch.empty(shape, dtype=dtype, device=xq.device)
    KERNEL.launch(xq.data_ptr(), w.data_ptr(), comb.data_ptr(),
                  bias.data_ptr(), 0 if res is None else res.data_ptr(),
                  out.data_ptr(), bsz, h, wd, c, n, cout, kh, stride, mode,
                  s_out, s_res, s_add, stream_ptr(xq.device))
    return out

