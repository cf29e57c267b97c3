"""Kernel 11: SPPF's three chained int8 max-pools and their concat, one
launch.

CUDA source: ``csrc/int8_sppf.cu``. The reference's int8 SPPF pools its
int8 input three times in a chain (``qmaxpool``: 5 x 5, stride 1, padding
2 of -128) and concatenates the four tensors, which share one amax, so
its ``qconcat`` rescales nothing. ``int8_sppf`` launches the kernel for a
CUDA tensor and runs ``int8_sppf_plain``, that composition
(``quant/qtensor.py`` ``qmaxpool`` three times, then ``qconcat``), for a
CPU tensor.
"""
from __future__ import annotations

import torch

from ...quant.qtensor import QTensor, qconcat, qmaxpool
from ._lib import I, Kernel, P, check_cuda, stream_ptr

KERNEL = Kernel("unina_int8_sppf", [P, P, I, I, I, I, P])
WINDOW = 5                          # the pool the kernel computes
SHIPPED_SHAPE = (1, 40, 40, 128)    # SPPF's input in the shipped frame


def int8_sppf_plain(x: QTensor, window: int = WINDOW) -> QTensor:
    """Plain PyTorch version: ``qmaxpool`` three times, chained, then
    ``qconcat`` of [x, y1, y2, y3]."""
    y1 = qmaxpool(x, window)
    y2 = qmaxpool(y1, window)
    y3 = qmaxpool(y2, window)
    return qconcat([x, y1, y2, y3])


def int8_sppf(x: QTensor, window: int = WINDOW) -> QTensor:
    """(B, H, W, C) int8 -> (B, H, W, 4C) int8 at x's amax: x and its
    ``window`` x ``window`` max-pools chained once, twice and three times.
    One launch for a CUDA tensor (5 x 5 pools only), the plain version
    for a CPU tensor."""
    q = x.q
    if not q.is_cuda:
        return int8_sppf_plain(x, window)
    if window != WINDOW:
        raise ValueError(f"the SPPF kernel pools {WINDOW} x {WINDOW}, "
                         f"got {window}")
    check_cuda(q, "x", torch.int8)
    if q.ndim != 4:
        raise ValueError(f"x: expected NHWC, got {tuple(q.shape)}")
    b, h, w, c = q.shape
    out = torch.empty((b, h, w, 4 * c), dtype=torch.int8, device=q.device)
    KERNEL.launch(q.data_ptr(), out.data_ptr(), b, h, w, c,
                  stream_ptr(q.device))
    return QTensor(out, x.amax)
