"""Kernel 12: one int8 concat of the int8 chain, each part copied,
requantised or quantised on the way, one launch.

CUDA source: ``csrc/qconcat.cu``. It computes two functions of the
reference, each for parts that may be upsampled 2x (nearest) first:

- ``int8_concat``: the reference's ``qconcat`` of int8 parts: the output
  at the largest amax, each part at that amax copied (COPY), any other
  requantised to it (REQ, ``requantize``: ``clip(round(q * r))`` with the
  ratio ``r = scale_of(a) / scale_of(t)`` in f32);
- ``quantize_concat``: the reference's ``concat_features`` of float and
  int8 parts (an int8 part dequantised to bf16 first), then ``quantize``
  at a given amax: float parts Q (``clip(round(v / s_t))``, the quotient
  correctly rounded), int8 parts DEQ_Q (``QTensor.dequant`` to bf16, then
  Q). One float part alone is a conv's ``in_q``.

On a CUDA tensor the wrapper launches the kernel, or raises ValueError on
parts it does not take; on CPU tensors it runs the plain version, the
port's composition of the reference's functions
(``quant/qtensor.py``: ``upsample_nearest_2x_q``, ``requantize``,
``qconcat``, ``QTensor.dequant``, ``torch.cat``, ``quantize``). Every amax
is a calibrated host constant, so each launch's modes, ratios and scales
are built once on the host for each site (``_launch_args``) and a call
only adds the pointers.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from ...quant.qtensor import (
    QTensor,
    concat_float,
    qconcat,
    quantize,
    scale_of,
    upsample_nearest_2x,
    upsample_nearest_2x_q,
)
from ._lib import F, I, Kernel, P, check_cuda, stream_ptr

KERNEL = Kernel("unina_qconcat", [P, P, P, I, I, I, I, I, F, P, P])
COPY, REQ, Q, DEQ_Q = 0, 1, 2, 3
MAX_PARTS = 8
DTYPES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}

# The shipped frame's nine launches at batch 1 (the same in int8_s2dm_fc,
# b8 and camera), with their calibrated amaxes: (site, H, W, the output's
# amax, parts). A part is (channels, kind, amax, up): kind "s8" an int8
# part at ``amax`` (COPY at the output's amax, else REQ), "deq" an int8
# part dequantised (DEQ_Q), "bf16" a float part (Q, no amax); ``up``: the
# part is read at (h / 2, w / 2).
SHIPPED_SITES = (
    ("backbone.stage2_c3k2 input", 80, 80, np.float32(27.125),
     ((128, "bf16", None, False),)),
    ("backbone.stage2_c3k2 cat", 80, 80, np.float32(57.25),
     ((64, "s8", np.float32(57.25), False),
      (64, "s8", np.float32(22.5), False))),
    ("backbone.stage3_c3k2 cat", 40, 40, np.float32(32.25),
     ((128, "s8", np.float32(32.25), False),
      (128, "s8", np.float32(21.875), False))),
    ("neck.fpn_c3k2_1 input", 80, 80, np.float32(28.125),
     ((128, "s8", np.float32(7.90625), True),
      (128, "s8", np.float32(28.125), False))),
    ("neck.fpn_c3k2_1 cat", 80, 80, np.float32(42.5),
     ((64, "s8", np.float32(42.5), False),
      (64, "s8", np.float32(23.0), False))),
    ("neck.pan_c3k2_1 input", 80, 80, np.float32(23.875),
     ((64, "bf16", None, False), (128, "deq", np.float32(23.875), False))),
    ("neck.pan_c3k2_1 cat", 80, 80, np.float32(21.0),
     ((64, "s8", np.float32(20.25), False),
      (64, "s8", np.float32(21.0), False))),
    ("neck.pan_c3k2_2 input", 40, 40, np.float32(16.875),
     ((128, "s8", np.float32(12.625), False),
      (256, "s8", np.float32(16.875), False))),
    ("neck.pan_c3k2_2 cat", 40, 40, np.float32(22.25),
     ((128, "s8", np.float32(22.25), False),
      (128, "s8", np.float32(16.5), False))),
)


def _ups(up: Sequence[bool], n: int) -> tuple[bool, ...]:
    up = tuple(bool(u) for u in up) or (False,) * n
    if len(up) != n:
        raise ValueError(f"{len(up)} upsample flags for {n} parts")
    return up


def int8_concat_plain(xs: Sequence[QTensor], up: Sequence[bool] = ()
                      ) -> QTensor:
    """Plain PyTorch version of ``int8_concat``: each part upsampled where
    ``up`` says, then ``qconcat``."""
    up = _ups(up, len(xs))
    return qconcat([upsample_nearest_2x_q(x) if u else x
                    for x, u in zip(xs, up)])


def quantize_concat_plain(xs: Sequence, amax, up: Sequence[bool] = ()
                          ) -> QTensor:
    """Plain PyTorch version of ``quantize_concat``: each part upsampled
    where ``up`` says, int8 parts dequantised to bf16, the parts cast to
    their promoted type and concatenated, then ``quantize`` at ``amax``."""
    up = _ups(up, len(xs))
    xs = [(upsample_nearest_2x_q if isinstance(x, QTensor)
           else upsample_nearest_2x)(x) if u else x for x, u in zip(xs, up)]
    return quantize(concat_float(xs), amax)


@functools.lru_cache(maxsize=None)
def _launch_args(parts: tuple, amax: np.float32):
    """The host side of a launch, built once for a site: ``parts`` is
    ((channels, mode, dtype code, up, the part's amax or None), ...),
    ``amax`` the output's. -> (meta, f, s_t) as the C entry point takes
    them: four ints a part (channels, mode, dtype, up); a float a part
    (REQ: ``scale_of(a) / scale_of(t)`` in f32, as ``requantize``
    computes it; DEQ_Q: ``scale_of(a)``); the output's scale."""
    s_t = scale_of(amax)
    meta, f = [], []
    for c, mode, dtype, up, a in parts:
        meta += [c, mode, dtype, int(up)]
        f.append(float(scale_of(a) / s_t) if mode == REQ else
                 float(scale_of(a)) if mode == DEQ_Q else 0.0)
    n = len(parts)
    return (ctypes.c_int * (4 * n))(*meta), (ctypes.c_float * n)(*f), \
        float(s_t)


def _launch(xs: Sequence, modes: Sequence[int], up: tuple[bool, ...],
            amax: np.float32) -> QTensor:
    """One launch of the kernel over ``xs`` (QTensors or float tensors) in
    ``modes``, the output at ``amax``."""
    if not 0 < len(xs) <= MAX_PARTS:
        raise ValueError(f"the kernel takes 1..{MAX_PARTS} parts, "
                         f"got {len(xs)}")
    # a conv's float output may be a strided view; the kernel reads NHWC
    ts = [(x.q if isinstance(x, QTensor) else x).contiguous() for x in xs]
    b, h, w = None, None, None
    parts = []
    for i, (t, mode, u) in enumerate(zip(ts, modes, up)):
        if t.dtype not in DTYPES or (t.dtype == torch.int8) == (mode == Q):
            raise ValueError(f"part {i}: the kernel takes int8 for an int8 "
                             "part and bfloat16 or float32 for a float "
                             f"part, got {t.dtype}")
        check_cuda(t, f"part {i}", t.dtype)
        if t.ndim != 4:
            raise ValueError(f"part {i}: expected NHWC, got {tuple(t.shape)}")
        pb, ph, pw, c = t.shape
        ph, pw = (2 * ph, 2 * pw) if u else (ph, pw)
        if b is None:
            b, h, w = pb, ph, pw
        elif (pb, ph, pw) != (b, h, w):
            raise ValueError(f"part {i}: {tuple(t.shape)} (upsampled: {u}) "
                             f"does not match ({b}, {h}, {w})")
        a = xs[i].amax if isinstance(xs[i], QTensor) else None
        parts.append((c, mode, DTYPES[t.dtype], u,
                      None if a is None else np.float32(a)))
    meta, f, s_t = _launch_args(tuple(parts), np.float32(amax))
    c_out = sum(p[0] for p in parts)
    out = torch.empty((b, h, w, c_out), dtype=torch.int8, device=ts[0].device)
    ptrs = (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    KERNEL.launch(ptrs, meta, f, len(ts), b, h, w, c_out, s_t,
                  out.data_ptr(), stream_ptr(ts[0].device))
    return QTensor(out, np.float32(amax))


def int8_concat(xs: Sequence[QTensor], up: Sequence[bool] = ()) -> QTensor:
    """The reference's ``qconcat`` of int8 NHWC parts along channels, each
    upsampled 2x first where ``up`` says: one launch on the card (COPY
    and REQ parts at the largest amax), ``int8_concat_plain`` on the
    CPU."""
    up = _ups(up, len(xs))
    if not xs[0].q.is_cuda:
        return int8_concat_plain(xs, up)
    target = max(np.float32(x.amax) for x in xs)
    modes = [COPY if np.float32(x.amax) == target else REQ for x in xs]
    return _launch(xs, modes, up, target)


def quantize_concat(xs: Sequence, amax, up: Sequence[bool] = ()
                    ) -> QTensor:
    """The reference's ``concat_features`` of float and int8 NHWC parts
    along channels (each upsampled 2x first where ``up`` says), quantised
    at ``amax``: one launch on the card (Q and DEQ_Q parts),
    ``quantize_concat_plain`` on the CPU."""
    up = _ups(up, len(xs))
    first = xs[0].q if isinstance(xs[0], QTensor) else xs[0]
    if not first.is_cuda:
        return quantize_concat_plain(xs, amax, up)
    modes = [DEQ_Q if isinstance(x, QTensor) else Q for x in xs]
    return _launch(xs, modes, up, np.float32(amax))
