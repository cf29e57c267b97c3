"""Kernel 3: per-level head decode into packed 7-float rows.

CUDA source: ``csrc/decode.cu``. Row layout per cell:
``[x1, y1, x2, y2, score, class, valid]`` (f32; class and valid are exact
small integers), the packing ``ops/decode.py`` gathers from.
"""
from __future__ import annotations

import torch

from ._lib import F, I, Kernel, P, check_cuda, stream_ptr

KERNEL = Kernel("unina_decode_level", [P, P, P, I, I, I, F, F, F, P])


def decode_level_plain(cls_logits: torch.Tensor, reg: torch.Tensor,
                       stride: int, conf_threshold: float,
                       q_factor: float) -> torch.Tensor:
    """Plain PyTorch version: (H, W, C) logits + (H, W, 4) TLBR -> (HW, 7)."""
    h, w, _ = cls_logits.shape
    dev = cls_logits.device
    probs = torch.sigmoid(cls_logits.float())
    scores, classes = probs.max(dim=-1)   # first maximum on ties
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    cx = (xs + 0.5) * float(stride)
    cy = (ys + 0.5) * float(stride)
    r = reg.float() * float(stride)
    x1, y1 = cx - r[..., 0], cy - r[..., 1]
    x2, y2 = cx + r[..., 2], cy + r[..., 3]
    if q_factor > 0.0:
        dw = (x2 - x1) * q_factor
        dh = (y2 - y1) * q_factor
        x1, y1, x2, y2 = x1 - dw, y1 - dh, x2 + dw, y2 + dh
    valid = scores > conf_threshold
    return torch.stack([x1, y1, x2, y2, scores, classes.float(),
                        valid.float()], dim=-1).reshape(h * w, 7)


def decode_level_packed(cls_logits: torch.Tensor, reg: torch.Tensor,
                        stride: int, conf_threshold: float,
                        q_factor: float) -> torch.Tensor:
    """(H, W, C) f32 logits + (H, W, 4) f32 TLBR -> (HW, 7) packed rows."""
    if not cls_logits.is_cuda:
        return decode_level_plain(cls_logits, reg, stride, conf_threshold,
                                  q_factor)
    h, w, c = cls_logits.shape
    check_cuda(cls_logits, "cls_logits", torch.float32)
    check_cuda(reg, "reg", torch.float32, (h, w, 4))
    if not 0 < c <= 16:
        raise ValueError(f"kernel takes 1..16 classes, got {c}")
    out = torch.empty((h * w, 7), dtype=torch.float32,
                      device=cls_logits.device)
    KERNEL.launch(cls_logits.data_ptr(), reg.data_ptr(), out.data_ptr(), h,
                  w, c, float(stride), float(conf_threshold),
                  float(q_factor), stream_ptr(cls_logits.device))
    return out
