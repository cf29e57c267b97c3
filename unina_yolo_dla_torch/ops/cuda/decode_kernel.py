"""Kernel 3: head decode and top-K compaction of all levels and all images.

CUDA source: ``csrc/decode.cu``. One wrapper call is one launch: the
kernel decodes every cell of every level of the B images, keeps the valid
ones, and writes each image's K slots (score descending, ties to the lower
cell index, then the first invalid cells in index order) into four
tensors. The plain version is the per-level decode, the concatenation and
a stable descending sort of the masked scores; the two agree bit for bit.

The kernel's scratch (a key list of B x cells, and a word per image that
counts its keys and its finished blocks) is allocated once per (device,
stream, B, cells), and every launch leaves the words at zero: launches on
one stream run in order, launches on different streams have their own
scratch. A CUDA graph keeps the scratch of the stream it was captured on,
so graphs captured on one stream (``torch.cuda.graph`` captures on one
side stream unless given another) must be replayed one at a time.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ._lib import F, I, Kernel, P, stream_ptr

KERNEL = Kernel("unina_decode_topk",
                [P, P, I, I, I, I, F, F, P, P, P, P, P, P, P])
MAX_K = 1024
MAX_CLASSES = 16
MAX_LEVELS = 3

_scratch: dict[tuple, list] = {}


def decode_level_plain(cls_logits: torch.Tensor, reg: torch.Tensor,
                       stride: int, conf_threshold: float,
                       q_factor: float) -> torch.Tensor:
    """(..., H, W, C) logits + (..., H, W, 4) TLBR -> (..., HW, 7) rows
    ``[x1, y1, x2, y2, score, class, valid]`` (class and valid as exact
    small floats)."""
    *lead, h, w, _ = cls_logits.shape
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
                        valid.float()], dim=-1).reshape(*lead, h * w, 7)


def decode_topk_plain(levels: Sequence[tuple[torch.Tensor, torch.Tensor]],
                      strides: Sequence[int], conf_threshold: float,
                      q_factor: float, max_detections: int):
    """Plain PyTorch version: (B, H, W, C) logits and (B, H, W, 4) TLBR per
    level -> (boxes (B, K, 4), scores (B, K), classes (B, K) int32,
    valid (B, K) bool), K = min(max_detections, cells)."""
    rows = torch.cat([decode_level_plain(c, r, s, conf_threshold, q_factor)
                      for (c, r), s in zip(levels, strides)], dim=1)
    valid = rows[..., 6] > 0.5
    masked = torch.where(valid, rows[..., 4], torch.full_like(rows[..., 4],
                                                              -1.0))
    k = min(max_detections, masked.shape[1])
    top_scores, order = torch.sort(masked, dim=1, descending=True,
                                   stable=True)
    top = torch.gather(rows, 1, order[:, :k, None].expand(-1, -1, 7))
    return (top[..., :4].contiguous(), top[..., 4].contiguous(),
            top[..., 5].to(torch.int32),
            (top[..., 6] > 0.5) & (top_scores[:, :k] > -0.5))


def _cells(t: torch.Tensor, name: str, b: int, h: int, w: int, c: int):
    """(B, H, W, c) f32 on the card, read as it lies when its cells have
    one stride and its channels are adjacent (the head's channel-slice
    views); anything else is copied first. -> (tensor, batch stride, cell
    stride) in elements."""
    if not t.is_cuda or t.dtype != torch.float32:
        raise ValueError(f"{name}: expected a float32 CUDA tensor")
    if tuple(t.shape) != (b, h, w, c):
        raise ValueError(f"{name}: expected shape {(b, h, w, c)}, "
                         f"got {tuple(t.shape)}")
    sb, sh, sw, sc = t.stride()
    if (sc != 1 and c > 1) or (h > 1 and sh != w * sw):
        t = t.contiguous()
        sb, _, sw, _ = t.stride()
    return t, sb, sw


def _scratch_for(device: torch.device, stream: int, b: int, cells: int):
    """(keys, state) of ``stream`` (the current one). Made during a graph
    capture, the state is zeroed by a node of the graph, and once more by
    the stream's first launch outside it."""
    entry = _scratch.get((device, stream, b, cells))
    if entry is None:
        entry = _scratch[(device, stream, b, cells)] = [
            torch.empty(b * cells, dtype=torch.int64, device=device),
            torch.zeros(b, dtype=torch.int64, device=device),
            torch.cuda.is_current_stream_capturing()]
    elif entry[2] and not torch.cuda.is_current_stream_capturing():
        entry[1].zero_()
        entry[2] = False
    return entry[0], entry[1]


def decode_topk(levels: Sequence[tuple[torch.Tensor, torch.Tensor]],
                strides: Sequence[int], conf_threshold: float,
                q_factor: float, max_detections: int):
    """Per level (B, H, W, C) f32 logits and (B, H, W, 4) f32 TLBR ->
    (boxes (B, K, 4), scores (B, K), classes (B, K) int32, valid (B, K)
    bool), K = min(max_detections, cells): one kernel launch."""
    cls0 = levels[0][0]
    if not cls0.is_cuda:
        return decode_topk_plain(levels, strides, conf_threshold, q_factor,
                                 max_detections)
    b, _, _, c = cls0.shape
    if not 0 < len(levels) <= MAX_LEVELS or len(strides) != len(levels):
        raise ValueError(f"kernel takes 1..{MAX_LEVELS} levels and a "
                         "stride each")
    if not 0 < c <= MAX_CLASSES:
        raise ValueError(f"kernel takes 1..{MAX_CLASSES} classes, got {c}")
    meta, keep_alive, cells = [], [], 0
    for i, (cls_l, reg_l) in enumerate(levels):
        h, w = cls_l.shape[1:3]
        cls_l, cb, cc = _cells(cls_l, f"level {i} cls", b, h, w, c)
        reg_l, rb, rc = _cells(reg_l, f"level {i} reg", b, h, w, 4)
        if reg_l.device != cls0.device:
            raise ValueError("all levels must lie on one device")
        keep_alive += [cls_l, reg_l]   # copies live until the launch
        meta += [cls_l.data_ptr(), reg_l.data_ptr(), cb, cc, rb, rc, h, w]
        cells += h * w
    k = min(max_detections, cells)
    if not 0 < k <= MAX_K:
        raise ValueError(f"kernel takes 1..{MAX_K} slots, got {k}")
    dev = cls0.device
    stream = stream_ptr(dev)
    keys, state = _scratch_for(dev, stream, b, cells)
    boxes = torch.empty((b, k, 4), dtype=torch.float32, device=dev)
    scores = torch.empty((b, k), dtype=torch.float32, device=dev)
    classes = torch.empty((b, k), dtype=torch.int32, device=dev)
    valid = torch.empty((b, k), dtype=torch.bool, device=dev)
    KERNEL.launch((ctypes.c_longlong * len(meta))(*meta),
                  (ctypes.c_float * len(strides))(*map(float, strides)),
                  len(levels), b, c, k, float(conf_threshold),
                  float(q_factor), keys.data_ptr(), state.data_ptr(),
                  boxes.data_ptr(), scores.data_ptr(), classes.data_ptr(),
                  valid.data_ptr(), stream)
    return boxes, scores, classes, valid
