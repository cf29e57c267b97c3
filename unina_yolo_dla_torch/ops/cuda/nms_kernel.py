"""Kernel 4: exact greedy class-aware NMS (suppression bitmask + scan).

CUDA source: ``csrc/nms.cu``. One wrapper call launches both of its
kernels (the K x K bitmask, then the one-block greedy scan) and counts one
launch. The plain version is the greedy recurrence over the same
suppression relation.
"""
from __future__ import annotations

import torch

from ...utils.boxes import pairwise_iou
from ._lib import F, I, Kernel, P, check_cuda, stream_ptr

KERNEL = Kernel("unina_nms", [P, P, P, P, P, I, F, P])
MAX_K = 1024


def suppress_matrix(boxes: torch.Tensor, classes: torch.Tensor,
                    valid: torch.Tensor, iou_threshold: float
                    ) -> torch.Tensor:
    """(K, K) bool: i would suppress j (j strictly later in sort order)."""
    k = boxes.shape[0]
    iou = pairwise_iou(boxes, boxes)
    same = classes[:, None] == classes[None, :]
    later = torch.ones((k, k), dtype=torch.bool,
                       device=boxes.device).triu(diagonal=1)
    return ((iou > iou_threshold) & same & later & valid[None, :]
            & valid[:, None])


def nms_keep_plain(boxes: torch.Tensor, classes: torch.Tensor,
                   valid: torch.Tensor, iou_threshold: float
                   ) -> torch.Tensor:
    """Plain PyTorch version: the sequential greedy scan, K steps."""
    s = suppress_matrix(boxes.float(), classes, valid, iou_threshold)
    keep = valid.clone()
    for i in range(boxes.shape[0]):
        keep &= ~(s[i] & keep[i])
    return keep


def nms_keep(boxes: torch.Tensor, classes: torch.Tensor,
             valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Keep mask (K,) bool of greedy NMS over score-sorted candidates."""
    if not boxes.is_cuda:
        return nms_keep_plain(boxes, classes, valid, iou_threshold)
    k = boxes.shape[0]
    check_cuda(boxes, "boxes", torch.float32, (k, 4))
    check_cuda(classes, "classes", torch.int32, (k,))
    check_cuda(valid, "valid", torch.bool, (k,))
    if not 0 < k <= MAX_K:
        raise ValueError(f"kernel takes 1..{MAX_K} candidates, got {k}")
    kp = -(-k // 32) * 32
    if kp != k:  # pad to whole 32-bit words with invalid candidates
        pad = kp - k
        boxes = torch.cat([boxes, boxes.new_zeros((pad, 4))])
        classes = torch.cat([classes, classes.new_zeros(pad)])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    mask = torch.empty(kp * kp // 32, dtype=torch.int32, device=boxes.device)
    keep = torch.empty(kp, dtype=torch.bool, device=boxes.device)
    KERNEL.launch(boxes.data_ptr(), classes.data_ptr(), valid.data_ptr(),
                  mask.data_ptr(), keep.data_ptr(), kp, float(iou_threshold),
                  stream_ptr(boxes.device))
    return keep[:k]
