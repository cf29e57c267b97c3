"""Kernel 4: exact greedy class-aware NMS (suppression bitmask + scan).

CUDA source: ``csrc/nms.cu``. One wrapper call is one kernel launch, for
one image or a batch: the kernel gives each image a cluster of blocks,
which compacts the valid slots, builds the suppression bits of that set in
shared memory and scans them greedily, so its work follows the number of
valid candidates, not K. The plain version is the greedy recurrence over
the same suppression relation, image by image.
"""
from __future__ import annotations

import torch

from ...utils.boxes import pairwise_iou
from ._lib import F, I, Kernel, P, check_cuda, stream_ptr

KERNEL = Kernel("unina_nms", [P, P, P, P, I, I, F, P])
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
    """Plain PyTorch version: the sequential greedy scan, K steps, for
    (K, ...) or, image by image, (B, K, ...) candidates."""
    if boxes.ndim == 3:
        return torch.stack([nms_keep_plain(*img, iou_threshold)
                            for img in zip(boxes, classes, valid)])
    s = suppress_matrix(boxes.float(), classes, valid, iou_threshold)
    keep = valid.clone()
    for i in range(boxes.shape[0]):
        keep &= ~(s[i] & keep[i])
    return keep


def nms_keep(boxes: torch.Tensor, classes: torch.Tensor,
             valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Keep mask ([B,] K) bool of greedy NMS over score-sorted candidates
    ([B,] K, 4) boxes, ([B,] K) classes and valid; ``valid`` may be any
    mask (not only a prefix), K anything in 1..1024."""
    if not boxes.is_cuda:
        return nms_keep_plain(boxes, classes, valid, iou_threshold)
    *lead, k, _ = boxes.shape
    if len(lead) > 1:
        raise ValueError(f"boxes: expected (K, 4) or (B, K, 4), got "
                         f"{tuple(boxes.shape)}")
    check_cuda(boxes, "boxes", torch.float32, (*lead, k, 4))
    check_cuda(classes, "classes", torch.int32, (*lead, k))
    check_cuda(valid, "valid", torch.bool, (*lead, k))
    if not 0 < k <= MAX_K:
        raise ValueError(f"kernel takes 1..{MAX_K} candidates, got {k}")
    keep = torch.empty((*lead, k), dtype=torch.bool, device=boxes.device)
    KERNEL.launch(boxes.data_ptr(), classes.data_ptr(), valid.data_ptr(),
                  keep.data_ptr(), lead[0] if lead else 1, k,
                  float(iou_threshold), stream_ptr(boxes.device))
    return keep
