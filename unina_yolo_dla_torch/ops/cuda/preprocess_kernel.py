"""Kernel 1: uint8 frame -> ImageNet-normalised float32 or bfloat16.

CUDA source: ``csrc/normalize.cu``. The wrapper launches it for a CUDA
tensor and runs the plain PyTorch version, the same formula, for a CPU
tensor. ``out_dtype=torch.bfloat16`` rounds the exact float32 value to
nearest-even on the way out (the serving path's form: the model's first
cast disappears); float32 is the reference kernel's contract.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ...models.config import IMAGENET_MEAN, IMAGENET_STD
from ._lib import I, Kernel, P, check_cuda, stream_ptr

KERNEL = Kernel("unina_normalize",
                [P, P, ctypes.c_longlong, I, I, P, P, P, I, P])
OUT_DTYPES = (torch.float32, torch.bfloat16)


def channel_constants(c_out: int, mean: Sequence[float] = IMAGENET_MEAN,
                      std: Sequence[float] = IMAGENET_STD):
    """mean/std tiled to ``c_out`` channels (8x for the merged layout)."""
    reps = c_out // len(mean)
    if reps * len(mean) != c_out:
        raise ValueError(f"{c_out} channels do not tile {len(mean)}")
    return tuple(mean) * reps, tuple(std) * reps


def _source_map(c_in: int, c_out: int, swap_rb: bool) -> list[int]:
    if swap_rb:
        if c_out != 3 or c_in not in (3, 4):
            raise ValueError("swap_rb takes (.., 3|4) BGR(A) frames")
        return [2, 1, 0]
    if c_out > c_in:
        raise ValueError(f"{c_out} output channels from {c_in} input")
    return list(range(c_out))


def normalize_plain(img: torch.Tensor, mean: Sequence[float],
                    std: Sequence[float], swap_rb: bool = False,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version: ``(x / 255 - mean) / std`` per channel in
    float32, then cast to ``out_dtype``."""
    c_out = len(mean)
    src = _source_map(img.shape[-1], c_out, swap_rb)
    dev = img.device
    # tensor divisors: on CUDA a Python-number divisor becomes a multiply
    # by its reciprocal, which is not the reference's division
    x = img[..., src].float() / torch.tensor(255.0, device=dev)
    m = torch.tensor(mean, dtype=torch.float32, device=dev)
    s = torch.tensor(std, dtype=torch.float32, device=dev)
    return ((x - m) / s).to(out_dtype)


def normalize(img: torch.Tensor, mean: Sequence[float] = IMAGENET_MEAN,
              std: Sequence[float] = IMAGENET_STD, swap_rb: bool = False,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., C_in) uint8 -> (..., len(mean)) float32 or bfloat16.

    ``swap_rb`` reads BGR(A) frames as RGB (alpha dropped)."""
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype: float32 or bfloat16, got {out_dtype}")
    if not img.is_cuda:
        return normalize_plain(img, mean, std, swap_rb, out_dtype)
    check_cuda(img, "img", torch.uint8)
    c_in, c_out = img.shape[-1], len(mean)
    if len(std) != c_out or not 0 < c_out <= 32:
        raise ValueError("mean/std must have the same 1..32 channels")
    src = _source_map(c_in, c_out, swap_rb)
    out = torch.empty((*img.shape[:-1], c_out), dtype=out_dtype,
                      device=img.device)
    n_pix = img.numel() // c_in
    fa = ctypes.c_float * c_out
    KERNEL.launch(img.data_ptr(), out.data_ptr(), n_pix, c_in, c_out,
                  fa(*mean), fa(*std), (ctypes.c_int * c_out)(*src),
                  int(out_dtype == torch.bfloat16), stream_ptr(img.device))
    return out

