"""Kernel 2: fused stem + stage1 over the column-merged frame.

CUDA source: ``csrc/stem.cu`` (tensor cores). ``fused_stem_stage1``
launches it for a CUDA tensor, with both kernels as the B-tile images
``mma_pack.pack_stem_mma`` / ``pack_stage1_mma`` make of them (packed by
the caller once at load); for a CPU tensor it runs
``fused_stem_stage1_plain`` on the blocked kernels, the same math in
PyTorch: products of the compute-dtype values accumulated in float32, the
stem rounded to the compute dtype before stage1.

Geometry (all pads on the top/left, as the reference):

    frame  (..., H, W2, CM) merged columns, stem pad ((1,0),(1,0))
    stem   2x2 stride-1 conv -> (..., H, W2, O2)
    stage1 2x2 blocked conv over row pairs, pad top 2 rows / left 1 col
           -> (..., H/2, W2, C2)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._lib import I, Kernel, P, check_cuda, stream_ptr

KERNEL = Kernel("unina_fused_stem_stage1", [P, P, P, P, P, P, I, I, I, P])

# the shapes the CUDA kernel is compiled for (csrc/stem.cu)
KERNEL_CM, KERNEL_O2, KERNEL_C2 = 24, 64, 64


def fused_stem_stage1_plain(xm: torch.Tensor, stem_kernel: torch.Tensor,
                            stem_bias: torch.Tensor,
                            stage1_kernel: torch.Tensor,
                            stage1_bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the fused pass (any float dtype).

    ``stem_kernel`` (2,2,CM,O2), ``stage1_kernel`` (2,2,2*O2,C2) are the
    reference's blocked HWIO layouts; both are rounded to ``xm.dtype``."""
    dt = xm.dtype
    *lead, h, w2, cm = xm.shape
    o2 = stem_kernel.shape[-1]
    c2 = stage1_kernel.shape[-1]
    x = xm.reshape(-1, h, w2, cm).float()
    ks = stem_kernel.to(dt).float().reshape(4 * cm, o2)
    k1 = stage1_kernel.to(dt).float().reshape(8 * o2, c2)
    xp = F.pad(x, (0, 0, 1, 0, 1, 0))
    patches = torch.cat([xp[:, kh:kh + h, kw:kw + w2, :]
                         for kh in range(2) for kw in range(2)], dim=-1)
    stem = torch.relu(patches @ ks + stem_bias.float())
    stem = stem.to(dt).float()
    h2 = h // 2
    sp = F.pad(stem, (0, 0, 1, 0, 2, 0))
    taps = [sp[:, 2 * kh + di:2 * kh + di + 2 * h2 - 1:2, kw:kw + w2, :]
            for kh in range(2) for kw in range(2) for di in range(2)]
    out = torch.relu(torch.cat(taps, dim=-1) @ k1 + stage1_bias.float())
    return out.to(dt).reshape(*lead, h2, w2, c2)


def fused_stem_stage1(xm: torch.Tensor, stem_kernel: torch.Tensor,
                      stem_bias: torch.Tensor, stage1_kernel: torch.Tensor,
                      stage1_bias: torch.Tensor) -> torch.Tensor:
    """ReLU(stage1(ReLU(stem(xm)))) in one pass; (..., H/2, W2, C2).

    The kernels are as the side that computes reads them: for a CPU
    tensor the blocked ones, (2, 2, CM, O2) and (2, 2, 2*O2, C2); for a
    CUDA tensor their B-tile images ``pack_stem_mma(stem)`` (2, 64, 64)
    and ``pack_stage1_mma(stage1)`` (8, 64, 64). The CUDA kernel takes
    bf16 ``xm`` (B, even H, W2, 24) and f32 biases (64,); batch rides on
    its tile index."""
    if not xm.is_cuda:
        return fused_stem_stage1_plain(xm, stem_kernel, stem_bias,
                                       stage1_kernel, stage1_bias)
    lead = xm.shape[:-3]
    h, w2, cm = xm.shape[-3:]
    bsz = xm.numel() // (h * w2 * cm)
    check_cuda(xm, "xm", torch.bfloat16)
    if cm != KERNEL_CM or h % 2:
        raise ValueError(f"kernel takes (B, even H, W2, {KERNEL_CM}), got "
                         f"{tuple(xm.shape)}")
    check_cuda(stem_kernel, "stem_kernel (pack_stem_mma image)",
               torch.bfloat16, (2, KERNEL_O2, 64))
    check_cuda(stem_bias, "stem_bias", torch.float32, (KERNEL_O2,))
    check_cuda(stage1_kernel, "stage1_kernel (pack_stage1_mma image)",
               torch.bfloat16, (8, KERNEL_C2, KERNEL_O2))
    check_cuda(stage1_bias, "stage1_bias", torch.float32, (KERNEL_C2,))
    out = torch.empty((*lead, h // 2, w2, KERNEL_C2), dtype=torch.bfloat16,
                      device=xm.device)
    KERNEL.launch(xm.data_ptr(), stem_kernel.data_ptr(),
                  stem_bias.data_ptr(), stage1_kernel.data_ptr(),
                  stage1_bias.data_ptr(), out.data_ptr(), bsz, h, w2,
                  stream_ptr(xm.device))
    return out
