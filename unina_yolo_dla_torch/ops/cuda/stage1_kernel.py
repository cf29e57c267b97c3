"""Kernel 5: the stage1 2x2 blocked downsample over the merged stem output.

CUDA source: ``csrc/stage1.cu`` (tensor cores). ``fused_downsample_merged``
launches it for a CUDA tensor, with the weights as the kernel's B tiles
(``mma_pack.pack_stage1_mma``, packed by the caller once at load); for a
CPU tensor it runs ``fused_downsample_merged_plain`` on the blocked
weights, which follows the reference's XLA form
step by step: kw-packed weights, the merged input padded 2 rows on top and
1 column on the left, four (kh, di) products accumulated in float32 with
the kw = 1 half shifted by one merged column, then bias and ReLU.

Geometry (``xm`` is the stem output with column pairs merged into
channels, ``xm[..., h, w2, :C]`` = column ``2*w2``, ``[C:]`` = ``2*w2+1``):

    xm   (..., H, W2, 2C)  ->  out (..., H/2, W2, O)
    out[r, w] = ReLU(b + sum_{kh,kw,di} xp[2r+2kh+di, w+kw] @ wb[kh,kw,di])
    with xp = xm padded 2 rows on top and 1 column on the left.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._lib import I, Kernel, P, check_cuda, stream_ptr
from .mma_pack import STEM_STAGE1_WIDTHS, stage1_mma_shape, \
    stem_stage1_takes

_ARGS = [P, P, P, P, I, I, I, P]
# one entry point, and one launch count, a compiled width C (merged input
# CM = output O = C = 2 x base; csrc/stage1.cu)
KERNELS = {c: Kernel("unina_stage1_merged" + ("" if c == 64 else
                                              f"_c{c}"), _ARGS)
           for c in STEM_STAGE1_WIDTHS}
KERNEL = KERNELS[64]          # the base-32 engines' width


def pack_stage1_weights(wb: torch.Tensor) -> torch.Tensor:
    """(2,2,4C,O) blocked kernel -> (2,2,2C,2O) kw-packed:
    ``wp[kh, di, c, kw*O + o] = wb[kh, kw, di*2C + c, o]``."""
    kh2, kw2, c4, o = wb.shape
    if kh2 != 2 or kw2 != 2 or c4 % 2:
        raise ValueError(f"expected a (2, 2, 4C, O) kernel, got "
                         f"{tuple(wb.shape)}")
    cm = c4 // 2
    w = wb.reshape(2, 2, 2, cm, o).permute(0, 2, 3, 1, 4)
    return w.reshape(2, 2, cm, 2 * o)


def fused_downsample_merged_plain(xm: torch.Tensor, wb: torch.Tensor,
                                  bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (any float dtype): products of ``xm.dtype``
    values summed in float32, bias and ReLU in float32, result in
    ``xm.dtype``."""
    dt = xm.dtype
    *lead, h, w2, cm = xm.shape
    wp = pack_stage1_weights(wb.to(dt)).float()
    co = wp.shape[-1] // 2
    h2 = h // 2
    x = xm.reshape(-1, h, w2, cm).float()
    xp = F.pad(x, (0, 0, 1, 0, 2, 0))              # (B, H+2, W2+1, CM)
    x4 = xp.reshape(x.shape[0], h2 + 1, 2, w2 + 1, cm)
    acc = torch.zeros(x.shape[0], h2, w2, co, device=xm.device)
    for kh in range(2):
        for di in range(2):
            z = x4[:, kh:kh + h2, di] @ wp[kh, di]  # (B, h2, W2+1, 2O)
            acc = acc + z[:, :, 0:w2, 0:co] + z[:, :, 1:w2 + 1, co:2 * co]
    out = torch.relu(acc + bias.float())
    return out.to(dt).reshape(*lead, h2, w2, co)


def fused_downsample_merged(xm: torch.Tensor, wb: torch.Tensor,
                            bias: torch.Tensor) -> torch.Tensor:
    """ReLU(blocked 2x2 conv + bias) over the merged layout, one pass.

    ``wb`` is the weights as the side that computes reads them: for a CPU
    tensor the blocked kernel (2, 2, 4C, O), for a CUDA tensor its B-tile
    image ``pack_stage1_mma(blocked)`` (C = 64: (8, 64, 64)), which the
    caller packs once at load. The CUDA kernel takes bf16 ``xm`` (B, even
    H, W2, C) and an f32 bias (C,), C one of ``STEM_STAGE1_WIDTHS``; batch
    rides on its tile index."""
    if not xm.is_cuda:
        return fused_downsample_merged_plain(xm, wb, bias)
    lead = xm.shape[:-3]
    h, w2, cm = xm.shape[-3:]
    bsz = xm.numel() // (h * w2 * cm)
    check_cuda(xm, "xm", torch.bfloat16)
    if not stem_stage1_takes(cm) or h % 2:
        raise ValueError(f"kernel takes (B, even H, W2, C), C in "
                         f"{STEM_STAGE1_WIDTHS}, got {tuple(xm.shape)}")
    check_cuda(wb, "wb (pack_stage1_mma image)", torch.bfloat16,
               stage1_mma_shape(cm))
    check_cuda(bias, "bias", torch.float32, (cm,))
    out = torch.empty((*lead, h // 2, w2, cm), dtype=torch.bfloat16,
                      device=xm.device)
    KERNELS[cm].launch(xm.data_ptr(), wb.data_ptr(), bias.data_ptr(),
                       out.data_ptr(), bsz, h, w2, stream_ptr(xm.device))
    return out
