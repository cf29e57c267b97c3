"""Kernel 8: the decoupled detection head, both branches in one pass.

CUDA source: ``csrc/head.cu`` (tensor cores): the tiled ``wgmma`` kernel
at width 64 (P2), the wide ``wgmma`` form (weights streamed through shared
memory; at 256 and 512 each output tile one cluster of two or four blocks
splitting the channels, at 512 and at 256 on large images each block
keeping only the planes it computes and copying its peers'; at 128 on
large images the large plan, ``large_plan``) at widths 32, 128, 256 and
512 (P3/P4 of the bf16 engines, base 16, 32 and 64; base 64's P2).
``fused_head`` launches one of them for a CUDA tensor; for a CPU tensor it runs
``fused_head_plain``, which follows the reference's XLA form step by step.
Per branch over the same input:

    c1   = ReLU(conv3x3(x)  + b1)  -> compute dtype
    c2   = ReLU(conv3x3(c1) + b2)  -> compute dtype
    pred = c2 @ wp + bp            float32, never rounded

The 3x3s are nine shifted products summed in float32. Unlike the port's
standard and merged heads, whose preds are rounded to the compute dtype
before the cast to float32, the fused head's preds stay float32.

Weights come packed by ``pack_head_weights`` (once, at load):
``(wc1, bc1, wc2, bc2, wcp, bcp, wr1, br1, wr2, br2, wrp, brp)`` with the
3x3 kernels (3, 3, h, h) and the preds (h, co) in the compute dtype and
the biases float32. The CUDA kernel reads the four 3x3 kernels as its B
tiles instead, ``w33 = mma_pack.pack_head_mma(wc1, wr1, wc2, wr2, wcp,
wrp)`` (the wide form's image holds the preds too), which the caller packs
once at load as well.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _lib
from ._lib import I, Kernel, P, check_cuda, stream_ptr
from .c3k2_kernel import _conv3x3, _dot
from .mma_pack import (HEAD_SPLIT, WIDE_PERSIST_BLOCKS, WIDE_PIX_BYTES,
                       WIDE_SMEM_HEAD, WIDE_SMEM_MAX, WIDE_WALK_MIN_BLOCKS,
                       head_mma_shape, wide_ring_bytes, wide_stage_cols)

KERNEL = Kernel("unina_fused_head",
                [P, P, P, P, P, P, I, P, P, P, P, I, P, P, I, I, I, I, P])

# the width the tiled kernel is compiled for (csrc/head.cu) and the pred
# outputs both forms take
KERNEL_C, KERNEL_NOMAX = 64, 8


# the owned plan's tile (csrc/head.cu ``OWNED_TR``, ``OWNED_TW``), and one
# image's grid at which it runs at 256 (``OWNED_MIN_BLOCKS``)
OWNED_TILE = (8, 16)
OWNED_MIN_BLOCKS = 128


def wide_tile(c: int) -> tuple[int, int]:
    """The wide form's output tile at width ``c`` in its replicated plan:
    8 x 16 at 128 (one wave of blocks at 80 x 80), 8 x 8 otherwise
    (csrc/head.cu ``tile_rows``, ``tile_w``); at 512, which runs the owned
    plan only, that plan's 8 x 16 (OWNED_TILE)."""
    return 8, (16 if c in (128, 512) else 8)


def owned_plan(c: int, h: int, w: int) -> bool:
    """Whether the wide head runs the owned plan over (h, w) images
    (csrc/head.cu ``owned_plan``): always at 512, at 256 where its clusters
    of 2 on OWNED_TILE tiles, both branches, make OWNED_MIN_BLOCKS blocks
    or more on one image. The batch plays no part: the plans sum in
    different orders, and a frame keeps its bits inside any batch."""
    tr, tw = OWNED_TILE
    tiles = -(-h // tr) * -(-w // tw)
    return c == 512 or (c == 256 and tiles * 2 * (c // 128)
                        >= OWNED_MIN_BLOCKS)


# the large plan (csrc/head.cu ``large``): C = 128 where one image's
# replicated grid (8 x 16 tiles, both branches) has WIDE_WALK_MIN_BLOCKS
# blocks or more; 10 x 14 tiles, one branch a unit, three warpgroups, one
# block an SM (at most ``sms``) walking units, a ring of LARGE_RING slots
# of two 16 KB chunks, the x window's planes LARGE_XPLANE bytes apart
LARGE_TILE = (10, 14)
LARGE_THREADS = 384
LARGE_RING = 3
LARGE_XPLANE = 32768


def large_plan(c: int, h: int, w: int) -> bool:
    """Whether the wide head runs the large plan over (h, w) images
    (csrc/head.cu ``large::plan``): at 128 where one image's replicated
    grid, both branches, has WIDE_WALK_MIN_BLOCKS blocks or more (base 64's
    head_p2 at 160 x 160: 400). The batch plays no part."""
    return c == 128 and -(-h // 8) * -(-w // 16) * 2 >= WIDE_WALK_MIN_BLOCKS


def large_smem() -> int:
    """The large plan's shared memory (csrc/head.cu ``large::SMEM``): the
    head, the ring, the x window's two planes (each 1024-aligned for the
    tensor copy's swizzle) and conv1's region, two planes."""
    tr, tw = LARGE_TILE
    return (WIDE_SMEM_HEAD + LARGE_RING * 2 * 128 * 128 + 2 * LARGE_XPLANE
            + 2 * (tr + 2) * (tw + 2) * WIDE_PIX_BYTES)


def large_units(b: int, h: int, w: int) -> int:
    """The large plan's units over a (b, h, w) input: tiles x branches."""
    tr, tw = LARGE_TILE
    return 2 * b * -(-h // tr) * -(-w // tw)


def _ring(ns: int, tr: int, tw: int) -> int:
    return wide_ring_bytes(max(wide_stage_cols(ns, (tr + 2) * (tw + 2)),
                               wide_stage_cols(ns, tr * tw)))


def wide_smem_owned(c: int) -> int:
    """The owned plan's shared memory (csrc/head.cu ``smem_owned``): the
    head, the ring, the block's two planes of conv1's region and two of
    the larger of the x window and that region."""
    tr, tw = OWNED_TILE
    c1, xp = (tr + 2) * (tw + 2), (tr + 4) * (tw + 4)
    return (WIDE_SMEM_HEAD + _ring(128, tr, tw)
            + 2 * (c1 + max(xp, c1)) * WIDE_PIX_BYTES)


def wide_smem_bytes(c: int) -> int:
    """The shared memory the wide form admits width ``c`` (one of
    ``HEAD_SPLIT``) by, as csrc/head.cu ``wide_head::smem_bytes`` computes
    it (held against the library on the card): at 512 the owned plan's
    (``wide_smem_owned``), else the replicated plan's: the head, the ring,
    the x window (halo 2) and conv1's region (halo 1), every plane (at 256
    the owned plan needs less)."""
    if c == 512:
        return wide_smem_owned(c)
    tr, tw = wide_tile(c)
    c1, xp = (tr + 2) * (tw + 2), (tr + 4) * (tw + 4)
    return (WIDE_SMEM_HEAD + _ring(c // HEAD_SPLIT[c], tr, tw)
            + (xp + c1) * -(-c // 64) * WIDE_PIX_BYTES)


def wide_launch(c: int, b: int, h: int, w: int,
                sms: int = WIDE_PERSIST_BLOCKS) -> dict:
    """The wide head's launch over a (b, h, w) input as csrc/head.cu makes
    it (``last_launch``' keys): tiles x cluster blocks by two branches,
    the cluster and the shared memory of the plan it picks; the large
    plan's units or the card's ``sms``, the fewer, of 384 threads."""
    if large_plan(c, h, w):
        return {"grid": [min(large_units(b, h, w), sms), 1, 1],
                "cluster": [1, 1, 1], "threads": LARGE_THREADS,
                "smem_bytes": large_smem()}
    if owned_plan(c, h, w):
        (tr, tw), s, smem = OWNED_TILE, c // 128, wide_smem_owned(c)
    else:
        (tr, tw), s, smem = wide_tile(c), HEAD_SPLIT[c], wide_smem_bytes(c)
    tiles = b * -(-h // tr) * -(-w // tw)
    return {"grid": [tiles * s, 2, 1], "cluster": [s, 1, 1],
            "threads": 256, "smem_bytes": smem}


def kernel_takes(c: int) -> bool:
    """Whether a CUDA kernel takes head width ``c``: the tiled kernel's,
    or one the wide form is compiled for whose windows and ring fit in
    shared memory (``wide_smem_bytes``); the caller packs ``w33`` only
    then."""
    return c == KERNEL_C or (c in HEAD_SPLIT
                             and wide_smem_bytes(c) <= WIDE_SMEM_MAX)


def last_launch() -> dict:
    """The shape of the last head launch."""
    return _lib.last_launch("unina_head_last_launch")


def wide_smem(c: int) -> int:
    """The wide form's shared memory at width ``c``, from the library (-1
    at a width it is not compiled for)."""
    return _lib.query("unina_head_wide_smem", [I], c)


def pack_head_weights(cls_convs, cls_pred, reg_convs, reg_pred,
                      dtype: torch.dtype):
    """HWIO ``(kernel, bias)`` pairs -> the kernel's flat operands:
    ``cls_convs``/``reg_convs`` the two 3x3 ConvBlocks of each branch,
    ``cls_pred``/``reg_pred`` the 1x1 preds."""
    def f32(a):
        return torch.from_numpy(np.array(a, np.float32))

    out = []
    for convs, (kp, bp) in ((cls_convs, cls_pred), (reg_convs, reg_pred)):
        for k, b in convs:
            out += [f32(k).to(dtype), f32(b)]
        kp = f32(kp)
        out += [kp.reshape(kp.shape[-2], kp.shape[-1]).to(dtype), f32(bp)]
    return tuple(out)


def _branch(x, w1, b1, w2, b2, wp, bp):
    t = _conv3x3(_conv3x3(x, w1, b1), w2, b2)
    return _dot(t, wp) + bp.float()


def fused_head_plain(x: torch.Tensor, *ws):
    """Plain PyTorch version (any float dtype): ``(cls, reg)`` float32."""
    xf = x.reshape(-1, *x.shape[-3:])
    cls = _branch(xf, *ws[:6])
    reg = _branch(xf, *ws[6:12])
    return (cls.reshape(*x.shape[:-1], cls.shape[-1]),
            reg.reshape(*x.shape[:-1], reg.shape[-1]))


def fused_head(x: torch.Tensor, *ws, w33: torch.Tensor | None = None):
    """Both head branches over ``x`` (..., H, W, h) -> ``(cls, reg)``,
    (..., H, W, Ccls) logits and (..., H, W, 4) distances in float32,
    each contiguous. The CUDA kernel takes bf16 ``x`` with h = 64 (the
    tiled kernel) or 32, 128, 256, 512 (the wide form), and up to 8 outputs per
    pred; batch rides on its tile index. Of ``ws`` it reads the biases, the
    3x3s from ``w33``, and the preds from ``ws`` (tiled) or ``w33``
    (wide)."""
    if not x.is_cuda:
        return fused_head_plain(x, *ws)
    check_cuda(x, "x", torch.bfloat16)
    h, w, c = x.shape[-3:]
    if not kernel_takes(c):
        raise ValueError(f"kernel takes {KERNEL_C} channels, or one of "
                         f"{sorted(HEAD_SPLIT)}, got {c}")
    if w33 is None:
        raise ValueError("the CUDA kernel needs w33 = pack_head_mma(wc1, "
                         "wr1, wc2, wr2, wcp, wrp)")
    bf = torch.bfloat16
    check_cuda(w33, "w33", bf, head_mma_shape(c))
    (_, bc1, _, bc2, wcp, bcp, _, br1, _, br2, wrp, brp) = ws
    outs = []
    for name, b1, b2, wp, bp in (("cls", bc1, bc2, wcp, bcp),
                                 ("reg", br1, br2, wrp, brp)):
        no = wp.shape[-1]
        if not 1 <= no <= KERNEL_NOMAX:
            raise ValueError(f"{name}_pred: 1..{KERNEL_NOMAX} outputs, "
                             f"got {no}")
        check_cuda(wp, f"{name}_pred", bf, (c, no))
        for t, tn in ((b1, "conv1 bias"), (b2, "conv2 bias")):
            check_cuda(t, f"{name} {tn}", torch.float32, (c,))
        check_cuda(bp, f"{name}_pred bias", torch.float32, (no,))
        outs.append(torch.empty((*x.shape[:-1], no), dtype=torch.float32,
                                device=x.device))
    bsz = x.numel() // (h * w * c)
    KERNEL.launch(x.data_ptr(), w33.data_ptr(), bc1.data_ptr(),
                  bc2.data_ptr(), wcp.data_ptr(), bcp.data_ptr(),
                  wcp.shape[-1], br1.data_ptr(), br2.data_ptr(),
                  wrp.data_ptr(), brp.data_ptr(), wrp.shape[-1],
                  outs[0].data_ptr(), outs[1].data_ptr(), bsz, h, w, c,
                  stream_ptr(x.device))
    return outs[0], outs[1]
