"""Kernels 6 and 7: the whole C3k2 block in one pass, and its pair form
over ``concat([upsample2x?(xa), xb])``.

CUDA source: ``csrc/c3k2.cu`` (tensor cores; entry points
``unina_fused_c3k2`` and ``unina_fused_c3k2_cat``, counted separately).
Each entry point launches one of two kernels by width: the tiled
``wgmma`` kernel at hidden 32 and F 64 (the int8 engine's float blocks),
the wide ``wgmma`` form (weights streamed through shared memory; at hidden
128 and 256 each output tile one cluster splitting the columns; at 256,
and at 128 on large images, each block keeping only the planes it
computes and copying its peers') at hidden 16, 64, 128 and 256 with F = 2
hidden: every other C3k2 of the bf16 engines at base 16, 32 and 64.
``fused_c3k2`` and ``fused_c3k2_cat`` launch them for CUDA tensors; for
CPU tensors they run ``fused_c3k2_plain`` / ``fused_c3k2_cat_plain``,
which follow the reference's XLA form step by step:

    p1 = cv1(x), p2 = cv2(x)                   1x1: ReLU(x @ w + b)
    n x [t = cv1_i(p1); t = cv2_i(t) (3x3); p1 = p1 + t (or t)]
    out = ReLU(p1 @ w3[:h] + p2 @ w3[h:] + b3)  cv3 as a split dot

Products of compute-dtype values are summed in float32, biases are
float32, and every conv output is ReLU'd in float32 then rounded to the
compute dtype; the residual add is in the compute dtype. In the pair form
the first dots split by input rows, ``xa``'s part runs at ``xa``'s
resolution and only its float32 result is upsampled.

Weights come packed by ``pack_c3k2_weights`` (once, at load):
``(w1, b1, wb1, bb1, wb2, bb2, w2, b2, w3, b3)`` with w1/w2 (Cin, h),
wb1 (n, h, h), wb2 (n, 3, 3, h, h), w3 (2h, F) in the compute dtype and
the biases (h,), (n, h), (n, h), (h,), (F,) in float32. The CUDA kernel
reads the five weights as its B tiles (or fragments) instead, ``wpk =
mma_pack.pack_c3k2_mma(w1, w2, wb1, wb2, w3, ca)`` (``ca`` = ``xa``'s
channels in the pair form, else 0), which the caller packs once at load as
well, and sums each split product of the plain version in one accumulator.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import _lib
from ._lib import I, Kernel, P, check_cuda, stream_ptr
from .mma_pack import (C3K2_SPLIT, WIDE_PERSIST_BLOCKS, WIDE_PIX_BYTES,
                       WIDE_SMEM_HEAD, WIDE_SMEM_MAX, WIDE_WALK_MIN_BLOCKS,
                       c3k2_mma_numel, wide_ring_bytes, wide_stage_cols)

KERNEL = Kernel("unina_fused_c3k2",
                [P, I, P, P, P, P, P, P, P, I, I, I, I, I, I, I, P])
KERNEL_CAT = Kernel("unina_fused_c3k2_cat",
                    [P, P, I, I, I, P, P, P, P, P, P, P,
                     I, I, I, I, I, I, I, P])

# the widths the tiled kernel is compiled for (csrc/c3k2.cu): hidden h,
# output F; both forms take bottlenecks n <= KERNEL_NMAX
KERNEL_HID, KERNEL_F, KERNEL_NMAX = 32, 64, 2


def _planes(c: int) -> int:
    return -(-c // 64)


# the owned plan's input (csrc/c3k2.cu ``XMAX``, ``XSLOTS``): at most this
# many 64-channel planes (``xa``'s and ``xb``'s counted apart), streamed
# through XSLOTS window planes
WIDE_XMAX, WIDE_XSLOTS = 12, 4
# the replicated plan's clusters (csrc/c3k2.cu ``split``): hidden 128 on
# grids below OWNED_MIN_BLOCKS owned-plan blocks
REPLICATED_SPLIT = {16: 1, 64: 1, 128: 4}
OWNED_MIN_BLOCKS = 128


def owned_plan(hid: int, ntiles: int) -> bool:
    """Whether the wide form runs the owned plan (csrc/c3k2.cu
    ``owned_plan``) at hidden ``hid`` over ``ntiles`` output tiles (batch
    included): always at 256, at 128 where its clusters of 2 make
    OWNED_MIN_BLOCKS blocks or more. Both plans sum in the same order: a
    frame's bits are the same in either."""
    return hid == 256 or (hid == 128 and 2 * ntiles >= OWNED_MIN_BLOCKS)


# the persistent plan (csrc/c3k2.cu ``persist_plan``): hidden 64, one
# bottleneck, where the replicated plan's grid (batch included) has
# WIDE_WALK_MIN_BLOCKS blocks or more and the plan's windows fit; its tile
PERSIST_TILE = (8, 16)


def persist_plan(hid: int, n: int, ntiles: int) -> bool:
    """Whether the wide form may run the persistent plan at hidden
    ``hid`` with ``n`` bottlenecks over ``ntiles`` replicated-plan tiles
    (``wide_tile``, batch included): one block an SM walking PERSIST_TILE
    tiles, its weight ring running on from tile to tile, each weight chunk
    copied once a block a tile. It sums as the replicated plan does: a
    frame's bits are the same in either. ``wide_plan`` also asks that its
    windows fit (``wide_smem_persist``)."""
    return hid == 64 and n == 1 and ntiles >= WIDE_WALK_MIN_BLOCKS


def wide_smem_persist(ca: int, cb: int, up_a: bool, hid: int, n: int
                      ) -> int:
    """The persistent plan's shared memory (csrc/c3k2.cu
    ``smem_persist``): the head, the ring (its widest part half of stage
    A's columns), the [p1 | p2] window, the input windows and the t
    window."""
    tr, tw = PERSIST_TILE
    wp = _region(tr, tw, n, -1, False)
    apx = (tr // 2 + 2) * (tw // 2 + 2) if up_a else wp
    return (WIDE_SMEM_HEAD + wide_ring_bytes(hid)
            + (_planes(2 * hid) * wp + _planes(ca) * apx + _planes(cb) * wp
               + _planes(hid) * wp) * WIDE_PIX_BYTES)


def wide_tile(hid: int, n: int) -> tuple[int, int]:
    """The wide form's output tile at hidden ``hid`` and ``n``
    bottlenecks: 8 x 8 at every width (csrc/c3k2.cu ``tile_rows``,
    ``tile_cols``)."""
    return 8, 8


def _region(tr: int, tw: int, n: int, i: int, c: bool) -> int:
    """Pixels of stage A's region (i < 0), B_i's, C_i's (``c``) or D's (i =
    n) at a tr x tw tile (csrc/c3k2.cu ``region``)."""
    if i < 0:
        return (tr + 2 * n) * (tw + 2 * n)
    if i >= n:
        return tr * tw
    h = n - 1 - i if c else n - i
    return (tr + 2 * h) * (tw + 2 * h)


def wide_smem_bytes(ca: int, cb: int, up_a: bool, hid: int, n: int) -> int:
    """The shared memory the wide form admits these widths by, as
    csrc/c3k2.cu ``wide_c3k2::smem_bytes`` computes it (held against the
    library on the card): at hidden 256 the owned plan's
    (``wide_smem_owned``), past WIDE_SMEM_MAX beyond WIDE_XMAX input
    planes; otherwise the replicated plan's: the head, the ring, the [p1 |
    p2] window, and the larger of the input windows (an upsampled ``xa`` at
    its coarse window) and the t window (at hidden 128 the owned plan needs
    no more for any input admitted so). ``hid`` one of ``C3K2_SPLIT``."""
    if hid == 256:
        if _planes(ca) + _planes(cb) > WIDE_XMAX:
            return WIDE_SMEM_MAX + 1
        return wide_smem_owned(hid, n)
    s = REPLICATED_SPLIT[hid]
    tr, tw = wide_tile(hid, n)
    cols = max([wide_stage_cols(2 * hid // s, _region(tr, tw, n, i, False))
                for i in (-1, n)]
               + [wide_stage_cols(hid // s, _region(tr, tw, n, i, c))
                  for i in range(n) for c in (False, True)])
    wp = _region(tr, tw, n, -1, False)
    apx = (tr // 2 + 2) * (tw // 2 + 2) if up_a else wp
    x = _planes(ca) * apx + _planes(cb) * wp
    t = _planes(hid) * wp
    return (WIDE_SMEM_HEAD + wide_ring_bytes(cols)
            + (_planes(2 * hid) * wp + max(x, t)) * WIDE_PIX_BYTES)


def wide_smem_owned(hid: int, n: int) -> int:
    """The owned plan's shared memory (csrc/c3k2.cu ``smem_owned``): the
    head, a ring of 64-column slots, the block's three window planes and
    WIDE_XSLOTS more."""
    tr, tw = wide_tile(hid, n)
    return (WIDE_SMEM_HEAD + wide_ring_bytes(64)
            + (3 + WIDE_XSLOTS) * _region(tr, tw, n, -1, False)
            * WIDE_PIX_BYTES)


def wide_plan(ca: int, cb: int, up_a: bool, hid: int, n: int, b: int,
              h: int, w: int) -> str:
    """The plan csrc/c3k2.cu ``launch_width`` picks over a (b, h, w)
    output: "owned", "persistent" (where ``persist_plan`` holds and its
    windows fit) or "replicated"."""
    tr, tw = wide_tile(hid, n)
    ntiles = b * -(-h // tr) * -(-w // tw)
    if owned_plan(hid, ntiles):
        return "owned"
    if persist_plan(hid, n, ntiles) and wide_smem_persist(
            ca, cb, up_a, hid, n) <= WIDE_SMEM_MAX:
        return "persistent"
    return "replicated"


def wide_launch(ca: int, cb: int, up_a: bool, hid: int, n: int, b: int,
                h: int, w: int, sms: int = WIDE_PERSIST_BLOCKS) -> dict:
    """The wide form's launch over a (b, h, w) output, as csrc/c3k2.cu
    makes it (``last_launch``' keys): the grid of tiles x cluster blocks
    (the persistent plan's: its tiles or the card's ``sms``, the fewer),
    the cluster and the dynamic shared memory of the plan it picks
    (``wide_plan``)."""
    tr, tw = wide_tile(hid, n)
    ntiles = b * -(-h // tr) * -(-w // tw)
    plan = wide_plan(ca, cb, up_a, hid, n, b, h, w)
    if plan == "persistent":
        tr, tw = PERSIST_TILE
        tiles = b * -(-h // tr) * -(-w // tw)
        return {"grid": [min(tiles, sms), 1, 1], "cluster": [1, 1, 1],
                "threads": 256,
                "smem_bytes": wide_smem_persist(ca, cb, up_a, hid, n)}
    if plan == "owned":
        s, smem = hid // 64, wide_smem_owned(hid, n)
    else:
        s, smem = REPLICATED_SPLIT[hid], wide_smem_bytes(ca, cb, up_a, hid,
                                                          n)
    return {"grid": [ntiles * s, 1, 1], "cluster": [s, 1, 1],
            "threads": 256, "smem_bytes": smem}


def last_launch() -> dict:
    """The shape of the last C3k2 launch (either entry point)."""
    return _lib.last_launch("unina_c3k2_last_launch")


def wide_smem(ca: int, cb: int, up_a: bool, hid: int, n: int) -> int:
    """The wide form's shared memory at these widths, from the library
    (-1 at a hidden width it is not compiled for)."""
    return _lib.query("unina_c3k2_wide_smem", [I] * 5, ca, cb, int(up_a),
                      hid, n)


def pack_c3k2_weights(cv1, cv2, cv3, bottlenecks, dtype: torch.dtype):
    """HWIO ``(kernel, bias)`` pairs -> the kernel's flat operands.

    ``cv1``/``cv2``/``cv3`` are the three 1x1 convs, ``bottlenecks`` a
    list of ``((k1, b1), (k2, b2))`` (1x1 then 3x3) per bottleneck."""
    def f32(a):
        return torch.from_numpy(np.array(a, np.float32))

    (k1, b1), (k2, b2), (k3, b3) = cv1, cv2, cv3
    hd = np.shape(k1)[-1]
    w1 = f32(k1).reshape(-1, hd).to(dtype)
    w2 = f32(k2).reshape(-1, hd).to(dtype)
    w3 = f32(k3).reshape(2 * hd, -1).to(dtype)
    wb1 = torch.stack([f32(k).reshape(hd, hd) for (k, _), _ in bottlenecks]
                      ).to(dtype)
    bb1 = torch.stack([f32(b) for (_, b), _ in bottlenecks])
    wb2 = torch.stack([f32(k) for _, (k, _) in bottlenecks]).to(dtype)
    bb2 = torch.stack([f32(b) for _, (_, b) in bottlenecks])
    return (w1, f32(b1), wb1, bb1, wb2, bb2, w2, f32(b2), w3, f32(b3))


def _dot(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """float32 sum of products of compute-dtype values."""
    return t.float() @ w.float()


def _act(z: torch.Tensor, b: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return torch.relu(z + b.float()).to(dt)


def _conv3x3(t: torch.Tensor, w: torch.Tensor, b: torch.Tensor
             ) -> torch.Tensor:
    """ReLU(3x3 same-pad conv) as nine shifted products, f32 sum."""
    h, wd = t.shape[-3:-1]
    tp = F.pad(t, (0, 0, 1, 1, 1, 1))
    acc = None
    for kh in range(3):
        for kw in range(3):
            z = _dot(tp[:, kh:kh + h, kw:kw + wd], w[kh, kw])
            acc = z if acc is None else acc + z
    return _act(acc, b, t.dtype)


def _up2(t: torch.Tensor) -> torch.Tensor:
    return t.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)


def _post(p1, p2, wb1, bb1, wb2, bb2, w3, b3, shortcut: bool):
    """Bottleneck chain + the cv3 split dot."""
    for i in range(wb1.shape[0]):
        t = _act(_dot(p1, wb1[i]), bb1[i], p1.dtype)
        t = _conv3x3(t, wb2[i], bb2[i])
        p1 = p1 + t if shortcut else t
    h = p1.shape[-1]
    return _act(_dot(p1, w3[:h]) + _dot(p2, w3[h:]), b3, p1.dtype)


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, *x.shape[-3:])


def fused_c3k2_plain(x, w1, b1, wb1, bb1, wb2, bb2, w2, b2, w3, b3, *,
                     shortcut: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the fused C3k2 (any float dtype)."""
    xf = _flat(x)
    dt = x.dtype
    p1 = _act(_dot(xf, w1), b1, dt)
    p2 = _act(_dot(xf, w2), b2, dt)
    out = _post(p1, p2, wb1, bb1, wb2, bb2, w3, b3, shortcut)
    return out.reshape(*x.shape[:-1], out.shape[-1])


def _pair(xa, xb, w, b, up_a: bool):
    ca = xa.shape[-1]
    za = _dot(xa, w[:ca])
    if up_a:
        za = _up2(za)
    return _act(za + _dot(xb, w[ca:]), b, xb.dtype)


def fused_c3k2_cat_plain(xa, xb, w1, b1, wb1, bb1, wb2, bb2, w2, b2, w3, b3,
                         *, shortcut: bool = True, up_a: bool = False
                         ) -> torch.Tensor:
    """Plain PyTorch version of the pair form (any float dtype)."""
    xaf, xbf = _flat(xa), _flat(xb)
    p1 = _pair(xaf, xbf, w1, b1, up_a)
    p2 = _pair(xaf, xbf, w2, b2, up_a)
    out = _post(p1, p2, wb1, bb1, wb2, bb2, w3, b3, shortcut)
    return out.reshape(*xb.shape[:-1], out.shape[-1])


def kernel_takes(cin: int, hid: int, fo: int, n: int, ca: int = 0,
                 up_a: bool = False) -> bool:
    """Whether a CUDA kernel takes these widths (what ``_check_weights``
    asks of them): the caller packs ``wpk`` only then."""
    if not 1 <= n <= KERNEL_NMAX:
        return False
    if (hid, fo) == (KERNEL_HID, KERNEL_F):
        return cin % 8 == 0 and ca % 8 == 0
    return (hid in C3K2_SPLIT and fo == 2 * hid and cin % 8 == 0
            and ca % 8 == 0 and wide_smem_bytes(
                ca, cin - ca, up_a, hid, n) <= WIDE_SMEM_MAX)


def _check_weights(ws, wpk, cin: int, ca: int = 0, up_a: bool = False
                   ) -> tuple[int, int, int]:
    """-> (n, hidden, F), after the checks of the form these widths take:
    the tiled kernel at hidden 32 and F 64 (Cin a multiple of 8); the wide
    form at hidden 16, 64, 128 and 256 with F = 2 hidden (Cin and Ca
    multiples of 8, its windows within shared memory); nothing else."""
    w1, b1, wb1, bb1, wb2, bb2, w2, b2, w3, b3 = ws
    n, hd, fo = wb1.shape[0], w1.shape[-1], w3.shape[-1]
    if not 1 <= n <= KERNEL_NMAX:
        raise ValueError(f"kernel takes 1..{KERNEL_NMAX} bottlenecks, got {n}")
    if (hd, fo) == (KERNEL_HID, KERNEL_F):
        if cin % 8:
            raise ValueError(f"kernel takes Cin a multiple of 8, got {cin}")
    else:
        if hd not in C3K2_SPLIT or fo != 2 * hd or cin % 8 or ca % 8:
            raise ValueError(
                f"wide form takes hidden in {sorted(C3K2_SPLIT)} with F = 2 "
                f"hidden, Cin and Ca multiples of 8, got hidden {hd}, F "
                f"{fo}, Cin {cin}, Ca {ca}")
        smem = wide_smem_bytes(ca, cin - ca, up_a, hd, n)
        if smem > WIDE_SMEM_MAX:
            raise ValueError(
                f"wide form: Cin {cin} (Ca {ca}{', upsampled' if up_a else ''}"
                f") needs {smem} bytes of shared memory at hidden {hd}, n "
                f"{n}, past the {WIDE_SMEM_MAX} a block has")
    if wpk is None:
        raise ValueError("the CUDA kernel needs wpk = pack_c3k2_mma(w1, w2, "
                         "wb1, wb2, w3, ca)")
    check_cuda(wpk, "wpk", torch.bfloat16,
               (c3k2_mma_numel(cin, n, ca, hd, fo),))
    for t, name, shape in ((b1, "b1", (hd,)), (b2, "b2", (hd,)),
                           (bb1, "bb1", (n, hd)), (bb2, "bb2", (n, hd)),
                           (b3, "b3", (fo,))):
        check_cuda(t, name, torch.float32, shape)
    return n, hd, fo


def _ptrs(ws, wpk):
    _, b1, _, bb1, _, bb2, _, b2, _, b3 = ws
    return [t.data_ptr() for t in (wpk, b1, bb1, bb2, b2, b3)]


def fused_c3k2(x: torch.Tensor, *ws, shortcut: bool = True,
               wpk: torch.Tensor | None = None) -> torch.Tensor:
    """The fused C3k2 over ``x`` (..., H, W, Cin) -> (..., H, W, F).

    The CUDA kernel takes bf16 ``x`` and 1 or 2 bottlenecks; batch rides
    on its tile index. At hidden 32 and F 64 the tiled kernel takes Cin a
    multiple of 8; it keeps a window of every 64-channel chunk of the input
    in shared memory, so its launch is refused (RuntimeError) beyond 5
    chunks with one bottleneck, 3 with two. Every other width goes to the
    wide form (see ``_check_weights``). Of ``ws`` the kernel reads the
    biases, and the weights from ``wpk``."""
    if not x.is_cuda:
        return fused_c3k2_plain(x, *ws, shortcut=shortcut)
    check_cuda(x, "x", torch.bfloat16)
    h, w, cin = x.shape[-3:]
    n, hd, fo = _check_weights(ws, wpk, cin)
    bsz = x.numel() // (h * w * cin)
    out = torch.empty((*x.shape[:-1], fo), dtype=torch.bfloat16,
                      device=x.device)
    KERNEL.launch(x.data_ptr(), cin, *_ptrs(ws, wpk), out.data_ptr(), bsz, h,
                  w, n, int(shortcut), hd, fo, stream_ptr(x.device))
    return out


def fused_c3k2_cat(xa: torch.Tensor, xb: torch.Tensor, *ws,
                   shortcut: bool = True, up_a: bool = False,
                   wpk: torch.Tensor | None = None) -> torch.Tensor:
    """The fused C3k2 over ``concat([upsample2x?(xa), xb])``: ``xa``
    (..., H/2, W/2, Ca) when ``up_a`` else (..., H, W, Ca), ``xb``
    (..., H, W, Cb) -> (..., H, W, F). The CUDA kernel takes bf16 inputs
    with Ca and Cb multiples of 8 and the widths and limits of
    ``fused_c3k2`` (the tiled kernel counts ``xa``'s and ``xb``'s chunks
    separately; the wide form takes Ca + Cb as its Cin); ``wpk`` is packed
    with ``ca = Ca``."""
    if not xb.is_cuda:
        return fused_c3k2_cat_plain(xa, xb, *ws, shortcut=shortcut,
                                    up_a=up_a)
    check_cuda(xb, "xb", torch.bfloat16)
    h, w, cb = xb.shape[-3:]
    lead = xb.shape[:-3]
    ca = xa.shape[-1]
    hs, ws_ = (h // 2, w // 2) if up_a else (h, w)
    check_cuda(xa, "xa", torch.bfloat16, (*lead, hs, ws_, ca))
    if ca % 8 or cb % 8 or (up_a and (h % 2 or w % 2)):
        raise ValueError(f"kernel takes Ca, Cb multiples of 8 (and even H, "
                         f"W to upsample), got xa {tuple(xa.shape)}, xb "
                         f"{tuple(xb.shape)}")
    n, hd, fo = _check_weights(ws, wpk, ca + cb, ca, up_a)
    bsz = xb.numel() // (h * w * cb)
    out = torch.empty((*lead, h, w, fo), dtype=torch.bfloat16,
                      device=xb.device)
    KERNEL_CAT.launch(xa.data_ptr(), xb.data_ptr(), ca, cb, int(up_a),
                      *_ptrs(ws, wpk), out.data_ptr(), bsz, h, w, n,
                      int(shortcut), hd, fo, stream_ptr(xb.device))
    return out
