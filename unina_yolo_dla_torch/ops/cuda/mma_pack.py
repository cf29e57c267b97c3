"""Host-side packing of weights into the tensor-core kernels' B operands.

``csrc/mma_sm90.cuh`` reads a weight tile from shared memory as
``[64 n][64 k]``, K contiguous (128 bytes a row in bf16), with the eight
16-byte chunks of row ``n`` stored at ``chunk ^ (n & 7)`` (the 128-byte
swizzle). The wide C3k2 and head kernels (``csrc/wide_mma.cuh``) stream
the same tiles through a ring in shared memory, one 64-deep K chunk of
one cluster block's output columns at a time (``_wide_stream``), and read
the head's 1x1 preds as m16n8k16 B fragments (``pack_frag``). The
functions here build exactly those images once at load, so the device
copies them flat, and invert them. All are pure permutations (with zero
padding): they work in any dtype and on any device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

TILE = 64          # rows (n) and depth (k) of one B tile
CHUNK = 8          # elements of one 16-byte bf16 chunk


def _swizzle(t: torch.Tensor) -> torch.Tensor:
    """(..., n, 64) -> the same with row n's chunk c moved to c ^ (n & 7).
    XOR is its own inverse, so this also undoes itself."""
    *lead, n, k = t.shape
    rows = torch.arange(n, device=t.device)[:, None] & 7
    src = torch.arange(k // CHUNK, device=t.device)[None, :] ^ rows
    chunks = t.reshape(*lead, n, k // CHUNK, CHUNK)
    idx = src[..., None].expand(*lead, n, k // CHUNK, CHUNK)
    return torch.gather(chunks, -2, idx).reshape(*lead, n, k)


def pack_b_tiles(w: torch.Tensor) -> torch.Tensor:
    """(..., 64 k, N) weights, N a multiple of 8 -> (..., N, 64) swizzled:
    tiles of ``[n][64 k]`` stacked along n (64 rows each for the m64n64
    products, 32 for the m64n32 ones)."""
    if w.shape[-2] != TILE or w.shape[-1] % CHUNK:
        raise ValueError(f"expected (..., {TILE}, N = j * {CHUNK}), got "
                         f"{tuple(w.shape)}")
    return _swizzle(w.transpose(-1, -2)).contiguous()


def unpack_b_tiles(p: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_b_tiles``."""
    return _swizzle(p).transpose(-1, -2).contiguous()


def pack_frag(w: torch.Tensor) -> torch.Tensor:
    """(K, N) weights, K a multiple of 16 and N of 8 -> the flat fragment
    image ``(N/8, K/16, 32 lanes, 4)``: lane ``4g + tq`` of n8 tile ``nt``
    and k16 step ``ks`` holds ``W[16ks + 2tq (+1)][8nt + g]`` then
    ``W[16ks + 8 + 2tq (+1)][8nt + g]``."""
    k, n = w.shape
    if k % 16 or n % CHUNK:
        raise ValueError(f"expected (16 i, 8 j), got {tuple(w.shape)}")
    # (ks, h, tq, l, nt, g) -> (nt, ks, g, tq, h, l)
    t = w.reshape(k // 16, 2, 4, 2, n // CHUNK, CHUNK)
    return t.permute(4, 0, 5, 2, 1, 3).contiguous().reshape(-1)


def unpack_frag(p: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """Inverse of ``pack_frag`` for a (k, n) matrix."""
    t = p.reshape(n // CHUNK, k // 16, CHUNK, 4, 2, 2)
    return t.permute(1, 4, 3, 5, 0, 2).contiguous().reshape(k, n)


# The stem and stage1 kernels' widths: C = 2 x the base width is the
# merged stem output's channels and stage1's output channels (base 16, 32,
# 64). One wgmma covers min(C, 64) output columns; at C = 128 each block
# takes one 64-column half of stage1 (csrc/stage1_tile.cuh Width).
STEM_STAGE1_WIDTHS = (32, 64, 128)


def stage1_columns(c: int) -> int:
    """Output columns of one stage1 product (and of a block) at width
    ``c``."""
    return min(c, TILE)


def stage1_mma_shape(c: int) -> tuple[int, int, int]:
    """Shape of ``pack_stage1_mma``'s image at width ``c``."""
    n = stage1_columns(c)
    return (c // n * c // 8, n, TILE)


def stem_stage1_takes(c: int) -> bool:
    """Whether the stem and stage1 kernels are compiled for width ``c``
    (the stem's outputs, stage1's inputs per merged column and outputs)."""
    return c in STEM_STAGE1_WIDTHS


def _check_width(c: int, what: str, shape) -> None:
    if not stem_stage1_takes(c):
        raise ValueError(f"{what} {tuple(shape)}: the kernel is compiled "
                         f"for widths {STEM_STAGE1_WIDTHS}")


def pack_stage1_mma(wb: torch.Tensor) -> torch.Tensor:
    """Blocked stage1 kernel (2, 2, 2C, C) -> (C/N * 8C/64, N, 64), N =
    ``stage1_columns(C)``: per N-column block, one tile per 64-deep chunk
    of K = ``((kh*2 + kw)*2 + di) * C + c``, the order the kernel walks
    them. At C = 64: (8, 64, 64), one tile per tap."""
    if wb.dim() != 4 or tuple(wb.shape[:2]) != (2, 2) or \
            wb.shape[2] != 2 * wb.shape[3]:
        raise ValueError(f"expected a (2, 2, 2C, C) kernel, got "
                         f"{tuple(wb.shape)}")
    c = wb.shape[3]
    _check_width(c, "stage1 kernel", wb.shape)
    n = stage1_columns(c)
    kc = 8 * c // TILE
    t = wb.reshape(kc, TILE, c // n, n).permute(2, 0, 1, 3)
    return pack_b_tiles(t).reshape(c // n * kc, n, TILE)


def unpack_stage1_mma(p: torch.Tensor) -> torch.Tensor:
    tiles, n, _ = p.shape
    c = round((8 * n * tiles) ** 0.5)   # tiles = C/N * 8C/64
    w = unpack_b_tiles(p.reshape(c // n, 8 * c // TILE, n, TILE))
    return w.permute(1, 2, 0, 3).reshape(2, 2, 2 * c, c).contiguous()


def _pad_k(w: torch.Tensor) -> torch.Tensor:
    """(..., K, N) -> (..., 64 j, N): K zero-padded to whole tiles."""
    return F.pad(w, (0, 0, 0, -w.shape[-2] % TILE))


def pack_stem_mma(ws: torch.Tensor) -> torch.Tensor:
    """Stem kernel (2, 2, 24, C) -> (2, C, 64): one tile per kernel row
    ``kh`` with K = ``kw*24 + c`` (the 96 contiguous bytes of a frame
    pixel and its right neighbour), zero-padded from 48 to 64."""
    if ws.dim() != 4 or tuple(ws.shape[:3]) != (2, 2, 24):
        raise ValueError(f"expected (2, 2, 24, C), got {tuple(ws.shape)}")
    _check_width(ws.shape[3], "stem kernel", ws.shape)
    return pack_b_tiles(_pad_k(ws.reshape(2, 48, ws.shape[3])))


def unpack_stem_mma(p: torch.Tensor) -> torch.Tensor:
    c = p.shape[1]
    return unpack_b_tiles(p)[:, :48].reshape(2, 2, 24, c).contiguous()


# The wide kernels split every product's output columns over a cluster
# of blocks (csrc/wide_mma.cuh) at the widest widths, whose 40 x 40 images
# have too few tiles for the SMs: blocks of a cluster by the C3k2's hidden
# width and by the head's width. These are the widths they are compiled
# for.
C3K2_SPLIT = {16: 1, 64: 1, 128: 4}
HEAD_SPLIT = {32: 1, 128: 1, 256: 2}
PRED_N = 8         # pred outputs the wide head's fragment image holds


def _planes(c: int) -> int:
    """64-channel planes of a window of ``c`` channels."""
    return -(-c // TILE)


def _wide_tiles(w: torch.Tensor, s: int) -> torch.Tensor:
    """(64 kc, N) -> (s, kc, N/s, 64): per cluster block ``r`` (output
    columns ``r N/s ..``) and 64-deep K chunk, one swizzled B tile."""
    k, n = w.shape
    t = w.reshape(k // TILE, TILE, s, n // s).permute(2, 0, 1, 3)
    return pack_b_tiles(t)


def _untiles(t: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_wide_tiles``."""
    s, kc, ns, _ = t.shape
    return unpack_b_tiles(t).permute(1, 2, 0, 3).reshape(kc * TILE, s * ns)


def _wide_stream(mats: list[torch.Tensor], s: int) -> torch.Tensor:
    """The wide kernels' weight stream: per cluster block, every stage's
    chunks in the order the block consumes them, blocks one after the
    other (so block ``r``'s stream is one contiguous range)."""
    tiles = [_wide_tiles(m, s) for m in mats]
    return torch.cat([t[r].reshape(-1) for r in range(s) for t in tiles])


def _unstream(p: torch.Tensor, shapes: list[tuple[int, int]], s: int
              ) -> list[torch.Tensor]:
    """Inverse of ``_wide_stream`` for stage matrices of ``shapes``."""
    per = [k * n // s for k, n in shapes]
    blocks = p.reshape(s, sum(per))
    return [_untiles(part.reshape(s, k // TILE, n // s, TILE))
            for part, (k, n) in zip(blocks.split(per, dim=1), shapes)]


def _taps(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, N) -> (9 * 64 planes, N): K chunk ``tap * planes + q``
    holds input channels ``64 q ..`` of tap ``tap``, zero-padded."""
    return torch.cat([_pad_k(w[kh, kw]) for kh in range(3)
                      for kw in range(3)])


def _untaps(m: torch.Tensor, c: int) -> torch.Tensor:
    rows = _planes(c) * TILE
    return torch.stack([m[t * rows:t * rows + c] for t in range(9)]
                       ).reshape(3, 3, c, m.shape[-1])


def head_mma_shape(c: int) -> tuple[int, ...]:
    """Shape of ``pack_head_mma``'s image at head width ``c``."""
    if c == TILE:
        return (18, 2 * TILE, TILE)
    return (2 * 18 * _planes(c) * TILE * c + 2 * c * PRED_N,)


def pack_head_mma(wc1: torch.Tensor, wr1: torch.Tensor, wc2: torch.Tensor,
                  wr2: torch.Tensor, wcp: torch.Tensor, wrp: torch.Tensor
                  ) -> torch.Tensor:
    """The head's four 3x3 kernels (3, 3, C, C) and its preds ``wcp``,
    ``wrp`` (C, no <= 8) -> the CUDA kernel's image.

    At C = 64 (the tiled kernel) (18, 128, 64): slab ``s < 9`` is tap ``s``
    of conv1 with the branches concatenated along n (``cls | reg``), slab
    ``9 + s`` the same of conv2; the tiled kernel reads the preds from the
    flat operands, not from here. At the wide kernel's widths
    (``HEAD_SPLIT``) a flat image: per branch (cls, reg) the weight stream
    of its cluster's blocks, conv1's nine taps then conv2's, each a (9 * 64
    planes, C) matrix split by output columns (``_wide_stream``); then the
    preds as m16n8k16 B fragments of (C, 8), zero-padded (``pack_frag``)."""
    c = wc1.shape[-1]
    for w in (wc1, wr1, wc2, wr2):
        if tuple(w.shape) != (3, 3, c, c) or c % 16:
            raise ValueError(f"expected four (3, 3, C, C), C a multiple of "
                             f"16, got {tuple(w.shape)}")
    for wp in (wcp, wrp):
        if wp.dim() != 2 or wp.shape[0] != c or not (
                1 <= wp.shape[1] <= PRED_N):
            raise ValueError(f"expected preds (C, 1..{PRED_N}), got "
                             f"{tuple(wp.shape)}")
    if c == TILE:
        slabs = torch.cat([torch.cat([wc1, wr1], dim=-1),
                           torch.cat([wc2, wr2], dim=-1)])  # (6, 3, 64, 128)
        return pack_b_tiles(slabs.reshape(18, TILE, 2 * TILE))
    if c not in HEAD_SPLIT:
        raise ValueError(f"the wide head is compiled for C in "
                         f"{sorted(HEAD_SPLIT)}, got {c}")
    s = HEAD_SPLIT[c]
    return torch.cat([_wide_stream([_taps(w1), _taps(w2)], s)
                      for w1, w2 in ((wc1, wc2), (wr1, wr2))]
                     + [pack_frag(F.pad(wp, (0, PRED_N - wp.shape[1])))
                        for wp in (wcp, wrp)])


def unpack_head_mma(p: torch.Tensor):
    """Inverse of ``pack_head_mma``: ``(wc1, wr1, wc2, wr2)``, and at the
    wide widths the preds zero-padded to (C, 8) after them."""
    if p.dim() == 1:
        c = next(c for c in HEAD_SPLIT if head_mma_shape(c)[0] == p.numel())
        s, k = HEAD_SPLIT[c], 9 * _planes(c) * TILE
        per = 2 * k * c
        (c1, c2), (r1, r2) = (_unstream(q, [(k, c), (k, c)], s)
                              for q in p[:2 * per].split(per))
        preds = [unpack_frag(q, c, PRED_N) for q in p[2 * per:].split(
            c * PRED_N)]
        return (_untaps(c1, c), _untaps(r1, c), _untaps(c2, c),
                _untaps(r2, c), *preds)
    w = unpack_b_tiles(p).reshape(2, 3, 3, TILE, 2 * TILE)
    return (w[0, ..., :TILE].contiguous(), w[0, ..., TILE:].contiguous(),
            w[1, ..., :TILE].contiguous(), w[1, ..., TILE:].contiguous())


HID = 32           # the tiled C3k2 kernel's hidden width: K and N of its
F_OUT = 64         # slabs, and its output width


def _c3k2_chunks(ca: int, cin: int) -> list[tuple[int, int]]:
    """Row ranges of the first products' K chunks: ``xa``'s channels
    (``ca`` of them, 0 in the single form), then ``xb``'s, each in chunks
    of at most 64."""
    return [(lo, min(lo + TILE, hi))
            for start, hi in ((0, ca), (ca, cin))
            for lo in range(start, hi, TILE)]


def _c3k2_wide(w1, w2, wb1, wb2, w3, ca: int) -> list[torch.Tensor]:
    """The wide kernel's stage matrices in stream order, K in 64-deep
    chunks: [w1 | w2] over ``xa``'s chunks then ``xb``'s; per bottleneck
    ``wb1`` and the 3x3 (``_taps``); then ``w3`` over the [p1 | p2]
    window's planes."""
    cin = w1.shape[0]
    wa = torch.cat([w1, w2], dim=-1)
    mats = [torch.cat([_pad_k(wa[lo:hi]) for lo, hi in
                       _c3k2_chunks(ca, cin)])]
    for i in range(wb1.shape[0]):
        mats += [_pad_k(wb1[i]), _taps(wb2[i])]
    return mats + [_pad_k(w3)]


def _c3k2_wide_shapes(cin: int, n: int, ca: int, hid: int, fo: int
                      ) -> list[tuple[int, int]]:
    first = len(_c3k2_chunks(ca, cin)) * TILE
    pt = _planes(hid) * TILE
    return ([(first, 2 * hid)] + [(pt, hid), (9 * pt, hid)] * n
            + [(_planes(2 * hid) * TILE, fo)])


def pack_c3k2_mma(w1: torch.Tensor, w2: torch.Tensor, wb1: torch.Tensor,
                  wb2: torch.Tensor, w3: torch.Tensor, ca: int = 0
                  ) -> torch.Tensor:
    """The fused C3k2's weights (``pack_c3k2_weights`` layouts) -> the flat
    image the CUDA kernel reads.

    At hidden 32 and F 64 (the tiled kernel, ``csrc/c3k2.cu``'s first
    form), the image it copies to shared memory:

    - one ``[64 n][64 k]`` tile per K chunk of the first products, n =
      ``[w1 | w2]``, k = 64 input channels (zero-padded); in the pair form
      ``xa``'s ``ca`` channels fill their own chunks, ahead of ``xb``'s;
    - per bottleneck five ``[32 n][64 k]`` tiles holding ten K = 32 slabs,
      two a tile along k: ``wb1``, then the nine 3x3 taps;
    - one ``[64 n][64 k]`` tile of ``w3`` (k = ``[p1 | p2]``).

    At the wide kernel's widths (hidden in ``C3K2_SPLIT``, F = 2 hidden)
    the weight stream of its cluster's blocks (``_wide_stream``) over the
    stage matrices of ``_c3k2_wide``: the same chunks of ``xa`` and
    ``xb``, every K zero-padded to whole 64-deep chunks of the windows'
    planes, every stage's output columns split evenly over the blocks."""
    cin, n = w1.shape[0], wb1.shape[0]
    hd, fo = w1.shape[-1], w3.shape[-1]
    if (tuple(w1.shape) != (cin, hd) or tuple(w2.shape) != (cin, hd)
            or tuple(wb1.shape) != (n, hd, hd)
            or tuple(wb2.shape) != (n, 3, 3, hd, hd)
            or tuple(w3.shape) != (2 * hd, fo) or not 0 <= ca < cin):
        shapes = [tuple(t.shape) for t in (w1, w2, wb1, wb2, w3)]
        raise ValueError("expected pack_c3k2_weights' layouts and 0 <= ca "
                         f"< Cin, got {shapes}, ca {ca}")
    if (hd, fo) != (HID, F_OUT):
        if hd not in C3K2_SPLIT or fo != 2 * hd:
            raise ValueError(f"the wide C3k2 is compiled for hidden in "
                             f"{sorted(C3K2_SPLIT)} and F = 2 hidden, got "
                             f"hidden {hd}, F {fo}")
        return _wide_stream(_c3k2_wide(w1, w2, wb1, wb2, w3, ca),
                            C3K2_SPLIT[hd])
    wa = torch.cat([w1, w2], dim=-1)
    first = torch.stack([_pad_k(wa[lo:hi]) for lo, hi in
                         _c3k2_chunks(ca, cin)])
    slabs = torch.cat([wb1[:, None], wb2.reshape(n, 9, HID, HID)], dim=1)
    return torch.cat([pack_b_tiles(first).reshape(-1),
                      pack_b_tiles(slabs.reshape(n, 5, TILE, HID)
                                   ).reshape(-1),
                      pack_b_tiles(w3).reshape(-1)])


def c3k2_mma_numel(cin: int, n: int, ca: int = 0, hid: int = HID,
                   fo: int = F_OUT) -> int:
    """Elements of ``pack_c3k2_mma``'s image."""
    if (hid, fo) != (HID, F_OUT):
        return sum(k * m for k, m in _c3k2_wide_shapes(cin, n, ca, hid, fo))
    return (len(_c3k2_chunks(ca, cin)) + 1) * TILE * TILE \
        + n * 5 * HID * TILE


def unpack_c3k2_mma(p: torch.Tensor, cin: int, n: int, ca: int = 0,
                    hid: int = HID, fo: int = F_OUT):
    """Inverse of ``pack_c3k2_mma``: ``(w1, w2, wb1, wb2, w3)``."""
    if (hid, fo) != (HID, F_OUT):
        mats = _unstream(p, _c3k2_wide_shapes(cin, n, ca, hid, fo),
                         C3K2_SPLIT[hid])
        wa = torch.cat([mats[0][q * TILE:q * TILE + hi - lo] for q, (lo, hi)
                        in enumerate(_c3k2_chunks(ca, cin))])
        wb1 = torch.stack([m[:hid] for m in mats[1:-1:2]])
        wb2 = torch.stack([_untaps(m, hid) for m in mats[2:-1:2]])
        return (wa[:, :hid].contiguous(), wa[:, hid:].contiguous(), wb1,
                wb2, mats[-1][:2 * hid].contiguous())
    chunks = _c3k2_chunks(ca, cin)
    kc = len(chunks)
    first, mid, last = p.split([kc * TILE * TILE, n * 5 * HID * TILE,
                                TILE * TILE])
    first = unpack_b_tiles(first.reshape(kc, TILE, TILE))
    wa = torch.cat([first[q, :hi - lo] for q, (lo, hi) in enumerate(chunks)])
    slabs = unpack_b_tiles(mid.reshape(n, 5, HID, TILE)).reshape(
        n, 10, HID, HID)
    return (wa[:, :HID].contiguous(), wa[:, HID:].contiguous(),
            slabs[:, 0].contiguous(),
            slabs[:, 1:].reshape(n, 3, 3, HID, HID).contiguous(),
            unpack_b_tiles(last.reshape(TILE, TILE)))
