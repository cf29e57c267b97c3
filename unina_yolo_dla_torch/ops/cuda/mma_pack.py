"""Host-side packing of weights into the tensor-core kernels' B operands.

``csrc/mma_sm90.cuh`` reads a weight tile from shared memory as
``[64 n][64 k]``, K contiguous (128 bytes a row in bf16), with the eight
16-byte chunks of row ``n`` stored at ``chunk ^ (n & 7)`` (the 128-byte
swizzle). The wide C3k2 and head kernels (``csrc/wide_mma.cuh``) read a
(K, N) matrix as its m16n8k16 B fragments straight from global memory
(``pack_frag``). The functions here build exactly those images once at
load, so the device reads them flat, and invert them. All are pure
permutations: they work in any dtype and on any device.
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


def pack_stage1_mma(wb: torch.Tensor) -> torch.Tensor:
    """Blocked stage1 kernel (2, 2, 128, 64) -> (8, 64, 64): one tile per
    K chunk ``q = (kh*2 + kw)*2 + di``, the order the kernel walks them."""
    if tuple(wb.shape) != (2, 2, 2 * TILE, TILE):
        raise ValueError(f"expected (2, 2, 128, 64), got {tuple(wb.shape)}")
    return pack_b_tiles(wb.reshape(8, TILE, TILE))


def unpack_stage1_mma(p: torch.Tensor) -> torch.Tensor:
    return unpack_b_tiles(p).reshape(2, 2, 2 * TILE, TILE)


def _pad_k(w: torch.Tensor) -> torch.Tensor:
    """(..., K, N) -> (..., 64 j, N): K zero-padded to whole tiles."""
    return F.pad(w, (0, 0, 0, -w.shape[-2] % TILE))


def pack_stem_mma(ws: torch.Tensor) -> torch.Tensor:
    """Stem kernel (2, 2, 24, 64) -> (2, 64, 64): one tile per kernel row
    ``kh`` with K = ``kw*24 + c`` (the 96 contiguous bytes of a frame
    pixel and its right neighbour), zero-padded from 48 to 64."""
    if tuple(ws.shape) != (2, 2, 24, TILE):
        raise ValueError(f"expected (2, 2, 24, 64), got {tuple(ws.shape)}")
    return pack_b_tiles(_pad_k(ws.reshape(2, 48, TILE)))


def unpack_stem_mma(p: torch.Tensor) -> torch.Tensor:
    return unpack_b_tiles(p)[:, :48].reshape(2, 2, 24, TILE).contiguous()


def head_mma_shape(c: int) -> tuple[int, ...]:
    """Shape of ``pack_head_mma``'s image at head width ``c``."""
    return (18, 2 * TILE, TILE) if c == TILE else (4 * 9 * c * c,)


def pack_head_mma(wc1: torch.Tensor, wr1: torch.Tensor, wc2: torch.Tensor,
                  wr2: torch.Tensor) -> torch.Tensor:
    """The head's four 3x3 kernels (3, 3, C, C) -> the CUDA kernel's image.

    At C = 64 (the tiled kernel) (18, 128, 64): slab ``s < 9`` is tap ``s``
    of conv1 with the branches concatenated along n (``cls | reg``), slab
    ``9 + s`` the same of conv2. At any other C, a multiple of 16 (the wide
    kernel), ``pack_frag`` of each kernel as a (9C, C) matrix, K = tap * C
    + input channel, in the order ``wc1, wr1, wc2, wr2``, flat."""
    c = wc1.shape[-1]
    for w in (wc1, wr1, wc2, wr2):
        if tuple(w.shape) != (3, 3, c, c) or c % 16:
            raise ValueError(f"expected four (3, 3, C, C), C a multiple of "
                             f"16, got {tuple(w.shape)}")
    if c != TILE:
        return torch.cat([pack_frag(w.reshape(9 * c, c))
                          for w in (wc1, wr1, wc2, wr2)])
    slabs = torch.cat([torch.cat([wc1, wr1], dim=-1),
                       torch.cat([wc2, wr2], dim=-1)])  # (6, 3, 64, 128)
    return pack_b_tiles(slabs.reshape(18, TILE, 2 * TILE))


def unpack_head_mma(p: torch.Tensor):
    """Inverse of ``pack_head_mma``: ``(wc1, wr1, wc2, wr2)``."""
    if p.dim() == 1:
        c = int(round((p.numel() // 36) ** 0.5))
        return tuple(unpack_frag(q, 9 * c, c).reshape(3, 3, c, c)
                     for q in p.split(9 * c * c))
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


def _c3k2_wide(w1, w2, wb1, wb2, w3) -> list[torch.Tensor]:
    """The wide kernel's matrices in image order: ``[w1 | w2]``, then per
    bottleneck ``wb1`` and the 3x3 as a (9h, h) matrix, then ``w3``."""
    n, hd = wb1.shape[0], wb1.shape[-1]
    mats = [torch.cat([w1, w2], dim=-1)]
    for i in range(n):
        mats += [wb1[i], wb2[i].reshape(9 * hd, hd)]
    return mats + [w3]


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

    At any other (hidden, F), hidden and Cin multiples of 16 and F of 8
    (the wide form), ``pack_frag`` of ``[w1 | w2]`` (Cin, 2h), of each
    bottleneck's ``wb1`` (h, h) and 3x3 (9h, h; K = tap * h + channel),
    and of ``w3`` (2h, F), concatenated; ``ca`` changes nothing there (the
    rows are already ``xa``'s then ``xb``'s)."""
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
        return torch.cat([pack_frag(m) for m in
                          _c3k2_wide(w1, w2, wb1, wb2, w3)])
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
        return cin * 2 * hid + n * 10 * hid * hid + 2 * hid * fo
    return (len(_c3k2_chunks(ca, cin)) + 1) * TILE * TILE \
        + n * 5 * HID * TILE


def unpack_c3k2_mma(p: torch.Tensor, cin: int, n: int, ca: int = 0,
                    hid: int = HID, fo: int = F_OUT):
    """Inverse of ``pack_c3k2_mma``: ``(w1, w2, wb1, wb2, w3)``."""
    if (hid, fo) != (HID, F_OUT):
        dims = [(cin, 2 * hid)] + [(hid, hid), (9 * hid, hid)] * n + [
            (2 * hid, fo)]
        mats = [unpack_frag(q, k, m) for q, (k, m) in
                zip(p.split([k * m for k, m in dims]), dims)]
        wb1 = torch.stack(mats[1:-1:2])
        wb2 = torch.stack(mats[2:-1:2]).reshape(n, 3, 3, hid, hid)
        return (mats[0][:, :hid].contiguous(), mats[0][:, hid:].contiguous(),
                wb1, wb2, mats[-1])
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
