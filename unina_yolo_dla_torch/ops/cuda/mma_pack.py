"""Host-side packing of weights into the tensor-core kernels' B tiles.

``csrc/mma_sm90.cuh`` reads a weight tile from shared memory as
``[64 n][64 k]``, K contiguous (128 bytes a row in bf16), with the eight
16-byte chunks of row ``n`` stored at ``chunk ^ (n & 7)`` (the 128-byte
swizzle). The functions here build exactly that image once at load, so the
device copies it flat, and invert it. All are pure permutations: they work
in any dtype and on any device.
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


def pack_head_mma(wc1: torch.Tensor, wr1: torch.Tensor, wc2: torch.Tensor,
                  wr2: torch.Tensor) -> torch.Tensor:
    """The head's four 3x3 kernels (3, 3, 64, 64) -> (18, 128, 64): slab
    ``s < 9`` is tap ``s`` of conv1 with the branches concatenated along n
    (``cls | reg``), slab ``9 + s`` the same of conv2."""
    for w in (wc1, wr1, wc2, wr2):
        if tuple(w.shape) != (3, 3, TILE, TILE):
            raise ValueError(f"expected (3, 3, 64, 64), got {tuple(w.shape)}")
    slabs = torch.cat([torch.cat([wc1, wr1], dim=-1),
                       torch.cat([wc2, wr2], dim=-1)])  # (6, 3, 64, 128)
    return pack_b_tiles(slabs.reshape(18, TILE, 2 * TILE))


def unpack_head_mma(p: torch.Tensor):
    """Inverse of ``pack_head_mma``: ``(wc1, wr1, wc2, wr2)``."""
    w = unpack_b_tiles(p).reshape(2, 3, 3, TILE, 2 * TILE)
    return (w[0, ..., :TILE].contiguous(), w[0, ..., TILE:].contiguous(),
            w[1, ..., :TILE].contiguous(), w[1, ..., TILE:].contiguous())


HID = 32           # the C3k2 kernel's hidden width: K and N of its slabs


def _c3k2_chunks(ca: int, cin: int) -> list[tuple[int, int]]:
    """Row ranges of the first products' K chunks: ``xa``'s channels
    (``ca`` of them, 0 in the single form), then ``xb``'s, each in chunks
    of at most 64."""
    return [(lo, min(lo + TILE, hi))
            for start, hi in ((0, ca), (ca, cin))
            for lo in range(start, hi, TILE)]


def pack_c3k2_mma(w1: torch.Tensor, w2: torch.Tensor, wb1: torch.Tensor,
                  wb2: torch.Tensor, w3: torch.Tensor, ca: int = 0
                  ) -> torch.Tensor:
    """The fused C3k2's weights (``pack_c3k2_weights`` layouts, hidden 32,
    F 64) -> the flat image ``csrc/c3k2.cu`` copies to shared memory:

    - one ``[64 n][64 k]`` tile per K chunk of the first products, n =
      ``[w1 | w2]``, k = 64 input channels (zero-padded); in the pair form
      ``xa``'s ``ca`` channels fill their own chunks, ahead of ``xb``'s;
    - per bottleneck five ``[32 n][64 k]`` tiles holding ten K = 32 slabs,
      two a tile along k: ``wb1``, then the nine 3x3 taps;
    - one ``[64 n][64 k]`` tile of ``w3`` (k = ``[p1 | p2]``)."""
    cin, n = w1.shape[0], wb1.shape[0]
    if (tuple(w1.shape) != (cin, HID) or tuple(w2.shape) != (cin, HID)
            or tuple(wb1.shape) != (n, HID, HID)
            or tuple(wb2.shape) != (n, 3, 3, HID, HID)
            or tuple(w3.shape) != (2 * HID, TILE) or not 0 <= ca < cin):
        shapes = [tuple(t.shape) for t in (w1, w2, wb1, wb2, w3)]
        raise ValueError("expected hidden 32 and F 64 in pack_c3k2_weights' "
                         f"layouts and 0 <= ca < Cin, got {shapes}, ca {ca}")
    wa = torch.cat([w1, w2], dim=-1)
    first = torch.stack([_pad_k(wa[lo:hi]) for lo, hi in
                         _c3k2_chunks(ca, cin)])
    slabs = torch.cat([wb1[:, None], wb2.reshape(n, 9, HID, HID)], dim=1)
    return torch.cat([pack_b_tiles(first).reshape(-1),
                      pack_b_tiles(slabs.reshape(n, 5, TILE, HID)
                                   ).reshape(-1),
                      pack_b_tiles(w3).reshape(-1)])


def c3k2_mma_numel(cin: int, n: int, ca: int = 0) -> int:
    """Elements of ``pack_c3k2_mma``'s image."""
    return (len(_c3k2_chunks(ca, cin)) + 1) * TILE * TILE \
        + n * 5 * HID * TILE


def unpack_c3k2_mma(p: torch.Tensor, cin: int, n: int, ca: int = 0):
    """Inverse of ``pack_c3k2_mma``: ``(w1, w2, wb1, wb2, w3)``."""
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
