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
    """(..., 64 k, N) weights, N a multiple of 64 -> (..., N, 64) swizzled:
    ``N / 64`` tiles of ``[64 n][64 k]`` stacked along n."""
    if w.shape[-2] != TILE or w.shape[-1] % TILE:
        raise ValueError(f"expected (..., {TILE}, N = j * {TILE}), got "
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
