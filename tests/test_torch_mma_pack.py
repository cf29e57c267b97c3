"""The tensor-core kernels' host side on the CPU: the weight repacks
(``ops/cuda/mma_pack.py``) invert exactly and hold the byte image
``csrc/mma_sm90.cuh`` reads, and the kernels' tiling, written out here in
plain PyTorch (tile + halo windows, zero fill outside the image, the c1
halo mask, M padded to 64 rows, weights read back from the packed image),
reproduces the plain versions on ragged shapes. The kernels themselves run
only on the card (``tests/test_torch_gpu.py``)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unina_yolo_dla_torch.ops.cuda import head_kernel, mma_pack, stage1_kernel

TILES = [(8, 16), (4, 32), (16, 16), (5, 7)]


def _kb(rng, shape):
    fan = int(np.prod(shape[:-1]))
    return (rng.normal(0, np.sqrt(2 / fan), shape).astype(np.float32),
            rng.normal(0, .1, shape[-1]).astype(np.float32))


def _head_ws(rng, dtype=torch.float32):
    return head_kernel.pack_head_weights(
        [_kb(rng, (3, 3, 64, 64)), _kb(rng, (3, 3, 64, 64))],
        _kb(rng, (1, 1, 64, 4)),
        [_kb(rng, (3, 3, 64, 64)), _kb(rng, (3, 3, 64, 64))],
        _kb(rng, (1, 1, 64, 4)), dtype)


def _w33(ws):
    return mma_pack.pack_head_mma(ws[0], ws[6], ws[2], ws[8])


def _b_tile(tile: torch.Tensor) -> torch.Tensor:
    """One packed [64 n][64 k'] tile -> B (64 k, 64 n), by the address the
    device computes: element k of row n sits in 16-byte chunk
    ``(k >> 3) ^ (n & 7)`` at position ``k & 7``."""
    n = torch.arange(64)[None, :]
    k = torch.arange(64)[:, None]
    return tile[n, (((k >> 3) ^ (n & 7)) << 3) + (k & 7)]


def _pad64(rows: torch.Tensor) -> torch.Tensor:
    """A's rows padded to a multiple of 64 by repeating the last one, as
    the kernel's clamped ldmatrix rows do; the caller drops them again."""
    extra = -rows.shape[0] % 64
    return torch.cat([rows, rows[-1:].expand(extra, -1)])


# ---- (a) the repacks ----

def test_b_tile_image_and_inverse():
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(0, 1, (3, 64, 128)).astype(np.float32))
    p = mma_pack.pack_b_tiles(w)
    assert p.shape == (3, 128, 64) and p.is_contiguous()
    assert torch.equal(mma_pack.unpack_b_tiles(p), w)
    for i in range(3):
        for half in range(2):
            got = _b_tile(p[i, 64 * half:64 * half + 64])
            assert torch.equal(got, w[i, :, 64 * half:64 * half + 64])
    with pytest.raises(ValueError):
        mma_pack.pack_b_tiles(torch.zeros(32, 64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stage1_pack_inverts_and_plain_is_bit_equal(dtype):
    rng = np.random.default_rng(1)
    wb, b = _kb(rng, (2, 2, 128, 64))
    wb, b = torch.from_numpy(wb).to(dtype), torch.from_numpy(b)
    p = mma_pack.pack_stage1_mma(wb)
    assert p.shape == (8, 64, 64) and p.dtype == dtype
    back = mma_pack.unpack_stage1_mma(p)
    assert torch.equal(back, wb)
    # chunk q = (kh*2 + kw)*2 + di holds wb[kh, kw, di*64:(di+1)*64, :]
    q = (1 * 2 + 0) * 2 + 1
    assert torch.equal(_b_tile(p[q]), wb[1, 0, 64:128, :])
    xm = torch.from_numpy(rng.normal(0, 1, (2, 10, 37, 64)).astype(
        np.float32)).to(dtype)
    assert torch.equal(
        stage1_kernel.fused_downsample_merged_plain(xm, back, b),
        stage1_kernel.fused_downsample_merged_plain(xm, wb, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_pack_inverts_and_plain_is_bit_equal(dtype):
    rng = np.random.default_rng(2)
    ws = _head_ws(rng, dtype)
    assert len(ws) == 12
    w33 = _w33(ws)
    assert w33.shape == (18, 128, 64) and w33.dtype == dtype
    wc1, wr1, wc2, wr2 = mma_pack.unpack_head_mma(w33)
    for got, want in ((wc1, ws[0]), (wr1, ws[6]), (wc2, ws[2]),
                      (wr2, ws[8])):
        assert torch.equal(got, want)
    # conv1's slab of tap (kh, kw) is cls | reg along n; conv2's follow
    assert torch.equal(_b_tile(w33[1 * 3 + 2, :64]), ws[0][1, 2])
    assert torch.equal(_b_tile(w33[1 * 3 + 2, 64:]), ws[6][1, 2])
    assert torch.equal(_b_tile(w33[9 + 2 * 3 + 0, :64]), ws[2][2, 0])
    assert torch.equal(_b_tile(w33[9 + 2 * 3 + 0, 64:]), ws[8][2, 0])
    x = torch.from_numpy(rng.normal(0, 1, (1, 9, 11, 64)).astype(
        np.float32)).to(dtype)
    un = list(ws)
    un[0], un[6], un[2], un[8] = wc1, wr1, wc2, wr2
    for got, want in zip(head_kernel.fused_head_plain(x, *un),
                         head_kernel.fused_head_plain(x, *ws)):
        assert torch.equal(got, want)


def test_head_pack_other_width_has_no_tiles():
    """Only the kernel's width packs into B tiles; the CPU path needs
    none."""
    rng = np.random.default_rng(3)
    ws = head_kernel.pack_head_weights(
        [_kb(rng, (3, 3, 16, 16)), _kb(rng, (3, 3, 16, 16))],
        _kb(rng, (1, 1, 16, 4)),
        [_kb(rng, (3, 3, 16, 16)), _kb(rng, (3, 3, 16, 16))],
        _kb(rng, (1, 1, 16, 4)), torch.float32)
    assert len(ws) == 12
    with pytest.raises(ValueError):
        _w33(ws)
    x = torch.from_numpy(rng.normal(0, 1, (5, 6, 16)).astype(np.float32))
    cls, reg = head_kernel.fused_head(x, *ws)
    assert cls.shape == reg.shape == (5, 6, 4)


# ---- (b), (c) the kernels' tiling in plain PyTorch ----

def _stage1_tiled(xm, p, bias, tr, tw):
    """csrc/stage1.cu's walk: per (tr x tw) output tile a zero-filled
    window of 2*tr + 2 input rows x tw + 1 merged columns, eight K chunks
    (kh, kw, di) of shifted window pixels against the packed tiles."""
    bsz, h, w2, _ = xm.shape
    h2 = h // 2
    out = torch.zeros(bsz, h2, w2, 64)
    rr, cc = torch.meshgrid(torch.arange(tr), torch.arange(tw),
                            indexing="ij")
    rr, cc = rr.reshape(-1), cc.reshape(-1)
    for b in range(bsz):
        for r0 in range(0, h2, tr):
            for w0 in range(0, w2, tw):
                win = torch.zeros(2 * tr + 2, tw + 1, 64)
                for wr in range(2 * tr + 2):
                    s = 2 * r0 - 2 + wr
                    for wc in range(tw + 1):
                        sc = w0 - 1 + wc
                        if 0 <= s < h and 0 <= sc < w2:
                            win[wr, wc] = xm[b, s, sc]
                acc = torch.zeros(-(-tr * tw // 64) * 64, 64)
                for q in range(8):
                    kh, kw, di = q >> 2, (q >> 1) & 1, q & 1
                    a = _pad64(win[2 * rr + 2 * kh + di, cc + kw])
                    acc = acc + a @ _b_tile(p[q])
                res = torch.relu(acc[:tr * tw] + bias).reshape(tr, tw, 64)
                nr, nc = min(tr, h2 - r0), min(tw, w2 - w0)
                out[b, r0:r0 + nr, w0:w0 + nc] = res[:nr, :nc]
    return out


@pytest.mark.parametrize("tr,tw", [(4, 16), (2, 32), (8, 8), (3, 5)])
def test_stage1_tiling_matches_plain(tr, tw):
    rng = np.random.default_rng(4)
    xm = torch.from_numpy(np.maximum(rng.normal(0, 1, (2, 10, 37, 64)),
                                     0).astype(np.float32))
    wb, b = _kb(rng, (2, 2, 128, 64))
    wb, b = torch.from_numpy(wb), torch.from_numpy(b)
    got = _stage1_tiled(xm, mma_pack.pack_stage1_mma(wb), b, tr, tw)
    want = stage1_kernel.fused_downsample_merged_plain(xm, wb, b)
    assert got.shape == want.shape == (2, 5, 37, 64)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def _window(x, r0, c0, rows, cols):
    """rows x cols pixels of (H, W, C) from (r0, c0), zero outside."""
    h, w, _ = x.shape
    win = torch.zeros(rows, cols, x.shape[-1])
    ra, rb = max(r0, 0), min(r0 + rows, h)
    ca, cb = max(c0, 0), min(c0 + cols, w)
    if ra < rb and ca < cb:
        win[ra - r0:rb - r0, ca - c0:cb - c0] = x[ra:rb, ca:cb]
    return win


def _conv_taps(win, slabs, half, out_r, out_c):
    """Nine taps of shifted window pixels, M padded to 64, against the n
    half (0: cls, 1: reg) of each tap's packed slab."""
    rr, cc = torch.meshgrid(torch.arange(out_r), torch.arange(out_c),
                            indexing="ij")
    rr, cc = rr.reshape(-1), cc.reshape(-1)
    acc = torch.zeros(-(-out_r * out_c // 64) * 64, 64)
    for tap in range(9):
        a = _pad64(win[rr + tap // 3, cc + tap % 3])
        acc = acc + a @ _b_tile(slabs[tap, 64 * half:64 * half + 64])
    return acc[:out_r * out_c].reshape(out_r, out_c, 64)


def _head_tiled(x, ws, tr, tw):
    """csrc/head.cu's walk: x on the tile + 2, conv1 on the tile + 1 set
    to 0 outside the image, conv2 on the tile, the preds in f32."""
    bsz, h, w, _ = x.shape
    w33 = _w33(ws)
    outs = [torch.zeros(bsz, h, w, ws[4].shape[1]),
            torch.zeros(bsz, h, w, ws[10].shape[1])]
    for b in range(bsz):
        for r0 in range(0, h, tr):
            for c0 in range(0, w, tw):
                xw = _window(x[b], r0 - 2, c0 - 2, tr + 4, tw + 4)
                gy = torch.arange(r0 - 1, r0 + tr + 1)[:, None]
                gx = torch.arange(c0 - 1, c0 + tw + 1)[None, :]
                inside = ((gy >= 0) & (gy < h) & (gx >= 0) & (gx < w))
                nr, nc = min(tr, h - r0), min(tw, w - c0)
                for half, i in ((0, 0), (1, 6)):
                    _, b1, _, b2, wp, bp = ws[i:i + 6]
                    c1 = torch.relu(_conv_taps(xw, w33[:9], half, tr + 2,
                                               tw + 2) + b1)
                    c1 = c1 * inside[..., None]
                    c2 = torch.relu(_conv_taps(c1, w33[9:], half, tr, tw)
                                    + b2)
                    pred = c2 @ wp + bp
                    outs[half][b, r0:r0 + nr, c0:c0 + nc] = pred[:nr, :nc]
    return outs


@pytest.mark.parametrize("tr,tw", TILES)
def test_head_tiling_matches_plain(tr, tw):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(np.maximum(rng.normal(0, 1, (2, 37, 45, 64)),
                                    0).astype(np.float32))
    ws = _head_ws(rng)
    got = _head_tiled(x, ws, tr, tw)
    want = head_kernel.fused_head_plain(x, *ws)
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape == (2, 37, 45, 4)
        np.testing.assert_allclose(g.numpy(), w_.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_head_halo_mask_is_needed():
    """Without the c1 mask the border pixels see ReLU(b1) instead of the
    zero padding: the tiling must differ from the plain version there."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(np.maximum(rng.normal(0, 1, (1, 9, 11, 64)),
                                    0).astype(np.float32))
    ws = list(_head_ws(rng))
    ws[1] = ws[1].abs() + 0.5          # a positive conv1 bias
    want = head_kernel.fused_head_plain(x, *ws)[0]
    xw, w33 = _window(x[0], -2, -2, 13, 15), _w33(ws)
    c1 = torch.relu(_conv_taps(xw, w33[:9], 0, 11, 13) + ws[1])
    c2 = torch.relu(_conv_taps(c1, w33[9:], 0, 9, 11) + ws[3])
    unmasked = c2 @ ws[4] + ws[5]
    err = (unmasked - want[0]).abs()
    assert float(err[1:-1, 1:-1].max()) <= 1e-5
    assert float(err[0].max()) > 1e-3 and float(err[:, 0].max()) > 1e-3
