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

from unina_yolo_dla_torch.ops.cuda import (
    c3k2_kernel,
    head_kernel,
    mma_pack,
    stage1_kernel,
    stem_kernel,
)

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
    """Only the tiled kernel's width packs into B tiles: another multiple
    of 16 packs into the wide form's flat fragment image, any other width
    into nothing; the CPU path needs neither."""
    rng = np.random.default_rng(3)

    def ws_at(c):
        return head_kernel.pack_head_weights(
            [_kb(rng, (3, 3, c, c)), _kb(rng, (3, 3, c, c))],
            _kb(rng, (1, 1, c, 4)),
            [_kb(rng, (3, 3, c, c)), _kb(rng, (3, 3, c, c))],
            _kb(rng, (1, 1, c, 4)), torch.float32)

    ws = ws_at(16)
    assert len(ws) == 12
    w33 = _w33(ws)
    assert w33.shape == mma_pack.head_mma_shape(16) == (4 * 9 * 16 * 16,)
    for got, want in zip(mma_pack.unpack_head_mma(w33),
                         (ws[0], ws[6], ws[2], ws[8])):
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        _w33(ws_at(8))
    x = torch.from_numpy(rng.normal(0, 1, (5, 6, 16)).astype(np.float32))
    cls, reg = head_kernel.fused_head(x, *ws)
    assert cls.shape == reg.shape == (5, 6, 4)


# ---- (b), (c) the kernels' tiling in plain PyTorch ----

def _window(x, r0, c0, rows, cols):
    """rows x cols pixels of (H, W, C) from (r0, c0), zero outside."""
    h, w, _ = x.shape
    win = torch.zeros(rows, cols, x.shape[-1])
    ra, rb = max(r0, 0), min(r0 + rows, h)
    ca, cb = max(c0, 0), min(c0 + cols, w)
    if ra < rb and ca < cb:
        win[ra - r0:rb - r0, ca - c0:cb - c0] = x[ra:rb, ca:cb]
    return win


def _stage1_tile(win, p, bias, tr, tw):
    """csrc/stage1_tile.cuh: one (tr x tw) output tile from its window of
    2*tr + 2 rows x tw + 1 merged columns, eight K chunks (kh, kw, di) of
    shifted window pixels against the packed tiles."""
    rr, cc = torch.meshgrid(torch.arange(tr), torch.arange(tw),
                            indexing="ij")
    rr, cc = rr.reshape(-1), cc.reshape(-1)
    acc = torch.zeros(-(-tr * tw // 64) * 64, 64)
    for q in range(8):
        kh, kw, di = q >> 2, (q >> 1) & 1, q & 1
        a = _pad64(win[2 * rr + 2 * kh + di, cc + kw])
        acc = acc + a @ _b_tile(p[q])
    return torch.relu(acc[:tr * tw] + bias).reshape(tr, tw, 64)


def _stage1_tiled(xm, p, bias, tr, tw):
    """csrc/stage1.cu's walk: per output tile a zero-filled window of the
    merged stem output."""
    bsz, h, w2, _ = xm.shape
    h2 = h // 2
    out = torch.zeros(bsz, h2, w2, 64)
    for b in range(bsz):
        for r0 in range(0, h2, tr):
            for w0 in range(0, w2, tw):
                win = _window(xm[b], 2 * r0 - 2, w0 - 1, 2 * tr + 2, tw + 1)
                res = _stage1_tile(win, p, bias, tr, tw)
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


# ---- (d) the fused stem + stage1 kernel ----

def _stem_ws(rng, dtype=torch.float32):
    ks, bs = _kb(rng, (2, 2, 24, 64))
    k1, b1 = _kb(rng, (2, 2, 128, 64))
    return (torch.from_numpy(ks).to(dtype), torch.from_numpy(bs),
            torch.from_numpy(k1).to(dtype), torch.from_numpy(b1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_pack_inverts_and_pads_k(dtype):
    rng = np.random.default_rng(7)
    ks = _stem_ws(rng, dtype)[0]
    p = mma_pack.pack_stem_mma(ks)
    assert p.shape == (2, 64, 64) and p.dtype == dtype and p.is_contiguous()
    assert torch.equal(mma_pack.unpack_stem_mma(p), ks)
    for kh in range(2):
        b = _b_tile(p[kh])
        # K = kw*24 + c: a frame pixel, then its right neighbour; 48..63 zero
        assert torch.equal(b[:24], ks[kh, 0]) and torch.equal(b[24:48],
                                                               ks[kh, 1])
        assert not b[48:].any()
    with pytest.raises(ValueError):
        mma_pack.pack_stem_mma(torch.zeros(2, 2, 12, 64))


def _stem_tiled(xm, ws, tr, tw, mask=True):
    """csrc/stem.cu's walk: per (tr x tw) output tile a zero-filled frame
    window of 2*tr + 3 rows x tw + 2 merged columns; the stem on the
    2*tr + 2 x tw + 1 pixels stage1 needs, as one K = 48 product per kernel
    row kh over the 96 contiguous bytes of a window pixel and its right
    neighbour (zero-padded to the 64-deep tile), M padded to 64 rows; 0
    where the stem pixel lies outside the image; then stage1's tile."""
    ks, bs, k1, b1 = ws
    ksp, k1p = mma_pack.pack_stem_mma(ks), mma_pack.pack_stage1_mma(k1)
    bsz, h, w2, _ = xm.shape
    h2 = h // 2
    sr_n, sc_n = 2 * tr + 2, tw + 1
    out = torch.zeros(bsz, h2, w2, 64)
    m = torch.arange(sr_n * sc_n)
    sr, sc = m // sc_n, m % sc_n
    for b in range(bsz):
        for r0 in range(0, h2, tr):
            for w0 in range(0, w2, tw):
                fwin = _window(xm[b], 2 * r0 - 3, w0 - 2, sr_n + 1, sc_n + 1)
                flat = fwin.reshape(-1)
                acc = torch.zeros(-(-len(m) // 64) * 64, 64)
                for kh in range(2):
                    pix = (sr + kh) * (sc_n + 1) + sc
                    a = flat[pix[:, None] * 24 + torch.arange(48)[None, :]]
                    acc = acc + _pad64(F.pad(a, (0, 16))) @ _b_tile(ksp[kh])
                stem = torch.relu(acc[:len(m)] + bs)
                if mask:
                    s, c = 2 * r0 - 2 + sr, w0 - 1 + sc
                    inside = (s >= 0) & (s < h) & (c >= 0) & (c < w2)
                    stem = stem * inside[:, None]
                stem = stem.to(xm.dtype).float().reshape(sr_n, sc_n, 64)
                res = _stage1_tile(stem, k1p, b1, tr, tw)
                nr, nc = min(tr, h2 - r0), min(tw, w2 - w0)
                out[b, r0:r0 + nr, w0:w0 + nc] = res[:nr, :nc]
    return out


@pytest.mark.parametrize("tr,tw", [(4, 16), (2, 32), (8, 16), (3, 5)])
def test_stem_tiling_matches_plain(tr, tw):
    rng = np.random.default_rng(8)
    xm = torch.from_numpy(rng.normal(0, 1, (2, 10, 37, 24)).astype(
        np.float32))
    ws = _stem_ws(rng)
    got = _stem_tiled(xm, ws, tr, tw)
    want = stem_kernel.fused_stem_stage1_plain(xm, *ws)
    assert got.shape == want.shape == (2, 5, 37, 64)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_stem_window_mask_is_needed():
    """Without the mask the stem pixels above and left of the image are
    ReLU(bias), not stage1's zero padding: the first output row and column
    must differ from the plain version, the rest must not."""
    rng = np.random.default_rng(9)
    xm = torch.from_numpy(rng.normal(0, 1, (1, 12, 9, 24)).astype(
        np.float32))
    ks, bs, k1, b1 = _stem_ws(rng)
    ws = (ks, bs.abs() + 0.5, k1, b1)      # a positive stem bias
    want = stem_kernel.fused_stem_stage1_plain(xm, *ws)[0]
    err = (_stem_tiled(xm, ws, 4, 16, mask=False)[0] - want).abs()
    assert float(err[1:, 1:].max()) <= 1e-5
    assert float(err[0].max()) > 1e-3 and float(err[:, 0].max()) > 1e-3


# ---- (e) the fused C3k2 kernel and its pair form ----

def _c3k2_ws(rng, cin, n, dtype=torch.float32):
    return c3k2_kernel.pack_c3k2_weights(
        _kb(rng, (1, 1, cin, 32)), _kb(rng, (1, 1, cin, 32)),
        _kb(rng, (1, 1, 64, 64)),
        [(_kb(rng, (1, 1, 32, 32)), _kb(rng, (3, 3, 32, 32)))
         for _ in range(n)], dtype)


def _wpk(ws, ca=0):
    return mma_pack.pack_c3k2_mma(ws[0], ws[6], ws[2], ws[4], ws[8], ca)


def _b_tile32(tile: torch.Tensor) -> torch.Tensor:
    """One packed [32 n][64 k'] tile -> B (64 k, 32 n), by the address the
    device computes (as ``_b_tile``)."""
    n = torch.arange(32)[None, :]
    k = torch.arange(64)[:, None]
    return tile[n, (((k >> 3) ^ (n & 7)) << 3) + (k & 7)]


@pytest.mark.parametrize("cin,ca,n", [(64, 0, 1), (128, 64, 2), (24, 8, 1),
                                      (136, 72, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_c3k2_pack_inverts_and_holds_the_image(dtype, cin, ca, n):
    rng = np.random.default_rng(10)
    ws = _c3k2_ws(rng, cin, n, dtype)
    w1, _, wb1, _, wb2, _, w2, _, w3, _ = ws
    p = _wpk(ws, ca)
    assert p.dtype == dtype and p.is_contiguous()
    assert p.shape == (mma_pack.c3k2_mma_numel(cin, n, ca),)
    for got, want in zip(mma_pack.unpack_c3k2_mma(p, cin, n, ca),
                         (w1, w2, wb1, wb2, w3)):
        assert torch.equal(got, want)
    # xa's channels fill their own 64-deep chunks ahead of xb's; the last
    # chunk of each is zero-padded
    kc = -(-ca // 64) + -(-(cin - ca) // 64)
    first = p[:kc * 4096].reshape(kc, 64, 64)
    q = -(-ca // 64)                       # xb's first chunk
    rows = min(64, cin - ca)
    b = _b_tile(first[q])
    assert torch.equal(b[:rows, :32], w1[ca:ca + rows])
    assert torch.equal(b[:rows, 32:], w2[ca:ca + rows])
    assert not b[rows:].any()
    # bottleneck i: slab 0 is wb1, slab 1 + tap the 3x3's taps, two K = 32
    # slabs a [32 n][64 k] tile
    mid = p[kc * 4096:kc * 4096 + n * 5 * 2048].reshape(n, 5, 32, 64)
    i, tap = n - 1, 5
    assert torch.equal(_b_tile32(mid[i, 0])[:32], wb1[i])
    slab = 1 + tap
    got = _b_tile32(mid[i, slab >> 1])[32 * (slab & 1):32 * (slab & 1) + 32]
    assert torch.equal(got, wb2[i, tap // 3, tap % 3])
    assert torch.equal(_b_tile(p[-4096:].reshape(64, 64)), w3)
    with pytest.raises(ValueError):
        mma_pack.pack_c3k2_mma(w1, w2, wb1, wb2, w3, cin)


def _c3k2_tiled(xa, xb, ws, tr, tw, *, up_a=False, shortcut=True,
                mask=True):
    """csrc/c3k2.cu's walk, per (tr x tw) output tile with a halo of n:
    A  [p1 | p2] on the window from 64-deep K chunks (xa's from a coarse
       window at (r >> 1, c >> 1) when upsampled), 0 outside the image;
    B  t = ReLU(p1 @ wb1 + bb1) on the window, 0 outside the image;
    C  the 3x3 over t on the window shrunk by one pixel more each
       bottleneck, the residual into p1 in place, 0 outside the image;
    D  ReLU([p1 | p2] @ w3 + b3) on the tile.
    M is padded to 64 rows, weights are read back from the packed image.
    ``xa`` None is the single form."""
    _, b1, wb1, bb1, _, bb2, _, b2, _, b3 = ws
    n = wb1.shape[0]
    ca = 0 if xa is None else xa.shape[-1]
    cb = xb.shape[-1]
    ka, kb_ = -(-ca // 64), -(-cb // 64)
    wpk = _wpk(ws, ca)
    first = wpk[:(ka + kb_) * 4096].reshape(ka + kb_, 64, 64)
    mid = wpk[(ka + kb_) * 4096:-4096].reshape(n, 5, 32, 64)
    w3 = _b_tile(wpk[-4096:].reshape(64, 64))

    def slab(i, s):   # K = 32 slab s of bottleneck i
        return _b_tile32(mid[i, s >> 1])[32 * (s & 1):32 * (s & 1) + 32]

    def rows64(win2d, c_lo):   # (pixels, C) -> M padded, one 64-deep chunk
        a = win2d[:, c_lo:c_lo + 64]
        return _pad64(F.pad(a, (0, 64 - a.shape[1])))

    bsz, h, w, _ = xb.shape
    out = torch.zeros(bsz, h, w, 64)
    wr_n, wc_n = tr + 2 * n, tw + 2 * n
    for b in range(bsz):
        for r0 in range(0, h, tr):
            for c0 in range(0, w, tw):
                gy = torch.arange(r0 - n, r0 - n + wr_n)[:, None]
                gx = torch.arange(c0 - n, c0 - n + wc_n)[None, :]
                inside = ((gy >= 0) & (gy < h) & (gx >= 0) & (gx < w))
                keep = inside[..., None] if mask else 1.0
                wp = wr_n * wc_n
                acc = torch.zeros(-(-wp // 64) * 64, 64)
                if xa is not None and up_a:
                    ay0, ax0 = (r0 - n) >> 1, (c0 - n) >> 1
                    coarse = _window(xa[b], ay0, ax0,
                                     ((r0 + tr + n - 1) >> 1) - ay0 + 1,
                                     ((c0 + tw + n - 1) >> 1) - ax0 + 1)
                    awin = coarse[(gy >> 1) - ay0, (gx >> 1) - ax0]
                elif xa is not None:
                    awin = _window(xa[b], r0 - n, c0 - n, wr_n, wc_n)
                for q in range(ka):
                    acc = acc + rows64(awin.reshape(wp, ca), 64 * q) \
                        @ _b_tile(first[q])
                bwin = _window(xb[b], r0 - n, c0 - n, wr_n, wc_n)
                for q in range(kb_):
                    acc = acc + rows64(bwin.reshape(wp, cb), 64 * q) \
                        @ _b_tile(first[ka + q])
                p = torch.relu(acc[:wp] + torch.cat([b1, b2])).reshape(
                    wr_n, wc_n, 64) * keep
                for i in range(n):
                    t = torch.relu(_pad64(p.reshape(wp, 64)[:, :32])
                                   @ slab(i, 0) + bb1[i])[:wp]
                    t = t.reshape(wr_n, wc_n, 32) * keep
                    hh = n - 1 - i
                    off = n - hh
                    rr_n, rc_n = tr + 2 * hh, tw + 2 * hh
                    rr, rc = torch.meshgrid(torch.arange(rr_n),
                                            torch.arange(rc_n), indexing="ij")
                    rr, rc = rr.reshape(-1), rc.reshape(-1)
                    acc = torch.zeros(-(-len(rr) // 64) * 64, 32)
                    for tap in range(9):
                        a = t[rr + off - 1 + tap // 3, rc + off - 1 + tap % 3]
                        acc = acc + _pad64(a) @ slab(i, 1 + tap)
                    u = torch.relu(acc[:len(rr)] + bb2[i]).reshape(
                        rr_n, rc_n, 32)
                    reg = (slice(off, off + rr_n), slice(off, off + rc_n))
                    new = p[reg][..., :32] + u if shortcut else u
                    if mask:
                        new = new * inside[reg][..., None]
                    p = p.clone()
                    p[reg[0], reg[1], :32] = new
                res = torch.relu(_pad64(p[n:n + tr, n:n + tw].reshape(-1, 64))
                                 @ w3 + b3)[:tr * tw].reshape(tr, tw, 64)
                nr, nc = min(tr, h - r0), min(tw, w - c0)
                out[b, r0:r0 + nr, c0:c0 + nc] = res[:nr, :nc]
    return out


def _img(rng, shape):
    return torch.from_numpy(np.maximum(rng.normal(0, 1, shape), 0).astype(
        np.float32))


def _frag(p, k, nt, ks, lane):
    """The four values lane ``lane`` reads for n8 tile ``nt`` and k16 step
    ``ks`` of a ``pack_frag`` image of a (k, N) matrix: one 8-byte load at
    ((nt * k/16 + ks) * 32 + lane) * 4 elements, as csrc/wide_mma.cuh."""
    base = ((nt * (k // 16) + ks) * 32 + lane) * 4
    return p[base:base + 4]


@pytest.mark.parametrize("k,n", [(16, 8), (48, 24), (1152, 128)])
def test_frag_image_is_the_mma_b_fragment(k, n):
    """Lane 4g + tq holds W[16ks + 2tq (+1)][8nt + g], then the same 8
    rows down: the m16n8k16 B fragment; ``unpack_frag`` inverts it."""
    w = torch.arange(k * n, dtype=torch.float32).reshape(k, n)
    p = mma_pack.pack_frag(w)
    assert p.shape == (k * n,)
    assert torch.equal(mma_pack.unpack_frag(p, k, n), w)
    for nt, ks, lane in ((0, 0, 0), (n // 8 - 1, k // 16 - 1, 31),
                         (n // 16, k // 32, 13)):
        g, tq = lane >> 2, lane & 3
        rows = [16 * ks + 2 * tq, 16 * ks + 2 * tq + 1,
                16 * ks + 8 + 2 * tq, 16 * ks + 9 + 2 * tq]
        assert torch.equal(_frag(p, k, nt, ks, lane), w[rows, 8 * nt + g])
    with pytest.raises(ValueError):
        mma_pack.pack_frag(w[:, :4])


# (Cin, Ca, hidden, F, n): widths of the bf16 engines' C3k2s
@pytest.mark.parametrize("cin,ca,hd,f,n", [(128, 0, 64, 128, 2),
                                           (384, 128, 128, 256, 1),
                                           (32, 16, 16, 24, 2)])
def test_c3k2_wide_pack_inverts_and_holds_the_fragments(cin, ca, hd, f, n):
    """At any width but hidden 32 / F 64 the image is the wide form's:
    [w1 | w2], then per bottleneck wb1 and the 3x3 as (9h, h) (K = tap * h
    + channel), then w3, each a fragment image."""
    rng = np.random.default_rng(12)
    ws = c3k2_kernel.pack_c3k2_weights(
        _kb(rng, (1, 1, cin, hd)), _kb(rng, (1, 1, cin, hd)),
        _kb(rng, (1, 1, 2 * hd, f)),
        [(_kb(rng, (1, 1, hd, hd)), _kb(rng, (3, 3, hd, hd)))
         for _ in range(n)], torch.float32)
    w1, _, wb1, _, wb2, _, w2, _, w3, _ = ws
    p = _wpk(ws, ca)
    assert p.shape == (mma_pack.c3k2_mma_numel(cin, n, ca, hd, f),)
    for got, want in zip(mma_pack.unpack_c3k2_mma(p, cin, n, ca, hd, f),
                         (w1, w2, wb1, wb2, w3)):
        assert torch.equal(got, want)
    # the last bottleneck's 3x3, tap (2, 1): its k16 step 0 of n8 tile 0
    off = cin * 2 * hd + (n - 1) * 10 * hd * hd + hd * hd
    tap, g, tq = 7, 0, 1
    got = _frag(p[off:], 9 * hd, 0, tap * hd // 16, 4 * g + tq)
    rows = [2 * tq, 2 * tq + 1, 8 + 2 * tq, 9 + 2 * tq]
    assert torch.equal(got, wb2[n - 1, 2, 1][rows, g])


@pytest.mark.parametrize("tr,tw", TILES)
@pytest.mark.parametrize("n,shortcut", [(1, True), (2, False)])
def test_c3k2_tiling_matches_plain(tr, tw, n, shortcut):
    rng = np.random.default_rng(11)
    x = _img(rng, (2, 19, 23, 24))        # Cin = 24: a zero-filled chunk
    ws = _c3k2_ws(rng, 24, n)
    got = _c3k2_tiled(None, x, ws, tr, tw, shortcut=shortcut)
    want = c3k2_kernel.fused_c3k2_plain(x, *ws, shortcut=shortcut)
    assert got.shape == want.shape == (2, 19, 23, 64)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("tr,tw", [(8, 16), (4, 32), (6, 10)])
@pytest.mark.parametrize("up_a,n,ca", [(True, 1, 64), (True, 2, 72),
                                       (False, 2, 8)])
def test_c3k2_cat_tiling_matches_plain(tr, tw, up_a, n, ca):
    """Even tile origins, as the kernel's 8 x 16: the coarse xa window is
    read at (r >> 1, c >> 1)."""
    rng = np.random.default_rng(12)
    hb, wb_ = 18, 22
    xa = _img(rng, (1, hb // 2, wb_ // 2, ca) if up_a else (1, hb, wb_, ca))
    xb = _img(rng, (1, hb, wb_, 16))
    ws = _c3k2_ws(rng, ca + 16, n)
    got = _c3k2_tiled(xa, xb, ws, tr, tw, up_a=up_a)
    want = c3k2_kernel.fused_c3k2_cat_plain(xa, xb, *ws, up_a=up_a)
    assert got.shape == want.shape == (1, hb, wb_, 64)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_c3k2_halo_mask_is_needed():
    """Without the masks the halo pixels outside the image carry
    ReLU(bias) into the 3x3 instead of its zero padding: the border must
    differ from the plain version, the interior must not."""
    rng = np.random.default_rng(13)
    x = _img(rng, (1, 7, 9, 64))
    ws = list(_c3k2_ws(rng, 64, 1))
    ws[1], ws[3] = ws[1].abs() + 0.5, ws[3].abs() + 0.5  # b1, bb1 > 0
    want = c3k2_kernel.fused_c3k2_plain(x, *ws)[0]
    err = (_c3k2_tiled(None, x, ws, 8, 16, mask=False)[0] - want).abs()
    assert float(err[1:-1, 1:-1].max()) <= 1e-5
    assert float(err[0].max()) > 1e-3 and float(err[:, 0].max()) > 1e-3
