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


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this module runs: the suite runs it
    beside other worker processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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
    return mma_pack.pack_head_mma(ws[0], ws[6], ws[2], ws[8], ws[4], ws[10])


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
    """Only the tiled kernel's width packs into its (18, 128, 64) slabs:
    the wide form's widths (32, 128, 256) pack into one flat image, its
    weight stream and the preds' fragments (up to 8 outputs a pred); any
    other width packs into nothing; the CPU path needs neither."""
    rng = np.random.default_rng(3)

    def ws_at(c):
        return head_kernel.pack_head_weights(
            [_kb(rng, (3, 3, c, c)), _kb(rng, (3, 3, c, c))],
            _kb(rng, (1, 1, c, 4)),
            [_kb(rng, (3, 3, c, c)), _kb(rng, (3, 3, c, c))],
            _kb(rng, (1, 1, c, 4)), torch.float32)

    ws = ws_at(32)
    assert len(ws) == 12
    w33 = mma_pack.pack_head_mma(ws[0], ws[6], ws[2], ws[8], ws[4], ws[10])
    # per branch 18 taps x one plane x 64 k x 32 n, then two (32, 8) preds
    assert w33.shape == mma_pack.head_mma_shape(32) == (
        2 * 18 * 64 * 32 + 2 * 32 * 8,)
    got = mma_pack.unpack_head_mma(w33)
    for g, want in zip(got, (ws[0], ws[6], ws[2], ws[8])):
        assert torch.equal(g, want)
    for g, want in zip(got[4:], (ws[4], ws[10])):
        assert torch.equal(g[:, :4], want) and not g[:, 4:].any()
    with pytest.raises(ValueError, match="preds"):
        mma_pack.pack_head_mma(ws[0], ws[6], ws[2], ws[8],
                               torch.zeros(32, 9), ws[10])
    for c in (16, 8):
        w = ws_at(c)
        with pytest.raises(ValueError):
            mma_pack.pack_head_mma(w[0], w[6], w[2], w[8], w[4], w[10])
        assert not head_kernel.kernel_takes(c)
    x = torch.from_numpy(rng.normal(0, 1, (5, 6, 32)).astype(np.float32))
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
    ((nt * k/16 + ks) * 32 + lane) * 4 elements, as the wide head reads
    its preds (csrc/head.cu)."""
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


def _b_tile_n(tile: torch.Tensor) -> torch.Tensor:
    """One packed [NS n][64 k] tile -> B (64 k, NS n), by the address the
    device computes (as ``_b_tile``, any NS)."""
    n = torch.arange(tile.shape[0])[None, :]
    k = torch.arange(64)[:, None]
    return tile[n, (((k >> 3) ^ (n & 7)) << 3) + (k & 7)]


def _stream_b(img, shapes, s):
    """The wide kernels' weight stream read as cluster block r reads it:
    ``[r][stage][chunk]`` -> B (64, N/s), each chunk a contiguous
    [N/s][64] tile, block r's chunks one contiguous range."""
    per = sum(k * n // s for k, n in shapes)
    out = []
    for r in range(s):
        off, stages = r * per, []
        for k, n in shapes:
            ns, kc = n // s, k // 64
            tiles = img[off:off + kc * ns * 64].reshape(kc, ns, 64)
            stages.append([_b_tile_n(t) for t in tiles])
            off += kc * ns * 64
        out.append(stages)
    return out


# (Cin, Ca, hidden, F, n): widths of the bf16 engines' C3k2s (base 32 and
# base 16)
@pytest.mark.parametrize("cin,ca,hd,f,n", [(128, 0, 64, 128, 2),
                                           (384, 128, 128, 256, 1),
                                           (32, 16, 16, 32, 2)])
def test_c3k2_wide_pack_inverts_and_holds_the_fragments(cin, ca, hd, f, n):
    """At the wide widths the image is the weight stream of the cluster's
    blocks: per block ``r`` its columns ``r N/s ..`` of [w1 | w2] over
    xa's then xb's 64-deep chunks, of each bottleneck's wb1 and 3x3 (K
    chunk tap * planes + plane), and of w3, each chunk one swizzled tile;
    ``unpack_c3k2_mma`` inverts it."""
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
    s, pl = mma_pack.C3K2_SPLIT[hd], -(-hd // 64)
    ka, kb_ = -(-ca // 64), -(-(cin - ca) // 64)
    shapes = ([((ka + kb_) * 64, 2 * hd)] + [(pl * 64, hd),
                                             (9 * pl * 64, hd)] * n
              + [(-(-2 * hd // 64) * 64, f)])
    blocks = _stream_b(p, shapes, s)
    r = s - 1
    ns = 2 * hd // s
    # xb's first chunk, block r's columns of [w1 | w2]
    rows = min(64, cin - ca)
    wa = torch.cat([w1, w2], dim=-1)[:, r * ns:(r + 1) * ns]
    b = blocks[r][0][ka]
    assert torch.equal(b[:rows], wa[ca:ca + rows]) and not b[rows:].any()
    # the last bottleneck's 3x3, tap (2, 1), plane 0
    nb = hd // s
    b = blocks[r][2 * n][7 * pl]
    assert torch.equal(b[:min(64, hd)], wb2[n - 1, 2, 1][:64, r * nb:
                                                           (r + 1) * nb])
    assert torch.equal(blocks[r][-1][0][:min(64, 2 * hd)],
                       w3[:64, r * ns:(r + 1) * ns])


# ---- (f) the wide forms: clusters of blocks splitting the columns ----

WT = 8   # the wide kernels' output tile


def _windows(x, halo, step=WT, size=None, lead=None, grid=None):
    """(B, H, W, C) -> (tiles, size^2, C): per 8 x 8 output tile (of a
    ``grid`` of tiles, by default the image's) the window of ``size``
    pixels (8 + 2 halo) from (step ty - lead, step tx - lead), zero
    outside the image."""
    size = size or WT + 2 * halo
    lead = halo if lead is None else lead
    bsz, h, w, c = x.shape
    ty, tx = grid or (-(-h // WT), -(-w // WT))
    hp, wp = (ty - 1) * step + size, (tx - 1) * step + size
    xp = torch.zeros(bsz, max(hp, h + lead), max(wp, w + lead), c,
                     dtype=x.dtype)
    xp[:, lead:lead + h, lead:lead + w] = x
    win = xp.unfold(1, size, step).unfold(2, size, step)[:, :ty, :tx]
    return win.permute(0, 1, 2, 4, 5, 3).reshape(-1, size * size, c)


def _planes_of(win, c):
    """Channels zero-padded to whole 64-channel planes: [plane](..., 64)."""
    win = F.pad(win, (0, -c % 64))
    return list(win.split(64, dim=-1))


def _m64(rows, count):
    """Row indices of ``count`` region rows padded to whole m64 products,
    the padding repeating the last row (the kernels' clamped rows)."""
    return torch.clamp(torch.arange(-(-count // 64) * 64), max=count - 1)


def _gemm(chunks, bs):
    """f32 sum over K chunks of A (tiles, M, 64) @ B (64, NS)."""
    acc = 0
    for a, b in zip(chunks, bs):
        acc = acc + a @ b.float()
    return acc


def _bf(t):
    return t.to(torch.bfloat16).float()


def _c3k2_wide_tiled(xa, xb, ws, *, up_a=False, shortcut=True):
    """csrc/c3k2.cu's wide form: per 8 x 8 tile (+ halo n) and per block
    r of its cluster, r's columns of each stage from the weight stream,
    over windows of 64-channel planes, M padded to m64 products, 0 outside
    the image after every stage, bf16 at every stage; the blocks' columns
    assembled (the distributed shared memory) before the next stage reads
    them. ``xa`` None is the single form."""
    _, b1, wb1, bb1, _, bb2, _, b2, _, b3 = ws
    n, hd, fo = wb1.shape[0], b1.shape[0], b3.shape[0]
    ca = 0 if xa is None else xa.shape[-1]
    cb = xb.shape[-1]
    s = mma_pack.C3K2_SPLIT[hd]
    ka, kb_ = -(-ca // 64), -(-cb // 64)
    pl, pp = -(-hd // 64), -(-2 * hd // 64)
    shapes = ([((ka + kb_) * 64, 2 * hd)] + [(pl * 64, hd),
                                             (9 * pl * 64, hd)] * n
              + [(pp * 64, fo)])
    blocks = _stream_b(_wpk(ws, ca), shapes, s)
    bsz, h, w, _ = xb.shape
    wc = WT + 2 * n
    wpx = wc * wc
    xf = xb.float()
    inside = _windows(torch.ones(bsz, h, w, 1), n)[..., 0] > 0   # (T, wp)
    chunks = _planes_of(_windows(xf, n), cb)
    if xa is not None and up_a:
        coarse = _windows(xa.float(), 1, step=WT // 2, size=WT // 2 + 2,
                          lead=1, grid=(-(-h // WT), -(-w // WT)))
        r = torch.arange(wc)
        cr = ((r - n) >> 1) + 1
        idx = (cr[:, None] * (WT // 2 + 2) + cr[None, :]).reshape(-1)
        chunks = _planes_of(coarse[:, idx], ca) + chunks
    elif xa is not None:
        chunks = _planes_of(_windows(xa.float(), n), ca) + chunks
    stages = iter(range(len(shapes)))

    def run(src, rows, bias, ncols, st):
        """Every block's columns of stage ``st`` over A rows ``rows`` of
        the source chunks, assembled, ReLU(acc + bias), bf16."""
        m = _m64(None, len(rows))
        parts = [_gemm([c[:, rows[m]] for c in src], blocks[r][st])
                 for r in range(s)]
        acc = torch.cat(parts, dim=-1)[:, :len(rows), :ncols]
        return _bf(torch.relu(acc + bias))

    def region(hh):
        rc = WT + 2 * hh
        off = n - hh
        rr, cc = torch.meshgrid(torch.arange(rc), torch.arange(rc),
                                indexing="ij")
        return ((rr + off) * wc + cc + off).reshape(-1)

    full = region(n)
    p = run(chunks, full, torch.cat([b1, b2]), 2 * hd, next(stages))
    p = p * inside[..., None]                           # (T, wp, 2h)
    for i in range(n):
        rows = region(n - i)
        t = torch.zeros(p.shape[0], wpx, hd)
        t[:, rows] = run(_planes_of(p[..., :hd], hd), rows, bb1[i], hd,
                         next(stages)) * inside[:, rows, None]
        st, rows = next(stages), region(n - 1 - i)
        tpl = _planes_of(t, hd)
        taps = [c[:, rows + (kh - 1) * wc + kw - 1] for kh in range(3)
                for kw in range(3) for c in tpl]
        m = _m64(None, len(rows))
        acc = torch.cat([_gemm([a[:, m] for a in taps], blocks[r][st])
                         for r in range(s)], dim=-1)[:, :len(rows)]
        u = _bf(torch.relu(acc + bb2[i]))
        new = _bf(p[:, rows, :hd] + u) if shortcut else u
        p = p.clone()
        p[:, rows, :hd] = new * inside[:, rows, None]
    res = run(_planes_of(p, 2 * hd), region(0), b3, fo, next(stages))
    ty, tx = -(-h // WT), -(-w // WT)
    out = res.reshape(bsz, ty, tx, WT, WT, fo).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(bsz, ty * WT, tx * WT, fo)[:, :h, :w]


def _rect_windows(x, halo, tr, tw):
    """(B, H, W, C) -> (tiles, (tr + 2 halo)(tw + 2 halo), C): the window of
    each tr x tw output tile, zero outside the image."""
    bsz, h, w, c = x.shape
    ty, tx = -(-h // tr), -(-w // tw)
    rows, cols = tr + 2 * halo, tw + 2 * halo
    xp = torch.zeros(bsz, ty * tr + 2 * halo, tx * tw + 2 * halo, c,
                     dtype=x.dtype)
    xp[:, halo:halo + h, halo:halo + w] = x
    win = xp.unfold(1, rows, tr).unfold(2, cols, tw)
    return win.permute(0, 1, 2, 4, 5, 3).reshape(-1, rows * cols, c)


def _head_wide_tiled(x, ws):
    """csrc/head.cu's wide form: per tile (``head_kernel.wide_tile``) and
    branch, each block r of the cluster r's channels of conv1 (tile + 1, M
    padded to m64) and conv2 from the weight stream, the blocks' channels
    assembled between the two; c1 0 outside the image; the pred per m16
    row tile from the fragment image, f32."""
    c = x.shape[-1]
    s, pl = mma_pack.HEAD_SPLIT[c], -(-c // 64)
    tr, tw = head_kernel.wide_tile(c)
    w33 = mma_pack.pack_head_mma(ws[0], ws[6], ws[2], ws[8], ws[4], ws[10])
    k = 9 * pl * 64
    per = 2 * k * c
    bsz, h, w, _ = x.shape
    xw = _planes_of(_rect_windows(x.float(), 2, tr, tw), c)
    inside = _rect_windows(torch.ones(bsz, h, w, 1), 1, tr, tw)[..., 0] > 0
    ty, tx = -(-h // tr), -(-w // tw)
    outs = []
    for br, i in ((0, 0), (1, 6)):
        _, b1, _, b2, wp, bp = ws[i:i + 6]
        blocks = _stream_b(w33[br * per:(br + 1) * per], [(k, c), (k, c)],
                           s)
        rr, cc = torch.meshgrid(torch.arange(tr + 2), torch.arange(tw + 2),
                                indexing="ij")
        rows = (rr * (tw + 4) + cc).reshape(-1)
        n1 = (tr + 2) * (tw + 2)
        m = _m64(None, n1)
        taps = [q[:, rows[m] + kh * (tw + 4) + kw] for kh in range(3)
                for kw in range(3) for q in xw]
        acc = torch.cat([_gemm(taps, blocks[r][0]) for r in range(s)],
                        dim=-1)[:, :n1, :c]
        c1 = _bf(torch.relu(acc + b1)) * inside[..., None]
        c1p = _planes_of(c1, c)
        rr, cc = torch.meshgrid(torch.arange(tr), torch.arange(tw),
                                indexing="ij")
        rows = (rr * (tw + 2) + cc).reshape(-1)
        taps = [q[:, rows + kh * (tw + 2) + kw] for kh in range(3)
                for kw in range(3) for q in c1p]
        acc = torch.cat([_gemm(taps, blocks[r][1]) for r in range(s)],
                        dim=-1)
        c2 = _bf(torch.relu(acc + b2))
        frag = w33[2 * per + br * c * 8:2 * per + (br + 1) * c * 8]
        # the lanes' fragments (rows 2tq, 2tq+1, 8+2tq, 9+2tq of k16 step
        # ks, column g) read back into the (C, 8) matrix they hold
        wq = torch.zeros(c, 8)
        for ks in range(c // 16):
            for g in range(8):
                for tq in range(4):
                    vals = _frag(frag, c, 0, ks, 4 * g + tq)
                    for e, r_ in enumerate((2 * tq, 2 * tq + 1, 8 + 2 * tq,
                                            9 + 2 * tq)):
                        wq[16 * ks + r_, g] = vals[e]
        no = wp.shape[1]
        pred = (c2 @ wq)[..., :no] + bp
        out = pred.reshape(bsz, ty, tx, tr, tw, no).permute(0, 1, 3, 2, 4, 5)
        outs.append(out.reshape(bsz, ty * tr, tx * tw, no)[:, :h, :w])
    return outs


def _grid_img(rng, shape):
    """bf16 activations on a binary grid (k/2): with grid weights every
    f32 sum is exact in any order, so the tiling must agree bit for bit."""
    return torch.from_numpy((rng.integers(0, 5, shape) * 0.5).astype(
        np.float32)).to(torch.bfloat16)


def _grid_kb(rng, shape):
    fan = int(np.prod(shape[:-1]))
    k = np.where(rng.random(shape) < min(1.0, 8 / fan),
                 rng.choice([-.5, -.25, .25, .5], shape), 0.0)
    return (k.astype(np.float32),
            (rng.integers(-2, 3, shape[-1]) / 8).astype(np.float32))


def _grid_c3k2_ws(rng, cin, hd, n):
    return c3k2_kernel.pack_c3k2_weights(
        _grid_kb(rng, (1, 1, cin, hd)), _grid_kb(rng, (1, 1, cin, hd)),
        _grid_kb(rng, (1, 1, 2 * hd, 2 * hd)),
        [(_grid_kb(rng, (1, 1, hd, hd)), _grid_kb(rng, (3, 3, hd, hd)))
         for _ in range(n)], torch.bfloat16)


# (batch, H, W, Cin, hidden, n): stage3_c3k2 and stage2_c3k2 (base 32),
# stage1_block at base 16 cut to 40 x 40, ragged images at batch 2
@pytest.mark.parametrize("b,h,w,cin,hd,n", [(1, 40, 40, 256, 128, 2),
                                            (1, 80, 80, 128, 64, 2),
                                            (1, 40, 40, 32, 16, 1),
                                            (2, 13, 22, 128, 64, 1),
                                            (2, 11, 9, 64, 128, 2)])
def test_c3k2_wide_tiling_matches_plain(b, h, w, cin, hd, n):
    rng = np.random.default_rng(20)
    x = _grid_img(rng, (b, h, w, cin))
    ws = _grid_c3k2_ws(rng, cin, hd, n)
    got = _c3k2_wide_tiled(None, x, ws)
    want = c3k2_kernel.fused_c3k2_plain(x, *ws)
    assert float(want.float().abs().max()) > 1.0   # not a degenerate case
    assert torch.equal(got.to(torch.bfloat16), want)


# (batch, H, W, Ca, Cb, hidden, up_a): fpn_c3k2_1, pan_c3k2_1, pan_c3k2_2
# (base 32), a ragged image at batch 2, base 16's fpn_c3k2_2 cut to 40
@pytest.mark.parametrize("b,h,w,ca,cb,hd,up", [
    (1, 80, 80, 128, 128, 64, True), (1, 80, 80, 64, 128, 64, False),
    (1, 40, 40, 128, 256, 128, False), (2, 14, 22, 128, 64, 128, True),
    (1, 40, 40, 32, 32, 16, True)])
def test_c3k2_cat_wide_tiling_matches_plain(b, h, w, ca, cb, hd, up):
    rng = np.random.default_rng(21)
    xa = _grid_img(rng, (b, h // 2, w // 2, ca) if up else (b, h, w, ca))
    xb = _grid_img(rng, (b, h, w, cb))
    ws = _grid_c3k2_ws(rng, ca + cb, hd, 1 if hd != 128 or not up else 2)
    got = _c3k2_wide_tiled(xa, xb, ws, up_a=up)
    want = c3k2_kernel.fused_c3k2_cat_plain(xa, xb, *ws, up_a=up)
    assert float(want.float().abs().max()) > 1.0
    assert torch.equal(got.to(torch.bfloat16), want)


@pytest.mark.parametrize("b,h,w,c", [(1, 40, 40, 256), (1, 80, 80, 128),
                                     (2, 9, 17, 32), (2, 13, 6, 256)])
def test_head_wide_tiling_matches_plain(b, h, w, c):
    rng = np.random.default_rng(22)
    x = _grid_img(rng, (b, h, w, c))
    ws = head_kernel.pack_head_weights(
        [_grid_kb(rng, (3, 3, c, c)), _grid_kb(rng, (3, 3, c, c))],
        _grid_kb(rng, (1, 1, c, 4)),
        [_grid_kb(rng, (3, 3, c, c)), _grid_kb(rng, (3, 3, c, c))],
        _grid_kb(rng, (1, 1, c, 4)), torch.bfloat16)
    got = _head_wide_tiled(x, ws)
    want = head_kernel.fused_head_plain(x, *ws)
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape == (b, h, w, 4)
        assert torch.equal(g, w_)


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


def test_wide_forms_take_the_served_widths_only():
    """The wide kernels are compiled for the bf16 engines' widths at base
    32 and base 16 (C3k2 hidden 16, 64, 128 with F = 2 hidden; heads 32,
    128, 256), the tiled kernels for hidden 32 / F 64 and head 64; any
    other width packs nothing and the card path raises. The wide C3k2
    takes its input up to the 64-channel planes it holds in shared memory
    (``WIDE_PLANES``, held against the library on the card), not past."""
    served_c3k2 = [(128, 64, 128, 2, 0), (256, 128, 256, 2, 0),
                   (256, 64, 128, 1, 128), (192, 64, 128, 1, 64),
                   (384, 128, 256, 1, 128), (32, 16, 32, 1, 0),
                   (128, 64, 128, 2, 0), (64, 16, 32, 1, 32),
                   (192, 64, 128, 1, 64), (64, 32, 64, 1, 0)]
    for cin, hd, f, n, ca in served_c3k2:
        assert c3k2_kernel.kernel_takes(cin, hd, f, n, ca), (cin, hd, f, n)
    for cin, hd, f, n in ((64, 32, 32, 1), (64, 48, 96, 1), (64, 64, 64, 1),
                          (64, 8, 16, 1), (1024, 128, 256, 2),
                          (128, 64, 128, 3)):
        assert not c3k2_kernel.kernel_takes(cin, hd, f, n), (cin, hd, f, n)
    for c in (32, 64, 128, 256):
        assert head_kernel.kernel_takes(c)
    for c in (16, 48, 96, 512):
        assert not head_kernel.kernel_takes(c)
    # the input planes the wide form holds: Cin up to them, not past
    for (hd, n), pl in c3k2_kernel.WIDE_PLANES.items():
        assert c3k2_kernel.kernel_takes(64 * pl, hd, 2 * hd, n)
        assert not c3k2_kernel.kernel_takes(64 * pl + 8, hd, 2 * hd, n)
        assert not c3k2_kernel.kernel_takes(64 * pl, hd, 2 * hd, n, ca=8)
    with pytest.raises(ValueError, match="compiled"):
        mma_pack.pack_c3k2_mma(*(torch.zeros(s) for s in (
            (64, 48), (64, 48), (1, 48, 48), (1, 3, 3, 48, 48),
            (96, 96))))
