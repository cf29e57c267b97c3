"""The stem and stage1 kernels' host side at every base width, on the CPU:
the weight images ``ops/cuda/mma_pack.py`` makes for C = 2 x base = 32,
64, 128 invert exactly and hold the byte image the device reads, and the
kernels' walk (csrc/stage1_tile.cuh ``Width``: K = tap * C + channel in
64-deep chunks of k16 steps, N = min(C, 64) columns a product, the two
64-column halves of C = 128 in two blocks), written out here in plain
PyTorch, reproduces the plain versions on ragged shapes. The kernels run
only on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unina_yolo_dla_torch.ops.cuda import mma_pack, stage1_kernel, \
    stem_kernel


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this module runs: the suite runs it
    beside other worker processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


WIDTHS = mma_pack.STEM_STAGE1_WIDTHS


def _kb(rng, shape):
    fan = int(np.prod(shape[:-1]))
    return (torch.from_numpy(rng.normal(0, np.sqrt(2 / fan), shape)
                             .astype(np.float32)),
            torch.from_numpy(rng.normal(0, .1, shape[-1])
                             .astype(np.float32)))


def _b_tile(tile: torch.Tensor) -> torch.Tensor:
    """One packed [N n][64 k'] tile -> B (64 k, N n), by the address the
    device computes: element k of row n sits in 16-byte chunk
    ``(k >> 3) ^ (n & 7)`` at position ``k & 7``."""
    n = torch.arange(tile.shape[0])[None, :]
    k = torch.arange(64)[:, None]
    return tile[n, (((k >> 3) ^ (n & 7)) << 3) + (k & 7)]


def _window(x, r0, c0, rows, cols):
    h, w, _ = x.shape
    win = torch.zeros(rows, cols, x.shape[-1])
    ra, rb = max(r0, 0), min(r0 + rows, h)
    ca, cb = max(c0, 0), min(c0 + cols, w)
    if ra < rb and ca < cb:
        win[ra - r0:rb - r0, ca - c0:cb - c0] = x[ra:rb, ca:cb]
    return win


def _stage1_tile(win, p, bias, c, tr=4, tw=16):
    """csrc/stage1_tile.cuh ``products`` and ``store`` at width ``c``:
    per block ``nh`` (N columns), per 64-deep K chunk ``kc`` its four k16
    steps, each of tap ``q = k0 // c``, channels ``k0 % c ..``, shifted
    window pixels against the block's packed tile."""
    n = mma_pack.stage1_columns(c)
    kc_n = 8 * c // 64
    rr, cc = torch.meshgrid(torch.arange(tr), torch.arange(tw),
                            indexing="ij")
    rr, cc = rr.reshape(-1), cc.reshape(-1)
    outs = []
    for nh in range(c // n):
        acc = torch.zeros(tr * tw, n)
        for kc in range(kc_n):
            b = _b_tile(p[nh * kc_n + kc])
            for ks in range(4):
                k0 = 64 * kc + 16 * ks
                q, c0 = k0 // c, k0 % c
                kh, kw, di = q >> 2, (q >> 1) & 1, q & 1
                a = win[2 * rr + 2 * kh + di, cc + kw, c0:c0 + 16]
                acc = acc + a @ b[16 * ks:16 * ks + 16]
        outs.append(torch.relu(acc + bias[nh * n:(nh + 1) * n]))
    return torch.cat(outs, dim=-1).reshape(tr, tw, c)


def _stage1_tiled(xm, p, bias, c, tr=4, tw=16):
    bsz, h, w2, _ = xm.shape
    h2 = h // 2
    out = torch.zeros(bsz, h2, w2, c)
    for b in range(bsz):
        for r0 in range(0, h2, tr):
            for w0 in range(0, w2, tw):
                win = _window(xm[b], 2 * r0 - 2, w0 - 1, 2 * tr + 2, tw + 1)
                res = _stage1_tile(win, p, bias, c, tr, tw)
                nr, nc = min(tr, h2 - r0), min(tw, w2 - w0)
                out[b, r0:r0 + nr, w0:w0 + nc] = res[:nr, :nc]
    return out


def _stem_tiled(xm, ks, bs, k1, b1, c, tr=4, tw=16):
    """csrc/stem.cu at width ``c``: per tile the frame window, the stem on
    the pixels stage1 needs in passes of N columns (one K = 48 product per
    kernel row against rows np*N.. of the kh tile), 0 outside the image,
    rounded, then stage1's tile."""
    ksp, k1p = mma_pack.pack_stem_mma(ks), mma_pack.pack_stage1_mma(k1)
    n = mma_pack.stage1_columns(c)
    bsz, h, w2, _ = xm.shape
    h2 = h // 2
    sr_n, sc_n = 2 * tr + 2, tw + 1
    out = torch.zeros(bsz, h2, w2, c)
    m = torch.arange(sr_n * sc_n)
    sr, sc = m // sc_n, m % sc_n
    for b in range(bsz):
        for r0 in range(0, h2, tr):
            for w0 in range(0, w2, tw):
                flat = _window(xm[b], 2 * r0 - 3, w0 - 2, sr_n + 1,
                               sc_n + 1).reshape(-1)
                parts = []
                for np_ in range(c // n):
                    acc = torch.zeros(len(m), n)
                    for kh in range(2):
                        pix = (sr + kh) * (sc_n + 1) + sc
                        a = flat[pix[:, None] * 24
                                 + torch.arange(48)[None, :]]
                        bt = _b_tile(ksp[kh, np_ * n:(np_ + 1) * n])
                        acc = acc + F.pad(a, (0, 16)) @ bt
                    parts.append(acc + bs[np_ * n:(np_ + 1) * n])
                stem = torch.relu(torch.cat(parts, dim=-1))
                s, cc = 2 * r0 - 2 + sr, w0 - 1 + sc
                inside = (s >= 0) & (s < h) & (cc >= 0) & (cc < w2)
                stem = (stem * inside[:, None]).reshape(sr_n, sc_n, c)
                res = _stage1_tile(stem, k1p, b1, c, tr, tw)
                nr, nc = min(tr, h2 - r0), min(tw, w2 - w0)
                out[b, r0:r0 + nr, w0:w0 + nc] = res[:nr, :nc]
    return out


@pytest.mark.parametrize("c", WIDTHS)
def test_stage1_pack_shape_and_inverse(c):
    rng = np.random.default_rng(c)
    wb, _ = _kb(rng, (2, 2, 2 * c, c))
    p = mma_pack.pack_stage1_mma(wb)
    n = mma_pack.stage1_columns(c)
    assert p.shape == mma_pack.stage1_mma_shape(c) == (c // n * c // 8, n, 64)
    assert p.is_contiguous()
    assert torch.equal(mma_pack.unpack_stage1_mma(p), wb)
    # block nh's chunk kc holds rows 64 kc.. of K (tap * C + channel) and
    # its output columns nh * N..
    flat = wb.reshape(8 * c, c)
    kc_n = 8 * c // 64
    for nh in range(c // n):
        for kc in (0, kc_n - 1):
            assert torch.equal(_b_tile(p[nh * kc_n + kc]),
                               flat[64 * kc:64 * kc + 64,
                                    nh * n:(nh + 1) * n])


@pytest.mark.parametrize("c", WIDTHS)
def test_stem_pack_shape_and_inverse(c):
    rng = np.random.default_rng(c + 1)
    ks, _ = _kb(rng, (2, 2, 24, c))
    p = mma_pack.pack_stem_mma(ks)
    assert p.shape == (2, c, 64)
    assert torch.equal(mma_pack.unpack_stem_mma(p), ks)
    for kh in range(2):
        b = _b_tile(p[kh])
        assert torch.equal(b[:24], ks[kh, 0])
        assert torch.equal(b[24:48], ks[kh, 1])
        assert not b[48:].any()


@pytest.mark.parametrize("c,shape", [(32, (2, 10, 37)), (128, (2, 10, 37)),
                                     (32, (1, 6, 5)), (128, (1, 2, 1))])
def test_stage1_walk_matches_plain(c, shape):
    rng = np.random.default_rng(3 * c)
    xm = torch.from_numpy(np.maximum(rng.normal(0, 1, (*shape, c)), 0)
                          .astype(np.float32))
    wb, b = _kb(rng, (2, 2, 2 * c, c))
    got = _stage1_tiled(xm, mma_pack.pack_stage1_mma(wb), b, c)
    want = stage1_kernel.fused_downsample_merged_plain(xm, wb, b)
    assert got.shape == want.shape == (shape[0], shape[1] // 2, shape[2], c)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("c,shape", [(32, (2, 10, 37)), (128, (2, 10, 37)),
                                     (32, (1, 12, 5)), (128, (1, 2, 1))])
def test_stem_walk_matches_plain(c, shape):
    rng = np.random.default_rng(5 * c)
    xm = torch.from_numpy(rng.normal(0, 1, (*shape, 24)).astype(np.float32))
    ks, bs = _kb(rng, (2, 2, 24, c))
    k1, b1 = _kb(rng, (2, 2, 2 * c, c))
    got = _stem_tiled(xm, ks, bs, k1, b1, c)
    want = stem_kernel.fused_stem_stage1_plain(xm, ks, bs, k1, b1)
    assert got.shape == want.shape == (shape[0], shape[1] // 2, shape[2], c)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("c", WIDTHS)
def test_kernels_take_every_base_width(c):
    """Every compiled width has its own entry point and launch count, the
    64-wide one the symbols the base-32 engines always used; other widths
    are refused by the packers and the card path."""
    assert mma_pack.stem_stage1_takes(c)
    assert stem_kernel.KERNELS[c].symbol.startswith("unina_fused_stem_stage1")
    assert stage1_kernel.KERNELS[c].symbol.startswith("unina_stage1_merged")
    assert stem_kernel.KERNEL is stem_kernel.KERNELS[64]
    assert stem_kernel.KERNEL.symbol == "unina_fused_stem_stage1"
    assert stage1_kernel.KERNEL.symbol == "unina_stage1_merged"
    for other in (16, 48, 96, 256):
        assert not mma_pack.stem_stage1_takes(other)
        with pytest.raises(ValueError, match="compiled"):
            mma_pack.pack_stage1_mma(torch.zeros(2, 2, 2 * other, other))
        with pytest.raises(ValueError, match="compiled"):
            mma_pack.pack_stem_mma(torch.zeros(2, 2, 24, other))


@pytest.mark.parametrize("base", [16, 64])
def test_engines_pack_at_every_base(base):
    """A seeded train-form model at base 16 and 64 through the export's
    deploy transforms: the fused-stem engine packs both kernels' B-tile
    images, the unfused ``s2d_merged`` engine its stage1's, as at base
    32, and each image inverts to the blocked kernel it serves on the
    CPU."""
    import dataclasses

    from unina_yolo_dla_torch.models.config import ModelConfig
    from unina_yolo_dla_torch.models.detector import (
        from_jax_variables, init_model, to_jax_variables)
    from unina_yolo_dla_torch.quant.deploy import (
        fold_batchnorm, fold_downsample_space_to_depth,
        fold_stem_space_to_depth, merge_stem_columns)

    cfg = ModelConfig(base_channels=base, input_size=64)
    model, _ = init_model(cfg, generator=torch.Generator().manual_seed(base),
                          device="cpu")
    v = merge_stem_columns(fold_downsample_space_to_depth(
        fold_stem_space_to_depth(fold_batchnorm(to_jax_variables(model)))))
    dep = dataclasses.replace(cfg, deploy=True, stem_s2d=True, s2d_host=True,
                              stage1_s2d=True, s2d_merged=True)
    c = 2 * base
    bb = from_jax_variables(v, dataclasses.replace(dep, fused_stem=True),
                            "cpu").backbone
    assert bb.stem_kernel_mma.shape == (2, c, 64)
    assert torch.equal(mma_pack.unpack_stem_mma(bb.stem_kernel_mma),
                       bb.stem_kernel)
    assert torch.equal(mma_pack.unpack_stage1_mma(bb.stage1_kernel_mma),
                       bb.stage1_kernel)
    st = from_jax_variables(v, dep, "cpu").backbone.stage1_conv
    assert torch.equal(mma_pack.unpack_stage1_mma(st.kernel_mma), st.kernel)
