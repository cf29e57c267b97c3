"""Port fused C3k2 and its pair form (plain versions and the CPU dispatch)
vs the reference ``fused_c3k2`` / ``fused_c3k2_cat`` (CPU; the kernels on
the card are in test_torch_gpu.py).

Weights are drawn with numpy in the reference's HWIO layout and packed
by each side's own packer. Tolerances: f32 within 1e-5 absolute (same
products, f32 sums in another order); bf16 within 1e-2 (1 + |ref|), a
bf16 rounding step where an f32 sum landed on the other side of a
rounding boundary.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unina_yolo_dla_torch.ops.cuda import c3k2_kernel as tk
from unina_yolo_dla_tpu.ops.pallas.c3k2_kernel import (
    fused_c3k2,
    fused_c3k2_cat,
)

ATOL_F32 = 1e-5
REL_BF16 = 1e-2


def _kb(rng, shape):
    fan = int(np.prod(shape[:-1]))
    return (rng.normal(0, np.sqrt(2 / fan), shape).astype(np.float32),
            rng.normal(0, .1, shape[-1]).astype(np.float32))


def _weights(rng, cin, hd, f, n):
    cv1, cv2 = _kb(rng, (1, 1, cin, hd)), _kb(rng, (1, 1, cin, hd))
    cv3 = _kb(rng, (1, 1, 2 * hd, f))
    bns = [(_kb(rng, (1, 1, hd, hd)), _kb(rng, (3, 3, hd, hd)))
           for _ in range(n)]
    return cv1, cv2, cv3, bns


def _jax(ws):
    cv1, cv2, cv3, bns = ws
    j = lambda kb: tuple(map(jnp.asarray, kb))  # noqa: E731
    return j(cv1), j(cv2), j(cv3), [(j(a), j(b)) for a, b in bns]


def _act(rng, shape):
    return np.maximum(rng.normal(0, 1, shape), 0).astype(np.float32)


def _close_bf16(got, want):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= REL_BF16 * (1 + np.abs(want)))


@pytest.mark.parametrize("n,shortcut", [(1, True), (2, True), (1, False),
                                        (2, False)])
def test_plain_matches_reference_xla_form_f32(rng, n, shortcut):
    x = _act(rng, (12, 16, 16))
    ws = _weights(rng, 16, 8, 16, n)
    want = np.asarray(fused_c3k2(jnp.asarray(x), *_jax(ws),
                                 shortcut=shortcut, use_pallas=False))
    got = tk.fused_c3k2(torch.from_numpy(x),
                        *tk.pack_c3k2_weights(*ws, torch.float32),
                        shortcut=shortcut).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_F32)


def test_plain_matches_reference_pallas_row_grid_f32(rng):
    """H = 80: the reference grids rows (blk 20, halo n); the interpret
    run of that kernel is the reference here."""
    x = _act(rng, (80, 24, 16))
    ws = _weights(rng, 16, 8, 16, 2)
    want = np.asarray(fused_c3k2(jnp.asarray(x), *_jax(ws),
                                 use_pallas=True, interpret=True))
    got = tk.fused_c3k2_plain(torch.from_numpy(x),
                              *tk.pack_c3k2_weights(*ws, torch.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_F32)


@pytest.mark.parametrize("n", [1, 2])
def test_plain_bf16_matches_reference_bf16(rng, n):
    x = _act(rng, (20, 24, 32))
    ws = _weights(rng, 32, 16, 32, n)
    want = fused_c3k2(jnp.asarray(x).astype(jnp.bfloat16), *_jax(ws),
                      use_pallas=False)
    got = tk.fused_c3k2(torch.from_numpy(x).to(torch.bfloat16),
                        *tk.pack_c3k2_weights(*ws, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close_bf16(got, want)


@pytest.mark.parametrize("up_a,shortcut", [(True, True), (False, True),
                                           (True, False)])
def test_cat_plain_matches_reference_xla_form_f32(rng, up_a, shortcut):
    xa = _act(rng, (6, 8, 8) if up_a else (12, 16, 8))
    xb = _act(rng, (12, 16, 16))
    ws = _weights(rng, 24, 8, 16, 1)
    want = np.asarray(fused_c3k2_cat(
        jnp.asarray(xa), jnp.asarray(xb), *_jax(ws), shortcut=shortcut,
        upsample_a=up_a, use_pallas=False))
    got = tk.fused_c3k2_cat(torch.from_numpy(xa), torch.from_numpy(xb),
                            *tk.pack_c3k2_weights(*ws, torch.float32),
                            shortcut=shortcut, up_a=up_a).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_F32)


@pytest.mark.parametrize("n", [1, 2])
def test_cat_plain_matches_reference_pallas_row_grid_f32(rng, n):
    """H = 80 with the upsample: the reference's row-gridded pair kernel
    (even halo) in interpret mode."""
    xa = _act(rng, (40, 12, 8))
    xb = _act(rng, (80, 24, 16))
    ws = _weights(rng, 24, 8, 16, n)
    want = np.asarray(fused_c3k2_cat(
        jnp.asarray(xa), jnp.asarray(xb), *_jax(ws), upsample_a=True,
        use_pallas=True, interpret=True))
    got = tk.fused_c3k2_cat_plain(
        torch.from_numpy(xa), torch.from_numpy(xb),
        *tk.pack_c3k2_weights(*ws, torch.float32), up_a=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_F32)


def test_cat_plain_bf16_matches_reference_bf16(rng):
    """The fpn_c3k2_2 pattern in the serving dtype: xa at half resolution,
    its dot's f32 result upsampled, 64 + 64 input channels, hidden 32."""
    xa = _act(rng, (10, 12, 64))
    xb = _act(rng, (20, 24, 64))
    ws = _weights(rng, 128, 32, 64, 1)
    bf = jnp.bfloat16
    want = fused_c3k2_cat(jnp.asarray(xa).astype(bf),
                          jnp.asarray(xb).astype(bf), *_jax(ws),
                          upsample_a=True, use_pallas=False)
    got = tk.fused_c3k2_cat(torch.from_numpy(xa).to(torch.bfloat16),
                            torch.from_numpy(xb).to(torch.bfloat16),
                            *tk.pack_c3k2_weights(*ws, torch.bfloat16),
                            up_a=True)
    _close_bf16(got, want)


def test_plain_batched_equals_per_frame(rng):
    x = torch.from_numpy(_act(rng, (3, 8, 12, 16)))
    xa = torch.from_numpy(_act(rng, (3, 4, 6, 8)))
    ws = tk.pack_c3k2_weights(*_weights(rng, 16, 8, 16, 1), torch.float32)
    wc = tk.pack_c3k2_weights(*_weights(rng, 24, 8, 16, 1), torch.float32)
    whole = tk.fused_c3k2(x, *ws)
    per = torch.stack([tk.fused_c3k2(x[i], *ws) for i in range(3)])
    torch.testing.assert_close(whole, per, rtol=0, atol=0)
    whole = tk.fused_c3k2_cat(xa, x, *wc, up_a=True)
    per = torch.stack([tk.fused_c3k2_cat(xa[i], x[i], *wc, up_a=True)
                       for i in range(3)])
    torch.testing.assert_close(whole, per, rtol=0, atol=0)


# ---- the wide kernels' tiling (emulated in tests/test_torch_mma_pack.py)
# against the reference, bf16 on binary-grid inputs ----

@pytest.mark.parametrize("hw,cin,hd,n", [(40, 256, 128, 2), (40, 128, 64, 1),
                                         (13, 512, 256, 2),
                                         (14, 256, 256, 1)])
def test_wide_tiling_matches_reference_bf16(hw, cin, hd, n):
    """The wide kernel's tiling, cluster split and rounding points (the
    plain-torch emulation of ``csrc/c3k2.cu``'s wide form) against the
    reference's bf16 XLA form: within 1e-2 (1 + |ref|), the products exact
    on grid inputs and only the reference's own bf16 rounding between."""
    from test_torch_mma_pack import _c3k2_wide_tiled, _grid_img, _grid_kb

    rng = np.random.default_rng(30)
    x = _grid_img(rng, (1, hw, hw, cin))
    kbs = [_grid_kb(rng, (1, 1, cin, hd)), _grid_kb(rng, (1, 1, cin, hd)),
           _grid_kb(rng, (1, 1, 2 * hd, 2 * hd)),
           [(_grid_kb(rng, (1, 1, hd, hd)), _grid_kb(rng, (3, 3, hd, hd)))
            for _ in range(n)]]
    ws = tk.pack_c3k2_weights(*kbs, torch.bfloat16)
    got = _c3k2_wide_tiled(None, x, ws)[0].to(torch.bfloat16)
    want = fused_c3k2(jnp.asarray(x.float().numpy()[0]).astype(jnp.bfloat16),
                      *_jax(kbs), use_pallas=False)
    _close_bf16(got, want)


# (Ca, Cb, hidden, H = W): base 32's fpn_c3k2_1 widths at 40 x 40 with
# and without the upsample; base 64's fpn_c3k2_1 (hidden 128, upsampled)
# and hidden 256 upsampled, or its pan_c3k2_2 (hidden 256, 4 x 8 tiles),
# at small ragged sizes
WIDE_CAT_WIDTHS = {True: [(128, 128, 64, 40), (256, 256, 128, 14),
                          (256, 256, 256, 14)],
                   False: [(128, 128, 64, 40), (256, 512, 256, 13)]}


@pytest.mark.parametrize("up_a", [True, False])
def test_wide_cat_tiling_matches_reference_bf16(up_a):
    from test_torch_mma_pack import _c3k2_wide_tiled, _grid_img, _grid_kb

    rng = np.random.default_rng(31)
    for ca, cb, hd, hw in WIDE_CAT_WIDTHS[up_a]:
        xa = _grid_img(rng, (1, hw // 2, hw // 2, ca) if up_a
                       else (1, hw, hw, ca))
        xb = _grid_img(rng, (1, hw, hw, cb))
        kbs = [_grid_kb(rng, (1, 1, ca + cb, hd)),
               _grid_kb(rng, (1, 1, ca + cb, hd)),
               _grid_kb(rng, (1, 1, 2 * hd, 2 * hd)),
               [(_grid_kb(rng, (1, 1, hd, hd)),
                 _grid_kb(rng, (3, 3, hd, hd)))]]
        ws = tk.pack_c3k2_weights(*kbs, torch.bfloat16)
        got = _c3k2_wide_tiled(xa, xb, ws, up_a=up_a)[0].to(torch.bfloat16)
        bf = jnp.bfloat16
        want = fused_c3k2_cat(jnp.asarray(xa.float().numpy()[0]).astype(bf),
                              jnp.asarray(xb.float().numpy()[0]).astype(bf),
                              *_jax(kbs), upsample_a=up_a, use_pallas=False)
        _close_bf16(got, want)
