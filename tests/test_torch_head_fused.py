"""Port fused detection head (plain version and the CPU dispatch) vs the
reference ``fused_head`` (CPU; the kernel on the card is in
test_torch_gpu.py).

Tolerances: f32 within 1e-5 absolute (same products, f32 sums in another
order); bf16 within 1e-2 (1 + |ref|) on the f32 predictions, which follow
two bf16-rounded 3x3 convs on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unina_yolo_dla_torch.ops.cuda import head_kernel as tk
from unina_yolo_dla_tpu.ops.pallas.head_kernel import fused_head

ATOL_F32 = 1e-5
REL_BF16 = 1e-2


def _kb(rng, shape):
    fan = int(np.prod(shape[:-1]))
    return (rng.normal(0, np.sqrt(2 / fan), shape).astype(np.float32),
            rng.normal(0, .1, shape[-1]).astype(np.float32))


def _weights(rng, h, nc=4):
    return ([_kb(rng, (3, 3, h, h)), _kb(rng, (3, 3, h, h))],
            _kb(rng, (1, 1, h, nc)),
            [_kb(rng, (3, 3, h, h)), _kb(rng, (3, 3, h, h))],
            _kb(rng, (1, 1, h, 4)))


def _jax(ws):
    cc, cp, rc, rp = ws
    j = lambda kb: tuple(map(jnp.asarray, kb))  # noqa: E731
    return [j(a) for a in cc], j(cp), [j(a) for a in rc], j(rp)


def _act(rng, shape):
    return np.maximum(rng.normal(0, 1, shape), 0).astype(np.float32)


@pytest.mark.parametrize("shape", [(16, 16, 24), (9, 13, 16)])
def test_plain_matches_reference_xla_form_f32(rng, shape):
    x = _act(rng, shape)
    ws = _weights(rng, shape[-1])
    want = fused_head(jnp.asarray(x), *_jax(ws), use_pallas=False)
    got = tk.fused_head(torch.from_numpy(x),
                        *tk.pack_head_weights(*ws, torch.float32))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL_F32)


def test_plain_matches_reference_pallas_row_grid_f32(rng):
    """H = 80: the reference's row-gridded head kernel (blk 20, halo 2,
    conv1 re-masked at the image's top and bottom rows) in interpret
    mode."""
    x = _act(rng, (80, 16, 24))
    ws = _weights(rng, 24)
    want = fused_head(jnp.asarray(x), *_jax(ws), use_pallas=True,
                      interpret=True)
    got = tk.fused_head_plain(torch.from_numpy(x),
                              *tk.pack_head_weights(*ws, torch.float32))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL_F32)


def test_plain_bf16_matches_reference_bf16_f32_preds(rng):
    """Serving dtype: bf16 input and convs, f32 preds on both sides. The
    preds are float32 and not rounded to bf16 (unlike the standard and
    merged heads): most of them are not bf16-representable."""
    x = _act(rng, (20, 24, 64))
    ws = _weights(rng, 64)
    want = fused_head(jnp.asarray(x).astype(jnp.bfloat16), *_jax(ws),
                      use_pallas=False)
    got = tk.fused_head(torch.from_numpy(x).to(torch.bfloat16),
                        *tk.pack_head_weights(*ws, torch.bfloat16))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and w.dtype == np.float32
        assert np.all(np.abs(g.numpy() - w) <= REL_BF16 * (1 + np.abs(w)))
        not_bf16 = (g != g.to(torch.bfloat16).float()).float().mean()
        assert float(not_bf16) > 0.9


def test_plain_batched_equals_per_frame(rng):
    x = torch.from_numpy(_act(rng, (3, 8, 10, 16)))
    ws = tk.pack_head_weights(*_weights(rng, 16), torch.float32)
    whole = tk.fused_head(x, *ws)
    per = [tk.fused_head(x[i], *ws) for i in range(3)]
    for k in range(2):
        torch.testing.assert_close(whole[k], torch.stack([p[k] for p in per]),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("hw,c", [(40, 256), (24, 128), (16, 32), (13, 512)])
def test_wide_tiling_matches_reference_bf16(hw, c):
    """The wide head's tiling, cluster split and f32 preds (the plain-torch
    emulation of ``csrc/head.cu``'s wide form, tests/test_torch_mma_pack.py)
    against the reference's bf16 XLA form within 1e-2 (1 + |ref|), on
    binary-grid inputs."""
    from test_torch_mma_pack import _grid_img, _grid_kb, _head_wide_tiled

    rng = np.random.default_rng(32)
    x = _grid_img(rng, (1, hw, hw, c))
    kbs = ([_grid_kb(rng, (3, 3, c, c)), _grid_kb(rng, (3, 3, c, c))],
           _grid_kb(rng, (1, 1, c, 4)),
           [_grid_kb(rng, (3, 3, c, c)), _grid_kb(rng, (3, 3, c, c))],
           _grid_kb(rng, (1, 1, c, 4)))
    got = _head_wide_tiled(x, tk.pack_head_weights(*kbs, torch.bfloat16))
    want = fused_head(jnp.asarray(x.float().numpy()[0]).astype(
        jnp.bfloat16), *_jax(kbs), use_pallas=False)
    for g, w in zip(got, want):
        g, w = g[0].numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape
        assert np.all(np.abs(g - w) <= REL_BF16 * (1 + np.abs(w)))
