"""Port fused stem+stage1 (plain version) vs the reference
``fused_stem_stage1`` (CPU; the kernel on the card is in
test_torch_gpu.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unina_yolo_dla_torch.ops.cuda import stem_kernel as tk
from unina_yolo_dla_tpu.ops.pallas.stem_kernel import fused_stem_stage1

ATOL_F32 = 1e-5   # f32: same products, f32 sums in another order


def _inputs(rng, h, w2, cm, o2, c2, lead=()):
    """Normalised-frame-like input, He-scaled weights (fan-in 4*CM for
    the stem, 8*O2 for stage1), so activations stay O(1) as in the
    trained engine."""
    xm = rng.normal(0, 1, (*lead, h, w2, cm)).astype(np.float32)
    ks = rng.normal(0, np.sqrt(2 / (4 * cm)), (2, 2, cm, o2)
                    ).astype(np.float32)
    bs = rng.normal(0, .1, (o2,)).astype(np.float32)
    k1 = rng.normal(0, np.sqrt(2 / (8 * o2)), (2, 2, 2 * o2, c2)
                    ).astype(np.float32)
    b1 = rng.normal(0, .1, (c2,)).astype(np.float32)
    return xm, ks, bs, k1, b1


@pytest.mark.parametrize("shape", [(32, 16, 24, 64, 64), (16, 8, 8, 16, 32),
                                   (12, 6, 24, 64, 64), (8, 4, 24, 128, 128)])
def test_plain_matches_reference_xla_form_f32(rng, shape):
    arrs = _inputs(rng, *shape)
    want = np.asarray(fused_stem_stage1(*map(jnp.asarray, arrs),
                                        use_pallas=False))
    got = tk.fused_stem_stage1(*map(torch.from_numpy, arrs)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_F32)


def test_plain_matches_reference_pallas_interpret_f32(rng):
    arrs = _inputs(rng, 32, 16, 24, 64, 64)
    want = np.asarray(fused_stem_stage1(*map(jnp.asarray, arrs),
                                        use_pallas=True, interpret=True))
    got = tk.fused_stem_stage1(*map(torch.from_numpy, arrs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_F32)


def test_plain_batched_equals_per_frame(rng):
    arrs = _inputs(rng, 16, 8, 24, 64, 64, lead=(3,))
    t = list(map(torch.from_numpy, arrs))
    whole = tk.fused_stem_stage1(*t)
    per = torch.stack([tk.fused_stem_stage1(t[0][i], *t[1:])
                       for i in range(3)])
    torch.testing.assert_close(whole, per, rtol=0, atol=0)


def test_plain_bf16_matches_reference_bf16(rng):
    """In bf16 (the serving dtype) the stem is rounded to bf16 before
    stage1 on both sides; outputs agree to a bf16 rounding step."""
    arrs = _inputs(rng, 32, 16, 24, 64, 64)
    xm = jnp.asarray(arrs[0]).astype(jnp.bfloat16)
    want = np.asarray(fused_stem_stage1(xm, *map(jnp.asarray, arrs[1:]),
                                        use_pallas=False), np.float32)
    xt = torch.from_numpy(arrs[0]).to(torch.bfloat16)
    got = tk.fused_stem_stage1(xt, *map(torch.from_numpy, arrs[1:]))
    got = got.float().numpy()
    assert np.all(np.abs(got - want) <= 1e-2 * (1 + np.abs(want)))
