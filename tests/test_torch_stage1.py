"""Port stage1 downsample over the merged stem output (plain version and
the CPU dispatch) vs the reference ``fused_downsample_merged`` (CPU; the
kernel on the card is in test_torch_gpu.py).

Tolerances: f32 within 1e-5 absolute (same products, f32 sums in another
order); bf16 within 1e-2 (1 + |ref|), a bf16 rounding step of an output
whose f32 sum landed on the other side of a rounding boundary.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unina_yolo_dla_torch.ops.cuda import stage1_kernel as tk
from unina_yolo_dla_tpu.ops.pallas.stage1_kernel import (
    fused_downsample_merged,
    pack_stage1_weights,
)

ATOL_F32 = 1e-5
REL_BF16 = 1e-2


def _inputs(rng, h, w2, cm, o, lead=()):
    """Post-ReLU-like merged input, He-scaled blocked kernel (fan-in
    4 * CM)."""
    xm = np.maximum(rng.normal(0, 1, (*lead, h, w2, cm)), 0).astype(
        np.float32)
    wb = rng.normal(0, np.sqrt(2 / (4 * cm)), (2, 2, 2 * cm, o)).astype(
        np.float32)
    b = rng.normal(0, .1, (o,)).astype(np.float32)
    return xm, wb, b


def test_pack_matches_reference(rng):
    wb = rng.normal(size=(2, 2, 32, 8)).astype(np.float32)
    want = np.asarray(pack_stage1_weights(jnp.asarray(wb)))
    got = tk.pack_stage1_weights(torch.from_numpy(wb)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(16, 8, 16, 8), (32, 16, 64, 64),
                                   (12, 6, 8, 16), (8, 4, 128, 128)])
def test_plain_matches_reference_xla_form_f32(rng, shape):
    arrs = _inputs(rng, *shape)
    want = np.asarray(fused_downsample_merged(*map(jnp.asarray, arrs),
                                              use_pallas=False))
    got = tk.fused_downsample_merged(*map(torch.from_numpy, arrs)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_F32)


def test_plain_matches_reference_pallas_interpret_f32(rng):
    arrs = _inputs(rng, 16, 8, 16, 8)
    want = np.asarray(fused_downsample_merged(
        *map(jnp.asarray, arrs), use_pallas=True, interpret=True))
    got = tk.fused_downsample_merged_plain(
        *map(torch.from_numpy, arrs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_F32)


def test_plain_bf16_matches_reference_bf16(rng):
    """In bf16 (the serving dtype): bf16 input and kernel, f32 sums and
    bias, one rounding of the output, on both sides."""
    xm, wb, b = _inputs(rng, 32, 16, 64, 64)
    want = np.asarray(fused_downsample_merged(
        jnp.asarray(xm).astype(jnp.bfloat16), jnp.asarray(wb),
        jnp.asarray(b), use_pallas=False), np.float32)
    got = tk.fused_downsample_merged(
        torch.from_numpy(xm).to(torch.bfloat16), torch.from_numpy(wb),
        torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.all(np.abs(got - want) <= REL_BF16 * (1 + np.abs(want)))


def test_plain_batched_equals_per_frame(rng):
    xm, wb, b = map(torch.from_numpy, _inputs(rng, 16, 8, 16, 8, lead=(3,)))
    whole = tk.fused_downsample_merged(xm, wb, b)
    per = torch.stack([tk.fused_downsample_merged(xm[i], wb, b)
                       for i in range(3)])
    torch.testing.assert_close(whole, per, rtol=0, atol=0)
