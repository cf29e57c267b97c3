"""Port normalize / host staging vs the reference (CPU; the kernel on the
card is in test_torch_gpu.py)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unina_yolo_dla_torch.ops import preprocess as tp
from unina_yolo_dla_torch.ops.cuda import preprocess_kernel as tk
from unina_yolo_dla_tpu.models import ModelConfig
from unina_yolo_dla_tpu.ops import preprocess as jp
from unina_yolo_dla_tpu.ops.pallas import normalize_pallas
from unina_yolo_dla_tpu.runtime.pipeline import _normalize_for

ATOL = 1e-6   # stated tolerance: normalize agrees to 1e-6 absolute


def test_merged_layout_normalize_matches_reference(rng):
    """The serving layout: merged (S/2, S/4, 24) frame, mean/std tiled 8x,
    against ``_normalize_for`` of an s2d_merged config."""
    frame = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
    merged = tp.merged_frame_np(frame)
    assert merged.shape == (16, 8, 24)
    cfg = dataclasses.replace(ModelConfig(), s2d_host=True, s2d_merged=True)
    want = np.asarray(_normalize_for(cfg, jnp.asarray(merged)))
    mean, std = tk.channel_constants(24)
    got = tk.normalize(torch.from_numpy(merged), mean, std).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("channels,swap", [(3, False), (4, True)])
def test_normalize_matches_pallas_interpret(rng, channels, swap):
    img = rng.integers(0, 256, (32, 32, channels), dtype=np.uint8)
    want = np.asarray(normalize_pallas(jnp.asarray(img), swap_rb=swap,
                                       interpret=True))
    got = tk.normalize(torch.from_numpy(img), swap_rb=swap).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", [(16, 8, 24), (7, 5, 24)])
def test_normalize_bf16_out_matches_plain_and_reference_bits(rng, shape):
    """The serving form: ``out_dtype=bfloat16`` is the exact float32 value
    rounded to nearest-even, bit for bit the plain version cast to bf16 and
    the reference's normalise of the same merged frame cast to bf16
    (tolerance 0 in bf16 bits)."""
    merged = rng.integers(0, 256, shape, dtype=np.uint8)
    mean, std = tk.channel_constants(24)
    got = tk.normalize(torch.from_numpy(merged), mean, std,
                       out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == shape
    plain = tk.normalize_plain(torch.from_numpy(merged), mean, std)
    assert plain.dtype == torch.float32
    assert torch.equal(got, plain.to(torch.bfloat16))
    assert torch.equal(got, tk.normalize_plain(
        torch.from_numpy(merged), mean, std, out_dtype=torch.bfloat16))
    cfg = dataclasses.replace(ModelConfig(), s2d_host=True, s2d_merged=True)
    want = np.asarray(_normalize_for(cfg, jnp.asarray(merged)).astype(
        jnp.bfloat16).view(jnp.uint16))
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(
        np.uint16), want)


def test_normalize_rejects_other_out_dtypes(rng):
    img = torch.from_numpy(rng.integers(0, 256, (4, 4, 3), dtype=np.uint8))
    with pytest.raises(ValueError):
        tk.normalize(img, out_dtype=torch.float16)


def test_normalize_float_formula(rng):
    x = rng.uniform(0, 1, (8, 8, 3)).astype(np.float32)
    want = np.asarray(jp.normalize(jnp.asarray(x)))
    got = tp.normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_space_to_depth_and_merged_view_match_reference(rng):
    frame = rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tp.space_to_depth_np(frame),
                                  jp.space_to_depth_np(frame))
    blocked = jp.space_to_depth_np(frame[0])
    np.testing.assert_array_equal(tp.merged_frame_np(frame[0]),
                                  blocked.reshape(8, 4, 24))
