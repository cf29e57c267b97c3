"""The serving slice as a whole: the port's detector and frame -> boxes
path against the reference, on the CPU.

- small: the reference ``UninaYoloDla`` with the shipped engine's flags
  (int8_fused + PERF_EXCLUDE, s2d_merged, fused_stem, merged_head) at
  base_channels 8 and 64^2, f32 compute, every leaf filled from a seeded
  numpy generator; per-level logits within 1e-4, Detections equal (same
  valid slots and classes, boxes and scores within 1e-4).
- full width: the committed ``artifacts/serving_artifact`` on the seed-7
  synthetic scene, the port vs the reference ``ServingArtifact``: same
  valid count, detections matched one to one by class with box error
  <= 0.5 px and score error <= 1e-2 (bf16 layers round differently).
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unina_yolo_dla_torch.data.synthetic import SynthConfig as TSynth
from unina_yolo_dla_torch.data.synthetic import generate_image as t_generate
from unina_yolo_dla_torch.models import config as tconfig
from unina_yolo_dla_torch.models.detector import from_jax_variables
from unina_yolo_dla_torch.ops.cuda import preprocess_kernel
from unina_yolo_dla_torch.ops.preprocess import merged_frame_np
from unina_yolo_dla_torch.quant.fake_quant import PERF_EXCLUDE as T_PERF
from unina_yolo_dla_torch.quant.fake_quant import QuantSpec as TSpec
from unina_yolo_dla_torch.runtime.artifact import ServingArtifact
from unina_yolo_dla_torch.runtime.pipeline import build_serving_fn
from unina_yolo_dla_tpu.data import SynthConfig, generate_image
from unina_yolo_dla_tpu.models import ModelConfig
from unina_yolo_dla_tpu.models.detector import UninaYoloDla
from unina_yolo_dla_tpu.quant.fake_quant import PERF_EXCLUDE, QuantSpec
from unina_yolo_dla_tpu.runtime.aot import ServingArtifact as JArtifact
from unina_yolo_dla_tpu.runtime.pipeline import build_serving_fn as j_build

ARTIFACT = Path(__file__).resolve().parents[1] / "artifacts" / \
    "serving_artifact"
LOGIT_ATOL = 1e-4
BOX_PX, SCORE_TOL = 0.5, 1e-2

SERVING_FLAGS = dict(deploy=True, stem_s2d=True, s2d_host=True,
                     stage1_s2d=True, s2d_merged=True, fused_stem=True,
                     merged_head=True)


def _fill(tree, rng, path=()):
    """Every leaf of a ``model.init`` tree from numpy: int8 kernels
    uniform, He-scaled float kernels, positive w_scale and amax."""
    if isinstance(tree, dict):
        return {k: _fill(v, rng, path + (k,)) for k, v in tree.items()}
    shape, dtype, name = np.shape(tree), np.asarray(tree).dtype, path[-1]
    if name == "amax":
        return np.float32(rng.uniform(2.0, 4.0))
    if name == "w_scale":   # scaled by the kernel's fan-in afterwards
        return rng.uniform(0.8, 1.2, shape).astype(np.float32)
    if name == "bias":
        return rng.normal(0, 0.05, shape).astype(np.float32)
    if name == "kernel":
        fan = int(np.prod(shape[:-1]))
        if dtype == np.int8:
            return rng.integers(-127, 128, shape, dtype=np.int8)
        return rng.normal(0, np.sqrt(2 / fan), shape).astype(np.float32)
    raise AssertionError(f"unexpected leaf {path}")


def _scale_w_scales(params):
    """w_scale *= sqrt(2 / fan_in) / 73 so int8 weights act He-scaled."""
    for k, v in params.items():
        if isinstance(v, dict):
            if "w_scale" in v:
                fan = int(np.prod(v["kernel"].shape[:-1]))
                v["w_scale"] = (v["w_scale"] * np.sqrt(2 / fan) / 73.0
                                ).astype(np.float32)
            else:
                _scale_w_scales(v)


@pytest.fixture(scope="module")
def small_engine():
    spec = QuantSpec("int8_fused", exclude=PERF_EXCLUDE)
    jcfg = ModelConfig(num_classes=4, base_channels=8, input_size=64,
                       compute_dtype=jnp.float32, quant=spec,
                       **SERVING_FLAGS)
    model = UninaYoloDla(jcfg)
    xm0 = jnp.zeros((1, 32, 16, 24), jnp.float32)
    shapes = model.init(jax.random.PRNGKey(0), xm0, train=False)
    rng = np.random.default_rng(11)
    variables = {k: _fill(jax.device_get(v), rng)
                 for k, v in shapes.items()}
    _scale_w_scales(variables["params"])
    tcfg = tconfig.ModelConfig(num_classes=4, base_channels=8,
                               input_size=64, compute_dtype=torch.float32,
                               quant=TSpec("int8_fused", exclude=T_PERF),
                               **SERVING_FLAGS)
    port = from_jax_variables(variables, tcfg, device="cpu")
    frame = np.random.default_rng(5).integers(0, 256, (64, 64, 3),
                                              dtype=np.uint8)
    return model, jcfg, variables, port, tcfg, merged_frame_np(frame)


def test_small_slice_logits_match_reference(small_engine):
    model, jcfg, variables, port, _, merged = small_engine
    mean, std = preprocess_kernel.channel_constants(24)
    x = preprocess_kernel.normalize(torch.from_numpy(merged), mean, std)
    want = model.apply(variables, jnp.asarray(x.numpy())[None], train=False)
    with torch.inference_mode():
        got = port(x[None])
    assert len(got) == 3
    for (jc, jr), (tc, tr) in zip(want, got):
        assert tc.shape == jc.shape and tr.shape == jr.shape
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                                   atol=LOGIT_ATOL)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0,
                                   atol=LOGIT_ATOL)


def test_small_slice_detections_match_reference(small_engine):
    model, jcfg, variables, port, tcfg, merged = small_engine
    want = jax.jit(j_build(model, jcfg, q_factor=0.2))(
        variables, jnp.asarray(merged))
    got = build_serving_fn(port, tcfg, q_factor=0.2)(
        torch.from_numpy(merged))
    jv = np.asarray(want.valid)
    assert jv.sum() > 0
    np.testing.assert_array_equal(got.valid.numpy(), jv)
    np.testing.assert_array_equal(got.classes.numpy()[jv],
                                  np.asarray(want.classes)[jv])
    np.testing.assert_allclose(got.boxes.numpy()[jv],
                               np.asarray(want.boxes)[jv], rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(got.scores.numpy()[jv],
                               np.asarray(want.scores)[jv], rtol=0,
                               atol=LOGIT_ATOL)


def test_synthetic_copy_matches_reference():
    a, la = t_generate(np.random.default_rng(7), TSynth(image_size=64))
    b, lb = generate_image(np.random.default_rng(7), SynthConfig(
        image_size=64))
    np.testing.assert_array_equal(a, b)
    assert la == lb


def test_full_width_artifact_matches_reference():
    img, labels = t_generate(np.random.default_rng(7),
                             TSynth(image_size=640, seed=7))
    rgb = np.ascontiguousarray(img[..., ::-1])
    want = JArtifact(ARTIFACT)(rgb)
    got = ServingArtifact(ARTIFACT, device="cpu")(rgb)
    jv, tv = np.asarray(want.valid), got.valid.numpy()
    assert tv.sum() == jv.sum() >= 1
    jb, jsc, jc = (np.asarray(a)[jv] for a in (want.boxes, want.scores,
                                                want.classes))
    tb, tsc, tc = (a.numpy()[tv] for a in (got.boxes, got.scores,
                                            got.classes))
    used = set()
    for i in range(len(jb)):
        cand = [j for j in range(len(tb)) if j not in used and tc[j] == jc[i]]
        assert cand, f"reference detection {i} unmatched"
        j = min(cand, key=lambda j: np.abs(tb[j] - jb[i]).max())
        used.add(j)
        assert np.abs(tb[j] - jb[i]).max() <= BOX_PX
        assert abs(tsc[j] - jsc[i]) <= SCORE_TOL


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the no-card error")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingArtifact(ARTIFACT)


def test_artifact_config_and_weight_carrier():
    art = ServingArtifact(ARTIFACT, device="cpu")
    cfg = art.model_config
    assert cfg.strides == (4, 8, 16) and cfg.grid_sizes == (160, 80, 40)
    assert cfg.quant is not None and cfg.merged_head and cfg.fused_stem
    # int8 stays int8 ((N, K) for the integer product), scales stay f32
    conv = art.model.backbone.stage3_conv.conv
    assert conv.int8 and conv.weight.dtype == torch.int8
    assert conv.weight.shape == (256, 9 * 128)
    assert conv.w_scale.dtype == torch.float32
    assert not art.model.backbone.stage2_conv.conv.int8      # PERF_EXCLUDE
    assert art.model.head_p2.merged and not art.model.head_p3.merged
    assert art.model.head_p3.cls_pred.weight.shape[0] == 8   # N 4 -> 8
    assert dataclasses.is_dataclass(cfg)
