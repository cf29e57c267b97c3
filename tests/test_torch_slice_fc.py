"""The fused-subgraph int8 engine (``int8_s2dm_fc``: int8_fused +
PERF_EXCLUDE, s2d_merged without fused_stem, fused_c3k2, fused_head, no
merged_head) in the port against the reference, on the CPU.

- small: the reference ``UninaYoloDla`` with those flags at base_channels
  8 and 64^2, f32 compute, every leaf from a seeded numpy generator;
  per-level logits within 1e-4, Detections equal (boxes and scores within
  1e-4).
- full width: the committed ``variables.msgpack`` under that config on
  the seed-7 scene, the port's entry points on the CPU vs the jitted
  reference: same valid count, detections matched one to one by class,
  box error <= 0.5 px, score error <= 1.5e-2. The score bound is looser
  than the shipped engine's 1e-2 for a measured reason: the stem and
  stage1 products sum in another order than XLA's, which flips about 1e-5
  of their bf16 outputs by one step, and the int8 chain downstream
  amplifies those flips (0.0101 on this scene, 0.003-0.005 on seeds 1-3).
- the same from the reference's own stage1 output onward: everything the
  fused kernels compute (stage1_block, fpn_c3k2_2, head_p2) and the int8
  chain between them then give the reference's detections within 1e-4.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import _fill, _scale_w_scales
from unina_yolo_dla_torch.data.synthetic import SynthConfig, generate_image
from unina_yolo_dla_torch.models import config as tconfig
from unina_yolo_dla_torch.models.detector import from_jax_variables
from unina_yolo_dla_torch.ops.cuda import preprocess_kernel
from unina_yolo_dla_torch.ops.decode import decode_outputs
from unina_yolo_dla_torch.ops.nms import nms
from unina_yolo_dla_torch.ops.preprocess import merged_frame_np
from unina_yolo_dla_torch.quant.fake_quant import PERF_EXCLUDE as T_PERF
from unina_yolo_dla_torch.quant.fake_quant import QuantSpec as TSpec
from unina_yolo_dla_torch.runtime.artifact import config_from_artifact
from unina_yolo_dla_torch.runtime.pipeline import build_serving_fn
from unina_yolo_dla_torch.utils.checkpoint import load_msgpack_raw
from unina_yolo_dla_tpu.models import ModelConfig
from unina_yolo_dla_tpu.models.detector import UninaYoloDla
from unina_yolo_dla_tpu.quant.fake_quant import PERF_EXCLUDE, QuantSpec
from unina_yolo_dla_tpu.runtime.pipeline import build_serving_fn as j_build

ARTIFACT = Path(__file__).resolve().parents[1] / "artifacts" / \
    "serving_artifact"
LOGIT_ATOL = 1e-4
BOX_PX, SCORE_TOL = 0.5, 1.5e-2

FC_FLAGS = dict(deploy=True, stem_s2d=True, s2d_host=True, stage1_s2d=True,
                s2d_merged=True, fused_c3k2=True, fused_head=True)
SERVE = dict(conf_threshold=0.5, iou_threshold=0.45, q_factor=0.2116)


def _configs(**kw):
    jcfg = ModelConfig(quant=QuantSpec("int8_fused", exclude=PERF_EXCLUDE),
                       **FC_FLAGS, **kw)
    tkw = {k: (torch.float32 if k == "compute_dtype" else v)
           for k, v in kw.items()}
    tcfg = tconfig.ModelConfig(quant=TSpec("int8_fused", exclude=T_PERF),
                               **FC_FLAGS, **tkw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def small_engine():
    jcfg, tcfg = _configs(num_classes=4, base_channels=8, input_size=64,
                          compute_dtype=jnp.float32)
    model = UninaYoloDla(jcfg)
    shapes = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 32, 16, 24), jnp.float32), train=False)
    rng = np.random.default_rng(11)
    variables = {k: _fill(jax.device_get(v), rng)
                 for k, v in shapes.items()}
    _scale_w_scales(variables["params"])
    port = from_jax_variables(variables, tcfg, device="cpu")
    frame = np.random.default_rng(5).integers(0, 256, (64, 64, 3),
                                              dtype=np.uint8)
    return model, jcfg, variables, port, tcfg, merged_frame_np(frame)


@pytest.fixture(scope="module")
def full_width():
    jcfg, tcfg = _configs()
    variables = load_msgpack_raw(ARTIFACT / "variables.msgpack")
    img, _ = generate_image(np.random.default_rng(7),
                            SynthConfig(image_size=640, seed=7))
    frame = merged_frame_np(np.ascontiguousarray(img[..., ::-1]))
    port = from_jax_variables(variables, tcfg, device="cpu")
    return jcfg, tcfg, variables, port, frame


def test_fc_engine_fuses_the_float_path_blocks(small_engine):
    port = small_engine[3]
    fused = {n for n, m in port.named_modules() if getattr(m, "fused", False)}
    assert fused == {"backbone.stage1_block", "neck.fpn_c3k2_2", "head_p2"}
    assert not port.head_p2.merged and not port.backbone.fused_stem


def test_fused_only_narrows_the_gate():
    cfg = tconfig.ModelConfig(fused_c3k2=True, fused_head=True,
                              fused_only=("stage1_block",))
    assert cfg.fuses(cfg.fused_c3k2, "stage1_block")
    assert not cfg.fuses(cfg.fused_head, "head_p2")
    assert not cfg.fuses(False, "stage1_block")
    wide = dataclasses.replace(cfg, fused_only=None)
    assert wide.fuses(wide.fused_head, "head_p2")


def test_small_fc_logits_match_reference(small_engine):
    model, _, variables, port, _, merged = small_engine
    mean, std = preprocess_kernel.channel_constants(24)
    x = preprocess_kernel.normalize(torch.from_numpy(merged), mean, std)
    want = model.apply(variables, jnp.asarray(x.numpy())[None], train=False)
    with torch.inference_mode():
        got = port(x[None])
    for (jc, jr), (tc, tr) in zip(want, got):
        assert tc.shape == jc.shape and tr.shape == jr.shape
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                                   atol=LOGIT_ATOL)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0,
                                   atol=LOGIT_ATOL)


def test_small_fc_detections_match_reference(small_engine):
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
    for a, b in ((got.boxes, want.boxes), (got.scores, want.scores)):
        np.testing.assert_allclose(a.numpy()[jv], np.asarray(b)[jv], rtol=0,
                                   atol=LOGIT_ATOL)


def _matched(want, got, box_px, score_tol):
    """One-to-one match of the reference's valid detections by class."""
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
        assert np.abs(tb[j] - jb[i]).max() <= box_px
        assert abs(tsc[j] - jsc[i]) <= score_tol


def test_full_width_fc_matches_reference(full_width):
    jcfg, tcfg, variables, port, frame = full_width
    want = jax.jit(j_build(UninaYoloDla(jcfg), jcfg, **SERVE))(
        variables, jnp.asarray(frame))
    got = build_serving_fn(port, tcfg, **SERVE)(torch.from_numpy(frame))
    _matched(want, got, BOX_PX, SCORE_TOL)


def test_full_width_fc_from_reference_stage1(full_width):
    """The reference's stage1 output fed to the port's stage1_block (a
    forward hook replaces the port's): the rest of the port, fused C3k2,
    C3k2-cat and head included, gives the reference's detections."""
    jcfg, tcfg, variables, port, frame = full_width
    model = UninaYoloDla(jcfg)
    mean, std = preprocess_kernel.channel_constants(24)
    x = preprocess_kernel.normalize(torch.from_numpy(frame), mean, std)[None]
    want, state = jax.jit(lambda v, x: model.apply(
        v, x, capture_intermediates=True))(variables, jnp.asarray(x.numpy()))
    s1 = np.array(state["intermediates"]["backbone"]["stage1_conv"][
        "__call__"][0], np.float32)
    s1 = torch.from_numpy(s1).to(torch.bfloat16)
    hook = port.backbone.stage1_conv.register_forward_hook(
        lambda m, args, out: s1)
    try:
        with torch.inference_mode():
            got = port(x)
    finally:
        hook.remove()
    def dets(outs):
        outs = [(torch.as_tensor(np.array(c)), torch.as_tensor(
            np.array(r))) for c, r in outs]
        return nms(decode_outputs(outs, tcfg.strides, SERVE["conf_threshold"],
                                  SERVE["q_factor"], 1024),
                   SERVE["iou_threshold"])

    _matched(dets(want), dets(got), LOGIT_ATOL, LOGIT_ATOL)


def test_config_from_artifact_accepts_merged_without_fused_stem():
    base = dict(num_classes=4, base_channels=32, input_size=640,
                quantized=True, stem_s2d=True, s2d_host=True,
                stage1_s2d=True, s2d_merged=True, camera=None, batch=None)
    cfg = config_from_artifact(dict(base, fused_stem=False))
    assert cfg.s2d_merged and not cfg.fused_stem and cfg.quant is not None
    assert config_from_artifact(dict(base, fused_stem=True)).fused_stem
    # a batch artifact's engine is the batch-1 one
    assert config_from_artifact(dict(base, fused_stem=False, batch=8)) == cfg
    # a camera cannot take host space-to-depth frames (the reference's
    # export refuses it); every other form the export writes is built as
    # written: the unmerged s2d_host stem, the standard stem with the 3x3
    # stage1 conv
    with pytest.raises(ValueError, match="space-to-depth"):
        config_from_artifact(dict(base, camera=[1080, 1920]))
    s2dh = config_from_artifact(dict(base, s2d_merged=False))
    assert s2dh.stem_s2d and s2dh.s2d_host and s2dh.stage1_s2d
    assert not s2dh.s2d_merged and not s2dh.fused_stem
    std = config_from_artifact(dict(base, stem_s2d=False, s2d_host=False,
                                    stage1_s2d=False, s2d_merged=False))
    assert not (std.stem_s2d or std.s2d_host or std.stage1_s2d
                or std.s2d_merged)
    assert not (std.fused_c3k2 or std.fused_head)
    assert config_from_artifact(dict(base, fused_c3k2=True,
                                     fused_head=True)).fused_head
