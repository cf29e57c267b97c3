"""The batch path of the port against the reference, on the CPU: decode
and top-K compaction of B images, batched NMS, the small engine served at
batch 2, and the batch artifact's configuration.

Tolerances:
- compaction: classes and valid equal in every slot, invalid slots
  included; boxes and scores within 1e-6 relative (1e-6 absolute near 0):
  the same f32 operations in the same order, on two libraries' kernels;
- NMS: the keep mask exact;
- small engine: as ``test_torch_slice.py``, valid slots and classes equal,
  boxes and scores within 1e-4 absolute.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import SERVING_FLAGS, _fill, _scale_w_scales
from unina_yolo_dla_torch.models import config as tconfig
from unina_yolo_dla_torch.models.detector import from_jax_variables
from unina_yolo_dla_torch.ops import decode as td
from unina_yolo_dla_torch.ops import nms as tn
from unina_yolo_dla_torch.ops.preprocess import merged_frame_np
from unina_yolo_dla_torch.quant.fake_quant import PERF_EXCLUDE as T_PERF
from unina_yolo_dla_torch.quant.fake_quant import QuantSpec as TSpec
from unina_yolo_dla_torch.runtime.artifact import (
    ServingArtifact,
    config_from_artifact,
)
from unina_yolo_dla_torch.runtime.pipeline import (
    build_batch_serving_fn,
    build_serving_fn,
)
from unina_yolo_dla_tpu.models import ModelConfig
from unina_yolo_dla_tpu.models.detector import UninaYoloDla
from unina_yolo_dla_tpu.ops import decode as jd
from unina_yolo_dla_tpu.ops.nms import nms as j_nms
from unina_yolo_dla_tpu.quant.fake_quant import PERF_EXCLUDE, QuantSpec
from unina_yolo_dla_tpu.runtime.pipeline import (
    build_batch_serving_fn as j_build_batch,
)

ARTIFACTS = Path(__file__).resolve().parents[1] / "artifacts"
RTOL = 1e-6
LOGIT_ATOL = 1e-4
GRIDS, STRIDES, K = (16, 8, 4), (4, 8, 16), 64


def _image(rng, kind):
    """Head outputs of one image whose valid cells number 0 ("empty"),
    fewer than K ("few": 20 cells lifted, 8 of them saturated to a tied
    score of exactly 1.0, spread over the levels) or more ("many")."""
    levels = []
    for g in GRIDS:
        mu, sd = (0.0, 3.0) if kind == "many" else (-6.0, 1.0)
        cls = rng.normal(mu, sd, (g, g, 4)).astype(np.float32)
        reg = rng.uniform(0.1, 3.0, (g, g, 4)).astype(np.float32)
        levels.append([cls, reg])
    flat = [c.reshape(-1, 4) for c, _ in levels]
    if kind in ("few", "many"):
        for i, lvl in enumerate(rng.integers(0, 3, 20)):
            cell = rng.integers(0, GRIDS[lvl] ** 2)
            flat[lvl][cell, rng.integers(0, 4)] = 40.0 if i < 8 else 1.5
    return levels


def _batch(kinds, seed=0):
    rng = np.random.default_rng(seed)
    imgs = [_image(rng, k) for k in kinds]
    return [tuple(np.stack([img[lvl][j] for img in imgs]) for j in (0, 1))
            for lvl in range(len(GRIDS))]


@pytest.mark.parametrize("kinds", [
    ("empty", "empty", "empty"), ("few", "few", "few"),
    ("many", "many", "many"), ("empty", "few", "many")])
def test_batched_compaction_matches_reference_per_image(kinds):
    """n = 0, n < K, n > K, and one empty image beside full ones: every
    slot of every image equals the reference's exact top-k, the invalid
    tail included."""
    levels = _batch(kinds)
    got = td.decode_batch([(torch.from_numpy(c), torch.from_numpy(r))
                           for c, r in levels], STRIDES, 0.5, 0.2, K)
    assert got.boxes.shape == (3, K, 4) and got.valid.shape == (3, K)
    assert got.classes.dtype == torch.int32
    for b, kind in enumerate(kinds):
        want = jd.decode_outputs(
            [(jnp.asarray(c[b])[None], jnp.asarray(r[b])[None])
             for c, r in levels], STRIDES, 0.5, 0.2, K, exact_topk=True)
        n = int(np.asarray(want.valid).sum())
        assert {"empty": n == 0, "few": 0 < n < K, "many": n == K}[kind]
        np.testing.assert_array_equal(got.valid[b].numpy(),
                                      np.asarray(want.valid))
        np.testing.assert_array_equal(got.classes[b].numpy(),
                                      np.asarray(want.classes))
        np.testing.assert_allclose(got.scores[b].numpy(),
                                   np.asarray(want.scores), rtol=RTOL,
                                   atol=RTOL)
        np.testing.assert_allclose(got.boxes[b].numpy(),
                                   np.asarray(want.boxes), rtol=RTOL,
                                   atol=RTOL)
    counts = got.counts()
    assert counts.shape == (3,)
    assert counts.tolist() == [int(v.sum()) for v in got.valid]
    with pytest.raises(ValueError, match="counts"):
        got.count   # noqa: B018 - a batch has no single count


def test_single_image_decode_is_the_batch_of_one():
    """``decode_outputs`` is ``decode_batch`` at B = 1 with the axis
    dropped; ``count`` and ``counts`` agree on it."""
    levels = _batch(("few",), seed=3)
    outs = [(torch.from_numpy(c), torch.from_numpy(r)) for c, r in levels]
    one = td.decode_outputs(outs, STRIDES, 0.5, 0.2, K)
    batch = td.decode_batch(outs, STRIDES, 0.5, 0.2, K)
    for f1, fb in zip(one, batch):
        assert torch.equal(f1, fb[0])
    assert one.count == batch.count == int(batch.counts()[0]) > 0
    unbatched = td.decode_outputs([(c[0], r[0]) for c, r in outs], STRIDES,
                                  0.5, 0.2, K)
    assert all(torch.equal(a, b) for a, b in zip(one, unbatched))
    with pytest.raises(ValueError, match="decode_batch"):
        td.decode_outputs([(torch.cat([c, c]), torch.cat([r, r]))
                           for c, r in outs], STRIDES, 0.5, 0.2, K)


def _crowd(rng, k, n_valid, one_class):
    centers = rng.uniform(50, 170, (k, 2))
    wh = rng.uniform(20, 60, (k, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1)
    scores = np.sort(rng.uniform(0.5, 1.0, k))[::-1]
    classes = (np.full(k, 1) if one_class else rng.integers(0, 4, k))
    valid = np.zeros(k, bool)
    valid[rng.choice(k, n_valid, replace=False)] = True
    return (boxes.astype(np.float32), scores.astype(np.float32),
            classes.astype(np.int32), valid)


@pytest.mark.parametrize("k,n_valid", [
    (128, (0, 40, 128, 90)), (37, (30, 0, 37, 5))])
def test_batched_nms_matches_vmapped_reference_exactly(k, n_valid):
    """Four images of scattered candidates (none valid, some, all, one
    class only) in one call: the keep mask equals ``jax.vmap`` of the
    reference ``nms`` exactly, image by image."""
    rng = np.random.default_rng(k)
    imgs = [_crowd(rng, k, n, one_class=(i == 3))
            for i, n in enumerate(n_valid)]
    boxes, scores, classes, valid = (np.stack(f) for f in zip(*imgs))
    want = np.asarray(jax.vmap(lambda d: j_nms(d, 0.45))(jd.Detections(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes),
        jnp.asarray(valid))).valid)
    dets = td.Detections(torch.from_numpy(boxes), torch.from_numpy(scores),
                         torch.from_numpy(classes), torch.from_numpy(valid))
    got = tn.nms(dets, 0.45).valid.numpy()
    assert got.shape == (4, k)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tn.nms_reference(dets, 0.45).valid.numpy(),
                                  want)
    for w, n in zip(want, n_valid):
        assert (w.sum() == 0) if n == 0 else 0 < w.sum() <= n
    assert any(w.sum() < n for w, n in zip(want, n_valid))  # suppressions


@pytest.fixture(scope="module")
def small_batch_engine():
    """The small seeded engine of ``test_torch_slice.py`` (base 8, 64^2,
    the shipped engine's flags), and two different merged frames."""
    jcfg = ModelConfig(num_classes=4, base_channels=8, input_size=64,
                       compute_dtype=jnp.float32,
                       quant=QuantSpec("int8_fused", exclude=PERF_EXCLUDE),
                       **SERVING_FLAGS)
    model = UninaYoloDla(jcfg)
    shapes = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 32, 16, 24), jnp.float32), train=False)
    rng = np.random.default_rng(11)
    variables = {k: _fill(jax.device_get(v), rng) for k, v in shapes.items()}
    _scale_w_scales(variables["params"])
    tcfg = tconfig.ModelConfig(num_classes=4, base_channels=8,
                               input_size=64, compute_dtype=torch.float32,
                               quant=TSpec("int8_fused", exclude=T_PERF),
                               **SERVING_FLAGS)
    port = from_jax_variables(variables, tcfg, device="cpu")
    frames = np.random.default_rng(5).integers(0, 256, (2, 64, 64, 3),
                                               dtype=np.uint8)
    return model, jcfg, variables, port, tcfg, merged_frame_np(frames)


def test_small_engine_batch_serving_matches_reference(small_batch_engine):
    """The port's ``build_batch_serving_fn`` at B = 2 against ``jax.jit``
    of the reference's, and each image against the port's batch-1 path."""
    model, jcfg, variables, port, tcfg, merged = small_batch_engine
    want = jax.jit(j_build_batch(model, jcfg, q_factor=0.2))(
        variables, jnp.asarray(merged))
    got = build_batch_serving_fn(port, tcfg, q_factor=0.2)(
        torch.from_numpy(merged))
    jv = np.asarray(want.valid)
    assert got.valid.shape == jv.shape == (2, 336)   # K = all the cells
    assert (jv.sum(axis=1) > 0).all()
    np.testing.assert_array_equal(got.valid.numpy(), jv)
    np.testing.assert_array_equal(got.classes.numpy()[jv],
                                  np.asarray(want.classes)[jv])
    np.testing.assert_allclose(got.boxes.numpy()[jv],
                               np.asarray(want.boxes)[jv], rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(got.scores.numpy()[jv],
                               np.asarray(want.scores)[jv], rtol=0,
                               atol=LOGIT_ATOL)
    serve_one = build_serving_fn(port, tcfg, q_factor=0.2)
    for b in range(2):
        one = serve_one(torch.from_numpy(merged[b]))
        assert torch.equal(one.valid, got.valid[b])
        torch.testing.assert_close(one.boxes[one.valid],
                                   got.boxes[b][got.valid[b]], rtol=0,
                                   atol=LOGIT_ATOL)


def _conf(name):
    import json

    return json.loads((ARTIFACTS / name / "config.json").read_text())


def test_batch_artifact_config():
    """The b8 artifact describes the shipped engine with a batch of 8; the
    camera artifact's engine loads (the standard stem with stage1_s2d);
    a camera with a batch is refused, as the reference's export does."""
    b8, b1 = _conf("serving_artifact_b8"), _conf("serving_artifact")
    assert b8["batch"] == 8
    assert config_from_artifact(b8) == config_from_artifact(b1)
    cam = _conf("serving_artifact_cam")
    cfg = config_from_artifact(cam)
    assert cfg.stage1_s2d and cfg.merged_head and cfg.quant is not None
    assert not (cfg.stem_s2d or cfg.s2d_host or cfg.s2d_merged
                or cfg.fused_stem)
    with pytest.raises(ValueError, match="camera and batch"):
        config_from_artifact(dict(cam, batch=8))


def test_batch_artifact_stages_its_batch():
    """A batch artifact stages (8, S, S, 3) frames into the merged layout
    frame by frame, and refuses a single frame or another batch."""
    art = ServingArtifact(ARTIFACTS / "serving_artifact_b8", device="cpu")
    assert art.batch == 8
    frames = np.random.default_rng(2).integers(0, 256, (8, 640, 640, 3),
                                               dtype=np.uint8)
    staged = art.stage(frames)
    assert staged.shape == (8, 320, 160, 24) and staged.dtype == torch.uint8
    assert np.array_equal(staged[5].numpy(), merged_frame_np(frames[5]))
    for bad in (frames[0], frames[:4]):
        with pytest.raises(ValueError, match="8, 640, 640, 3"):
            art.stage(bad)
