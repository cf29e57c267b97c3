"""The camera serving path: the port against the reference, on the CPU.

- resize: ``resize_bilinear_mxu`` and ``resize_bilinear`` against the
  reference's, exact where the source/destination ratio is a whole number
  (every product and sum exact), within 1e-4 on the 0-255 scale otherwise;
- camera preprocessing, plain (colour, resize, 114 pad, normalise) for
  bgra/rgb/nv12, letterboxed and stretched, at small camera sizes, within
  2e-6 of the jitted reference (on the normalised scale, about 1e-4 on the
  0-255 one: the jitted reference multiplies by the reciprocals of 255 and
  of std where the port divides, ~1 f32 step, and sums the resize in
  another order);
- the camera engine's stage1 (standard stem output viewed merged, the
  plain stage1 kernel) against ``space_to_depth_rt`` + ``ShiftDot2x2`` +
  ReLU: at most one bf16 step apart, on at most 1e-3 of the elements;
- the whole slice: the committed ``artifacts/serving_artifact_cam`` served
  by the port on the CPU against the reference ``ServingArtifact`` on the
  seed-7 1080x1920 BGRA scene: the same 9 detections, boxes within 1.5
  camera px (the 0.5 px model-space gate times the scale, 3), scores
  within 1e-2 (bf16 and int8 roundings differ between the two);
- other geometries (rgb and nv12, stretched, model-space boxes) against
  ``jax.jit`` of the reference ``build_camera_serving_fn`` with the
  committed weights: the same count, boxes within 1.5 px, scores within
  1.5e-2, the gate of the fc engine's full-width test. Score gaps of
  0.01-0.018 occur between two correct paths (card and CPU port, 4 of 32
  scene-engine pairs); on the nv12 480x640 stretch scene the reference
  itself gives 7 or 6 detections (one at 0.504) depending only on whether
  its preprocessing is compiled with the model, and the port, 7, is
  0.0117 from it;
- the executor's camera branch on the CPU: records and the sentinel.
"""
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unina_yolo_dla_torch.models.blocks import MergedDownsample, WeightTree
from unina_yolo_dla_torch.models.detector import from_jax_variables
from unina_yolo_dla_torch.ops import preprocess as tp
from unina_yolo_dla_torch.ops.cuda.camera_kernel import (
    CameraGeometry,
    CameraPreprocess,
    axis_taps,
    camera_preprocess_plain,
)
from unina_yolo_dla_torch.runtime.artifact import (
    ServingArtifact,
    config_from_artifact,
)
from unina_yolo_dla_torch.runtime.embed import make_executor
from unina_yolo_dla_torch.runtime.pipeline import build_camera_serving_fn
from unina_yolo_dla_torch.utils.checkpoint import load_msgpack_raw
from unina_yolo_dla_tpu.data import SynthConfig, generate_image
from unina_yolo_dla_tpu.models import ModelConfig
from unina_yolo_dla_tpu.models.blocks import ShiftDot2x2
from unina_yolo_dla_tpu.models.detector import UninaYoloDla
from unina_yolo_dla_tpu.ops import preprocess as jp
from unina_yolo_dla_tpu.quant.fake_quant import PERF_EXCLUDE, QuantSpec
from unina_yolo_dla_tpu.runtime.aot import ServingArtifact as JArtifact
from unina_yolo_dla_tpu.runtime.pipeline import (
    build_camera_serving_fn as j_build_camera,
)

ARTIFACT = Path(__file__).resolve().parents[1] / "artifacts" / \
    "serving_artifact_cam"
RESIZE_ATOL = 1e-4          # 0-255 scale, fractional ratios
PRE_ATOL = 2e-6             # normalised scale
BOX_PX, SCORE_TOL = 1.5, 1e-2
GEOMETRY_SCORE_TOL = 1.5e-2


def _u8(rng, shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _bgra(rgb):
    return np.concatenate([rgb[..., ::-1], np.full(rgb.shape[:2] + (1,), 255,
                                                   np.uint8)], axis=-1)


def _nv12(rgb):
    """An RGB frame as NV12 bytes (BT.601, chroma averaged 2x2): any
    bytes are a valid frame, this keeps the scene recognisable."""
    f = rgb.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 16 + 0.257 * r + 0.504 * g + 0.098 * b
    u = 128 - 0.148 * r - 0.291 * g + 0.439 * b
    v = 128 + 0.439 * r - 0.368 * g - 0.071 * b
    h, w = y.shape

    def half(c):
        return c.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))

    uv = np.stack([half(u), half(v)], axis=-1).reshape(h // 2, w)
    return np.clip(np.round(np.concatenate([y, uv])), 0, 255).astype(np.uint8)


def _frame(fmt, rgb):
    return {"rgb": np.ascontiguousarray(rgb), "bgra": _bgra(rgb),
            "nv12": _nv12(rgb)}[fmt]


def _scene(h, w, seed=7):
    img, labels = generate_image(np.random.default_rng(seed),
                                 SynthConfig(image_size=h, image_width=w,
                                             seed=seed))
    return np.ascontiguousarray(img[..., ::-1]), labels   # BGR -> RGB


# ---- resize and geometry ----

@pytest.mark.parametrize("form", ["mxu", "gather"])
@pytest.mark.parametrize("src,dst", [((48, 64), (24, 32)),
                                     ((1080, 1920), (360, 640)),
                                     ((1080, 1920), (640, 640))])
def test_resize_matches_reference(src, dst, form):
    img = np.random.default_rng(1).integers(0, 256, (*src, 3)).astype(
        np.float32)
    j_fn, t_fn = {"mxu": (jp.resize_bilinear_mxu, tp.resize_bilinear_mxu),
                  "gather": (jp.resize_bilinear, tp.resize_bilinear)}[form]
    want = np.asarray(jax.jit(j_fn, static_argnums=(1, 2))(
        jnp.asarray(img), *dst))
    got = t_fn(torch.from_numpy(img), *dst)
    assert got.dtype == torch.float32 and got.shape == (*dst, 3)
    whole = all(s % d == 0 for s, d in zip(src, dst))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=0 if whole else RESIZE_ATOL)


def test_geometry_tables_and_space_to_depth():
    """The served letterbox geometry; the kernel's tap tables rebuild the
    reference's interpolation matrix exactly (two nonzeros a row, one at
    the clamped edge); ``space_to_depth_rt`` is the reference's."""
    assert tp.letterbox_geometry(1080, 1920, 640) == (1 / 3, 360, 640, 140, 0)
    assert tp.letterbox_geometry(720, 1280, 640) == (0.5, 360, 640, 140, 0)
    for dst, src in ((360, 1080), (640, 1080), (640, 480), (7, 5)):
        m = tp.interp_matrix(dst, src)
        np.testing.assert_array_equal(m, np.asarray(jp._interp_matrix(dst,
                                                                       src)))
        idx, wts = axis_taps(dst, src)
        rebuilt = np.zeros_like(m)
        for d in range(dst):
            rebuilt[d, idx[d, 0]] += wts[d, 0]
            rebuilt[d, idx[d, 1]] += wts[d, 1]
        np.testing.assert_array_equal(rebuilt, m)
    idx, wts = axis_taps(360, 1080)   # ratio 3: pure point sampling
    assert (idx[:, 0] == 3 * np.arange(360) + 1).all()
    assert (wts[:, 0] == 1).all() and (wts[:, 1] == 0).all()
    x = np.random.default_rng(2).normal(size=(2, 8, 12, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        tp.space_to_depth_rt(torch.from_numpy(x)).numpy(),
        np.asarray(jp.space_to_depth_rt(jnp.asarray(x))))


# ---- camera preprocessing, plain ----

def _j_preprocess(fmt, ch, cw, s, letterbox):
    """The reference's camera program up to the model input."""
    if letterbox:
        scale = min(s / ch, s / cw)
        new_h, new_w = round(ch * scale), round(cw * scale)
        pad_y, pad_x = (s - new_h) // 2, (s - new_w) // 2

    def pre(frame):
        if fmt == "bgra":
            rgb = frame[..., 2::-1].astype(jnp.float32)
        elif fmt == "nv12":
            rgb = jp.nv12_to_rgb(frame[:ch].reshape(ch, cw),
                                 frame[ch:].reshape(ch // 2, cw // 2, 2))
        else:
            rgb = frame.astype(jnp.float32)
        if letterbox:
            resized = jp.resize_bilinear_mxu(rgb, new_h, new_w)
            canvas = jnp.full((s, s, 3), 114.0, jnp.float32)
            resized = jax.lax.dynamic_update_slice(canvas, resized,
                                                   (pad_y, pad_x, 0))
        else:
            resized = jp.resize_bilinear_mxu(rgb, s, s)
        return jp.normalize(resized / 255.0)

    return jax.jit(pre)


@pytest.mark.parametrize("letterbox", [True, False])
@pytest.mark.parametrize("fmt", ["bgra", "rgb", "nv12"])
def test_camera_preprocess_plain_matches_reference(fmt, letterbox):
    ch, cw, s = 30, 52, 32
    frame = _frame(fmt, _u8(np.random.default_rng(3), (ch, cw, 3)))
    geom = CameraGeometry(ch, cw, fmt, s, letterbox)
    assert frame.shape == geom.frame_shape
    want = np.asarray(_j_preprocess(fmt, ch, cw, s, letterbox)(
        jnp.asarray(frame)))
    got = camera_preprocess_plain(torch.from_numpy(frame), geom)
    assert got.dtype == torch.float32 and got.shape == (s, s, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PRE_ATOL)
    # the module: the plain version on a CPU frame, in its output dtype
    pre = CameraPreprocess(geom, torch.bfloat16)
    assert torch.equal(pre(torch.from_numpy(frame)), got.to(torch.bfloat16))
    with pytest.raises(ValueError, match="uint8"):
        pre(torch.from_numpy(frame[1:]))


# ---- the camera engine's stage1 ----

def test_stage1_s2d_matches_reference():
    """(1, 64, 64, 32) stem output -> (1, 32, 32, 64): the port's plain
    stage1 over the merged view against the reference's blocked
    downsample in bf16."""
    rng = np.random.default_rng(4)
    x = np.maximum(rng.normal(0, 1, (1, 64, 64, 32)), 0).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    kernel = rng.normal(0, np.sqrt(2 / 512), (2, 2, 128, 64)).astype(
        np.float32)
    bias = rng.normal(0, 0.05, 64).astype(np.float32)
    params = {"kernel": kernel, "bias": bias}
    xs = jp.space_to_depth_rt(jnp.asarray(x, jnp.bfloat16))
    want = jax.nn.relu(ShiftDot2x2(64, dtype=jnp.bfloat16).apply(
        {"params": params}, xs))
    want = np.asarray(want.astype(jnp.float32))
    tree = WeightTree({"params": {"s1": {"conv": params}}}, None,
                      torch.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16).contiguous()
    with torch.inference_mode():
        got = MergedDownsample(tree, "s1/conv")(xt.view(1, 64, 32, 64))
    assert got.dtype == torch.bfloat16 and got.shape == (1, 32, 32, 64)
    got = got.float().numpy()
    diff = np.abs(got - want)
    # one bf16 step of the larger of the two values
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))) / 128
    assert (diff <= step * 1.0001).all(), float(diff.max())
    assert (diff > 0).mean() <= 1e-3


# ---- the whole slice ----

@pytest.fixture(scope="module")
def seed7():
    """The seed-7 1080x1920 scene as BGRA, and the reference artifact's
    Detections on it."""
    rgb, labels = _scene(1080, 1920)
    bgra = _bgra(rgb)
    want = JArtifact(str(ARTIFACT))(bgra)
    return bgra, labels, jax.device_get(want)


def _matched(want, got, box_px, score_tol):
    """One-to-one match of the reference's valid detections by class;
    -> (count, worst box error, worst score error)."""
    jv, tv = np.asarray(want.valid), got.valid.numpy()
    assert tv.sum() == jv.sum() >= 1
    jb, jsc, jc = (np.asarray(a)[jv] for a in (want.boxes, want.scores,
                                                want.classes))
    tb, tsc, tc = (a.numpy()[tv] for a in (got.boxes, got.scores,
                                            got.classes))
    used, worst = set(), [0.0, 0.0]
    for i in range(len(jb)):
        cand = [j for j in range(len(tb)) if j not in used and tc[j] == jc[i]]
        assert cand, f"reference detection {i} unmatched"
        j = min(cand, key=lambda j: np.abs(tb[j] - jb[i]).max())
        used.add(j)
        worst = [max(worst[0], float(np.abs(tb[j] - jb[i]).max())),
                 max(worst[1], float(abs(tsc[j] - jsc[i])))]
    assert worst[0] <= box_px and worst[1] <= score_tol, worst
    return int(jv.sum()), *worst


def test_camera_artifact_matches_reference(seed7):
    """The committed camera artifact on the seed-7 scene: 9 cones, the
    same 9 detections (observed: boxes 0.454 px, scores 0.0086 apart)."""
    bgra, labels, want = seed7
    art = ServingArtifact(ARTIFACT, device="cpu")
    assert art.camera["format"] == "bgra" and art.frame_shape == bgra.shape
    assert not art.model_config.s2d_merged and art.model_config.stage1_s2d
    got = art(bgra)
    assert got.boxes.shape == (1024, 4)
    count, box_err, score_err = _matched(want, got, BOX_PX, SCORE_TOL)
    print(f"seed 7: {count} detections, boxes {box_err} px, scores "
          f"{score_err} apart")
    assert count == len(labels) == 9
    b = got.boxes.numpy()[got.valid.numpy()]
    assert (b >= 0).all() and (b[:, [0, 2]] <= 1920).all() and \
        (b[:, [1, 3]] <= 1080).all()
    with pytest.raises(ValueError, match="bgra"):
        art(bgra[..., :3])


@pytest.fixture(scope="module")
def camera_engine():
    jcfg = ModelConfig(quant=QuantSpec("int8_fused", exclude=PERF_EXCLUDE),
                       deploy=True, stage1_s2d=True, merged_head=True)
    tcfg = config_from_artifact({"num_classes": 4, "base_channels": 32,
                                 "input_size": 640, "quantized": True,
                                 "stage1_s2d": True, "merged_head": True})
    variables = load_msgpack_raw(ARTIFACT / "variables.msgpack")
    return (UninaYoloDla(jcfg), jcfg, variables,
            from_jax_variables(variables, tcfg, device="cpu"), tcfg)


@pytest.mark.parametrize("fmt,ch,cw,letterbox,space", [
    ("rgb", 720, 1280, True, "camera"),
    ("nv12", 480, 640, False, "camera"),
    ("rgb", 1080, 1920, False, "model"),
])
def test_camera_geometries_match_reference(camera_engine, fmt, ch, cw,
                                           letterbox, space):
    model, jcfg, variables, port, tcfg = camera_engine
    rgb, _ = _scene(ch, cw, seed=3)
    frame = _frame(fmt, rgb)
    kw = dict(camera_format=fmt, letterbox=letterbox, box_space=space,
              q_factor=0.2116)
    want = jax.jit(j_build_camera(model, jcfg, ch, cw, **kw))(
        variables, jnp.asarray(frame))
    got = build_camera_serving_fn(port, tcfg, ch, cw, **kw)(
        torch.from_numpy(frame))
    _matched(want, got, BOX_PX, GEOMETRY_SCORE_TOL)


def test_camera_executor_matches_reference(seed7, monkeypatch):
    """The executor's camera branch on the CPU: the ring's BGRA bytes as
    they are -> records of the reference's detections; any other
    geometry or format -> the sentinel."""
    monkeypatch.setenv("UNINA_FORCE_CPU", "1")
    bgra, _, want = seed7
    execute = make_executor(str(ARTIFACT))
    blob = execute(memoryview(bgra.tobytes()), 1920, 1080, 4)
    count, = struct.unpack_from("<I", blob, 0)
    assert len(blob) == 4 + 24 * count and count == int(want.valid.sum())
    rec = np.frombuffer(blob, np.float32, offset=4).reshape(count, 6)
    got = type(want)(torch.from_numpy(rec[:, :4].copy()),
                     torch.from_numpy(rec[:, 4].copy()),
                     torch.from_numpy(rec[:, 5].view(np.int32).copy()),
                     torch.ones(count, dtype=torch.bool))
    _matched(want, got, BOX_PX, SCORE_TOL)
    sentinel = struct.pack("<I", 0xFFFFFFFF)
    for w, h, c in ((1920, 1080, 3), (1080, 1920, 4), (1920, 1080, 0),
                    (640, 640, 3)):
        assert execute(memoryview(bgra.tobytes()), w, h, c) == sentinel
