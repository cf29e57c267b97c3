"""The port's serving runtime (``runtime/aot.py``, ``serving.py``,
``embed.py``) on the CPU, held against the reference's runtime.

- The fallback report: strict mode raises on a host node; a synthetic node
  list is classified as the captured graph's walker classifies it.
- ``pack_detections`` against the reference's packed layout
  (``serve_packed``: ``[x1, y1, x2, y2, score, cls, valid]``) on the small
  shipped-flag engine of ``test_torch_slice.py``, within 1e-4.
- ``PerceptionServer`` and ``make_executor`` on a small ``s2d_merged``
  float32 artifact exported by the reference in the test, served in
  float32 as the caller says (the reference's ``config.json`` does not
  record the compute dtype), against the reference's server and executor:
  same count, detections matched one to one by class within 1e-4 px and
  1e-5 (measured: 1.9e-6 px, 2.4e-7; the port's f32 sums run in another
  order).
- Loading by what the weight tree holds: the reference's exports of an
  unfolded (BatchNorm) model and of the QAT fake-quant model are served as
  the train form against the reference's artifacts (the same tolerances);
  the unfused int8 engine and the folded QAT model are read from the mode
  ``config.json`` or the caller names, or from the tree; a ``config.json`` and a caller
  that disagree raise; the three committed artifacts load as before; a
  ``--fused-c3k2 --fused-head`` export of the reference served with those
  flags equals the reference's artifact.
- ``nv12_to_rgb`` against the reference within 1e-4.
"""
import dataclasses
import json
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import SERVING_FLAGS, _fill, _scale_w_scales
from unina_yolo_dla_torch.models import config as tconfig
from unina_yolo_dla_torch.models.detector import from_jax_variables
from unina_yolo_dla_torch.ops.decode import Detections
from unina_yolo_dla_torch.ops.preprocess import merged_frame_np
from unina_yolo_dla_torch.ops.preprocess import nv12_to_rgb as t_nv12
from unina_yolo_dla_torch.quant.fake_quant import DEFAULT_EXCLUDE as T_DEFAULT
from unina_yolo_dla_torch.quant.fake_quant import PERF_EXCLUDE as T_PERF
from unina_yolo_dla_torch.quant.fake_quant import QuantSpec as TSpec
from unina_yolo_dla_torch.runtime import aot as taot
from unina_yolo_dla_torch.runtime.artifact import ServingArtifact
from unina_yolo_dla_torch.runtime.embed import make_executor, pack_records
from unina_yolo_dla_torch.runtime.pipeline import build_serving_fn
from unina_yolo_dla_torch.runtime.serving import (
    LifecycleState,
    PerceptionServer,
)
from unina_yolo_dla_tpu.models import ModelConfig, init_model
from unina_yolo_dla_tpu.models.detector import UninaYoloDla
from unina_yolo_dla_tpu.ops.preprocess import nv12_to_rgb as j_nv12
from unina_yolo_dla_tpu.quant.deploy import (
    fold_batchnorm,
    fold_downsample_space_to_depth,
    fold_stem_space_to_depth,
    merge_stem_columns,
)
from unina_yolo_dla_tpu.quant.fake_quant import PERF_EXCLUDE, QuantSpec
from unina_yolo_dla_tpu.quant.qat import make_qat_model
from unina_yolo_dla_tpu.runtime.aot import ServingArtifact as JArtifact
from unina_yolo_dla_tpu.runtime.aot import export_serving_artifact
from unina_yolo_dla_tpu.runtime.embed import make_executor as j_executor
from unina_yolo_dla_tpu.runtime.pipeline import build_serving_fn as j_build
from unina_yolo_dla_tpu.runtime.serving import PerceptionServer as JServer

IMG = 32
BOX_PX, SCORE_TOL = 1e-4, 1e-5
F32 = dict(compute_dtype=torch.float32)   # how the reference built it
PACK_TOL = 1e-4
CONF = 0.92          # a few detections on FRAME_SEED's frame


def _frame(seed):
    return np.random.default_rng(seed).integers(0, 256, (IMG, IMG, 3),
                                                dtype=np.uint8)


FRAME_SEED = 0


@pytest.fixture(scope="module")
def artifact_dir(tmp_path_factory):
    """A float ``s2d_merged`` artifact exported by the reference: the
    init model's folded weights, its class logits scaled 30x about 0 so
    that scores spread over (0.5, 1) and a few cells pass ``CONF``."""
    cfg = ModelConfig(num_classes=4, base_channels=16, input_size=IMG,
                      compute_dtype=jnp.float32)
    _, variables = init_model(jax.random.key(0), cfg)
    merged = dataclasses.replace(cfg, deploy=True, stem_s2d=True,
                                 s2d_host=True, stage1_s2d=True,
                                 s2d_merged=True)
    m_vars = jax.device_get(merge_stem_columns(
        fold_downsample_space_to_depth(fold_stem_space_to_depth(
            fold_batchnorm(variables)))))
    for head in ("head_p2", "head_p3", "head_p4"):
        pred = m_vars["params"][head]["cls_pred"]
        pred["kernel"] = np.asarray(pred["kernel"]) * np.float32(30.0)
        pred["bias"] = np.zeros_like(np.asarray(pred["bias"]))
    out = tmp_path_factory.mktemp("s2dm_artifact")
    export_serving_artifact(UninaYoloDla(merged), m_vars, out,
                            conf_threshold=CONF, max_detections=64)
    return out


def _match(got, want):
    """One-to-one match of two detection dicts by class and box."""
    assert got["count"] == want["count"] >= 1
    used = set()
    for i in range(want["count"]):
        cand = [j for j in range(got["count"]) if j not in used
                and got["classes"][j] == want["classes"][i]]
        assert cand, f"reference detection {i} unmatched"
        j = min(cand, key=lambda j: np.abs(got["boxes"][j]
                                           - want["boxes"][i]).max())
        used.add(j)
        assert np.abs(got["boxes"][j] - want["boxes"][i]).max() <= BOX_PX
        assert abs(got["scores"][j] - want["scores"][i]) <= SCORE_TOL


def _records(blob: bytes) -> dict:
    count, = struct.unpack_from("<I", blob, 0)
    assert len(blob) == 4 + 24 * count
    rec = np.frombuffer(blob[4:], dtype=[
        ("x1", "<f4"), ("y1", "<f4"), ("x2", "<f4"), ("y2", "<f4"),
        ("score", "<f4"), ("cls", "<i4")])
    return {"count": count,
            "boxes": np.stack([rec[k] for k in ("x1", "y1", "x2", "y2")],
                              axis=-1),
            "scores": rec["score"], "classes": rec["cls"]}


# ---- fallback report ----

def _report(**kw):
    base = dict(host_nodes=[], dynamic_shapes=[], output_bytes=25600,
                kernel_nodes=3, port_kernels={}, nodes={"kernel": 3})
    return taot.FallbackReport(**(base | kw))


def test_strict_fallback_report_raises_on_host_node():
    bad = _report(host_nodes=["host: "])
    assert not bad.clean
    with pytest.raises(RuntimeError, match="host"):
        taot.print_fallback_report(bad, strict=True, log_fn=lambda s: None)
    taot.print_fallback_report(bad, strict=False, log_fn=lambda s: None)
    lines = []
    taot.print_fallback_report(_report(), strict=True, log_fn=lines.append)
    assert _report().clean and any("25600 B" in s for s in lines)


def test_report_from_nodes_classifies_nodes():
    """Host nodes and copies with a host end are host nodes; device
    copies, memsets and library kernels are not; each port kernel is
    counted by its device function, mangled or not."""
    nodes = [("kernel", "_ZN12_GLOBAL__N_123normalize_merged_kernelI13"
                        "__nv_bfloat16EEvPKhPT_x6Const3"),
             ("kernel", "_ZN12_GLOBAL__N_117c3k2_kernelILb1EEEvNS_6ParamsE"),
             ("kernel", "void (anonymous namespace)::c3k2_kernel<false>("
                        "(anonymous namespace)::Params)"),
             ("kernel", "_ZN12_GLOBAL__N_110nms_kernelEPKfPKiPKhPhif"),
             ("kernel", "_ZN41_GLOBAL__N__3c4cbb4f_9_camera_cu_7f14fb2d24"
                        "camera_preprocess_kernelILi1E13__nv_bfloat16EEvPKh"
                        "PT0_iiiiiiiPK4int2PK6float2S8_SB_NS_4NormE"),
             ("kernel", "void at::native::vectorized_elementwise_kernel"),
             ("memcpy", "1024 B"), ("memset", ""),
             ("memcpy", "28672 B, host dst"), ("host", "")]
    dets = Detections(torch.zeros(1024, 4), torch.zeros(1024),
                      torch.zeros(1024, dtype=torch.int32),
                      torch.zeros(1024, dtype=torch.bool))
    rep = taot.report_from_nodes(nodes, dets)
    assert rep.host_nodes == ["memcpy: 28672 B, host dst", "host: "]
    assert rep.kernel_nodes == 6 and rep.output_bytes == 25600
    assert rep.nodes == {"kernel": 6, "memcpy": 2, "memset": 1, "host": 1}
    assert rep.port_kernels == {
        "normalize": 1, "fused_stem_stage1": 0, "decode_topk": 0, "nms": 1,
        "stage1_merged": 0, "fused_c3k2": 1, "fused_c3k2_cat": 1,
        "fused_head": 0, "camera": 1}
    with pytest.raises(RuntimeError):
        taot.print_fallback_report(rep, log_fn=lambda s: None)


# ---- packed layout ----

def test_pack_detections_matches_reference_layout():
    """The reference's ``serve_packed`` concatenation of its Detections
    (``runtime/aot.py`` of the JAX package) against ``pack_detections``
    of the port's, on the small engine of ``test_torch_slice.py``."""
    spec = QuantSpec("int8_fused", exclude=PERF_EXCLUDE)
    jcfg = ModelConfig(num_classes=4, base_channels=8, input_size=64,
                       compute_dtype=jnp.float32, quant=spec,
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
    merged = merged_frame_np(np.random.default_rng(5).integers(
        0, 256, (64, 64, 3), dtype=np.uint8))

    dets = jax.jit(j_build(model, jcfg, q_factor=0.2))(variables,
                                                      jnp.asarray(merged))
    want = np.asarray(jnp.concatenate([
        dets.boxes.astype(jnp.float32),
        dets.scores.astype(jnp.float32)[..., None],
        dets.classes.astype(jnp.float32)[..., None],
        dets.valid.astype(jnp.float32)[..., None]], axis=-1))
    got = taot.pack_detections(build_serving_fn(port, tcfg, q_factor=0.2)(
        torch.from_numpy(merged)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    valid = want[:, 6] > 0.5
    assert valid.sum() > 0
    np.testing.assert_array_equal(got.numpy()[:, 6], want[:, 6])
    np.testing.assert_allclose(got.numpy()[valid], want[valid], rtol=0,
                               atol=PACK_TOL)


# ---- server ----

def test_server_lifecycle_drops_guard_and_stats(artifact_dir):
    logs = []
    srv = PerceptionServer(artifact_dir, expected_input=IMG,
                           expected_classes=4, log_fn=logs.append,
                           warn_throttle_s=0.0, device="cpu", **F32)
    assert srv.state == LifecycleState.UNCONFIGURED
    frame = _frame(FRAME_SEED)
    assert srv.process_frame(frame) is None          # before configure
    assert srv.frames_dropped == 1
    with pytest.raises(RuntimeError):
        srv.activate()
    srv.configure()
    assert srv.state == LifecycleState.INACTIVE
    with pytest.raises(RuntimeError):
        srv.configure()
    srv.activate()
    assert srv.state == LifecycleState.ACTIVE

    out = srv.process_frame(frame)
    assert out["count"] == len(out["boxes"]) == len(out["scores"]) >= 1
    assert out["boxes"].shape[1] == 4 and out["classes"].dtype == np.int32
    assert srv.process_frame(np.zeros((IMG + 2, IMG, 3), np.uint8)) is None
    assert srv.process_frame(np.zeros((IMG, IMG, 3), np.float32)) is None
    assert srv.process_frame(None) is None
    stats = srv.stats()
    assert stats["frames_processed"] == 1 and stats["frames_dropped"] == 4
    assert stats["count"] == 1 and stats["p99_ms"] > 0
    assert any("WARNING: bad frame geometry" in s for s in logs)

    srv.deactivate()
    assert srv.process_frame(frame) is None
    srv.cleanup()
    assert srv.state == LifecycleState.UNCONFIGURED and srv.artifact is None
    srv.shutdown()
    assert srv.state == LifecycleState.FINALIZED


def test_configure_rejects_wrong_dims(artifact_dir):
    for size, classes in ((640, 4), (IMG, 7)):
        srv = PerceptionServer(artifact_dir, expected_input=size,
                               expected_classes=classes,
                               log_fn=lambda s: None, device="cpu", **F32)
        with pytest.raises(ValueError):
            srv.configure()
        assert srv.state == LifecycleState.UNCONFIGURED


@pytest.mark.parametrize("seed", [FRAME_SEED, 1])
def test_process_frame_matches_reference_server(artifact_dir, seed):
    kw = dict(expected_input=IMG, log_fn=lambda s: None)
    want_srv, got_srv = JServer(artifact_dir, **kw), PerceptionServer(
        artifact_dir, device="cpu", **F32, **kw)
    for srv in (want_srv, got_srv):
        srv.configure()
        srv.activate()
    frame = _frame(seed)
    want, got = want_srv.process_frame(frame), got_srv.process_frame(frame)
    assert set(got) == set(want)
    _match(got, want)


def test_artifact_packed_equals_its_detections(artifact_dir):
    art = ServingArtifact(artifact_dir, device="cpu", **F32)
    assert art.graph is None
    assert art.model_config.compute_dtype == torch.float32
    frame = _frame(FRAME_SEED)
    dets = art(frame)
    packed = art.packed(frame)
    np.testing.assert_array_equal(
        packed, taot.pack_detections(dets).numpy())
    assert taot.output_bytes(dets) == json.loads(
        (artifact_dir / "fallback_report.json").read_text())["output_bytes"]
    taot.validate_artifact_shapes(art, IMG, 4)
    with pytest.raises(ValueError):
        taot.validate_artifact_shapes(art, IMG, 5)


# ---- executor ----

@pytest.fixture
def executors(artifact_dir, monkeypatch):
    monkeypatch.setenv("UNINA_FORCE_CPU", "1")
    return (j_executor(str(artifact_dir), IMG, 4),
            make_executor(str(artifact_dir), IMG, 4, **F32))


def test_executor_bytes_match_reference(executors):
    want_ex, got_ex = executors
    rgb = _frame(FRAME_SEED)
    bgra = np.concatenate([rgb[..., ::-1], np.full((IMG, IMG, 1), 255,
                                                   np.uint8)], axis=-1)
    for frame, ch in ((rgb, 3), (bgra, 4)):
        buf = memoryview(np.ascontiguousarray(frame).tobytes())
        want, got = want_ex(buf, IMG, IMG, ch), got_ex(buf, IMG, IMG, ch)
        _match(_records(got), _records(want))
    wrong = memoryview(np.zeros((IMG, IMG + 8, 3), np.uint8).tobytes())
    sentinel = struct.pack("<I", 0xFFFFFFFF)
    assert got_ex(wrong, IMG + 8, IMG, 3) == sentinel
    assert want_ex(wrong, IMG + 8, IMG, 3) == sentinel


def test_executor_nv12_matches_reference(executors):
    """A random NV12 plane pair (a seed whose scores keep 0.005 from
    ``CONF``), converted on the host and served."""
    want_ex, got_ex = executors
    rng = np.random.default_rng(6)
    nv12 = memoryview(rng.integers(0, 256, IMG * IMG * 3 // 2,
                                   dtype=np.uint8).tobytes())
    want, got = want_ex(nv12, IMG, IMG, 0), got_ex(nv12, IMG, IMG, 0)
    _match(_records(got), _records(want))


def test_executor_refuses_camera_artifact(monkeypatch):
    """A camera artifact's executor serves its camera's geometry (raw BGRA
    bytes, records of the artifact's own packed result) and refuses every
    other geometry or format with the sentinel."""
    monkeypatch.setenv("UNINA_FORCE_CPU", "1")
    cam = Path(__file__).resolve().parents[1] / "artifacts" / \
        "serving_artifact_cam"
    execute = make_executor(str(cam))
    frame = np.random.default_rng(8).integers(0, 256, (1080, 1920, 4),
                                              dtype=np.uint8)
    blob = execute(memoryview(frame.tobytes()), 1920, 1080, 4)
    want = ServingArtifact(cam, device="cpu").packed(frame)
    assert blob == pack_records(want)
    sentinel = struct.pack("<I", 0xFFFFFFFF)
    for w, h, c in ((1920, 1080, 3), (1920, 1080, 0), (1080, 1920, 4),
                    (IMG, IMG, 3)):
        assert execute(memoryview(frame.tobytes()), w, h, c) == sentinel


# ---- what an artifact's config.json does not say ----

COMMITTED = Path(__file__).resolve().parents[1] / "artifacts"


def _unfolded_export(tmp_path, qat: bool):
    """The reference's export of an unfolded (train-form) model, float32,
    as its train CLI's ``--export`` and ``tests/test_native_host.py``
    write it (no deploy flag): BatchNorm nodes and statistics in its tree;
    with ``qat`` the QAT fake-quant model (its exclusions) with a ``quant``
    collection of amaxes drawn in [2, 6]. The class logits are scaled so a
    random model detects at confidence 0.6."""
    cfg = ModelConfig(num_classes=4, base_channels=16, input_size=IMG,
                      compute_dtype=jnp.float32)
    model = make_qat_model(cfg) if qat else UninaYoloDla(cfg)
    variables = jax.device_get(model.init(
        jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)), train=False))
    variables = jax.tree.map(np.asarray, variables)
    assert variables["batch_stats"]
    for head in ("head_p2", "head_p3", "head_p4"):
        pred = variables["params"][head]["cls_pred"]
        pred["kernel"] = pred["kernel"] * np.float32(30.0)
        pred["bias"] = np.zeros_like(pred["bias"])
    if qat:
        rng = np.random.default_rng(3)
        variables["quant"] = jax.tree.map(
            lambda a: rng.uniform(2, 6, np.shape(a)).astype(np.float32),
            variables["quant"])
    export_serving_artifact(model, variables, tmp_path, conf_threshold=0.6,
                            max_detections=64)
    return tmp_path


def test_unfolded_jax_export_is_refused(tmp_path):
    """The reference's unfolded float export, which the port refused until
    it served the train form, is served (the weight tree says which form
    to build): the train form in eval mode, float32 as the caller says,
    against the reference's artifact on two frames."""
    art = _unfolded_export(tmp_path, qat=False)
    got_art = ServingArtifact(art, device="cpu", **F32)
    cfg = got_art.model_config
    assert not cfg.deploy and cfg.quant is None
    want_art = JArtifact(art)
    for seed in (FRAME_SEED, 1):
        frame = _frame(seed)
        _match(_dets(got_art(frame)), _dets(want_art(frame)))


def test_unfolded_qat_jax_export_is_served(tmp_path):
    """The reference's export of the QAT fake-quant model (a quantised
    unfolded tree, as its train CLI exports after QAT): served as the
    train form in the ``quantize`` mode with the train CLI's exclusions,
    against the reference's artifact on two frames."""
    art = _unfolded_export(tmp_path, qat=True)
    got_art = ServingArtifact(art, device="cpu", **F32)
    cfg = got_art.model_config
    assert not cfg.deploy and cfg.quant.mode == "quantize"
    assert cfg.quant.exclude == T_DEFAULT
    want_art = JArtifact(art)
    for seed in (FRAME_SEED, 1):
        frame = _frame(seed)
        _match(_dets(got_art(frame)), _dets(want_art(frame)))
    conf = json.loads((art / "config.json").read_text())
    from unina_yolo_dla_torch.runtime.artifact import config_from_artifact

    for bad in ({"merged_head": True}, {"quant_mode": "int8_fused"}):
        with pytest.raises(ValueError):
            config_from_artifact(dict(conf, **bad), unfolded=True)
    # the same config.json with the mode of a folded QAT model
    folded = config_from_artifact(dict(conf, quant_mode="quantize"))
    assert folded.deploy and folded.quant.mode == "quantize"
    assert folded.quant.exclude == T_DEFAULT


@pytest.mark.parametrize("name", ["serving_artifact", "serving_artifact_b8",
                                  "serving_artifact_cam"])
def test_committed_artifacts_still_load(name):
    """The committed artifacts (written by the reference, no build keys)
    load as before: bf16, unfused, the fused int8 chain."""
    art = ServingArtifact(COMMITTED / name, device="cpu")
    cfg = art.model_config
    assert cfg.compute_dtype == torch.bfloat16
    assert not cfg.fused_c3k2 and not cfg.fused_head
    assert cfg.quant.mode == "int8_fused" and cfg.quant.exclude == T_PERF


def test_build_keys_from_config_or_caller():
    """Each build key comes from config.json where it has it, else from
    the caller; the two disagreeing raises; the unfused int8 engine is
    built where either names it, the folded QAT model where the tree has
    no int8 kernel; a quant mode that contradicts ``quantized`` raises."""
    from unina_yolo_dla_torch.runtime.artifact import config_from_artifact

    conf = json.loads((COMMITTED / "serving_artifact" /
                       "config.json").read_text())
    cfg = config_from_artifact(conf, compute_dtype="float32",
                               fused_c3k2=True, fused_head=True)
    assert cfg.compute_dtype == torch.float32
    assert cfg.fused_c3k2 and cfg.fused_head
    own = dict(conf, compute_dtype="bfloat16", quant_mode="int8_fused",
               fused_c3k2=False, fused_head=False)
    assert config_from_artifact(own, compute_dtype=torch.bfloat16) == \
        config_from_artifact(conf)
    for key, value in (("compute_dtype", torch.float32),
                       ("quant_mode", "off"), ("fused_c3k2", True),
                       ("fused_head", True)):
        with pytest.raises(ValueError, match=key):
            config_from_artifact(own, **{key: value})
    with pytest.raises(ValueError, match="quantized"):
        config_from_artifact(conf, quant_mode="off")
    for src, kw in ((conf, {"quant_mode": "int8"}),
                    (dict(own, quant_mode="int8"), {})):
        cfg = config_from_artifact(src, **kw)   # the unfused int8 engine
        assert (cfg.quant.mode, cfg.quant.exclude) == ("int8", T_DEFAULT)
    # without a mode, a folded quantised tree without int8 kernels is the
    # folded QAT model
    cfg = config_from_artifact(conf, int8_kernels=False)
    assert (cfg.quant.mode, cfg.quant.exclude) == ("quantize", T_DEFAULT)
    with pytest.raises(TypeError):
        config_from_artifact(conf, fused_stem=True)


def test_fused_jax_export_served_fused_equals_reference(tmp_path):
    """A ``--fused-c3k2 --fused-head`` float32 export of the reference
    (its config.json records neither flag nor the dtype), served by the
    port with those flags given, against the reference's artifact."""
    cfg = ModelConfig(num_classes=4, base_channels=16, input_size=IMG,
                      compute_dtype=jnp.float32)
    _, variables = init_model(jax.random.key(0), cfg)
    fused = dataclasses.replace(cfg, deploy=True, fused_c3k2=True,
                                fused_head=True)
    f_vars = jax.device_get(fold_batchnorm(variables))
    for head in ("head_p2", "head_p3", "head_p4"):
        pred = f_vars["params"][head]["cls_pred"]
        pred["kernel"] = np.asarray(pred["kernel"]) * np.float32(30.0)
        pred["bias"] = np.zeros_like(np.asarray(pred["bias"]))
    export_serving_artifact(UninaYoloDla(fused), f_vars, tmp_path,
                            conf_threshold=0.6, max_detections=64)
    conf = json.loads((tmp_path / "config.json").read_text())
    assert not set(conf) & {"compute_dtype", "fused_c3k2", "fused_head"}
    got_art = ServingArtifact(tmp_path, device="cpu", fused_c3k2=True,
                              fused_head=True, **F32)
    assert got_art.model_config.fused_c3k2 and got_art.model_config.fused_head
    want_art = JArtifact(tmp_path)
    for seed in (FRAME_SEED, 1):
        frame = _frame(seed)
        _match(_dets(got_art(frame)), _dets(want_art(frame)))


def _dets(d) -> dict:
    valid = np.asarray(d.valid)
    return {"count": int(valid.sum()),
            "boxes": np.asarray(d.boxes, np.float32)[valid],
            "scores": np.asarray(d.scores, np.float32)[valid],
            "classes": np.asarray(d.classes)[valid]}


# ---- the rest ----

def test_nv12_to_rgb_matches_reference():
    rng = np.random.default_rng(9)
    y = rng.integers(0, 256, (18, 22), dtype=np.uint8)
    uv = rng.integers(0, 256, (9, 11, 2), dtype=np.uint8)
    want = np.asarray(j_nv12(jnp.asarray(y), jnp.asarray(uv)))
    got = t_nv12(torch.from_numpy(y), torch.from_numpy(uv))
    assert got.dtype == torch.float32 and got.shape == (18, 22, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_default_device_without_card_raises(artifact_dir, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the no-card error")
    monkeypatch.delenv("UNINA_FORCE_CPU", raising=False)
    srv = PerceptionServer(artifact_dir, expected_input=IMG,
                           log_fn=lambda s: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        srv.configure()
    assert srv.state == LifecycleState.UNCONFIGURED
    with pytest.raises(RuntimeError, match="CUDA"):
        make_executor(str(artifact_dir), IMG, 4)
