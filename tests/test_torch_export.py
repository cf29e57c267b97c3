"""The port's export path against the reference, on the CPU.

- The deploy transforms (``quant/deploy.py``) on
  ``artifacts/engine_source.msgpack``: after each step of each committed
  artifact's chain, every leaf equal to the reference's in dtype, shape and
  value (exact: the same numpy arithmetic).
- ``save_msgpack``: the shipped tree written byte for byte as committed,
  and read back equal by the reference's reader.
- ``export.main`` with ``--device cpu`` and the committed artifacts' flags
  (shipped, batch 8, camera): ``variables.msgpack`` byte for byte and leaf
  for leaf, ``config.json`` on every key but ``platforms`` and the four
  keys the port adds.
- The export's refusals; without a deploy flag, the unfolded float and
  QAT models exported as the reference exports them and served.
- The plain fused C3k2, C3k2-cat and head at the bf16 engines' widths
  (hidden 64/128, F 128/256, head 128/256) against the reference's XLA
  form, f32 within 1e-5 (the same products, f32 sums in another order).
"""
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unina_yolo_dla_torch import export as texport
from unina_yolo_dla_torch.ops.cuda import c3k2_kernel as tk
from unina_yolo_dla_torch.ops.cuda import head_kernel as th
from unina_yolo_dla_torch.quant import deploy as tdeploy
from unina_yolo_dla_torch.quant.fake_quant import PERF_EXCLUDE as T_PERF
from unina_yolo_dla_torch.quant.fake_quant import QuantSpec as TSpec
from unina_yolo_dla_torch.train.conformal import load_cp_q
from unina_yolo_dla_torch.utils.checkpoint import (
    load_msgpack_raw,
    save_msgpack,
)
from unina_yolo_dla_tpu.ops.pallas.c3k2_kernel import (
    fused_c3k2,
    fused_c3k2_cat,
)
from unina_yolo_dla_tpu.ops.pallas.head_kernel import fused_head
from unina_yolo_dla_tpu.quant import deploy as jdeploy
from unina_yolo_dla_tpu.quant.fake_quant import PERF_EXCLUDE, QuantSpec
from unina_yolo_dla_tpu.train.conformal import load_cp_q as j_load_cp_q
from unina_yolo_dla_tpu.utils.checkpoint import load_msgpack_raw as ref_load

ARTIFACTS = Path(__file__).resolve().parents[1] / "artifacts"
SOURCE = ARTIFACTS / "engine_source.msgpack"
CP = ARTIFACTS / "cp_calibration.json"
ATOL_F32 = 1e-5

# each committed artifact's chain of transforms, as its export ran them
CHAINS = {
    "serving_artifact": ("fold_batchnorm", "fold_stem_space_to_depth",
                         "fold_downsample_space_to_depth",
                         "merge_stem_columns", "quantize_weights_int8"),
    "serving_artifact_b8": ("fold_batchnorm", "fold_stem_space_to_depth",
                            "fold_downsample_space_to_depth",
                            "merge_stem_columns", "quantize_weights_int8"),
    "serving_artifact_cam": ("fold_batchnorm",
                             "fold_downsample_space_to_depth",
                             "quantize_weights_int8"),
}
STEPS = [(a, i) for a, chain in CHAINS.items() for i in range(len(chain))]
# the committed artifacts' export flags
FLAGS = {
    "serving_artifact": ["--int8", "--s2d-merged", "--fused-stem",
                         "--merged-head"],
    "serving_artifact_b8": ["--int8", "--s2d-merged", "--fused-stem",
                            "--merged-head", "--batch", "8"],
    "serving_artifact_cam": ["--int8", "--merged-head", "--stage1-s2d",
                             "--camera", "1080x1920", "--format", "bgra"],
}
OUTPUT_BYTES = {"serving_artifact": 25600, "serving_artifact_b8": 204800,
                "serving_artifact_cam": 25600}
# keys the reference does not have, or writes for its own platforms
OWN_KEYS = ("platforms", "fused_c3k2", "fused_head", "compute_dtype",
            "quant_mode")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, np.asarray(tree)


def _assert_trees_equal(got, want):
    """Same paths in the same order, every leaf equal in dtype, shape
    and value."""
    g, w = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    assert len(g) > 0
    for (p, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape, p
        np.testing.assert_array_equal(a, b, err_msg=str(p))


def _sorted(tree):
    """Keys sorted at every level, as the reference writes a tree."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


@pytest.fixture(scope="module")
def source():
    tree = load_msgpack_raw(SOURCE)
    tree.pop("calib_meta")
    return tree


def _apply(module, steps, tree, spec):
    for name in steps:
        fn = getattr(module, name)
        tree = (fn(tree, spec) if name == "quantize_weights_int8"
                else fn(tree))
    return tree


@pytest.mark.parametrize("artifact,step", STEPS)
def test_transform_matches_reference(source, artifact, step):
    """The chain of ``artifact`` up to and including ``step``, port vs
    reference on the same tree; the whole chain also equals the committed
    variables leaf for leaf."""
    steps = CHAINS[artifact][:step + 1]
    got = _apply(tdeploy, steps, source, TSpec("int8_fused",
                                               exclude=T_PERF))
    want = _apply(jdeploy, steps, source,
                  QuantSpec("int8_fused", exclude=PERF_EXCLUDE))
    _assert_trees_equal(got, want)
    if step == len(CHAINS[artifact]) - 1:
        _assert_trees_equal(
            _sorted(got), load_msgpack_raw(
                ARTIFACTS / artifact / "variables.msgpack"))


def test_quantize_is_idempotent_and_per_tensor_option(source):
    """An int8 kernel passes through; ``per_channel_weights=False`` gives
    one scale per tensor, as the reference."""
    spec = TSpec("int8_fused", exclude=T_PERF)
    once = tdeploy.quantize_weights_int8(tdeploy.fold_batchnorm(source),
                                         spec)
    _assert_trees_equal(tdeploy.quantize_weights_int8(once, spec), once)
    got = tdeploy.quantize_weights_int8(
        tdeploy.fold_batchnorm(source),
        TSpec("int8_fused", exclude=T_PERF, per_channel_weights=False))
    want = jdeploy.quantize_weights_int8(
        jdeploy.fold_batchnorm(source),
        QuantSpec("int8_fused", exclude=PERF_EXCLUDE,
                  per_channel_weights=False))
    _assert_trees_equal(got, want)
    scale = got["params"]["backbone"]["stage3_conv"]["conv"]["w_scale"]
    assert len(set(scale.tolist())) == 1


def test_save_msgpack_writes_the_committed_bytes(tmp_path):
    path = ARTIFACTS / "serving_artifact" / "variables.msgpack"
    tree = load_msgpack_raw(path)
    out = tmp_path / "sub" / "v.msgpack"
    save_msgpack(tree, out)
    assert out.read_bytes() == path.read_bytes()
    _assert_trees_equal(ref_load(out), ref_load(path))


def test_load_cp_q_matches_reference(tmp_path):
    assert load_cp_q(CP) == j_load_cp_q(CP) == 0.21160399913787842
    assert load_cp_q(tmp_path / "missing.json", 0.3) == 0.3


@pytest.mark.parametrize("artifact", list(FLAGS))
def test_export_cli_reproduces_committed_artifact(tmp_path, artifact):
    out = tmp_path / artifact
    texport.main(["--weights", str(SOURCE), *FLAGS[artifact],
                  "--cp-calibration", str(CP), "--device", "cpu",
                  "--output", str(out)])
    ref = ARTIFACTS / artifact
    got_v = (out / "variables.msgpack").read_bytes()
    assert got_v == (ref / "variables.msgpack").read_bytes()
    _assert_trees_equal(load_msgpack_raw(out / "variables.msgpack"),
                        ref_load(ref / "variables.msgpack"))
    got, want = (json.loads((d / "config.json").read_text())
                 for d in (out, ref))
    assert got["output_bytes"] == OUTPUT_BYTES[artifact]
    assert got["platforms"] == ["cpu"]
    assert not got["fused_c3k2"] and not got["fused_head"]
    assert (got["compute_dtype"], got["quant_mode"]) == ("bfloat16",
                                                         "int8_fused")
    assert {k: v for k, v in got.items() if k not in OWN_KEYS} == \
        {k: v for k, v in want.items() if k not in OWN_KEYS}
    report = json.loads((out / "fallback_report.json").read_text())
    assert report["output_bytes"] == OUTPUT_BYTES[artifact]
    assert not report["captured"] and not report["host_nodes"]


@pytest.fixture(scope="module")
def float_ckpt(tmp_path_factory, source):
    """The float checkpoint: engine_source without quant and calib_meta."""
    path = tmp_path_factory.mktemp("ckpt") / "float.msgpack"
    save_msgpack({k: v for k, v in source.items() if k != "quant"}, path)
    return path


# the cases that export since the port builds the folded QAT model and
# the unfused int8 engine: the reference's transforms and quantisation
DEPLOY_MODE_CASES = {
    "quantized_without_int8": (
        ("fold_batchnorm", "fold_stem_space_to_depth",
         "fold_downsample_space_to_depth", "merge_stem_columns"),
        "quantize"),
    "int8_unfused": (("fold_batchnorm", "quantize_weights_int8"), "int8"),
}


@pytest.mark.parametrize("case", [
    "int8_uncalibrated", "calib_min_images", "fused_stem_unmerged",
    "quantized_without_int8", "int8_unfused", "unfolded_float",
    "platforms"])
def test_export_refusals(tmp_path, float_ckpt, source, case):
    """Each refused flag set exits with a message and writes nothing; the
    two deploy modes once refused here now export: the written tree is
    the reference's transforms of the checkpoint leaf for leaf, and
    ``config.json`` names the mode."""
    base = ["--device", "cpu", "--output", str(tmp_path / "out")]
    argv = {
        "int8_uncalibrated": ["--weights", str(float_ckpt), "--int8"],
        "calib_min_images": ["--weights", str(SOURCE), "--int8",
                             "--calib-min-images", "481"],
        "fused_stem_unmerged": ["--weights", str(float_ckpt),
                                "--fused-stem", "--fold-bn"],
        "quantized_without_int8": ["--weights", str(SOURCE),
                                   "--s2d-merged"],
        "int8_unfused": ["--weights", str(SOURCE), "--int8",
                         "--int8-unfused"],
        "unfolded_float": ["--weights", str(float_ckpt)],
        "platforms": ["--weights", str(SOURCE), "--int8", "--platforms",
                      "cpu,tpu"],
    }[case]
    if case == "unfolded_float":
        # exported as it stands since the port serves the train form
        _unfolded_parity(tmp_path, float_ckpt, quantized=False)
        return
    if case in DEPLOY_MODE_CASES:
        chain, mode = DEPLOY_MODE_CASES[case]
        texport.main(argv + ["--imgsz", "64"] + base)
        want = _apply(jdeploy, chain, source, QuantSpec(mode))
        _assert_trees_equal(
            load_msgpack_raw(tmp_path / "out" / "variables.msgpack"),
            _sorted(want))
        conf = json.loads((tmp_path / "out" / "config.json").read_text())
        assert conf["quant_mode"] == mode and conf["quantized"]
        return
    with pytest.raises(SystemExit) as e:
        texport.main(argv + base)
    assert isinstance(e.value.code, str)   # a message, not an exit code
    assert not (tmp_path / "out").exists()


def test_export_unfolded_qat_model(tmp_path):
    """A quantised checkpoint without ``--int8`` or a deploy flag: the QAT
    fake-quant model, as the train CLI's ``--export`` writes it."""
    _unfolded_parity(tmp_path, SOURCE, quantized=True)


# bf16 detections of the port (eager CPU) against the reference's compiled
# artifact: XLA's CPU backend runs bf16 convolutions in float32 without
# the intermediate bf16 roundings PyTorch's CPU convolutions keep
# (measured on seeds 1 and 7 at 64^2: 0.80 px and 0.0069 in score for the
# float model, 0.098 px and 0.029 for the QAT one; at 128^2 on seeds 1,
# 2, 3, 7: 0.60 px and 0.012, 0.78 px and 0.044)
BF16_BOX_PX, BF16_SCORE = 1.0, 0.05


def _unfolded_parity(tmp_path, ckpt, quantized: bool):
    """The port's export without a deploy flag (``--imgsz 64``) against
    the reference's export of the same checkpoint's unfolded model (its
    float or QAT model, as its CLI picks it): the same variable tree leaf
    for leaf, ``config.json`` equal on the reference's keys; the port
    serves both artifacts alike bit for bit, and finds the reference
    artifact's detections on two scenes (the same count, boxes and scores
    within the bf16 tolerances above)."""
    from unina_yolo_dla_torch.data.synthetic import SynthConfig, \
        generate_image
    from unina_yolo_dla_torch.runtime.artifact import ServingArtifact
    from unina_yolo_dla_torch.utils.checkpoint import sorted_tree
    from unina_yolo_dla_tpu.models import ModelConfig as JCfg
    from unina_yolo_dla_tpu.models.detector import UninaYoloDla as JModel
    from unina_yolo_dla_tpu.quant.qat import make_qat_model
    from unina_yolo_dla_tpu.runtime.aot import ServingArtifact as JArtifact
    from unina_yolo_dla_tpu.runtime.aot import export_serving_artifact

    out, ref = tmp_path / "out", tmp_path / "ref"
    texport.main(["--weights", str(ckpt), "--imgsz", "64", "--device",
                  "cpu", "--output", str(out)])
    v = load_msgpack_raw(ckpt)
    v.pop("calib_meta", None)
    jcfg = JCfg(input_size=64)
    export_serving_artifact(make_qat_model(jcfg) if quantized
                            else JModel(jcfg), v, ref, conf_threshold=0.5,
                            q_factor=0.1, max_detections=1024)
    _assert_trees_equal(sorted_tree(load_msgpack_raw(out / "variables.msgpack")),
                        sorted_tree(ref_load(ref / "variables.msgpack")))
    got, want = (json.loads((d / "config.json").read_text())
                 for d in (out, ref))
    assert (got["quant_mode"], got["compute_dtype"]) == (
        "quantize" if quantized else "off", "bfloat16")
    assert {k: v for k, v in got.items() if k not in OWN_KEYS} == \
        {k: v for k, v in want.items() if k not in OWN_KEYS}
    own, theirs = (ServingArtifact(d, device="cpu") for d in (out, ref))
    assert not own.model_config.deploy
    jart = JArtifact(ref)
    for seed in (1, 7):
        bgr, _ = generate_image(np.random.default_rng(seed), SynthConfig(
            image_size=64, seed=seed, min_height=8, max_height=20))
        rgb = np.ascontiguousarray(bgr[..., ::-1])
        a, b = own(rgb), theirs(rgb)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        w = jart(rgb)
        gv, wv = a.valid.numpy(), np.asarray(w.valid)
        assert gv.sum() == wv.sum() > 0
        gb, gs = a.boxes.numpy()[gv], a.scores.numpy()[gv]
        gc = a.classes.numpy()[gv]
        free = np.ones(len(gb), bool)
        for box, score, cls in zip(np.asarray(w.boxes)[wv],
                                   np.asarray(w.scores)[wv],
                                   np.asarray(w.classes)[wv]):
            d = np.where(free & (gc == cls), np.abs(gb - box).max(1), np.inf)
            j = int(np.argmin(d))
            assert d[j] <= BF16_BOX_PX and abs(gs[j] - score) <= BF16_SCORE
            free[j] = False


def _kb(rng, shape):
    fan = int(np.prod(shape[:-1]))
    return (rng.normal(0, np.sqrt(2 / fan), shape).astype(np.float32),
            rng.normal(0, .1, shape[-1]).astype(np.float32))


def _act(rng, shape):
    return np.maximum(rng.normal(0, 1, shape), 0).astype(np.float32)


def _j(kb):
    return tuple(map(jnp.asarray, kb))


# (Cin or (Ca, Cb, up), hidden, F, n): stage2_c3k2, stage3_c3k2,
# fpn_c3k2_1, pan_c3k2_1 and pan_c3k2_2 of the bf16 engines
WIDE = [(128, 64, 128, 2), (256, 128, 256, 2), ((128, 128, True), 64, 128, 1),
        ((64, 128, False), 64, 128, 1), ((128, 256, False), 128, 256, 1)]


@pytest.mark.parametrize("cin,hd,f,n", WIDE)
def test_plain_c3k2_at_bf16_engine_widths(rng, cin, hd, f, n):
    h, w = 6, 10
    cat = isinstance(cin, tuple)
    k_in = cin[0] + cin[1] if cat else cin
    cv1, cv2 = _kb(rng, (1, 1, k_in, hd)), _kb(rng, (1, 1, k_in, hd))
    cv3 = _kb(rng, (1, 1, 2 * hd, f))
    bns = [(_kb(rng, (1, 1, hd, hd)), _kb(rng, (3, 3, hd, hd)))
           for _ in range(n)]
    jw = (_j(cv1), _j(cv2), _j(cv3), [(_j(a), _j(b)) for a, b in bns])
    ws = tk.pack_c3k2_weights(cv1, cv2, cv3, bns, torch.float32)
    if cat:
        ca, cb, up = cin
        xa = _act(rng, (h // 2, w // 2, ca) if up else (h, w, ca))
        xb = _act(rng, (h, w, cb))
        want = fused_c3k2_cat(jnp.asarray(xa), jnp.asarray(xb), *jw,
                              upsample_a=up, use_pallas=False)
        got = tk.fused_c3k2_cat(torch.from_numpy(xa), torch.from_numpy(xb),
                                *ws, up_a=up)
    else:
        x = _act(rng, (h, w, cin))
        want = fused_c3k2(jnp.asarray(x), *jw, use_pallas=False)
        got = tk.fused_c3k2(torch.from_numpy(x), *ws)
    assert got.shape == (h, w, f)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL_F32)


@pytest.mark.parametrize("c", [128, 256])
def test_plain_head_at_bf16_engine_widths(rng, c):
    x = _act(rng, (5, 7, c))
    ws = ([_kb(rng, (3, 3, c, c)), _kb(rng, (3, 3, c, c))],
          _kb(rng, (1, 1, c, 4)),
          [_kb(rng, (3, 3, c, c)), _kb(rng, (3, 3, c, c))],
          _kb(rng, (1, 1, c, 4)))
    cc, cp, rc, rp = ws
    want = fused_head(jnp.asarray(x), [_j(a) for a in cc], _j(cp),
                      [_j(a) for a in rc], _j(rp), use_pallas=False)
    got = th.fused_head(torch.from_numpy(x),
                        *th.pack_head_weights(*ws, torch.float32))
    for g, wv in zip(got, want):
        assert g.shape == (5, 7, 4)
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=0,
                                   atol=ATOL_F32)


def test_full_width_bf16_fc_frame_matches_jitted_reference(source):
    """The bf16_s2dm_fc engine at full width from the committed float
    weights (engine_source without quant), the seed-7 scene: the port's
    CPU path against ``jax.jit`` of the reference, the same count matched
    one to one by class, box within 0.5 px, score within 1e-2 (bf16 layers
    round differently in the two frameworks)."""
    import jax

    from unina_yolo_dla_torch.data.synthetic import SynthConfig, \
        generate_image
    from unina_yolo_dla_torch.models.config import ModelConfig as TConfig
    from unina_yolo_dla_torch.models.detector import from_jax_variables
    from unina_yolo_dla_torch.ops.preprocess import merged_frame_np
    from unina_yolo_dla_torch.runtime.pipeline import build_serving_fn
    from unina_yolo_dla_tpu.models import ModelConfig
    from unina_yolo_dla_tpu.models.detector import UninaYoloDla
    from unina_yolo_dla_tpu.runtime.pipeline import build_serving_fn as jb

    steps = CHAINS["serving_artifact"][:-1]   # the float deploy chain
    flt = {k: v for k, v in source.items() if k != "quant"}
    flags = dict(deploy=True, stem_s2d=True, s2d_host=True, stage1_s2d=True,
                 s2d_merged=True, fused_c3k2=True, fused_head=True)
    img, _ = generate_image(np.random.default_rng(7),
                            SynthConfig(image_size=640, seed=7))
    frame = merged_frame_np(np.ascontiguousarray(img[..., ::-1]))
    jcfg = ModelConfig(**flags)
    want = jax.jit(jb(UninaYoloDla(jcfg), jcfg, q_factor=0.2116))(
        _apply(jdeploy, steps, flt, None), jnp.asarray(frame))
    tcfg = TConfig(**flags)
    got = build_serving_fn(
        from_jax_variables(_apply(tdeploy, steps, flt, None), tcfg, "cpu"),
        tcfg, q_factor=0.2116)(torch.from_numpy(frame))
    jv, tv = np.asarray(want.valid), got.valid.numpy()
    assert tv.sum() == jv.sum() >= 1
    jbx, js, jc = (np.asarray(a)[jv] for a in (want.boxes, want.scores,
                                                want.classes))
    tb, ts, tc = (a.numpy()[tv] for a in (got.boxes, got.scores,
                                           got.classes))
    used = set()
    for i in range(len(jbx)):
        cand = [j for j in range(len(tb)) if j not in used and tc[j] == jc[i]]
        assert cand, f"reference detection {i} unmatched"
        j = min(cand, key=lambda j: np.abs(tb[j] - jbx[i]).max())
        used.add(j)
        assert np.abs(tb[j] - jbx[i]).max() <= 0.5
        assert abs(ts[j] - js[i]) <= 1e-2


def test_export_serving_artifact_checks(tmp_path):
    """The reference's checks: camera and batch exclude each other, a host
    space-to-depth engine takes no camera, NV12 dimensions are even, an
    unknown format is refused; nothing is written."""
    from unina_yolo_dla_torch.runtime.aot import export_serving_artifact
    from unina_yolo_dla_torch.runtime.artifact import ServingArtifact

    ship = ServingArtifact(ARTIFACTS / "serving_artifact", device="cpu")
    cam = ServingArtifact(ARTIFACTS / "serving_artifact_cam", device="cpu")
    variables = load_msgpack_raw(ARTIFACTS / "serving_artifact_cam" /
                                 "variables.msgpack")
    out = tmp_path / "out"
    for model, kw, match in (
            (cam.model, dict(camera=(1080, 1920, "bgra"), batch=8),
             "exclusive"),
            (ship.model, dict(camera=(1080, 1920, "bgra")), "s2d_host"),
            (cam.model, dict(camera=(1081, 1920, "nv12")), "even"),
            (cam.model, dict(camera=(1080, 1920, "yuyv")), "format")):
        with pytest.raises(ValueError, match=match):
            export_serving_artifact(model, variables, out, **kw)
    assert not out.exists()
