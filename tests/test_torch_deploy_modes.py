"""The two deploy modes the export writes beside the fused int8 chain,
against the reference on the CPU:

- the unfused int8 engine (``--int8 --int8-unfused``, quant mode ``int8``:
  int8 convs whose result is the compute dtype, every quantised conv
  quantising its float input through its own ``in_q``, the reference's
  default exclusions);
- the folded QAT model (a quantised checkpoint with deploy flags and no
  ``--int8``, quant mode ``quantize``: fake-quant of each quantised conv's
  input at its ``in_q`` amax and of its weights per output channel, the
  residuals through ``residual_q``).

Small engines (base 8, 64^2, float32 compute, ``s2d_merged`` +
``fused_stem``, every leaf of the reference's deploy tree drawn from a
seeded numpy generator as in ``tests/test_torch_deploy_forms.py``) against
``jax.jit`` of the reference model: per-level logits within 1e-4 and the
same Detections (matched one to one by class, scores within 1e-4, boxes
within 16 x 1e-4: the logit tolerance times the largest stride). The
export CLI on ``artifacts/engine_source.msgpack`` at ``--imgsz 64`` with
both flag sets writes the reference CLI's ``variables.msgpack`` byte for
byte, and its artifact is served as the mode it names.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unina_yolo_dla_torch import export as texport
from unina_yolo_dla_torch.models import config as tconfig
from unina_yolo_dla_torch.models.detector import from_jax_variables
from unina_yolo_dla_torch.ops.cuda import preprocess_kernel
from unina_yolo_dla_torch.ops.preprocess import merged_frame_np
from unina_yolo_dla_torch.quant.fake_quant import DEFAULT_EXCLUDE as T_DEF
from unina_yolo_dla_torch.quant.fake_quant import QuantSpec as TSpec
from unina_yolo_dla_torch.runtime.artifact import ServingArtifact
from unina_yolo_dla_torch.runtime.pipeline import build_serving_fn
from unina_yolo_dla_tpu import export as jexport
from unina_yolo_dla_tpu.models import ModelConfig
from unina_yolo_dla_tpu.models.detector import UninaYoloDla
from unina_yolo_dla_tpu.quant.fake_quant import QuantSpec
from unina_yolo_dla_tpu.runtime.pipeline import build_serving_fn as j_build


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this module runs: the suite runs it
    beside other worker processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ARTIFACTS = Path(__file__).resolve().parents[1] / "artifacts"
SOURCE = ARTIFACTS / "engine_source.msgpack"
LOGIT_ATOL = 1e-4
BOX_ATOL = 16 * LOGIT_ATOL   # the largest stride times LOGIT_ATOL
SERVE = dict(conf_threshold=0.3, q_factor=0.2)
S2DM = dict(stem_s2d=True, s2d_host=True, stage1_s2d=True, s2d_merged=True,
            fused_stem=True)
# mode -> deploy flags beside S2DM, as the export CLI sets them
MODES = {"int8": dict(), "quantize": dict(merged_head=True)}
# mode -> export flags beside --s2d-merged --fused-stem
CLI_FLAGS = {"int8": ["--int8", "--int8-unfused"],
             "quantize": ["--merged-head"]}


def _fill(tree, rng, path=()):
    """Every leaf of a ``model.init`` tree from numpy: int8 kernels
    uniform, He-scaled float kernels, positive w_scale and amax."""
    if isinstance(tree, dict):
        return {k: _fill(v, rng, path + (k,)) for k, v in tree.items()}
    shape, dtype, name = np.shape(tree), np.asarray(tree).dtype, path[-1]
    if name == "amax":
        return np.float32(rng.uniform(2.0, 4.0))
    if name == "w_scale":
        fan = int(np.prod(path_shapes[path[:-1]][:-1]))
        return (rng.uniform(0.8, 1.2, shape) * np.sqrt(2 / fan) / 73.0
                ).astype(np.float32)
    if name == "bias":
        return rng.normal(0, 0.05, shape).astype(np.float32)
    if name == "kernel":
        fan = int(np.prod(shape[:-1]))
        if dtype == np.int8:
            return rng.integers(-127, 128, shape, dtype=np.int8)
        return rng.normal(0, np.sqrt(2 / fan), shape).astype(np.float32)
    raise AssertionError(f"unexpected leaf {path}")


path_shapes: dict = {}


def _kernel_shapes(tree, path=()):
    if isinstance(tree, dict):
        if "kernel" in tree:
            path_shapes[path] = np.shape(tree["kernel"])
        for k, v in tree.items():
            _kernel_shapes(v, path + (k,))


_CACHE: dict = {}


def _engine(mode):
    """(jitted reference apply, reference model, its config, variables,
    port model, port config, merged frame), built once per mode."""
    if mode in _CACHE:
        return _CACHE[mode]
    flags = dict(S2DM, **MODES[mode])
    jcfg = ModelConfig(num_classes=4, base_channels=8, input_size=64,
                       compute_dtype=jnp.float32, deploy=True,
                       quant=QuantSpec(mode), **flags)
    tcfg = tconfig.ModelConfig(num_classes=4, base_channels=8,
                               input_size=64, compute_dtype=torch.float32,
                               deploy=True, quant=TSpec(mode), **flags)
    model = UninaYoloDla(jcfg)
    x0 = jnp.zeros((1, 32, 16, 24), jnp.float32)
    shapes = jax.device_get(model.init(jax.random.PRNGKey(0), x0,
                                       train=False))
    _kernel_shapes(shapes["params"], ("params",))
    rng = np.random.default_rng(21)
    variables = {k: _fill(v, rng, (k,)) for k, v in shapes.items()}
    port = from_jax_variables(variables, tcfg, device="cpu")
    frame = np.random.default_rng(5).integers(0, 256, (64, 64, 3),
                                              dtype=np.uint8)
    apply = jax.jit(lambda v, x: model.apply(v, x, train=False))
    _CACHE[mode] = (apply, model, jcfg, variables, port, tcfg,
                    merged_frame_np(frame))
    return _CACHE[mode]


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_builds_the_reference_layers(mode):
    """int8: int8 kernels outside the default exclusions, float between
    layers (no out_q/add_q); quantize: float kernels, the input and
    residual fake-quantisers, the merged float P2 head."""
    port, tcfg = _engine(mode)[4:6]
    assert tcfg.quant.exclude == T_DEF
    conv = port.backbone.stage2_conv.conv
    block = port.backbone.stage2_c3k2.bottlenecks[0]
    assert port.backbone.stage2_conv.out_q is None and block.add_q is None
    if mode == "int8":
        assert conv.int8 and conv.in_q is not None
        assert conv.int8_out == torch.float32 and block.residual_q is None
    else:
        assert not conv.int8 and conv.fake_in is not None
        assert block.residual_q is not None
        assert port.head_p2.merged and not port.head_p3.merged
        assert port.head_p3.cls_pred.fake_in is not None


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_logits_match_jitted_reference(mode):
    apply, _, _, variables, port, _, staged = _engine(mode)
    mean, std = preprocess_kernel.channel_constants(24)
    x = preprocess_kernel.normalize(torch.from_numpy(staged), mean, std)
    want = apply(variables, jnp.asarray(x.numpy())[None])
    with torch.inference_mode():
        got = port(x[None])
    for (jc, jr), (tc, tr) in zip(want, got):
        assert tc.shape == jc.shape and tr.shape == jr.shape
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                                   atol=LOGIT_ATOL)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0,
                                   atol=LOGIT_ATOL)


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_detections_match_jitted_reference(mode):
    _, model, jcfg, variables, port, tcfg, staged = _engine(mode)
    want = jax.jit(j_build(model, jcfg, **SERVE))(variables,
                                                    jnp.asarray(staged))
    got = build_serving_fn(port, tcfg, **SERVE)(torch.from_numpy(staged))
    jv, tv = np.asarray(want.valid), got.valid.numpy()
    assert tv.sum() == jv.sum() > 0
    jb, js, jc = (np.asarray(a)[jv] for a in (want.boxes, want.scores,
                                               want.classes))
    tb, ts, tc = (a.numpy()[tv] for a in (got.boxes, got.scores,
                                           got.classes))
    used = set()
    for i in range(len(jb)):
        cand = [j for j in range(len(tb)) if j not in used and tc[j] == jc[i]]
        assert cand, f"reference detection {i} unmatched"
        j = min(cand, key=lambda j: np.abs(tb[j] - jb[i]).max())
        used.add(j)
        assert np.abs(tb[j] - jb[i]).max() <= BOX_ATOL, (tb[j], jb[i])
        assert abs(ts[j] - js[i]) <= LOGIT_ATOL


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """Both flag sets through both CLIs at --imgsz 64: mode -> (port
    artifact directory, reference artifact directory)."""
    root = tmp_path_factory.mktemp("exports")
    out = {}
    for mode, flags in CLI_FLAGS.items():
        argv = ["--weights", str(SOURCE), "--imgsz", "64", "--s2d-merged",
                "--fused-stem", *flags]
        mine, ref = root / f"{mode}_port", root / f"{mode}_ref"
        texport.main(argv + ["--device", "cpu", "--output", str(mine)])
        jexport.main(argv + ["--platforms", "cpu", "--output", str(ref)])
        out[mode] = (mine, ref)
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_export_writes_the_reference_variables(exports, mode):
    mine, ref = exports[mode]
    assert (mine / "variables.msgpack").read_bytes() == \
        (ref / "variables.msgpack").read_bytes()
    conf = json.loads((mine / "config.json").read_text())
    assert conf["quant_mode"] == mode and conf["quantized"]
    assert conf["s2d_merged"] and conf["fused_stem"]


@pytest.mark.parametrize("mode", list(MODES))
def test_exported_artifacts_serve_in_their_mode(exports, mode):
    """The port's artifact reads its mode from its config.json; the
    reference's (whose config.json names none) from its weight tree (the
    folded QAT model's kernels are float) or, for the unfused int8
    engine, from the caller; both build the same model and serve a scene
    alike bit for bit."""
    from unina_yolo_dla_torch.data.synthetic import SynthConfig, \
        generate_image

    mine, ref = exports[mode]
    own = ServingArtifact(mine, device="cpu")
    theirs = ServingArtifact(ref, device="cpu",
                             **({"quant_mode": "int8"} if mode == "int8"
                                else {}))
    for art in (own, theirs):
        cfg = art.model_config
        assert cfg.quant.mode == mode and cfg.quant.exclude == T_DEF
        assert cfg.deploy and cfg.fused_stem
    bgr, _ = generate_image(np.random.default_rng(7), SynthConfig(
        image_size=64, seed=7, min_height=8, max_height=20))
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    a, b = own(rgb), theirs(rgb)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
