"""Every engine configuration the export writes that the port serves
since the deploy transforms came, against ``jax.jit`` of the reference
model on the CPU.

Small engines (base_channels 8, 64^2, float32 compute, every leaf of the
reference's deploy tree drawn from a seeded numpy generator, as in
``tests/test_torch_slice.py``): the bf16 folded engine (standard stem,
3x3 stride-2 stage1), the host and device space-to-depth stems, the int8
engines with the standard and the s2d_host stem, and the two bf16 merged
engines (merged head; fused C3k2 and head). Per-level logits within 1e-4
and the same Detections: as many valid ones, matched one to one by class
and box, scores within 1e-4, boxes within 16 x 1e-4 (a box is a cell
centre plus or minus the regressed distances times the stride, 16 at P4:
the logit tolerance scaled by the largest stride). They are matched
rather than compared slot by slot because the reference's batch-1 top-K
is approximate (``approx_max_k``) and orders candidates of equal score
its own way, where the port's sort is stable.
The reference is jitted: XLA contracts the int8 epilogue into an FMA only
in a compiled graph, which the port emulates.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unina_yolo_dla_torch.models import config as tconfig
from unina_yolo_dla_torch.models.detector import from_jax_variables
from unina_yolo_dla_torch.ops.cuda import preprocess_kernel
from unina_yolo_dla_torch.ops.preprocess import (
    merged_frame_np,
    space_to_depth_np,
)
from unina_yolo_dla_torch.quant.fake_quant import PERF_EXCLUDE as T_PERF
from unina_yolo_dla_torch.quant.fake_quant import QuantSpec as TSpec
from unina_yolo_dla_torch.runtime.pipeline import (
    build_serving_fn,
    staged_shape,
)
from unina_yolo_dla_tpu.models import ModelConfig
from unina_yolo_dla_tpu.models.detector import UninaYoloDla
from unina_yolo_dla_tpu.quant.fake_quant import PERF_EXCLUDE, QuantSpec
from unina_yolo_dla_tpu.runtime.pipeline import build_serving_fn as j_build

LOGIT_ATOL = 1e-4
BOX_ATOL = 16 * LOGIT_ATOL   # the largest stride times LOGIT_ATOL
SERVE = dict(conf_threshold=0.3, q_factor=0.2)

S2DH = dict(stem_s2d=True, s2d_host=True, stage1_s2d=True)
S2DM = dict(S2DH, s2d_merged=True)
ENGINES = {
    "bf16_folded": dict(),
    "bf16_s2dh": S2DH,
    "bf16_s2d_device": dict(stem_s2d=True),
    "int8_s2dh": dict(S2DH, int8=True),
    "int8_fused": dict(int8=True),
    "bf16_s2dm_mh": dict(S2DM, merged_head=True),
    "bf16_s2dm_fc": dict(S2DM, fused_c3k2=True, fused_head=True),
}


def _fill(tree, rng, path=()):
    """Every leaf of a ``model.init`` tree from numpy: int8 kernels
    uniform, He-scaled float kernels, positive w_scale and amax."""
    if isinstance(tree, dict):
        return {k: _fill(v, rng, path + (k,)) for k, v in tree.items()}
    shape, dtype, name = np.shape(tree), np.asarray(tree).dtype, path[-1]
    if name == "amax":
        return np.float32(rng.uniform(2.0, 4.0))
    if name == "w_scale":
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
    for v in params.values():
        if isinstance(v, dict):
            if "w_scale" in v:
                fan = int(np.prod(v["kernel"].shape[:-1]))
                v["w_scale"] = (v["w_scale"] * np.sqrt(2 / fan) / 73.0
                                ).astype(np.float32)
            else:
                _scale_w_scales(v)


def _stage(frame, tcfg):
    """The (64, 64, 3) RGB frame in the engine's input layout."""
    if tcfg.s2d_merged:
        return merged_frame_np(frame)
    if tcfg.s2d_host:
        return space_to_depth_np(frame)
    return frame


_CACHE: dict = {}


def _engine(name):
    """(jitted reference apply, reference model, its config, variables,
    port model, port config, staged frame), built once per engine."""
    if name in _CACHE:
        return _CACHE[name]
    flags = dict(ENGINES[name])
    int8 = flags.pop("int8", False)
    jcfg = ModelConfig(num_classes=4, base_channels=8, input_size=64,
                       compute_dtype=jnp.float32, deploy=True,
                       quant=(QuantSpec("int8_fused", exclude=PERF_EXCLUDE)
                              if int8 else None), **flags)
    tcfg = tconfig.ModelConfig(
        num_classes=4, base_channels=8, input_size=64,
        compute_dtype=torch.float32, deploy=True,
        quant=TSpec("int8_fused", exclude=T_PERF) if int8 else None,
        **flags)
    model = UninaYoloDla(jcfg)
    x0 = jnp.zeros((1, *staged_shape(tcfg)), jnp.float32)
    shapes = model.init(jax.random.PRNGKey(0), x0, train=False)
    rng = np.random.default_rng(11)
    variables = {k: _fill(jax.device_get(v), rng)
                 for k, v in shapes.items()}
    _scale_w_scales(variables["params"])
    port = from_jax_variables(variables, tcfg, device="cpu")
    frame = np.random.default_rng(5).integers(0, 256, (64, 64, 3),
                                              dtype=np.uint8)
    apply = jax.jit(lambda v, x: model.apply(v, x, train=False))
    _CACHE[name] = (apply, model, jcfg, variables, port, tcfg,
                    _stage(frame, tcfg))
    return _CACHE[name]


@pytest.mark.parametrize("name", list(ENGINES))
def test_small_engine_logits_match_jitted_reference(name):
    apply, _, _, variables, port, tcfg, staged = _engine(name)
    mean, std = preprocess_kernel.channel_constants(staged.shape[-1])
    x = preprocess_kernel.normalize(torch.from_numpy(staged), mean, std)
    want = apply(variables, jnp.asarray(x.numpy())[None])
    with torch.inference_mode():
        got = port(x[None])
    assert len(got) == 3
    for (jc, jr), (tc, tr) in zip(want, got):
        assert tc.shape == jc.shape and tr.shape == jr.shape
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                                   atol=LOGIT_ATOL)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0,
                                   atol=LOGIT_ATOL)


@pytest.mark.parametrize("name", list(ENGINES))
def test_small_engine_detections_match_jitted_reference(name):
    _, model, jcfg, variables, port, tcfg, staged = _engine(name)
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


def test_backbone_forms_are_the_configured_ones():
    """Each engine builds the stem and stage1 its flags name."""
    kinds = {}
    for name in ("bf16_folded", "bf16_s2dh", "bf16_s2d_device",
                 "bf16_s2dm_mh"):
        bb = _engine(name)[4].backbone
        kinds[name] = (type(bb.stem).__name__, type(bb.stage1_conv).__name__,
                       bb.device_s2d)
    assert kinds == {
        "bf16_folded": ("ConvBlock", "ConvBlock", False),
        "bf16_s2dh": ("ShiftDot2x2", "MergedDownsample", False),
        "bf16_s2d_device": ("ShiftDot2x2", "ConvBlock", True),
        "bf16_s2dm_mh": ("ShiftDot2x2", "MergedDownsample", False),
    }
