"""The port's quantisation-aware training against the JAX package on the
CPU: the fake-quant primitives (value and gradient), the calibration
quantisers and collections, amax selection, the calibration cache,
``calibrate`` / ``prepare_qat_variables`` and one QAT step.

Model-level comparisons run the small model (base 16, 64^2, the JAX init
variables) in float64 compute on float batches both sides normalise
alike: in float32 the reference's XLA program rounds some convolutions
and its rsqrt one step away from PyTorch's (measured: 1.6e-6 relative on
the entropy amaxes end to end, and single histogram bins), while the
quantisers themselves, fed the same activations, agree bit for bit in any
dtype.
"""
import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from unina_yolo_dla_torch.models import detector as tdet
from unina_yolo_dla_torch.models.config import ModelConfig as TCfg
from unina_yolo_dla_torch.quant import calibrate as tcal
from unina_yolo_dla_torch.quant import fake_quant as tfq
from unina_yolo_dla_torch.quant import qat as tqat
from unina_yolo_dla_torch.train import losses as tl
from unina_yolo_dla_torch.train import trainer as ttr
from unina_yolo_dla_tpu.models import ModelConfig as JCfg
from unina_yolo_dla_tpu.models.detector import UninaYoloDla as JModel
from unina_yolo_dla_tpu.quant import fake_quant as jfq
from unina_yolo_dla_tpu.quant import qat as jqat
from unina_yolo_dla_tpu.train import losses as jl
from unina_yolo_dla_tpu.train import trainer as jtr

# the JAX package's quant/__init__.py re-exports the function `calibrate`
# under the module's name
jcal = importlib.import_module("unina_yolo_dla_tpu.quant.calibrate")
SMALL = dict(num_classes=4, base_channels=16, input_size=64)
T64 = TCfg(**SMALL, compute_dtype=torch.float64)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _bf16(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_tensor_value_and_gradient(dtype):
    """fake_quant_tensor and ste_round: values, the result's dtype and the
    gradients w.r.t. x and amax equal the reference's, with inputs at
    exactly +-amax (the clip's bound: half the gradient there), at
    round-half-even ties and beyond the bound; a bf16 input is quantised
    in float32 against the float32 amax and cast back."""
    amax = np.float32(127 * 2.0 ** -5)     # scale 2^-5: exact levels
    scale = amax / 127
    x = np.array([amax, -amax, 2.5 * scale, -3.5 * scale, 0.3, 1e-3,
                  amax * 1.5, -amax * 2, 0.0], np.float32)
    if dtype == "bfloat16":
        xj, xt = _bf16(x), torch.tensor(x, dtype=torch.bfloat16)
    else:
        xj, xt = x, torch.tensor(x)

    def jf(x, a):
        return jfq.fake_quant_tensor(x, a, 127.0)

    want = np.asarray(jf(xj, jnp.float32(amax))).astype(np.float32)
    gx, ga = jax.grad(lambda x, a: jf(x, a).astype(jnp.float32).sum(),
                      argnums=(0, 1))(xj, jnp.float32(amax))
    xt.requires_grad_()
    at = torch.tensor(amax, requires_grad=True)
    got = tfq.fake_quant_tensor(xt, at, 127.0)
    assert got.dtype == xt.dtype
    got.float().sum().backward()
    np.testing.assert_array_equal(got.detach().float().numpy(), want)
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  np.asarray(gx).astype(np.float32))
    np.testing.assert_allclose(float(at.grad), float(ga), rtol=1e-6)
    assert xt.grad.float().numpy()[0] == 0.5
    # ste_round: half to even, identity gradient
    r = torch.tensor([0.5, 1.5, 2.5, -0.5, 0.49], requires_grad=True)
    tfq.ste_round(r).sum().backward()
    np.testing.assert_array_equal(
        tfq.ste_round(r).detach().numpy(),
        np.asarray(jfq.ste_round(jnp.asarray(r.detach().numpy()))))
    assert torch.equal(r.grad, torch.ones(5))


@pytest.mark.parametrize("per_channel", [True, False])
def test_quant_weight_gradient_at_tied_max(per_channel):
    """quant_weight: amax = max|w| per output channel (or tensor), not
    detached; two entries of one channel share its max, so the amax
    gradient splits between them as the reference's max splits it."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(3, 3, 4, 5)).astype(np.float32)
    w[0, 0, 0, 1], w[2, 1, 3, 1] = 2.0, -2.0
    spec_j = jfq.QuantSpec("quantize", per_channel_weights=per_channel)
    spec_t = tfq.QuantSpec("quantize", per_channel_weights=per_channel)
    cot = rng.normal(size=w.shape).astype(np.float32)
    val, vjp = jax.vjp(lambda w: jfq.quant_weight(w, spec_j, "neck/x"), w)
    wt = torch.tensor(w, requires_grad=True)
    got = tfq.quant_weight(wt, spec_t, "neck/x")
    got.backward(torch.tensor(cot))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(val))
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(vjp(cot)[0]),
                               rtol=1e-6, atol=1e-6)
    # an excluded path and the other modes leave the weight as it is
    assert tfq.quant_weight(wt, spec_t, "head_p2/cls_pred") is wt
    assert tfq.quant_weight(wt, tfq.QuantSpec("calib_max"), "neck/x") is wt


def _act_quant_run(mode, xs, calib=None):
    """The reference's ActQuant over the activations in turn."""
    mod = jfq.ActQuant(jfq.QuantSpec(mode))
    coll = calib
    for x in xs:
        v = {"quant_calib": coll} if coll is not None else {}
        _, mut = mod.apply(v, x, mutable=["quant_calib"])
        coll = jax.tree.map(np.asarray, mut["quant_calib"])
    return coll


def test_calibration_quantisers_bit_exact():
    """TrainActQuant in calib_max then calib_hist mode, fed the same
    activations as the reference's ActQuant (bf16 and float32, one above
    2^21 elements: the strided subsample): the running amax equal and the
    2048-bin histogram equal bin for bin."""
    rng = np.random.default_rng(9)
    xs = [np.maximum(rng.normal(0.2, 1, (2, 16, 16, 8)), 0).astype(
        np.float32),
        rng.standard_cauchy((1, 64, 64, 64)).astype(np.float32) * 0.1,
        np.abs(rng.normal(0, 2, (2, 1, 1, (1 << 21) + 4097 // 2))).astype(
            np.float32)]
    xs_j = [_bf16(xs[0]), xs[1], xs[2]]
    xs_t = [torch.tensor(xs[0], dtype=torch.bfloat16),
            torch.tensor(xs[1]), torch.tensor(xs[2])]
    c1 = _act_quant_run("calib_max", xs_j)
    c2 = _act_quant_run("calib_hist", xs_j, calib=c1)
    q = tfq.TrainActQuant(tfq.QuantSpec("calib_max"))
    for x in xs_t:
        assert q(x) is x
    assert float(q.amax) == float(c1["amax"])
    h = tfq.TrainActQuant(tfq.QuantSpec("calib_hist"))
    h.amax.copy_(q.amax)
    for x in xs_t:
        h(x)
    np.testing.assert_array_equal(h.hist.numpy(), c2["hist"])
    assert float(h.amax) == float(c2["amax"])
    assert h.hist.sum() < sum(x.numel() for x in xs_t)   # subsampled


@pytest.fixture(scope="module")
def small64():
    """The JAX init variables of the small model in float64, three float
    batches of 2 scenes (already normalised: both packages pass them
    through), and the reference's calibration collections (its two passes)
    and quant tree (entropy), in float64 compute."""
    rng = np.random.default_rng(0)
    batches = [{"images": rng.normal(size=(2, 64, 64, 3))} for _ in range(3)]
    with jax.enable_x64(True):
        cfg = JCfg(**SMALL, compute_dtype=jnp.float64)
        model = JModel(cfg)
        v = jax.jit(lambda k: model.init(k, jnp.zeros((1, 64, 64, 3)),
                                         train=False))(jax.random.key(0))
        # float64 params off the float32 grid: a float32 kernel divided
        # by its float32 scale can land exactly on a rounding tie, where
        # XLA's reciprocal-multiply and a division round apart
        v = jax.tree.map(lambda a: np.asarray(a, np.float64) * (
            1 + rng.uniform(-1e-9, 1e-9, np.shape(a))), v)
        v["batch_stats"] = jax.tree.map(
            lambda a: a + rng.uniform(0.1, 0.5, a.shape), v["batch_stats"])

        def run(mode, variables):
            m = JModel(cfg.with_quant(mode))
            f = jax.jit(lambda vv, b: m.apply(vv, b["images"], train=False,
                                              mutable=["quant_calib"]))
            return jax.tree.map(np.asarray, jcal._run_calib_pass(
                f, variables, iter(batches), 30)[0])

        c1 = run("calib_max", v)
        c2 = run("calib_hist", dict(v, quant_calib=c1))
    # what the reference's calibrate returns after these two passes
    quant = jcal.select_amax(c2, "entropy")
    return v, batches, c1, c2, quant


def _torch_batches(batches):
    return [{"images": torch.tensor(b["images"])} for b in batches]


def test_model_calibration_collections(small64):
    """Both calibration passes of the model: the quant_calib trees have
    the reference's keys, every amax equal, every histogram equal bin for
    bin."""
    v, batches, c1, c2, _ = small64
    tv = tdet.variables_from_jax(v, "cpu")
    base = {**tv["params"], **tv["batch_stats"]}
    got = []
    for mode, start in (("calib_max", None), ("calib_hist", "c1")):
        m = tdet.UninaYoloDla(None, T64.with_quant(mode)).double()
        calib = {k: torch.zeros_like(t) for k, t in
                 tdet.variables_of(m)["quant_calib"].items()}
        if start:
            for k, t in got[0].items():
                calib[k].copy_(t)
        tcal._run_calib_pass(m, base, calib, _torch_batches(batches), 30,
                             lambda b: b["images"])
        got.append(calib)
    for want, calib in ((c1, got[0]), (c2, got[1])):
        tree = tdet.to_jax_variables({"q": calib})["q"]
        assert [p for p, _ in _leaves(tree)] == [p for p, _ in _leaves(want)]
        for (p, a), (_, b) in zip(_leaves(want), _leaves(tree)):
            np.testing.assert_array_equal(b, a, err_msg=str(p))


def test_select_amax_entropy_percentile():
    """select_amax (every method), entropy_amax and percentile_amax on the
    same histograms: equal to the reference's."""
    rng = np.random.default_rng(4)
    tree = {"a": {"in_q": {"amax": np.float32(3.5), "hist": np.histogram(
        np.abs(rng.normal(0, 1, 20000)), 2048, (0, 3.5))[0].astype(
            np.float32)}},
        "b": {"amax": np.float32(2.0), "hist": np.histogram(
            np.abs(rng.standard_cauchy(20000)), 2048, (0, 2.0))[0].astype(
                np.float32)},
        "c": {"amax": np.float32(0.7)}}
    for method in ("entropy", "percentile", "max"):
        want = jcal.select_amax(tree, method)
        got = tcal.select_amax(tree, method)
        assert [p for p, _ in _leaves(got)] == [p for p, _ in _leaves(want)]
        for (p, a), (_, b) in zip(_leaves(want), _leaves(got)):
            assert type(b) is np.float32 and b == a, (method, p)
    h = tree["b"]["hist"]
    assert tcal.entropy_amax(h, 2.0) == jcal.entropy_amax(h, 2.0)
    assert tcal.percentile_amax(h, 2.0, 99.0) == \
        jcal.percentile_amax(h, 2.0, 99.0)


def test_calibrate_and_prepare_qat_variables(small64):
    """calibrate end to end (two passes, entropy) within 1e-6 relative of
    the reference; prepare_qat_variables attaches the same quant tree and
    passes params and statistics through; the QAT model's quantisers are
    the reference's."""
    v, batches, _, _, want = small64
    tv = tdet.variables_from_jax(v, "cpu")
    fp32 = tdet.UninaYoloDla(None, T64).double()
    calib_model = tdet.UninaYoloDla(None, T64.with_quant("calib_max"))
    got = tcal.calibrate(calib_model, tv, lambda: _torch_batches(batches),
                         min_images=0)
    assert [p for p, _ in _leaves(got)] == [p for p, _ in _leaves(want)]
    for (p, a), (_, b) in zip(_leaves(want), _leaves(got)):
        assert type(b) is np.float32
        np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=str(p))
    qat_model, qv = tqat.prepare_qat_variables(
        fp32, tv, lambda: _torch_batches(batches), min_images=0)
    assert qv["params"] is tv["params"]
    assert qat_model.config.quant.mode == "quantize"
    tree = tdet.to_jax_variables({"quant": qv["quant"]})["quant"]
    for (p, a), (_, b) in zip(_leaves(got), _leaves(tree)):
        assert b == a, p
    with jax.enable_x64(True):
        shapes = jax.eval_shape(lambda: jqat.make_qat_model(JCfg(
            **SMALL)).init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
                           train=False))
    assert [p for p, _ in _leaves(tdet.variables_of(qat_model)["quant"])
            ] == [] or [p for p, _ in _leaves(tdet.to_jax_variables(
                qat_model)["quant"])] == [p for p, _ in _leaves(
                    shapes["quant"])]


def test_calibration_cache_bytes(small64, tmp_path):
    """save_calibration_cache writes the reference's bytes;
    load_calibration_cache reads them back to the same tree."""
    quant = small64[4]
    jcal.save_calibration_cache(quant, tmp_path / "want.cache")
    tcal.save_calibration_cache(quant, tmp_path / "got.cache")
    assert (tmp_path / "got.cache").read_bytes() == \
        (tmp_path / "want.cache").read_bytes()
    assert len(json.loads((tmp_path / "got.cache").read_text())) == \
        len(_leaves(quant))
    back = tcal.load_calibration_cache(tmp_path / "want.cache")
    for (p, a), (_, b) in zip(_leaves(quant), _leaves(back)):
        assert type(b) is np.float32 and b == a, p


def test_min_images_refuses_as_reference(small64):
    """Fewer calibration images than min_images: both packages raise the
    same ValueError after pass 1 (the reference's on a 4-channel model at
    32^2, a quick compile); an empty batch list raises too."""
    v, batches, _, _, _ = small64
    tiny = JCfg(num_classes=4, base_channels=4, input_size=32,
                compute_dtype=jnp.float32)
    tiny_v = jax.jit(lambda k: JModel(tiny).init(
        k, jnp.zeros((1, 32, 32, 3)), train=False))(jax.random.key(0))
    with pytest.raises(ValueError) as want:
        jcal.calibrate(JModel(tiny.with_quant("calib_max")), tiny_v,
                       lambda: iter([{"images": np.zeros((2, 32, 32, 3),
                                                         np.float32)}]),
                       min_images=5)
    tv = tdet.variables_from_jax(v, "cpu")
    m = tdet.UninaYoloDla(None, T64.with_quant("calib_max"))
    with pytest.raises(ValueError) as got:
        tcal.calibrate(m, tv, lambda: _torch_batches(batches[:1]),
                       min_images=5)
    assert str(got.value) == str(want.value)
    assert "saw only 2 images" in str(got.value)
    with pytest.raises(ValueError, match="at least one batch"):
        tcal.calibrate(m, tv, lambda: [], min_images=0)


def test_qat_step(small64):
    """One QAT step (the recipe: lr0 1e-3, warmup_steps 1, no EMA, the
    calibrated quant collection frozen in extra_variables) in float64: the
    loss within 1e-5 relative, every gradient leaf within 1e-4 of its
    largest entry, the assignment equal; after the step the params within
    1e-4 of each leaf's largest entry."""
    v, batches, _, _, quant = small64
    rng = np.random.default_rng(1)
    g = 8
    cxy = rng.uniform(10, 54, (2, g, 2))
    wh = rng.uniform(8, 24, (2, g, 2))
    batch = {"images": batches[0]["images"],
             "boxes": np.concatenate([cxy - wh / 2, cxy + wh / 2], -1),
             "labels": rng.integers(0, 4, (2, g)).astype(np.int32),
             "mask": np.arange(g)[None, :] < np.array([[6], [4]])}
    batch["boxes"] = batch["boxes"].astype(np.float32)
    extra = {"quant": quant}
    with jax.enable_x64(True):
        cfg = JCfg(**SMALL, compute_dtype=jnp.float64)
        qmodel = jqat.make_qat_model(cfg)

        def lf(params):
            out, _ = qmodel.apply({"params": params,
                                   "batch_stats": v["batch_stats"], **extra},
                                  batch["images"], train=True,
                                  mutable=["batch_stats"])
            return jl.detection_loss(out, batch["boxes"], batch["labels"],
                                     batch["mask"], qmodel.config)

        (wl, waux), wg = jax.jit(jax.value_and_grad(lf, has_aux=True))(
            v["params"])
        wg = jax.tree.map(np.asarray, wg)
        # the reference's step applies optax's chain to these gradients
        tc = jtr.TrainConfig(lr0=1e-3, warmup_steps=1, use_ema=False)
        tx = jtr.make_optimizer(tc)
        upd, _ = tx.update(wg, tx.init(v["params"]), v["params"])
        wp = jax.tree.map(np.asarray, optax.apply_updates(v["params"], upd))
        wfg, wl, wnorm = int(waux["num_fg"]), float(wl), float(
            optax.global_norm(wg))
    tv = tdet.variables_from_jax(v, "cpu")
    tq = tdet.variables_from_jax({"quant": quant}, "cpu")
    qm = tqat.make_qat_model(T64, device="cpu").double()
    tb = {k: torch.tensor(a) for k, a in batch.items()}
    params = {k: p.detach().clone().requires_grad_()
              for k, p in tv["params"].items()}
    qm.train()
    outs = torch.func.functional_call(qm, {
        **params, **{k: t.clone() for k, t in tv["batch_stats"].items()},
        **tdet.model_inputs(qm, tq)}, (tb["images"],))
    loss, taux = tl.detection_loss(outs, tb["boxes"], tb["labels"],
                                   tb["mask"], qm.config)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert int(taux["num_fg"]) == wfg > 0
    np.testing.assert_allclose(float(loss.detach()), wl, rtol=1e-5)
    gg = tdet.to_jax_variables({"p": dict(zip(params, grads))})["p"]
    for (p, a), (_, b) in zip(_leaves(wg), _leaves(gg)):
        assert np.max(np.abs(a - b)) <= 1e-4 * np.max(np.abs(a)), p
    ttc = ttr.TrainConfig(lr0=1e-3, warmup_steps=1, use_ema=False)
    tx_t = ttr.make_optimizer(ttc)
    s1, aux_t = ttr.make_train_step(qm, T64.with_quant("quantize"), tx_t,
                                    ttc, extra_variables=tq)(
        ttr.create_train_state(tv, tx_t, ttc), tb)
    np.testing.assert_allclose(float(aux_t["grad_norm"]), wnorm, rtol=1e-5)
    assert s1.ema_params is s1.params
    got_p = tdet.to_jax_variables({"p": s1.params})["p"]
    for (p, a), (_, b) in zip(_leaves(wp), _leaves(got_p)):
        assert np.max(np.abs(a - b)) <= 1e-4 * np.max(np.abs(a)), p


def test_unported_quant_modes_refused():
    """Every quant mode is built where the reference builds it: 'int8'
    (the unfused engine) is a QuantSpec mode, and a deploy model takes it
    and 'quantize' (the folded QAT model); the train form refuses both
    int8 modes and a deploy model the calibration modes."""
    assert tfq.QuantSpec("int8").mode == "int8"
    for mode in ("int8", "int8_fused"):
        with pytest.raises(ValueError, match="deploy mode"):
            tdet.create_model(TCfg().with_quant(mode), device="cpu")
    for mode in ("calib_max", "calib_hist"):
        with pytest.raises(ValueError, match="train form"):
            tdet.from_jax_variables({"params": {}}, dataclasses.replace(
                TCfg(), deploy=True).with_quant(mode), "cpu")
    for mode in ("int8", "quantize"):
        with pytest.raises(KeyError):   # built: it finds no weights
            tdet.from_jax_variables({"params": {}}, dataclasses.replace(
                TCfg(), deploy=True).with_quant(mode), "cpu")
