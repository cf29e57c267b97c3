"""The port's training step (TAL assigner, detection loss, optimiser,
EMA, train and eval steps) against the JAX package on the CPU.

Two models, each with a batch of 2 synthetic scenes, labels padded to 16
boxes: the small one (base 16, 64^2, the JAX init variables carried
across) and the committed checkpoint (base 32) at 128^2.

Gradients are held where the reference itself is reproducible: float32
with running statistics (eval-mode BatchNorm), and train mode in float64
(the head's logits and the loss stay float32, as the reference keeps
them). In float32 train mode the BatchNorm backward subtracts nearly equal
batch means: on the small model at init the reference's own jitted and
eager gradients differ by up to 3.5% of a leaf's largest entry. There the
step is held by its assignment, loss and gradient norm, on the committed
weights.

The reference's jitted program normalises a uint8 batch by multiplying
with reciprocals where the port divides (one float32 step apart); the
multi-step comparison feeds both the reference's normalised batch, since
a train step at init amplifies any input difference.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unina_yolo_dla_torch.data.synthetic import SynthConfig, generate_image
from unina_yolo_dla_torch.models import detector as tdet
from unina_yolo_dla_torch.models.config import ModelConfig as TCfg
from unina_yolo_dla_torch.utils.checkpoint import load_msgpack_raw
from unina_yolo_dla_torch.train import assigner as tas
from unina_yolo_dla_torch.train import losses as tl
from unina_yolo_dla_torch.train import trainer as ttr
from unina_yolo_dla_tpu.models import ModelConfig as JCfg
from unina_yolo_dla_tpu.models.detector import UninaYoloDla as JModel
from unina_yolo_dla_tpu.ops.preprocess import ensure_normalized as j_norm
from unina_yolo_dla_tpu.train import assigner as jas
from unina_yolo_dla_tpu.train import losses as jl
from unina_yolo_dla_tpu.train import trainer as jtr

SMALL = dict(num_classes=4, base_channels=16, input_size=64)
T32 = TCfg(**SMALL, compute_dtype=torch.float32)
J32 = JCfg(**SMALL, compute_dtype=jnp.float32)
G = 16
SOURCE = Path(__file__).resolve().parents[1] / "artifacts" / \
    "engine_source.msgpack"


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def make_batch(seeds, size, max_boxes):
    """Synthetic RGB scenes, labels as xyxy pixels padded to max_boxes."""
    images, boxes = [], np.zeros((len(seeds), max_boxes, 4), np.float32)
    labels = np.zeros((len(seeds), max_boxes), np.int32)
    mask = np.zeros((len(seeds), max_boxes), bool)
    for i, seed in enumerate(seeds):
        img, lab = generate_image(np.random.default_rng(seed), SynthConfig(
            image_size=size, seed=seed, min_height=6, max_height=24,
            min_cones=2, max_cones=5))
        images.append(np.ascontiguousarray(img[..., ::-1]))
        for j, (c, cx, cy, w, h) in enumerate(lab[:max_boxes]):
            boxes[i, j] = np.array([cx - w / 2, cy - h / 2, cx + w / 2,
                                    cy + h / 2], np.float32) * size
            labels[i, j], mask[i, j] = c, True
    return {"images": np.stack(images), "boxes": boxes, "labels": labels,
            "mask": mask}


def to_torch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def jax_init(cfg):
    """The JAX model's init variables (``init_model``'s, jitted)."""
    model = JModel(cfg)
    variables = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, cfg.input_size, cfg.input_size, 3)), train=False))(
        jax.random.key(0))
    return model, jax.tree.map(np.asarray, variables)


@pytest.fixture(scope="module")
def setup():
    return *jax_init(J32), make_batch([11, 12], 64, G)


@pytest.fixture(scope="module")
def committed():
    """The committed checkpoint's params and batch statistics, a batch of
    2 scenes at 128^2."""
    src = load_msgpack_raw(SOURCE)
    return ({k: src[k] for k in ("params", "batch_stats")},
            make_batch([11, 12], 128, G))


def _grad_err(want, got):
    """max over leaves of max|got - want| / max|want|."""
    return max(float(np.max(np.abs(np.asarray(a, np.float64) - b))
                     / max(float(np.max(np.abs(a))), 1e-30))
               for (_, a), (_, b) in zip(_leaves(want), _leaves(got)))


def test_anchors_and_decode():
    a_t, s_t = tas.make_anchors((8, 4, 2), (4, 8, 16))
    a_j, s_j = jas.make_anchors((8, 4, 2), (4, 8, 16))
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    reg = np.random.default_rng(0).uniform(0, 3, (2, 84, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tas.decode_ltrb(torch.from_numpy(reg), a_t, s_t).numpy(),
        np.asarray(jas.decode_ltrb(reg, a_j, s_j)))


def _assign_inputs(seed, tied=False):
    """Random predictions and GTs over the 84 anchors of a 32^2 input;
    ``tied``: quantised scores and a few predicted boxes repeated, so many
    alignment values are equal (top-k and argmax ties)."""
    rng = np.random.default_rng(seed)
    anchors, strides = jas.make_anchors((8, 4, 2), (4, 8, 16))
    a = anchors.shape[0]
    scores = rng.uniform(0, 1, (2, a, 4)).astype(np.float32)
    ltrb = rng.uniform(0.3, 2.5, (2, a, 4)).astype(np.float32)
    if tied:
        scores = np.round(scores * 4) / 4
        ltrb = np.round(ltrb * 2) / 2
    pred = np.array(jas.decode_ltrb(ltrb, anchors, strides))
    if tied:
        pred[:, 1::2] = pred[:, ::2]
    cxy = rng.uniform(4, 28, (2, 6, 2))
    wh = rng.uniform(6, 20, (2, 6, 2))
    gt = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    if tied:
        gt[:, 1] = gt[:, 0]
    labels = rng.integers(0, 4, (2, 6)).astype(np.int32)
    mask = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 0, 1, 1, 1]], bool)
    return scores, pred, np.asarray(anchors), gt, labels, mask


@pytest.mark.parametrize("seed,tied", [(0, False), (1, False), (2, False),
                                       (3, True)])
def test_assigner_parity(seed, tied):
    """fg_mask and target_gt_idx equal, target scores and boxes within
    1e-6 of the jitted reference; seed 3 has tied alignment values and a
    duplicated GT (ties go to the lower anchor and the first GT)."""
    args = _assign_inputs(seed, tied)
    want = jax.jit(lambda *a: jas.assign(*a, num_classes=4))(*args)
    got = tas.assign(*(torch.tensor(a) for a in args), num_classes=4)
    assert int(want.fg_mask.sum()) > 5
    np.testing.assert_array_equal(got.fg_mask.numpy(),
                                  np.asarray(want.fg_mask))
    np.testing.assert_array_equal(got.target_gt_idx.numpy(),
                                  np.asarray(want.target_gt_idx))
    assert got.target_gt_idx.dtype == torch.int32
    np.testing.assert_allclose(got.target_scores.numpy(),
                               np.asarray(want.target_scores), atol=1e-6)
    np.testing.assert_allclose(got.target_boxes.numpy(),
                               np.asarray(want.target_boxes), atol=1e-6)
    if tied:
        align = np.asarray(want.target_scores).max(-1)
        assert len(np.unique(align[align > 0])) < (align > 0).sum()


def test_loss_and_aux_parity():
    """detection_loss on the same head outputs: the loss and every aux
    entry within 1e-5 relative, its gradient w.r.t. the outputs within
    1e-4 of the largest entry."""
    rng = np.random.default_rng(4)
    outs = [(rng.normal(-2, 1.5, (2, g, g, 4)).astype(np.float32),
             rng.uniform(0.2, 3, (2, g, g, 4)).astype(np.float32))
            for g in (16, 8, 4)]
    batch = make_batch([21, 22], 64, G)
    args = (batch["boxes"], batch["labels"], batch["mask"])

    def jloss(o):
        return jl.detection_loss(o, *args, J32)

    (want, waux), wgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        outs)
    touts = [tuple(torch.tensor(t, requires_grad=True) for t in lvl)
             for lvl in outs]
    got, aux = tl.detection_loss(touts, *(torch.from_numpy(a) for a in args),
                                 T32)
    got.backward()
    assert int(aux["num_fg"]) == int(waux["num_fg"]) > 0
    for k in ("loss", "cls_loss", "box_loss"):
        np.testing.assert_allclose(float(aux[k]), float(waux[k]), rtol=1e-5)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    ggrad = [[t.grad.numpy() for t in lvl] for lvl in touts]
    assert _grad_err(wgrad, ggrad) < 1e-4


def _loss_grads_port(cfg, variables, batch, train, dtype=None):
    port = tdet.from_jax_variables(variables, cfg, "cpu")
    if dtype is not None:
        port = port.to(dtype)
    port.train(train)
    v = tdet.variables_of(port)
    params = {k: p.detach().requires_grad_() for k, p in v["params"].items()}
    tb = to_torch(batch)
    outs = torch.func.functional_call(
        port, {**params, **v["batch_stats"]},
        (ttr.ensure_normalized(tb["images"]),))
    loss, aux = tl.detection_loss(outs, tb["boxes"], tb["labels"],
                                  tb["mask"], cfg)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), aux, tdet.to_jax_variables(
        {"params": dict(zip(params, grads))})["params"]


def _loss_grads_jax(model, variables, batch, train):
    def lf(params):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        if train:
            out, _ = model.apply(v, j_norm(batch["images"]), train=True,
                                 mutable=["batch_stats"])
        else:
            out = model.apply(v, j_norm(batch["images"]), train=False)
        return jl.detection_loss(out, batch["boxes"], batch["labels"],
                                 batch["mask"], model.config)

    (loss, aux), grads = jax.jit(jax.value_and_grad(lf, has_aux=True))(
        variables["params"])
    return float(loss), aux, jax.tree.map(np.asarray, grads)


def test_gradients_eval_mode_f32(committed):
    """Running statistics, float32, the committed weights at 128^2: the
    loss within 1e-5 relative, every gradient leaf within 1e-4 of its
    largest entry (measured 9e-6); the port's eval step (the EMA params of
    a new state, running statistics) gives the same loss."""
    v, batch = committed
    model = JModel(JCfg(input_size=128, compute_dtype=jnp.float32))
    wl, waux, wg = _loss_grads_jax(model, v, batch, train=False)
    gl, gaux, gg = _loss_grads_port(
        TCfg(input_size=128, compute_dtype=torch.float32), v, batch,
        train=False)
    assert int(gaux["num_fg"]) == int(waux["num_fg"]) > 0
    np.testing.assert_allclose(gl, wl, rtol=1e-5)
    assert _grad_err(wg, gg) < 1e-4
    tcfg = TCfg(input_size=128, compute_dtype=torch.float32)
    port = tdet.from_jax_variables(v, tcfg, "cpu")
    tc = ttr.TrainConfig(warmup_steps=1, total_steps=10)
    state = ttr.create_train_state(tdet.variables_of(port), ttr.make_optimizer(
        tc), tc)
    _, eaux = ttr.make_eval_step(port, tcfg)(state, to_torch(batch))
    assert int(eaux["num_fg"]) == int(waux["num_fg"])
    np.testing.assert_allclose(float(eaux["loss"]), wl, rtol=1e-5)


def test_gradients_train_mode_f64(setup):
    """Train mode (batch statistics) in float64 (the head's float32 logits
    and the loss as the reference computes them): the loss within 1e-5
    relative, every gradient leaf within 1e-4 of its largest entry."""
    _, variables, batch = setup
    v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
    with jax.enable_x64(True):
        jm = JModel(JCfg(**SMALL, compute_dtype=jnp.float64))
        wl, waux, wg = _loss_grads_jax(jm, v64, batch, train=True)
        wfg = int(waux["num_fg"])
    gl, gaux, gg = _loss_grads_port(
        TCfg(**SMALL, compute_dtype=torch.float64), variables, batch,
        train=True, dtype=torch.float64)
    assert int(gaux["num_fg"]) == wfg > 0
    np.testing.assert_allclose(gl, wl, rtol=1e-5)
    assert _grad_err(wg, gg) < 1e-4


def test_schedule_matches_optax():
    """warmup_cosine_decay_schedule at every count of a short run, and the
    reference's refusal when the warmup reaches the total."""
    kw = dict(init_value=1e-4, peak_value=1e-2, warmup_steps=3,
              decay_steps=10, end_value=1e-4)
    want = optax.warmup_cosine_decay_schedule(**kw)
    got = ttr.warmup_cosine_decay_schedule(*kw.values())
    for c in range(13):
        np.testing.assert_allclose(got(c), float(want(c)), rtol=2e-7)
    with pytest.raises(ValueError, match="positive decay_steps"):
        optax.warmup_cosine_decay_schedule(1e-4, 1e-2, 300, 10, 1e-4)
    with pytest.raises(ValueError, match="positive decay_steps"):
        ttr.make_optimizer(ttr.TrainConfig(total_steps=10))


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
@pytest.mark.parametrize("scale", [1.0, 40.0])
def test_optimizer_matches_optax(opt, scale):
    """Three updates of the optimiser chain on the same params and
    gradients: params within 1e-6 relative of optax's. ``scale`` 40 puts
    the gradients' global norm above the clip's 10 (1.0 below it)."""
    tc = jtr.TrainConfig(optimizer=opt, warmup_steps=2, total_steps=6)
    rng = np.random.default_rng(7)
    params = {"a": rng.normal(size=(3, 3, 4, 8)).astype(np.float32),
              "b": rng.normal(size=(8,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=p.shape) * scale / 8).astype(np.float32)
              for k, p in params.items()} for _ in range(3)]
    norms = [float(optax.global_norm(g)) for g in grads]
    assert all((n > 10) == (scale > 1) for n in norms)
    tx_j = jtr.make_optimizer(tc)
    tx_t = ttr.make_optimizer(ttr.TrainConfig(optimizer=opt, warmup_steps=2,
                                              total_steps=6))
    pj, sj = params, tx_j.init(params)
    pt = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    st = tx_t.init(pt)
    for g in grads:
        u, sj = tx_j.update(g, sj, pj)
        pj = optax.apply_updates(pj, u)
        ut, st = tx_t.update({k: torch.from_numpy(v) for k, v in g.items()},
                             st, pt)
        pt = {k: pt[k] + ut[k] for k in pt}
    for k in params:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                   rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("step", [0, 5, 4000])
def test_ema_update_matches_reference(step):
    """The EMA of the reference's train step (trainer.py:122-133, written
    out here in jnp): within 1e-6 relative."""
    rng = np.random.default_rng(step)
    ema = rng.normal(size=(16,)).astype(np.float32)
    p = rng.normal(size=(16,)).astype(np.float32)
    step_f = jnp.asarray(step, jnp.int32).astype(jnp.float32) + 1.0
    d = 0.9999 * (1.0 - jnp.exp(-step_f / 2000.0))
    want = np.asarray(jnp.asarray(ema) * d + jnp.asarray(p) * (1.0 - d))
    got = ttr.ema_update({"a": torch.from_numpy(ema)},
                         {"a": torch.from_numpy(p)}, step, 0.9999)["a"]
    # operands of magnitude ~1: an absolute 1e-6 where the two terms cancel
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def three_steps_f64(setup):
    """Three train steps (SGD, Nesterov, EMA, the schedule's warmup) of
    both packages in float64 from the same state and batch."""
    _, variables, batch = setup
    batch = dict(batch, images=np.asarray(jax.jit(j_norm)(batch["images"])))
    tc = dict(lr0=0.02, warmup_steps=2, total_steps=30, ema_decay=0.999)
    v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
    with jax.enable_x64(True):
        cfg = JCfg(**SMALL, compute_dtype=jnp.float64)
        jtc = jtr.TrainConfig(**tc)
        tx = jtr.make_optimizer(jtc)
        state = jtr.create_train_state(v64, tx, jtc)
        step = jax.jit(jtr.make_train_step(JModel(cfg), cfg, tx, jtc))
        want = []
        for _ in range(3):
            state, aux = step(state, batch)
            want.append({k: float(v) for k, v in aux.items()})
        want_state = jax.tree.map(np.asarray, (state.params, state.ema_params,
                                               state.batch_stats))
    cfg_t = TCfg(**SMALL, compute_dtype=torch.float64)
    port = tdet.from_jax_variables(variables, cfg_t, "cpu").double()
    ttc = ttr.TrainConfig(**tc)
    tx_t = ttr.make_optimizer(ttc)
    tstate = ttr.create_train_state(tdet.variables_of(port), tx_t, ttc)
    tstep = ttr.make_train_step(port, cfg_t, tx_t, ttc)
    got, tb = [], to_torch(batch)
    for _ in range(3):
        tstate, aux = tstep(tstate, tb)
        got.append({k: float(v) for k, v in aux.items()})
    return want, want_state, got, tstate


def test_train_steps_f64_match(three_steps_f64):
    """Per step: num_fg equal, the losses within 1e-5 and grad_norm within
    1e-4 relative (measured 2.4e-6 and 1.3e-5 at the third step); after
    three steps every leaf of the params and EMA params within 1e-4
    of its largest entry (the float32 loss's rounding, grown over three
    steps of a model at init: measured 2.8e-5, on BatchNorm biases that
    started at 0) and the batch statistics within 1e-5 (1 + |ref|)."""
    want, (wp, we, ws), got, tstate = three_steps_f64
    assert tstate.step == 3
    for w, g in zip(want, got):
        assert g["num_fg"] == w["num_fg"] > 0
        for k in ("loss", "cls_loss", "box_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4)
    for tree, coll in ((tstate.params, wp), (tstate.ema_params, we)):
        got_tree = tdet.to_jax_variables({"p": tree})["p"]
        assert _grad_err(coll, got_tree) < 1e-4
    stats = tdet.to_jax_variables({"s": tstate.batch_stats})["s"]
    for (p, a), (_, b) in zip(_leaves(ws), _leaves(stats)):
        assert np.max(np.abs(a - b) / (1 + np.abs(a))) < 1e-5, p


def test_train_step_f32(committed):
    """One float32 step of the committed weights at 128^2 from a uint8
    batch: the same assignment, the loss within 1e-5 and the gradient norm
    within 1e-2 relative of the reference (measured 4.5e-7 and 2.0e-4);
    the batch statistics move; the input state is not changed."""
    variables, batch = committed
    jcfg = JCfg(input_size=128, compute_dtype=jnp.float32)
    model = JModel(jcfg)
    jtc = jtr.TrainConfig(warmup_steps=1, total_steps=10)
    tx = jtr.make_optimizer(jtc)
    jstate = jtr.create_train_state(variables, tx, jtc)
    jstate, jaux = jax.jit(jtr.make_train_step(model, jcfg, tx, jtc))(
        jstate, batch)
    tcfg = TCfg(input_size=128, compute_dtype=torch.float32)
    port = tdet.from_jax_variables(variables, tcfg, "cpu")
    ttc = ttr.TrainConfig(warmup_steps=1, total_steps=10)
    tx_t = ttr.make_optimizer(ttc)
    s0 = ttr.create_train_state(tdet.variables_of(port), tx_t, ttc)
    before = {k: v.clone() for k, v in s0.params.items()}
    s1, aux = ttr.make_train_step(port, tcfg, tx_t, ttc)(s0,
                                                         to_torch(batch))
    assert all(torch.equal(before[k], s0.params[k]) for k in before)
    assert int(aux["num_fg"]) == int(jaux["num_fg"]) > 0
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux["grad_norm"]),
                               float(jaux["grad_norm"]), rtol=1e-2)
    moved = tdet.to_jax_variables({"s": s1.batch_stats})["s"]
    assert not np.array_equal(moved["backbone"]["stem"]["bn"]["mean"],
                              variables["batch_stats"]["backbone"]["stem"][
                                  "bn"]["mean"])


def test_bf16_train_step_loss(committed):
    """One train step in bf16 compute (the default), the committed weights
    at 128^2: the same assignment and the loss within 1e-2 relative of the
    reference's (measured 2.9e-3). XLA's CPU backend runs the bf16
    convolutions in float32 and drops the bf16 round trip before the
    BatchNorm statistics, which the port keeps, as the program says; at
    init on 64^2 inputs that moves the assignment itself."""
    variables, batch = committed
    cfg = JCfg(input_size=128)
    jtc = jtr.TrainConfig(warmup_steps=1, total_steps=10)
    tx = jtr.make_optimizer(jtc)
    _, jaux = jax.jit(jtr.make_train_step(JModel(cfg), cfg, tx, jtc))(
        jtr.create_train_state(variables, tx, jtc), batch)
    cfg_t = TCfg(input_size=128)
    port = tdet.from_jax_variables(variables, cfg_t, "cpu")
    ttc = ttr.TrainConfig(warmup_steps=1, total_steps=10)
    tx_t = ttr.make_optimizer(ttc)
    _, aux = ttr.make_train_step(port, cfg_t, tx_t, ttc)(
        ttr.create_train_state(tdet.variables_of(port), tx_t, ttc),
        to_torch(batch))
    assert np.isfinite(float(aux["loss"]))
    assert int(aux["num_fg"]) == int(jaux["num_fg"]) > 0
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]),
                               rtol=1e-2)
