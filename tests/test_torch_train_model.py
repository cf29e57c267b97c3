"""The port's train-form model (BatchNorm blocks, ``init_model``,
``from_jax_variables`` / ``to_jax_variables``), its box utilities,
checkpoint directory and ``ensure_normalized`` against the JAX package,
on the CPU.

Small model: base 16, 64^2, float32 compute unless a test says otherwise.
The reference is ``jax.jit`` of the JAX model on the same numpy inputs
with the JAX init variables carried across.

Train-mode float32 outputs are held loosely on purpose: their batch
statistics are sums whose order differs between XLA and PyTorch (and
between the reference's own jitted and eager forms, which differ by up to
6.8e-5 (1 + |ref|) on these outputs), and BatchNorm over the few samples
of the deep levels amplifies the last-bit differences. In float64 the
same computation agrees to ~1e-14, which is where the issue's 1e-5 bound
is held.
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unina_yolo_dla_torch.models import detector as tdet
from unina_yolo_dla_torch.models.config import ModelConfig as TCfg
from unina_yolo_dla_torch.ops.preprocess import ensure_normalized
from unina_yolo_dla_torch.ops.cuda.preprocess_kernel import normalize_plain
from unina_yolo_dla_torch.quant import deploy as tdeploy
from unina_yolo_dla_torch.utils import boxes as tboxes
from unina_yolo_dla_torch.utils import checkpoint as tckpt
from unina_yolo_dla_tpu.models import ModelConfig as JCfg
from unina_yolo_dla_tpu.models import init_model, param_count
from unina_yolo_dla_tpu.models.detector import UninaYoloDla as JModel
from unina_yolo_dla_tpu.ops.preprocess import ensure_normalized as j_norm
from unina_yolo_dla_tpu.utils import boxes as jboxes
from unina_yolo_dla_tpu.utils import checkpoint as jckpt

SOURCE = Path(__file__).resolve().parents[1] / "artifacts" / \
    "engine_source.msgpack"
SMALL = dict(num_classes=4, base_channels=16, input_size=64)
T32 = TCfg(**SMALL, compute_dtype=torch.float32)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _rel_err(ref, got):
    """max |got - ref| / (1 + |ref|) over every output map."""
    return max(float(np.max(np.abs(np.asarray(g, np.float64)
                                   - np.asarray(r, np.float64))
                            / (1 + np.abs(np.asarray(r, np.float64)))))
               for r, g in zip(ref, got))


def _flat_outputs(outs):
    return [np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor)
                       else t) for level in outs for t in level]


@pytest.fixture(scope="module")
def small():
    """JAX model and init variables (numpy) at base 16, 64^2, float32,
    with batch statistics moved off their init so eval mode is not the
    identity; the input batch."""
    cfg = JCfg(**SMALL, compute_dtype=jnp.float32)
    model = JModel(cfg)
    variables = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, 64, 64, 3)), train=False))(jax.random.key(0))
    variables = jax.tree.map(np.asarray, variables)
    rng = np.random.default_rng(0)
    variables["batch_stats"] = jax.tree.map(
        lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32),
        variables["batch_stats"])
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    return model, variables, x


def test_train_tree_names_and_shapes_equal_init_model():
    """init_model's variables, written as the reference's tree, have the
    JAX init tree's paths and shapes (params and batch_stats)."""
    cfg = JCfg(**SMALL, compute_dtype=jnp.float32)
    want = jax.eval_shape(lambda: init_model(jax.random.key(0), cfg)[1])
    _, got = tdet.init_model(TCfg(**SMALL), device="cpu",
                             generator=torch.Generator().manual_seed(0))
    got = tdet.to_jax_variables(got)
    assert sorted(got) == sorted(want) == ["batch_stats", "params"]
    for coll in want:
        w, g = _leaves(want[coll]), _leaves(got[coll])
        assert [p for p, _ in g] == [p for p, _ in w]
        assert [a.shape for _, a in g] == [tuple(a.shape) for _, a in w]
    # the initialisers' statistics: BatchNorm at its identity, every
    # kernel lecun-normal (truncated at 2 sigma)
    stem = got["params"]["backbone"]["stem"]
    assert np.all(stem["bn"]["scale"] == 1) and np.all(stem["bn"]["bias"] == 0)
    k = got["params"]["neck"]["down1"]["conv"]["kernel"]
    std = np.sqrt(1 / np.prod(k.shape[:3])) / 0.87962566103423978
    assert np.abs(k).max() <= 2 * std + 1e-7
    assert 0.8 < k.std() / np.sqrt(1 / np.prod(k.shape[:3])) < 1.2


@pytest.mark.parametrize("bc,lite", [(32, False), (32, True), (16, False)])
def test_param_count_equals_reference(bc, lite):
    """param_count at full width equals the JAX model's, counted through
    jax.eval_shape (no full-size run)."""
    jcfg = JCfg(num_classes=4, base_channels=bc, lite_p2=lite,
                input_size=640)
    shapes = jax.eval_shape(
        lambda: JModel(jcfg).init(jax.random.key(0), jnp.zeros(
            (1, 640, 640, 3), jnp.float32), train=False))
    _, got = tdet.init_model(TCfg(num_classes=4, base_channels=bc,
                                  lite_p2=lite), device="cpu")
    assert tdet.param_count(got) == param_count(shapes)


def test_from_to_jax_variables_bit_exact(small):
    """from_jax_variables -> to_jax_variables gives the same tree and
    bits; the committed checkpoint through the QAT model keeps every
    quantiser amax that model reads: the quant tree of the JAX QAT
    model's init."""
    _, variables, _ = small
    model = tdet.from_jax_variables(variables, TCfg(**SMALL), "cpu")
    back = tdet.to_jax_variables(model)
    for coll in ("params", "batch_stats"):
        w, g = _leaves(variables[coll]), _leaves(back[coll])
        assert [p for p, _ in g] == [p for p, _ in w]
        for (p, a), (_, b) in zip(w, g):
            assert b.dtype == np.float32
            np.testing.assert_array_equal(a, b, err_msg=str(p))
    src = tckpt.load_msgpack_raw(SOURCE)
    qat = tdet.from_jax_variables(src, TCfg().with_quant("quantize"), "cpu")
    back = tdet.to_jax_variables(qat)
    quant = dict(_leaves(src["quant"]))
    jcfg = JCfg().with_quant("quantize")
    shapes = jax.eval_shape(lambda: JModel(jcfg).init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False))
    assert [p for p, _ in _leaves(back["quant"])] == \
        [p for p, _ in _leaves(shapes["quant"])]
    for p, a in _leaves(back["quant"]):
        np.testing.assert_array_equal(a, quant[p], err_msg=str(p))
    for coll in ("params", "batch_stats"):
        for (p, a), (_, b) in zip(_leaves(src[coll]), _leaves(back[coll])):
            np.testing.assert_array_equal(a, b, err_msg=str(p))


def test_train_forward_and_batch_stats_f32(small):
    """Train mode, float32: outputs and updated statistics against the
    jitted reference within 1e-3 (1 + |ref|) (measured: 1.9e-4 outputs,
    1.6e-6 statistics; see the module docstring)."""
    model, variables, x = small
    ref, mut = jax.jit(lambda v, x: model.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, x)
    port = tdet.from_jax_variables(variables, T32, "cpu").train()
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert _rel_err(_flat_outputs(ref), _flat_outputs(out)) < 1e-3
    stats = tdet.to_jax_variables(port)["batch_stats"]
    assert _rel_err(jax.tree.leaves(mut["batch_stats"]),
                    jax.tree.leaves(stats)) < 1e-5


def test_train_forward_and_batch_stats_f64(small):
    """Train mode in float64 (the statistics' reductions then agree to
    rounding): outputs and updated statistics within 1e-5 (1 + |ref|)."""
    _, variables, x = small
    v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
    with jax.enable_x64(True):
        model = JModel(JCfg(**SMALL, compute_dtype=jnp.float64))
        ref, mut = jax.jit(lambda v, x: model.apply(
            v, x, train=True, mutable=["batch_stats"]))(v64, x)
        ref = _flat_outputs(ref)
        mut = jax.tree.map(np.asarray, mut)
    port = tdet.from_jax_variables(
        variables, TCfg(**SMALL, compute_dtype=torch.float64), "cpu")
    port = port.double().train()
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert _rel_err(ref, _flat_outputs(out)) < 1e-5
    stats = tdet.to_jax_variables(port)["batch_stats"]
    assert _rel_err(jax.tree.leaves(mut["batch_stats"]),
                    jax.tree.leaves(stats)) < 1e-5


def test_eval_forward_f32_and_bf16(small):
    """Eval mode (running statistics): float32 within 1e-4 (1 + |ref|);
    bf16 compute within 5e-2 (1 + |ref|), where oneDNN and XLA round the
    bf16 convolutions differently."""
    model, variables, x = small
    ref = jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, x)
    port = tdet.from_jax_variables(variables, T32, "cpu")
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert _rel_err(_flat_outputs(ref), _flat_outputs(out)) < 1e-4
    jm = JModel(JCfg(**SMALL))
    ref16 = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x)
    port16 = tdet.from_jax_variables(variables, TCfg(**SMALL), "cpu")
    with torch.no_grad():
        out16 = port16(torch.from_numpy(x))
    assert out16[0][0].dtype == torch.float32
    assert _rel_err(_flat_outputs(ref16), _flat_outputs(out16)) < 5e-2


@pytest.fixture(scope="module")
def committed():
    """The committed checkpoint (full base-32 train form: params,
    batch_stats) in float32 and one 256^2 input."""
    src = tckpt.load_msgpack_raw(SOURCE)
    variables = {k: src[k] for k in ("params", "batch_stats")}
    x = np.random.default_rng(3).normal(size=(1, 256, 256, 3)).astype(
        np.float32)
    return variables, x


def test_committed_checkpoint_eval_forward(committed):
    """engine_source.msgpack through the train form in eval mode at 256^2
    against jax.jit of the JAX model: within 1e-4 (1 + |ref|)."""
    variables, x = committed
    jm = JModel(JCfg(input_size=256, compute_dtype=jnp.float32))
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x)
    port = tdet.from_jax_variables(
        variables, TCfg(input_size=256, compute_dtype=torch.float32), "cpu")
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert [tuple(t.shape) for t in _flat_outputs(out)] == \
        [t.shape for t in _flat_outputs(ref)]
    assert _rel_err(_flat_outputs(ref), _flat_outputs(out)) < 1e-4


def test_folded_equivalence_report(committed):
    """The train form in eval mode against the deploy model built from its
    folded weights: a small gap, as the reference's report shows for the
    same models (1e-3 bound; the reference's own value is not recomputed
    here: its report runs both models op by op)."""
    variables, x = committed
    cfg = TCfg(input_size=256, compute_dtype=torch.float32)
    train = tdet.from_jax_variables(variables, cfg, "cpu")
    folded = tdeploy.fold_batchnorm(variables)
    dep = tdet.from_jax_variables(folded, dataclasses.replace(
        cfg, deploy=True), "cpu")
    got = tdeploy.folded_equivalence_report(train, dep, torch.from_numpy(x))
    assert 0 < got < 1e-3
    assert train.training is False


def test_box_conversions_and_ciou():
    """xywh <-> xyxy and CIoU (value and gradient, alpha held constant)
    against the JAX functions."""
    rng = np.random.default_rng(5)
    a = np.concatenate([rng.uniform(0, 50, (64, 2)),
                        rng.uniform(1, 30, (64, 2))], -1).astype(np.float32)
    b = np.concatenate([rng.uniform(0, 50, (64, 2)),
                        rng.uniform(1, 30, (64, 2))], -1).astype(np.float32)
    for f_t, f_j in ((tboxes.xywh_to_xyxy, jboxes.xywh_to_xyxy),
                     (tboxes.xyxy_to_xywh, jboxes.xyxy_to_xywh)):
        np.testing.assert_allclose(f_t(torch.from_numpy(a)).numpy(),
                                   np.asarray(f_j(a)), rtol=1e-6, atol=1e-6)
    xa = np.asarray(jboxes.xywh_to_xyxy(a))
    xb = np.asarray(jboxes.xywh_to_xyxy(b))
    val, grad = jax.value_and_grad(
        lambda p: jboxes.box_ciou(p, xb).sum())(xa)
    p = torch.tensor(xa, requires_grad=True)
    got = tboxes.box_ciou(p, torch.from_numpy(xb))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(
        jboxes.box_ciou(xa, xb)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(got.detach().sum()), float(val),
                               rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(grad),
                               rtol=1e-4, atol=1e-6)


def test_ensure_normalized():
    """uint8 -> the plain normalize formula (the kernel's plain version,
    bit for bit), within 2 f32 steps of the reference (which multiplies
    by reciprocals); a float batch passes through."""
    img = np.random.default_rng(1).integers(0, 256, (2, 8, 8, 3),
                                            dtype=np.uint8)
    got = ensure_normalized(torch.from_numpy(img))
    assert got.dtype == torch.float32
    want = normalize_plain(torch.from_numpy(img), (0.485, 0.456, 0.406),
                           (0.229, 0.224, 0.225))
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_norm(img)),
                               rtol=0, atol=2.5e-7)
    f = torch.randn(2, 8, 8, 3)
    assert ensure_normalized(f) is f


def _ckpt_trees(rng):
    return [{"params": {"a": rng.normal(size=(3, 2)).astype(np.float32),
                        "b": {"c": np.float32(rng.normal())}},
             "step": np.int32(i)} for i in range(5)]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_manager_cross_package(tmp_path, writer):
    """A CheckpointManager directory written by either package loads in
    the other: the same files, state.json, last and best (keep=2, the best
    step kept beyond it), the trees restored bit for bit."""
    rng = np.random.default_rng(2)
    trees = _ckpt_trees(rng)
    fitness = [0.1, 0.5, 0.2, None, 0.3]
    mgr_w = (jckpt if writer == "jax" else tckpt).CheckpointManager(
        tmp_path / writer, keep=2)
    for i, (t, f) in enumerate(zip(trees, fitness)):
        mgr_w.save(i * 10, t, f)
    # the other package writes the same directory layout and bits
    other = (tckpt if writer == "jax" else jckpt).CheckpointManager(
        tmp_path / "other", keep=2)
    for i, (t, f) in enumerate(zip(trees, fitness)):
        other.save(i * 10, t, f)
    names = sorted(p.name for p in (tmp_path / writer).iterdir())
    assert names == sorted(p.name for p in (tmp_path / "other").iterdir())
    assert names == ["state.json", "step_10.msgpack", "step_20.msgpack",
                     "step_30.msgpack", "step_40.msgpack"]
    for n in names:
        assert (tmp_path / writer / n).read_bytes() == \
            (tmp_path / "other" / n).read_bytes()
    meta = json.loads((tmp_path / writer / "state.json").read_text())
    assert (meta["best_step"], meta["last_step"]) == (10, 40)
    reader = (tckpt if writer == "jax" else jckpt).CheckpointManager(
        tmp_path / writer, keep=2)
    template = jax.tree.map(np.zeros_like, trees[0])
    for got, want in ((reader.load_last(template), trees[4]),
                      (reader.load_best(template), trees[1])):
        for (p, a), (_, b) in zip(_leaves(want), _leaves(got)):
            np.testing.assert_array_equal(np.asarray(b), a, err_msg=str(p))


def test_load_msgpack_template(tmp_path):
    """load_msgpack restores into the template's structure (extra keys
    dropped) and refuses a template key the file lacks, as flax does."""
    tree = {"params": {"w": np.arange(4, dtype=np.float32)},
            "extra": np.float32(1)}
    path = tmp_path / "t.msgpack"
    tckpt.save_msgpack(tree, path)
    got = tckpt.load_msgpack(path, {"params": {"w": None}})
    assert list(got) == ["params"]
    np.testing.assert_array_equal(got["params"]["w"], tree["params"]["w"])
    for load in (tckpt.load_msgpack, jckpt.load_msgpack):
        with pytest.raises(ValueError, match="do not match"):
            load(path, {"params": {"w": np.zeros(4, np.float32),
                                   "v": np.zeros(1, np.float32)}})
