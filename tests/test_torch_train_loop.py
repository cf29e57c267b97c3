"""The port's fit loop and two-phase train CLI against the JAX package, on
the CPU.

- ``fit`` against the reference's ``fit``: the small model (base 16, 64^2,
  the JAX init variables carried across) in float64 compute (the loss
  float32 in both, as the reference keeps it), 8 training scenes in
  batches of 4, 2 epochs, augmentation on (flip, HSV, mosaic 0.5), the EMA
  on. Both loops are fed the reference's host-normalised batches (its
  ``normalize_images`` swapped into each loop's batch iterator, in the test
  only): a train step at init amplifies the one float32 step between the
  two packages' own normalisations. Per epoch the mean loss within 1e-5
  relative; at the end the batch statistics within 1e-5 (1 + |ref|) and
  the params and EMA params, leaf by leaf, within 1e-2 of the leaf's
  largest entry, the median leaf within 1e-5 (measured: 4.7e-3 on a head
  BatchNorm bias that started at 0, where the float32 loss's rounding is
  most of the value after 4 steps; median 9.3e-7).
- Resume: 2 epochs against 1 epoch and a resumed 1, in float32 with
  validation: step, params, optimiser state, EMA and statistics bit for
  bit, the resumed epochs' history equal, the best variables equal.
- The CLI (``python -m unina_yolo_dla_torch.train.train --device cpu``
  with the reference's dry-run flags): every phase, the reference CLI's
  file set (its serialized program files aside: the port serves from
  weights), checkpoints the reference's ``load_msgpack`` reads into its own
  templates (FP32 and QAT), and the exported QAT train-form artifact served
  by ``PerceptionServer(device="cpu")``; ``--skip-qat``.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unina_yolo_dla_torch.data import dataset as tds
from unina_yolo_dla_torch.data import synthetic as tsyn
from unina_yolo_dla_torch.models import detector as tdet
from unina_yolo_dla_torch.models.config import ModelConfig as TCfg
from unina_yolo_dla_torch.train import loop as tloop
from unina_yolo_dla_torch.train import trainer as ttr
from unina_yolo_dla_torch.train.train import main as t_main
from unina_yolo_dla_tpu.data import dataset as jds
from unina_yolo_dla_tpu.models import ModelConfig as JCfg
from unina_yolo_dla_tpu.models.detector import UninaYoloDla as JModel
from unina_yolo_dla_tpu.train import loop as jloop
from unina_yolo_dla_tpu.train import trainer as jtr

SMALL = dict(num_classes=4, base_channels=16, input_size=64)
SYNTH = dict(image_size=64, seed=9, min_height=6, max_height=28,
             min_cones=2, max_cones=5)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this module runs: the suite runs it
    beside other worker processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _leaves(tree, leaf=np.asarray):
    return {".".join(str(p.key) for p in path): leaf(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    yaml = tsyn.generate_dataset(tmp_path_factory.mktemp("synth"), 8, 4,
                                 tsyn.SynthConfig(**SYNTH))
    spec = tds.load_dataset_yaml(yaml)
    return yaml, spec


@pytest.fixture(scope="module")
def init_vars():
    from test_torch_train_step import jax_init

    return jax_init(JCfg(**SMALL, compute_dtype=jnp.float32))[1]


def _normalised(batch_iterator):
    """``batch_iterator`` with its images normalised on the host by the
    reference's ``normalize_images`` (float32: both steps take it as
    normalised)."""
    def wrapped(*a, **kw):
        for b in batch_iterator(*a, **kw):
            yield dict(b, images=jds.normalize_images(b["images"]))
    return wrapped


TC = dict(lr0=0.02, warmup_steps=2, total_steps=20, ema_decay=0.999,
          batch_size=4)
FIT = dict(epochs=2, augment=True, mosaic_p=0.5, seed=3)


def test_fit_matches_reference_f64(data, init_vars, tmp_path, monkeypatch):
    _, spec = data
    monkeypatch.setattr(jloop, "batch_iterator",
                        _normalised(jloop.batch_iterator))
    monkeypatch.setattr(tloop, "batch_iterator",
                        _normalised(tloop.batch_iterator))
    v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), init_vars)
    with jax.enable_x64(True):
        jcfg = JCfg(**SMALL, compute_dtype=jnp.float64)
        want = jloop.fit(JModel(jcfg), v64,
                         jds.YoloDataset(spec["train"], 64, 16), None,
                         jtr.TrainConfig(**TC), output_dir=tmp_path / "j",
                         log_fn=lambda *_: None, **FIT)
        w_state = {k: _leaves(getattr(want.state, k)) for k in (
            "params", "ema_params", "batch_stats")}
    cfg = TCfg(**SMALL, compute_dtype=torch.float64)
    model = tdet.from_jax_variables(init_vars, cfg, "cpu").double()
    got = tloop.fit(model, tdet.variables_of(model),
                    tds.YoloDataset(spec["train"], 64, 16), None,
                    ttr.TrainConfig(**TC), output_dir=tmp_path / "t",
                    log_fn=lambda *_: None, **FIT)
    assert got.state.step == int(want.state.step) == 4
    assert len(got.history) == len(want.history) == 2
    for g, w in zip(got.history, want.history):
        assert g["epoch"] == w["epoch"]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["fitness"], w["fitness"], rtol=1e-5)
    for coll in ("params", "ema_params"):
        gl = {k: t.numpy() for k, t in getattr(got.state, coll).items()}
        errs = {k: np.abs(gl[k] - w).max() / max(np.abs(w).max(), 1e-30)
                for k, w in w_state[coll].items()}
        assert max(errs.values()) < 1e-2, max(errs.items(), key=lambda x: x[1])
        assert np.median(list(errs.values())) < 1e-5
    for k, w in w_state["batch_stats"].items():
        g = got.state.batch_stats[k].numpy()
        assert np.max(np.abs(g - w) / (1 + np.abs(w))) < 1e-5, k
    lines = (tmp_path / "t" / "history.jsonl").read_text().splitlines()
    assert [json.loads(x)["loss"] for x in lines] == \
        [h["loss"] for h in got.history]


def test_resume_is_bit_identical(data, init_vars, tmp_path):
    _, spec = data
    cfg = TCfg(**SMALL, compute_dtype=torch.float32)
    train = tds.YoloDataset(spec["train"], 64, 16)
    val = tds.YoloDataset(spec["val"], 64, 16)
    tc = ttr.TrainConfig(lr0=0.02, warmup_steps=1, total_steps=8,
                         batch_size=4)

    def run(epochs, out, resume=False):
        model = tdet.from_jax_variables(init_vars, cfg, "cpu")
        return tloop.fit(model, tdet.variables_of(model), train, val, tc,
                         epochs=epochs, output_dir=out, mosaic_p=0.5,
                         seed=11, resume=resume, log_fn=lambda *_: None)

    full = run(2, tmp_path / "full")
    run(1, tmp_path / "resumed")
    resumed = run(2, tmp_path / "resumed", resume=True)
    assert resumed.state.step == full.state.step == 4
    for name in ("params", "batch_stats", "ema_params"):
        a, b = getattr(full.state, name), getattr(resumed.state, name)
        assert list(a) == list(b)
        assert all(torch.equal(a[k], b[k]) for k in a), name
    assert full.state.opt_state["count"] == resumed.state.opt_state["count"]
    assert all(torch.equal(full.state.opt_state["trace"][k], t)
               for k, t in resumed.state.opt_state["trace"].items())
    assert [h["loss"] for h in resumed.history] == \
        [h["loss"] for h in full.history[1:]]
    for coll, tree in full.best_variables.items():
        assert all(torch.equal(t, resumed.best_variables[coll][k])
                   for k, t in tree.items())


DRY_RUN = ["--epochs", "2", "--qat-epochs", "1", "--batch", "4",
           "--imgsz", "64", "--base-channels", "16", "--calib-batches", "2",
           "--calib-min-images", "0", "--calib-method", "max",
           "--calibrate-cp", "--export", "--max-boxes", "16",
           "--device", "cpu"]
# the reference CLI's files after its dry run, but its serialized program
# (serving.stablehlo, serving_baked.stablehlo, compile_options.pb,
# pjrt_plugin.conf): the port serves from the weights
CLI_FILES = {
    "calibration.cache", "qat_init_calibrated.msgpack", "results.json",
    "serving_artifact/config.json", "serving_artifact/variables.msgpack",
    "serving_artifact/fallback_report.json",
} | {f"{phase}/{f}" for phase, steps in (("fp32", 2), ("qat", 1))
     for f in ["best.msgpack", "history.jsonl", "weights/state.json",
               "weights/last_state.msgpack", "weights/last_state.json",
               *(f"weights/step_{i}.msgpack" for i in range(steps))]}


def test_cli_dry_run(data, tmp_path):
    from unina_yolo_dla_torch.runtime.serving import PerceptionServer
    from unina_yolo_dla_tpu.quant.qat import make_qat_model
    from unina_yolo_dla_tpu.utils.checkpoint import load_msgpack

    yaml, _ = data
    out = tmp_path / "runs"
    results = t_main(["--data", str(yaml), "--output-dir", str(out),
                      *DRY_RUN])
    files = {str(p.relative_to(out)) for p in out.rglob("*") if p.is_file()}
    assert files - {"cp_calibration.json"} == CLI_FILES
    assert "fp32" in results and "qat" in results
    assert np.isfinite(results["fp32"]["loss"])
    assert np.isfinite(results["qat"]["loss"])
    assert results["export"] == str(out / "serving_artifact")
    assert json.loads((out / "results.json").read_text()).keys() == \
        results.keys()

    # the checkpoints load into the reference's own templates
    cfg = JCfg(**SMALL)
    x = jnp.zeros((1, 64, 64, 3))
    for path, model in ((out / "fp32" / "best.msgpack", JModel(cfg)),
                        (out / "qat" / "best.msgpack", make_qat_model(cfg)),
                        (out / "qat_init_calibrated.msgpack",
                         make_qat_model(cfg))):
        template = jax.eval_shape(lambda m=model: m.init(
            jax.random.key(0), x, train=False))
        loaded = load_msgpack(path, template)
        assert set(loaded) == set(template), path
        assert _leaves(loaded, np.shape) == _leaves(template, np.shape)
    conf = json.loads((out / "serving_artifact" / "config.json").read_text())
    assert conf["quantized"] and conf["quant_mode"] == "quantize"

    srv = PerceptionServer(out / "serving_artifact", expected_input=64,
                           expected_classes=4, log_fn=lambda s: None,
                           device="cpu")
    srv.configure()
    srv.activate()
    assert srv.process_frame(np.zeros((64, 64, 3), np.uint8)) is not None
    cp = out / "cp_calibration.json"
    if cp.exists():
        assert 0 <= json.loads(cp.read_text())["q_hat"] <= 1


def test_cli_skip_qat(data, tmp_path):
    yaml, _ = data
    out = tmp_path / "skip"
    results = t_main(["--data", str(yaml), "--epochs", "1", "--qat-epochs",
                      "1", "--batch", "4", "--imgsz", "64",
                      "--base-channels", "16", "--skip-qat", "--max-boxes",
                      "16", "--device", "cpu", "--output-dir", str(out)])
    assert "fp32" in results and "qat" not in results


def test_prefetch_and_fitness():
    assert list(tloop.prefetch(iter(range(5)), depth=2)) == list(range(5))

    def broken():
        yield 1
        raise OSError("disk")

    with pytest.raises(OSError, match="disk"):
        list(tloop.prefetch(broken()))
    m = {"map50": 0.5, "map50_95": 0.25}
    assert tloop.fitness(m) == jloop.fitness(m) == 0.1 * 0.5 + 0.9 * 0.25
