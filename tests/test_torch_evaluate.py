"""The port's evaluation and conformal calibration against the JAX
package's, on the CPU.

The committed checkpoint (``artifacts/engine_source.msgpack``) in its two
train forms at 128^2: the FP32 model (params and batch statistics; float32
compute, the uint8 batches normalised by each package) and the QAT
fake-quant model (with its calibrated ``quant`` collection; float64
compute on the reference's normalised batches, see ``models``), its
variables carried to the port unchanged. The validation
set: 5 XHARD scenes at 128^2 written by the port's ``generate_dataset``
(JPEG), in batches of 4 (the last one padded). Each package predicts,
evaluates (writing predictions.json) and calibrates once per model
(``runs``); the tests compare those runs.

- ``predict_batches``: per image the same number of detections, matched one
  to one by class (in score order) with boxes within 1e-3 px and scores
  within 1e-5 (the port's float32 sums run in another order).
- ``evaluate_model``: every metric within 1e-6.
- ``save_predictions_json``: the same images, predictions and ground truth
  with the same flags; boxes within 0.01 and scores within 1e-4 (the
  file's rounding).
- ``calibrate_conformal_prediction`` (confidence 0.001, q = 0): the same
  number of scores, q_hat and the other statistics within 1e-6; a
  validation set without ground truth raises in both.
"""
import contextlib
import dataclasses
import json
from pathlib import Path
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unina_yolo_dla_torch import evaluate as tev
from unina_yolo_dla_torch.data import dataset as tds
from unina_yolo_dla_torch.data import synthetic as tsyn
from unina_yolo_dla_torch.models import detector as tdet
from unina_yolo_dla_torch.models.config import ModelConfig as TCfg
from unina_yolo_dla_torch.quant.qat import make_qat_model as t_qat
from unina_yolo_dla_torch.train import conformal as tcp
from unina_yolo_dla_torch.utils.checkpoint import load_msgpack_raw
from unina_yolo_dla_tpu import evaluate as jev
from unina_yolo_dla_tpu.models import ModelConfig as JCfg
from unina_yolo_dla_tpu.models.detector import UninaYoloDla as JModel
from unina_yolo_dla_tpu.ops.preprocess import ensure_normalized as j_norm
from unina_yolo_dla_tpu.quant.qat import make_qat_model as j_qat
from unina_yolo_dla_tpu.train import conformal as jcp

SIZE = 128
SOURCE = Path(__file__).resolve().parents[1] / "artifacts" / \
    "engine_source.msgpack"
BOX_PX, SCORE_TOL, METRIC_TOL, Q_TOL = 1e-3, 1e-5, 1e-6, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this module runs: the suite runs it
    beside other worker processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def val(tmp_path_factory):
    cfg = dataclasses.replace(tsyn.XHARD, image_size=SIZE, seed=3,
                              min_cones=4, max_cones=10)
    yaml = tsyn.generate_dataset(tmp_path_factory.mktemp("val"), 0, 5, cfg)
    ds = tds.YoloDataset(tds.load_dataset_yaml(yaml)["val"], img_size=SIZE,
                         max_boxes=32)
    return ds, lambda: tds.batch_iterator(ds, 4, np.random.default_rng(0),
                                          shuffle=False)


class Case(NamedTuple):
    jm: Any          # the JAX model
    jv: dict         # its variables
    tm: Any          # the port's model
    tv: dict         # its variables
    jax_ctx: Any     # the context the JAX calls run in
    prep: Any        # batch -> the batch both packages are fed


@pytest.fixture(scope="module", params=["fp32", "qat"])
def models(request):
    """FP32: float32 compute on the uint8 batches. QAT: float64 compute
    (the quant collection float32, as the reference keeps it) on the
    reference's normalised batches: in float32 the reference's XLA program
    rounds some convolutions, and its normalisation, one step away from
    PyTorch's, and a quantiser turns such a step at a rounding tie into a
    whole int8 step (measured: up to 0.23 px and 0.05 in score on the
    QAT model's boxes)."""
    src = load_msgpack_raw(SOURCE)
    if request.param == "fp32":
        v = {k: src[k] for k in ("params", "batch_stats")}
        return Case(JModel(JCfg(input_size=SIZE, compute_dtype=jnp.float32)),
                    v, tdet.create_model(TCfg(input_size=SIZE,
                                              compute_dtype=torch.float32),
                                         device="cpu"),
                    tdet.variables_from_jax(v, "cpu"),
                    contextlib.nullcontext, lambda b: b)
    v = {k: (jax.tree.map(lambda a: np.asarray(a, np.float64), src[k])
             if k != "quant" else src[k])
         for k in ("params", "batch_stats", "quant")}
    norm = jax.jit(j_norm)
    return Case(j_qat(JCfg(input_size=SIZE, compute_dtype=jnp.float64)), v,
                t_qat(TCfg(input_size=SIZE, compute_dtype=torch.float64),
                      device="cpu"),
                tdet.variables_from_jax(v, "cpu"),
                lambda: jax.enable_x64(True),
                lambda b: dict(b, images=np.asarray(norm(b["images"]))))


def _fed(val, case):
    """The zero-argument batches function both packages take."""
    return lambda: (case.prep(b) for b in val[1]())


def _match(got, want):
    """One image's predictions, matched one to one by class in the
    reference's score order: boxes within BOX_PX, scores within
    SCORE_TOL."""
    assert len(got) == len(want)
    free = np.ones(len(got), bool)
    for w in want[np.argsort(-want[:, 4], kind="stable")]:
        d = np.abs(got[:, :4] - w[:4]).max(1)
        ok = free & (got[:, 5] == w[5]) & (d <= BOX_PX)
        assert ok.any(), f"reference detection {w} unmatched"
        j = int(np.argmin(np.where(ok, d, np.inf)))
        assert abs(got[j, 4] - w[4]) <= SCORE_TOL
        free[j] = False


@pytest.fixture(scope="module")
def runs(val, models, tmp_path_factory):
    """Each package's predictions, evaluation (with predictions.json) and
    CP calibration of ``models`` on the validation set."""
    ds, c, batches = val[0], models, _fed(val, models)
    out = tmp_path_factory.mktemp("runs")
    got = {"pred": list(tev.predict_batches(c.tm, c.tv, batches())),
           "metrics": tev.evaluate_model(c.tm, c.tv, batches,
                                         save_json=out / "t.json",
                                         image_paths=ds.image_paths),
           "local": tev.evaluate_model.last_local_images,
           "cp": tcp.calibrate_conformal_prediction(
               c.tm, c.tv, batches(), output_path=out / "cp.json")}
    with c.jax_ctx():
        want = {"pred": list(jev.predict_batches(c.jm, c.jv, batches())),
                "metrics": jev.evaluate_model(c.jm, c.jv, batches,
                                              save_json=out / "j.json",
                                              image_paths=ds.image_paths),
                "cp": jcp.calibrate_conformal_prediction(c.jm, c.jv,
                                                         batches())}
    return got, want, out


def test_predict_and_evaluate_match(runs):
    got, want, _ = runs
    assert [r[2] for r in got["pred"]] == [r[2] for r in want["pred"]] == \
        list(range(5))
    assert sum(len(r[0]) for r in want["pred"]) > 20
    for (gp, gg, _), (wp, wg, _) in zip(got["pred"], want["pred"]):
        np.testing.assert_array_equal(gg, wg)
        _match(gp, wp)
    g, w = got["metrics"], want["metrics"]
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=METRIC_TOL,
                                   err_msg=k)
    assert 0.3 < w["map50"] < 1 and w["small_object_tp"] > 0
    assert got["local"] == 5


def test_save_predictions_json_matches(runs):
    _, _, out = runs
    got, want = (json.loads((out / f).read_text())
                 for f in ("t.json", "j.json"))
    assert {k: v for k, v in got.items() if k != "images"} == \
        {k: v for k, v in want.items() if k != "images"}
    assert [i["image"] for i in got["images"]] == \
        [i["image"] for i in want["images"]]
    for gi, wi in zip(got["images"], want["images"]):
        assert gi["ground_truth"] == wi["ground_truth"]
        key = lambda p: (p["class"], p["bbox"])   # noqa: E731
        gp, wp = sorted(gi["predictions"], key=key), sorted(
            wi["predictions"], key=key)
        assert len(gp) == len(wp)
        for a, b in zip(gp, wp):
            assert (a["class"], a["matched"], a["small"]) == \
                (b["class"], b["matched"], b["small"])
            assert np.abs(np.subtract(a["bbox"], b["bbox"])).max() <= 0.0101
            assert abs(a["score"] - b["score"]) <= 1.01e-4


def test_match_predictions_equal():
    rng = np.random.default_rng(5)
    gt = np.concatenate([rng.integers(0, 3, (6, 1)),
                         rng.uniform(0, 40, (6, 2)),
                         rng.uniform(50, 90, (6, 2))], 1).astype(np.float32)
    pred = np.concatenate([gt[:, 1:] + rng.normal(0, 4, (6, 4)),
                           rng.uniform(0, 1, (6, 1)), gt[:, :1]], 1)
    pred = np.concatenate([pred, pred[:2] + 1]).astype(np.float32)
    for a, b in zip(tev.match_predictions(pred, gt),
                    jev.match_predictions(pred, gt)):
        np.testing.assert_array_equal(a, b)


def test_conformal_calibration_matches(runs):
    g, w, out = runs
    got, want = g["cp"], w["cp"]
    assert json.loads((out / "cp.json").read_text()) == got
    assert got["num_scores"] == want["num_scores"] > 20
    assert got["num_images"] == want["num_images"] == 5
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=Q_TOL, err_msg=k)
    assert tcp.load_cp_q(out / "cp.json") == got["q_hat"]


def test_conformal_zero_matches_raises(val, models):
    """No ground truth: zero matched predictions, an error in both."""
    c = models

    def no_gt():
        b = next(_fed(val, models)())
        yield dict(b, mask=np.zeros_like(b["mask"]))

    with pytest.raises(RuntimeError, match="zero matched"):
        tcp.calibrate_conformal_prediction(c.tm, c.tv, no_gt())
    with c.jax_ctx(), pytest.raises(RuntimeError, match="zero matched"):
        jcp.calibrate_conformal_prediction(c.jm, c.jv, no_gt())
