"""The one-pass matrix NMS (``ops/nms.py nms_fast``) and the serving
switch that picks it (``use_greedy_nms=False``) against the reference, on
the CPU.

- seeded candidate sets (clustered boxes of four classes, some slots
  invalid, sorted by score): the port's keep mask equals the reference
  ``nms_fast``'s exactly, one image and a batch of two;
- a suppression chain (A suppresses B, B would suppress C, A does not
  reach C), where the two forms differ: greedy keeps C, the one-pass form
  drops it;
- the shipped artifact's weights served with ``use_greedy_nms=False`` on
  the seed-7 scene: the port's CPU path gives the jitted reference's
  Detections (same count, boxes within 0.5 px, scores within 1e-2, the
  tolerances of ``tests/test_torch_slice.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import ARTIFACT, BOX_PX, SCORE_TOL, SERVING_FLAGS
from unina_yolo_dla_torch.data.synthetic import SynthConfig, generate_image
from unina_yolo_dla_torch.models import config as tconfig
from unina_yolo_dla_torch.models.detector import from_jax_variables
from unina_yolo_dla_torch.ops.decode import Detections
from unina_yolo_dla_torch.ops.nms import nms, nms_fast
from unina_yolo_dla_torch.ops.preprocess import merged_frame_np
from unina_yolo_dla_torch.quant.fake_quant import PERF_EXCLUDE as T_PERF
from unina_yolo_dla_torch.quant.fake_quant import QuantSpec as TSpec
from unina_yolo_dla_torch.runtime.pipeline import build_serving_fn
from unina_yolo_dla_torch.utils.checkpoint import load_msgpack_raw
from unina_yolo_dla_tpu.models import ModelConfig
from unina_yolo_dla_tpu.models.detector import UninaYoloDla
from unina_yolo_dla_tpu.ops.decode import Detections as JDetections
from unina_yolo_dla_tpu.ops.nms import nms_fast as j_nms_fast
from unina_yolo_dla_tpu.quant.fake_quant import PERF_EXCLUDE, QuantSpec
from unina_yolo_dla_tpu.runtime.pipeline import build_serving_fn as j_build

IOU = 0.45
SERVE = dict(conf_threshold=0.5, iou_threshold=IOU, q_factor=0.2116)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this module runs: the suite runs it
    beside other worker processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _candidates(rng, k):
    """K score-sorted candidates: boxes clustered in a square of 12
    sqrt(K) px (96 at K = 64: same-class boxes overlap often), classes
    0..3, ~80% valid."""
    c = rng.uniform(0, 12 * np.sqrt(k), (k, 2))
    wh = rng.uniform(8, 40, (k, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = np.sort(rng.uniform(0.3, 1.0, k))[::-1].astype(np.float32)
    classes = rng.integers(0, 4, k).astype(np.int32)
    valid = rng.random(k) < 0.8
    return boxes, scores, classes, valid


def _port(boxes, scores, classes, valid):
    return Detections(*(torch.from_numpy(np.ascontiguousarray(a))
                        for a in (boxes, scores, classes, valid)))


def _ref_keep(boxes, scores, classes, valid):
    return np.asarray(j_nms_fast(JDetections(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes),
        jnp.asarray(valid)), IOU).valid)


@pytest.mark.parametrize("seed,k", [(0, 64), (1, 64), (2, 300), (3, 131)])
def test_nms_fast_keep_mask_matches_reference(seed, k):
    cand = _candidates(np.random.default_rng(seed), k)
    want = _ref_keep(*cand)
    got = nms_fast(_port(*cand), IOU).valid.numpy()
    np.testing.assert_array_equal(got, want)
    # the sets are not trivial: some valid candidates are suppressed
    assert 0 < want.sum() < cand[3].sum()


def test_nms_fast_batch_of_two_matches_reference_per_image():
    rng = np.random.default_rng(4)
    sets = [_candidates(rng, 64) for _ in range(2)]
    batch = _port(*(np.stack(f) for f in zip(*sets)))
    got = nms_fast(batch, IOU).valid.numpy()
    assert got.shape == (2, 64)
    for i, cand in enumerate(sets):
        np.testing.assert_array_equal(got[i], _ref_keep(*cand))


def test_nms_fast_chain_differs_from_greedy():
    """A (0..10) overlaps B (3..13) by 7/13, B overlaps C (6..16) by 7/13,
    A and C by 4/16: greedy keeps A and C, the one-pass form A alone."""
    boxes = np.array([[0, 0, 10, 10], [3, 0, 13, 10], [6, 0, 16, 10]],
                     np.float32)
    cand = (boxes, np.array([0.9, 0.8, 0.7], np.float32),
            np.zeros(3, np.int32), np.ones(3, bool))
    want = _ref_keep(*cand)
    np.testing.assert_array_equal(want, [True, False, False])
    np.testing.assert_array_equal(nms_fast(_port(*cand), IOU).valid.numpy(),
                                  want)
    np.testing.assert_array_equal(nms(_port(*cand), IOU).valid.numpy(),
                                  [True, False, True])
    # a box of another class, or an invalid one, suppresses nothing
    other = (cand[0], cand[1], np.array([0, 1, 0], np.int32), cand[3])
    np.testing.assert_array_equal(
        nms_fast(_port(*other), IOU).valid.numpy(), _ref_keep(*other))
    np.testing.assert_array_equal(_ref_keep(*other), [True, True, True])
    off = (cand[0], cand[1], cand[2], np.array([False, True, True]))
    np.testing.assert_array_equal(
        nms_fast(_port(*off), IOU).valid.numpy(), _ref_keep(*off))
    np.testing.assert_array_equal(_ref_keep(*off), [False, True, False])


def _matched(want, got):
    """One-to-one match of the reference's valid detections by class."""
    jv, tv = np.asarray(want.valid), got.valid.numpy()
    assert tv.sum() == jv.sum() >= 1
    jb, jsc, jc = (np.asarray(a)[jv] for a in (want.boxes, want.scores,
                                                want.classes))
    tb, tsc, tc = (a.numpy()[tv] for a in (got.boxes, got.scores,
                                            got.classes))
    used = set()
    for i in range(len(jb)):
        cand = [j for j in range(len(tb)) if j not in used and tc[j] == jc[i]]
        assert cand, f"reference detection {i} unmatched"
        j = min(cand, key=lambda j: np.abs(tb[j] - jb[i]).max())
        used.add(j)
        assert np.abs(tb[j] - jb[i]).max() <= BOX_PX
        assert abs(tsc[j] - jsc[i]) <= SCORE_TOL


def test_serving_without_greedy_nms_matches_reference():
    """The shipped engine's weights and flags, the seed-7 scene: the
    port's ``build_serving_fn(..., use_greedy_nms=False)`` on the CPU
    against the jitted reference's with the same switch."""
    jcfg = ModelConfig(quant=QuantSpec("int8_fused", exclude=PERF_EXCLUDE),
                       **SERVING_FLAGS)
    tcfg = tconfig.ModelConfig(quant=TSpec("int8_fused", exclude=T_PERF),
                               **SERVING_FLAGS)
    variables = load_msgpack_raw(ARTIFACT / "variables.msgpack")
    img, _ = generate_image(np.random.default_rng(7),
                            SynthConfig(image_size=640, seed=7))
    frame = merged_frame_np(np.ascontiguousarray(img[..., ::-1]))
    want = jax.jit(j_build(UninaYoloDla(jcfg), jcfg, use_greedy_nms=False,
                           **SERVE))(variables, jnp.asarray(frame))
    port = from_jax_variables(variables, tcfg, device="cpu")
    got = build_serving_fn(port, tcfg, use_greedy_nms=False, **SERVE)(
        torch.from_numpy(frame))
    _matched(want, got)
