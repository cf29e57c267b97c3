"""Port decode / compaction / NMS vs the reference functions (CPU; the
kernels on the card are in test_torch_gpu.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unina_yolo_dla_torch.ops import decode as td
from unina_yolo_dla_torch.ops import nms as tn
from unina_yolo_dla_torch.ops.cuda.decode_kernel import decode_level_plain
from unina_yolo_dla_tpu.ops import decode as jd
from unina_yolo_dla_tpu.ops.nms import nms as j_nms
from unina_yolo_dla_tpu.ops.nms import nms_reference as j_nms_reference
from unina_yolo_dla_tpu.ops.pallas import nms_pallas

RTOL = 1e-6   # stated tolerance: boxes and scores within 1e-6 (relative)


def _level(rng, g, saturate=0):
    cls = rng.normal(0, 2, (g, g, 4)).astype(np.float32)
    # saturated logits: sigmoid == 1.0 exactly, tied scores
    idx = rng.choice(g * g, saturate, replace=False)
    cls.reshape(-1, 4)[idx, rng.integers(0, 4, saturate)] = 40.0
    reg = rng.uniform(0.1, 3.0, (g, g, 4)).astype(np.float32)
    return cls, reg


@pytest.mark.parametrize("stride,q", [(4, 0.0), (8, 0.2116), (16, 0.1)])
def test_decode_level_matches_reference(rng, stride, q):
    cls, reg = _level(rng, 24, saturate=5)
    jb, js, jc, jv = map(np.asarray, jd.decode_level(
        jnp.asarray(cls), jnp.asarray(reg), stride, 0.5, q))
    rows = decode_level_plain(torch.from_numpy(cls), torch.from_numpy(reg),
                              stride, 0.5, q).numpy()
    tb, ts, tc, tv = rows[:, :4], rows[:, 4], rows[:, 5], rows[:, 6] > 0.5
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(ts, js, rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(tb, jb, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("exact_topk", [True, False])
def test_decode_outputs_matches_reference(rng, exact_topk):
    """Compaction with tied (saturated) scores: same valid rows in the same
    order as the reference's top-k (exact, and the serving approx form)."""
    outs = [_level(rng, g, saturate=6) for g in (16, 8, 4)]
    jdets = jd.decode_outputs(
        [(jnp.asarray(c)[None], jnp.asarray(r)[None]) for c, r in outs],
        (4, 8, 16), 0.5, 0.2, 64, exact_topk=exact_topk)
    tdets = td.decode_outputs(
        [(torch.from_numpy(c)[None], torch.from_numpy(r)[None])
         for c, r in outs], (4, 8, 16), 0.5, 0.2, 64)
    jv = np.asarray(jdets.valid)
    np.testing.assert_array_equal(tdets.valid.numpy(), jv)
    np.testing.assert_array_equal(tdets.classes.numpy()[jv],
                                  np.asarray(jdets.classes)[jv])
    np.testing.assert_allclose(tdets.scores.numpy()[jv],
                               np.asarray(jdets.scores)[jv], rtol=RTOL)
    np.testing.assert_allclose(tdets.boxes.numpy()[jv],
                               np.asarray(jdets.boxes)[jv], rtol=RTOL,
                               atol=RTOL)


def _random_dets(rng, k=256, n_valid=200):
    centers = rng.uniform(50, 590, (k, 2))
    wh = rng.uniform(5, 60, (k, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1)
    scores = np.sort(rng.uniform(0.5, 1.0, k))[::-1].copy()
    classes = rng.integers(0, 4, k)
    valid = np.arange(k) < n_valid
    return (boxes.astype(np.float32), scores.astype(np.float32),
            classes.astype(np.int32), valid)


def _chain(k=256, n=48):
    """Consecutive boxes overlap at IoU 0.5 (> 0.3), i and i+2 at 0.2:
    greedy keeps the evens, a suppression chain n deep."""
    boxes = np.zeros((k, 4), np.float32)
    for i in range(n):
        boxes[i] = (6.0 * i, 0, 6.0 * i + 18.0, 18.0)
    scores = np.linspace(1.0, 0.1, k).astype(np.float32)
    return boxes, scores, np.zeros(k, np.int32), np.arange(k) < n


def _both(arrs, thr):
    boxes, scores, classes, valid = arrs
    jdets = jd.Detections(jnp.asarray(boxes), jnp.asarray(scores),
                          jnp.asarray(classes), jnp.asarray(valid))
    tdets = td.Detections(torch.from_numpy(boxes), torch.from_numpy(scores),
                          torch.from_numpy(classes), torch.from_numpy(valid))
    return jdets, tdets


@pytest.mark.parametrize("case", ["random0", "random1", "random2", "chain"])
def test_nms_keep_mask_matches_reference_exactly(case):
    if case == "chain":
        arrs, thr = _chain(), 0.3
    else:
        arrs, thr = _random_dets(np.random.default_rng(int(case[-1]))), 0.45
    jdets, tdets = _both(arrs, thr)
    want = np.asarray(j_nms(jdets, thr).valid)
    np.testing.assert_array_equal(want, np.asarray(
        j_nms_reference(jdets, thr).valid))
    np.testing.assert_array_equal(tn.nms(tdets, thr).valid.numpy(), want)
    np.testing.assert_array_equal(tn.nms_reference(tdets, thr).valid.numpy(),
                                  want)
    if case == "chain":
        np.testing.assert_array_equal(want[:6], [1, 0, 1, 0, 1, 0])


def _scattered(rng, k, n_valid, one_class=False):
    """Random candidates, crowded enough that some suppress others, whose
    valid slots are scattered over all k (not a prefix)."""
    _, scores, classes, _ = _random_dets(rng, k, k)
    centers = rng.uniform(50, 170, (k, 2))
    wh = rng.uniform(20, 60, (k, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2],
                           -1).astype(np.float32)
    valid = np.zeros(k, bool)
    valid[rng.choice(k, n_valid, replace=False)] = True
    if one_class:
        classes = np.full(k, 2, np.int32)
    return boxes, scores, classes, valid


@pytest.mark.parametrize("case,k,n_valid,one_class", [
    ("scattered", 256, 90, False), ("k100", 100, 70, False),
    ("k37", 37, 30, False), ("one_class", 128, 100, True),
    ("none_valid", 64, 0, False)])
def test_nms_any_mask_any_k_matches_reference_exactly(case, k, n_valid,
                                                      one_class):
    """A scattered valid mask, K not a multiple of 32, one class only and
    no valid candidate: the keep mask equals the reference's ``nms`` and
    ``nms_reference`` exactly."""
    arrs = _scattered(np.random.default_rng(k + n_valid), k, n_valid,
                      one_class)
    thr = 0.45
    jdets, tdets = _both(arrs, thr)
    want = np.asarray(j_nms(jdets, thr).valid)
    np.testing.assert_array_equal(want, np.asarray(
        j_nms_reference(jdets, thr).valid))
    got = tn.nms(tdets, thr).valid.numpy()
    assert got.shape == (k,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tn.nms_reference(tdets, thr).valid.numpy(),
                                  want)
    assert not (got & ~arrs[3]).any()
    if n_valid:
        assert 0 < got.sum() < n_valid   # something is suppressed
    else:
        assert got.sum() == 0


def test_nms_matches_pallas_interpret_deep_chain():
    arrs, thr = _chain(n=60), 0.3
    jdets, tdets = _both(arrs, thr)
    want = np.asarray(nms_pallas(jdets.boxes, jdets.scores, jdets.classes,
                                 jdets.valid, thr, interpret=True))
    np.testing.assert_array_equal(tn.nms(tdets, thr).valid.numpy(), want)
