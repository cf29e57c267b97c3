"""The port's curation (``unina_yolo_dla_torch/curation/``) against the
reference's on the CPU, on the model ``tests/test_curation.py`` builds
(base 16, float32 compute, 64^2 inputs, the reference's init
weights carried into the port's train form by ``from_jax_variables``):

- entropy and loc-var scores and the P4+SPPF embeddings against the
  reference's ``ActiveLearner`` within 1e-5 relative (float32 sums and
  transcendentals in another order);
- ``kcenter_greedy`` and ``kmeans_select`` (when scikit-learn is
  installed) pick the same indices from the same embeddings;
- ``mine_difficulty_map`` writes the same keys, values within 1e-5
  relative, read back by the port's ``load_difficulty_weights``; its CLI
  reads a checkpoint through ``utils/checkpoint.py``;
- ``slice_image``, ``nms_per_class`` and ``AutoLabeler`` with a mock
  detector (and a mask refiner) identical to the reference's; the gated
  GroundingDINO and SAM loaders raise ``ImportError``.
"""
import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unina_yolo_dla_torch import curation as tc
from unina_yolo_dla_torch.curation import auto_labeler as tal
from unina_yolo_dla_torch.curation import mine as tmine
from unina_yolo_dla_torch.data.dataset import YoloDataset, \
    load_difficulty_weights
from unina_yolo_dla_torch.models import config as tconfig
from unina_yolo_dla_torch.models.detector import from_jax_variables
from unina_yolo_dla_torch.utils.checkpoint import save_msgpack
from unina_yolo_dla_tpu import curation as jc
from unina_yolo_dla_tpu.models import ModelConfig, init_model


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this module runs: the suite runs it
    beside other worker processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


IMG = 64
RTOL = 1e-5


@pytest.fixture(scope="module")
def models():
    cfg = ModelConfig(num_classes=4, base_channels=16, input_size=IMG,
                      compute_dtype=jnp.float32)
    model, variables = init_model(jax.random.key(0), cfg)
    variables = jax.device_get(variables)
    tcfg = tconfig.ModelConfig(num_classes=4, base_channels=16,
                               input_size=IMG, compute_dtype=torch.float32)
    port = from_jax_variables(variables, tcfg, device="cpu")
    return model, variables, port


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(0)
    return [(rng.normal(0, 1, (3, IMG, IMG, 3)).astype(np.float32),
             [f"img_{i}_{j}.jpg" for j in range(3)]) for i in range(2)]


@pytest.fixture(scope="module")
def learners(models):
    model, variables, port = models
    return jc.ActiveLearner(model, variables), tc.ActiveLearner(port)


def _close(got: dict, want: dict):
    assert list(got) == list(want)
    g, w = np.array(list(got.values())), np.array(list(want.values()))
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=0)


@pytest.mark.parametrize("mode", ["entropy", "loc_var"])
def test_scores_match_reference(learners, batches, mode):
    want = learners[0].compute_difficulty_scores(batches, mode)
    got = learners[1].compute_difficulty_scores(batches, mode)
    _close(got, want)
    assert learners[1].query_uncertain_samples(batches, 2, mode) == \
        learners[0].query_uncertain_samples(batches, 2, mode)


def test_score_functions_on_fixed_logits():
    """ln 2 at p = 0.5, ~0 for confident logits; loc-var 1 at p = 0.5."""
    rng = np.random.default_rng(1)
    outs = [(rng.normal(0, 3, (2, 4, 4, 4)).astype(np.float32),
             np.zeros((2, 4, 4, 4), np.float32)) for _ in range(3)]
    t_outs = [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in outs]
    j_outs = [(jnp.asarray(a), jnp.asarray(b)) for a, b in outs]
    for tf, jf in ((tc.entropy_scores, jc.entropy_scores),
                   (tc.loc_var_scores, jc.loc_var_scores)):
        np.testing.assert_allclose(tf(t_outs).numpy(), np.asarray(jf(j_outs)),
                                   rtol=RTOL)
    half = [(torch.zeros(2, 4, 4, 4), torch.zeros(2, 4, 4, 4))]
    np.testing.assert_allclose(tc.entropy_scores(half).numpy(), np.log(2),
                               rtol=1e-6)
    np.testing.assert_allclose(tc.loc_var_scores(half).numpy(), 1.0)
    p = torch.tensor([0.2, 0.5])
    np.testing.assert_allclose(tc.binary_entropy_map(p).numpy(), np.asarray(
        jc.binary_entropy_map(jnp.asarray(p.numpy()))), rtol=RTOL)


def test_embeddings_and_coresets_match_reference(learners, batches):
    je, jp = learners[0].extract_embeddings(batches)
    te, tp = learners[1].extract_embeddings(batches)
    assert tp == jp and te.shape == je.shape == (6, 128)
    np.testing.assert_allclose(te, je, rtol=RTOL,
                               atol=RTOL * np.abs(je).max())
    for k in (1, 3, 6):
        assert tc.kcenter_greedy(je, k, seed=2) == \
            jc.kcenter_greedy(je, k, seed=2)
    want = learners[0].coreset_selection(lambda: batches, 3)
    got = learners[1].coreset_selection(lambda: batches, 3)
    assert got == want and learners[1]._cached_embeddings is not None
    learners[1].invalidate_cache()
    assert learners[1]._cached_embeddings is None


def test_kmeans_select_matches_reference():
    pytest.importorskip("sklearn")
    emb = np.random.default_rng(3).normal(0, 1, (30, 8))
    assert tc.kmeans_select(emb, 5) == jc.kmeans_select(emb, 5)


def test_mine_difficulty_map_matches_reference(models, tmp_path):
    model, variables, port = models
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(5):
        cv2.imwrite(str(img_dir / f"u{i}.jpg"),
                    rng.integers(0, 255, (48, 56, 3)).astype(np.uint8))
    for mode in ("entropy", "loc_var"):
        want = jc.mine_difficulty_map(model, variables, img_dir,
                                      tmp_path / f"j_{mode}.json", mode, 2)
        out = tmp_path / f"t_{mode}.json"
        got = tc.mine_difficulty_map(port, None, img_dir, out, mode, 2)
        _close(got, want)
        assert list(json.loads(out.read_text())) == sorted(got)
        w = load_difficulty_weights(YoloDataset(img_dir, img_size=IMG), out)
        np.testing.assert_allclose(w, np.maximum(
            [got[f"u{i}"] for i in range(5)], 0.1))
    # the CLI: a checkpoint read by utils/checkpoint.py, the train form
    ckpt = tmp_path / "ckpt.msgpack"
    save_msgpack(variables, ckpt)
    out = tmp_path / "cli.json"
    tmine.main(["--weights", str(ckpt), "--images", str(img_dir),
                "--output", str(out), "--imgsz", str(IMG),
                "--base-channels", "16", "--batch", "2", "--device", "cpu"])
    cli = json.loads(out.read_text())
    ref = json.loads((tmp_path / "j_entropy.json").read_text())
    assert list(cli) == list(ref)
    # the CLI's model computes in the config's bf16: scores close, not equal
    np.testing.assert_allclose(list(cli.values()), list(ref.values()),
                               rtol=0.05)


def test_slicing_and_nms_identical():
    img = np.arange(150 * 210 * 3, dtype=np.uint32).reshape(150, 210, 3)
    img = (img % 251).astype(np.uint8)
    for tile, overlap in ((64, 0.2), (64, 0.0), (100, 0.5), (300, 0.2)):
        got, want = (m.slice_image(img, tile, overlap) for m in (tal, jc))
        assert len(got) == len(want)
        for (gt, gx, gy), (wt, wx, wy) in zip(got, want):
            assert (gx, gy) == (wx, wy) and np.array_equal(gt, wt)
    rng = np.random.default_rng(4)
    xy = rng.uniform(0, 100, (40, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 30, (40, 2))], 1)
    scores = rng.uniform(0, 1, 40)
    classes = rng.integers(0, 3, 40)
    for thr in (0.3, 0.5, 0.7):
        assert np.array_equal(tc.nms_per_class(boxes, scores, classes, thr),
                              jc.nms_per_class(boxes, scores, classes, thr))


def test_auto_labeler_with_mock_detector_identical(tmp_path):
    def detector(tile, prompts):
        h, w = tile.shape[:2]
        s = float(tile.mean()) / 255
        return (np.asarray([[w * 0.4, h * 0.4, w * 0.6, h * 0.6],
                            [w * 0.41, h * 0.4, w * 0.61, h * 0.6],
                            [0, 0, w * 0.1, h * 0.2]]),
                np.asarray([0.9, 0.8, 0.2 + s]), np.asarray([1, 1, 2]))

    def mask_fn(image, boxes):
        m = np.zeros((len(boxes), *image.shape[:2]), bool)
        for i, (x1, y1, x2, y2) in enumerate(boxes.astype(int)):
            m[i, y1 + 1:y2 - 1, x1 + 2:x2 - 1] = True
        return m

    img = np.random.default_rng(5).integers(0, 256, (200, 300, 3),
                                            dtype=np.uint8)
    for refiner_of in (lambda m: None, lambda m: m.mask_refiner_from_masks(
            mask_fn)):
        kw = dict(tile=64, overlap=0.2, conf_threshold=0.5)
        got = tc.AutoLabeler(detector, refiner_of(tal), **kw).label_image(img)
        want = jc.AutoLabeler(detector, refiner_of(jc.auto_labeler),
                              **kw).label_image(img)
        assert got.shape[0] > 0 and np.array_equal(got, want)
    # a directory to YOLO text files, as the reference writes them
    src = tmp_path / "src"
    src.mkdir()
    cv2.imwrite(str(src / "a.jpg"), img)
    for m, name in ((tal, "t"), (jc.auto_labeler, "j")):
        n = m.AutoLabeler(detector, tile=64).label_directory(
            src, tmp_path / name)
        assert n == 1
    assert (tmp_path / "t" / "a.txt").read_text() == \
        (tmp_path / "j" / "a.txt").read_text()
    with pytest.raises(ImportError):
        tal.load_groundingdino_detector("cfg.py", "ckpt.pth")
    with pytest.raises(ImportError):
        tal.load_sam_refiner("sam.pth")
