"""The port's data pipeline against the JAX package's, on the CPU: the same
seeded numpy inputs through both, every comparison exact.

- ``generate_dataset``: the same files, byte for byte (scenes, labels,
  the dataset YAML but its absolute ``path``).
- ``YoloDataset`` + ``batch_iterator`` over one written dataset: every
  batch array bit-equal (images, boxes, labels, mask, sample_valid,
  indices) for plain epoch shuffling; augmentation with mosaic, mixup and
  copy-paste (RGBA .png and .npy assets); corruption; difficulty weights;
  ``process_slice`` with 2 processes (each process's rows; together, the
  single process's samples in its order); tail padding.
- Each corruption at each severity and ``maybe_corrupt``; ``SmallObjectMetric``
  over random predictions and ground truths: equal.
"""
import dataclasses

import numpy as np
import pytest

from unina_yolo_dla_torch.curation.copy_paste import CopyPasteAugmentor as TCP
from unina_yolo_dla_torch.data import corruptions as tcor
from unina_yolo_dla_torch.data import dataset as tds
from unina_yolo_dla_torch.data import synthetic as tsyn
from unina_yolo_dla_torch.metrics.small_object import SmallObjectMetric as TSM
from unina_yolo_dla_tpu.curation.copy_paste import CopyPasteAugmentor as JCP
from unina_yolo_dla_tpu.data import corruptions as jcor
from unina_yolo_dla_tpu.data import dataset as jds
from unina_yolo_dla_tpu.data import synthetic as jsyn
from unina_yolo_dla_tpu.metrics.small_object import SmallObjectMetric as JSM

SYNTH = dict(image_size=64, seed=5, min_height=6, max_height=28,
             min_cones=2, max_cones=6)
N_TRAIN, N_VAL = 10, 5


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The same dataset written by each package (64^2, 10 train, 5 val)."""
    root = tmp_path_factory.mktemp("synth")
    t = tsyn.generate_dataset(root / "port", N_TRAIN, N_VAL,
                              tsyn.SynthConfig(**SYNTH))
    j = jsyn.generate_dataset(root / "ref", N_TRAIN, N_VAL,
                              jsyn.SynthConfig(**SYNTH))
    return t, j


@pytest.fixture(scope="module")
def datasets(written):
    spec = tds.load_dataset_yaml(written[0])
    assert spec == {**jds.load_dataset_yaml(written[0])}
    return (tds.YoloDataset(spec["train"], img_size=64, max_boxes=8),
            jds.YoloDataset(spec["train"], img_size=64, max_boxes=8))


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """Cone cut-outs: RGBA pngs and an .npy, class from the file name."""
    import cv2

    d = tmp_path_factory.mktemp("assets")
    rng = np.random.default_rng(3)
    for i, name in enumerate(("yellow_cone", "blue_cone",
                              "large_orange_cone")):
        a = rng.integers(0, 256, (10 + 2 * i, 8 + i, 4), dtype=np.uint8)
        a[..., 3] = np.where(rng.uniform(size=a.shape[:2]) < 0.7, 255, 0)
        cv2.imwrite(str(d / f"{name}_{i:03d}.png"), a)
    np.save(d / "orange_cone_009.npy",
            rng.integers(0, 256, (9, 7, 4), dtype=np.uint8))
    return d


def test_generate_dataset_writes_the_same_files(written):
    t, j = written
    t_files = sorted(p.relative_to(t.parent) for p in t.parent.rglob("*")
                     if p.is_file())
    j_files = sorted(p.relative_to(j.parent) for p in j.parent.rglob("*")
                     if p.is_file())
    assert t_files == j_files and len(t_files) == 2 * (N_TRAIN + N_VAL) + 1
    for rel in t_files:
        a, b = (t.parent / rel).read_bytes(), (j.parent / rel).read_bytes()
        if rel.name == "fsd_synth.yaml":
            a, b = (x.replace(str(p.parent.resolve()).encode(), b"ROOT")
                    for x, p in ((a, t), (b, j)))
        assert a == b, rel
    assert tsyn.validate_labels([(0, 0.5, 0.5, 0.1, 0.2)])
    assert not tsyn.validate_labels([(4, 0.5, 0.5, 0.1, 0.2)])
    assert not tsyn.validate_labels([(0, 1.5, 0.5, 0.1, 0.2)])


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    return got


CASES = {
    "plain": dict(batch_size=4, steps=3),
    "tail_padding": dict(batch_size=4, shuffle=False),
    "weights": dict(batch_size=3, steps=3, weights="map"),
    "augment": dict(batch_size=3, steps=3, augment=True, mosaic_p=0.6,
                    mixup_p=0.6, copy_paste=True),
    "corruption": dict(batch_size=4, steps=2, corruption_p=0.9),
    "process_slice": dict(batch_size=4, steps=2, augment=True,
                          mosaic_p=0.5, corruption_p=0.5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_batch_iterator_bit_equal(datasets, assets, case):
    """Every array of every batch equal; with ``process_slice`` each of 2
    processes' rows (drawn from per-row seeds) and both together covering
    the global batch's samples."""
    tdset, jdset = datasets
    kw = dict(CASES[case])
    if kw.pop("copy_paste", False):
        kw["copy_paste"] = (TCP(assets, seed=1), JCP(assets, seed=1))
    if kw.get("weights") == "map":
        dmap = {p.stem: float(w) for p, w in zip(
            tdset.image_paths, np.linspace(0.0, 3.0, len(tdset)))}
        kw["weights"] = tds.load_difficulty_weights(tdset, dmap)
        np.testing.assert_array_equal(
            kw["weights"], jds.load_difficulty_weights(jdset, dmap))
        assert kw["weights"].min() == 0.1
    slices = [(0, 2), (1, 2)] if case == "process_slice" else [None]
    if "copy_paste" in kw:
        assert len(kw["copy_paste"][0].assets) == 4
    rows = []
    for ps in slices:
        cp = kw.pop("copy_paste", (None, None))
        got = tds.batch_iterator(tdset, rng=np.random.default_rng(7),
                                 process_slice=ps, copy_paste=cp[0], **kw)
        want = jds.batch_iterator(jdset, rng=np.random.default_rng(7),
                                  process_slice=ps, copy_paste=cp[1], **kw)
        batches = _assert_batches_equal(got, want)
        kw["copy_paste"] = cp
        if ps is not None:
            assert all(len(b["images"]) == 2 for b in batches)
            rows.append(np.stack([b["indices"] for b in batches]))
    if rows:
        whole = tds.batch_iterator(tdset, 4, np.random.default_rng(7),
                                   steps=2)
        np.testing.assert_array_equal(
            np.concatenate(rows, axis=1),
            np.stack([b["indices"] for b in whole]))
    if case == "tail_padding":
        last = batches[-1]
        assert last["sample_valid"].tolist() == [True, True, False, False]
        assert last["indices"].tolist()[2:] == [-1, -1]
        assert not last["mask"][2:].any()
    if case == "augment":
        assert any(b["mask"].sum() for b in batches)


def test_normalize_images_and_letterbox(datasets):
    tdset, jdset = datasets
    img = tdset.load_letterboxed(0)[0][None]
    np.testing.assert_array_equal(tds.normalize_images(img),
                                  jds.normalize_images(img))
    wide = np.random.default_rng(1).integers(0, 256, (30, 50, 3), np.uint8)
    for a, b in zip(tds.letterbox_image(wide, 64),
                    jds.letterbox_image(wide, 64)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(jcor.CORRUPTIONS))
def test_corruptions_equal(name):
    img = np.random.default_rng(2).integers(0, 256, (40, 48, 3), np.uint8)
    for sev in (1, 2, 3):
        got = tcor.CORRUPTIONS[name](img, sev, np.random.default_rng(sev))
        want = jcor.CORRUPTIONS[name](img, sev, np.random.default_rng(sev))
        np.testing.assert_array_equal(got, want)
    r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(6):
        np.testing.assert_array_equal(tcor.maybe_corrupt(r1, img, 0.7),
                                      jcor.maybe_corrupt(r2, img, 0.7))


def test_corrupt_batches_equal(datasets):
    tdset, jdset = datasets

    def batches(mod, d):
        return lambda: mod.batch_iterator(d, 4, np.random.default_rng(0),
                                          shuffle=False)

    _assert_batches_equal(
        tcor.corrupt_batches(batches(tds, tdset), "low_light", 2, seed=3)(),
        jcor.corrupt_batches(batches(jds, jdset), "low_light", 2, seed=3)())


def test_small_object_metric_equal():
    """Random predictions and ground truths (normalised, many under the
    15 px threshold): TP/FP/FN and P/R/F1 equal."""
    rng = np.random.default_rng(6)
    t, j = TSM(), JSM()
    for _ in range(5):
        preds, gts = [], []
        for _ in range(3):
            n, m = rng.integers(0, 12), rng.integers(0, 8)
            g = np.concatenate([rng.integers(0, 4, (m, 1)),
                                rng.uniform(0.1, 0.9, (m, 2)),
                                rng.uniform(0.005, 0.04, (m, 2))], 1)
            p = np.concatenate([g[:, 1:], rng.uniform(0, 1, (m, 1)),
                                g[:, :1]], 1) if m else np.zeros((0, 6))
            p[:, :2] += rng.normal(0, 0.004, (len(p), 2))
            extra = np.concatenate([rng.uniform(0.1, 0.9, (n, 2)),
                                    rng.uniform(0.005, 0.05, (n, 2)),
                                    rng.uniform(0, 1, (n, 1)),
                                    rng.integers(0, 4, (n, 1))], 1)
            preds.append(np.concatenate([p, extra]))
            gts.append(g)
        t.update(preds, gts)
        j.update(preds, gts)
    got, want = t.compute(), j.compute()
    assert got == want
    assert want["small_object_tp"] > 0 and want["small_object_fp"] > 0
    assert dataclasses.is_dataclass(tsyn.SynthConfig())
