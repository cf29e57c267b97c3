"""The port's CUDA kernels on the card against their plain PyTorch
versions, and the served artifact on the card against the port's CPU
path. Every test needs a CUDA device (``gpu`` marker) and skips without
one. This file imports no JAX, so it also runs where only PyTorch is
installed (``--noconftest``: the suite's conftest sets up JAX):

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py
"""
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from unina_yolo_dla_torch.data.synthetic import SynthConfig, generate_image
from unina_yolo_dla_torch.models.config import ModelConfig
from unina_yolo_dla_torch.models.detector import from_jax_variables
from unina_yolo_dla_torch.ops.cuda import (
    c3k2_kernel,
    camera_kernel,
    decode_kernel,
    head_kernel,
    int8_conv_kernel,
    mma_pack,
    nms_kernel,
    preprocess_kernel,
    qconcat_kernel,
    sppf_kernel,
    stage1_kernel,
    stem_kernel,
)
from unina_yolo_dla_torch.ops import decode as td
from unina_yolo_dla_torch.ops.preprocess import merged_frame_np
from unina_yolo_dla_torch.quant.fake_quant import PERF_EXCLUDE, QuantSpec
from unina_yolo_dla_torch.quant.qtensor import QTensor
from unina_yolo_dla_torch.ops.cuda import _lib
from unina_yolo_dla_torch.runtime import aot
from unina_yolo_dla_torch.runtime.artifact import ServingArtifact
from unina_yolo_dla_torch.runtime.embed import make_executor
from unina_yolo_dla_torch.runtime.pipeline import build_serving_fn
from unina_yolo_dla_torch.runtime.serving import PerceptionServer
from unina_yolo_dla_torch.utils.checkpoint import load_msgpack_raw

pytestmark = pytest.mark.gpu

ARTIFACT = Path(__file__).resolve().parents[1] / "artifacts" / \
    "serving_artifact"
ARTIFACT_B8 = ARTIFACT.with_name("serving_artifact_b8")
ARTIFACT_CAM = ARTIFACT.with_name("serving_artifact_cam")
# the int8 layers of the int8 engines' chain (shipped, b8, camera, fc), one
# int8 conv launch each
INT8_LAYERS = 46
# and the int8 chain's glue: SPPF's pools and concat (one launch), the
# other int8 concats and the quantises of a C3k2's float input (nine)
INT8_GLUE = {"int8_sppf": 1, "qconcat": 9}


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _launched(kernel, fn):
    before = kernel.launches
    out = fn()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    return out


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(320, 160, 24), (7, 5, 24), (1, 1, 24),
                                   (33, 17, 3)])
def test_normalize_kernel_exact(rng, cuda, shape, out_dtype):
    """The merged path at the serving shape, at ragged shapes whose byte
    count is no multiple of a warp's 384-byte step (840 and 24 bytes: the
    tail alone) and on a plain 3-channel frame, both output forms, bit for
    bit the plain version; one wrapper call is one launch."""
    img = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(
        cuda)
    mean, std = preprocess_kernel.channel_constants(shape[-1])
    got = _launched(preprocess_kernel.KERNEL,
                    lambda: preprocess_kernel.normalize(
                        img, mean, std, out_dtype=out_dtype))
    want = preprocess_kernel.normalize_plain(img, mean, std)
    assert got.dtype == out_dtype and got.shape == want.shape
    assert torch.equal(got, want.to(out_dtype))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels,swap", [(3, True), (4, True), (4, False)])
def test_normalize_kernel_generic_path_exact(rng, cuda, channels, swap,
                                             out_dtype):
    """3- and 4-channel frames with the B/R swap and the dropped alpha (a
    thread per pixel), and a view that starts 1 byte into its buffer (the
    4-byte loads do not apply)."""
    img = torch.from_numpy(rng.integers(0, 256, (61, 67, channels),
                                        dtype=np.uint8)).to(cuda)
    mean, std = preprocess_kernel.IMAGENET_MEAN, preprocess_kernel.IMAGENET_STD
    got = _launched(preprocess_kernel.KERNEL,
                    lambda: preprocess_kernel.normalize(
                        img, swap_rb=swap, out_dtype=out_dtype))
    want = preprocess_kernel.normalize_plain(img, mean, std, swap_rb=swap)
    assert got.shape == (61, 67, 3)
    assert torch.equal(got, want.to(out_dtype))
    flat = torch.from_numpy(rng.integers(
        0, 256, 1 + 9 * 5 * channels, dtype=np.uint8)).to(cuda)
    odd = flat[1:].view(9, 5, channels)
    got = preprocess_kernel.normalize(odd, swap_rb=swap, out_dtype=out_dtype)
    want = preprocess_kernel.normalize_plain(odd, mean, std, swap_rb=swap)
    assert torch.equal(got, want.to(out_dtype))


def test_normalize_kernel_other_channel_maps(rng, cuda):
    """Constants that do not repeat with period 3, and fewer output than
    input channels: the by-value channel map."""
    img = torch.from_numpy(rng.integers(0, 256, (19, 23, 8),
                                        dtype=np.uint8)).to(cuda)
    for c_out in (8, 5):
        mean = tuple(float(m) for m in rng.uniform(0.3, 0.6, c_out))
        std = tuple(float(s) for s in rng.uniform(0.2, 0.3, c_out))
        got = preprocess_kernel.normalize(img, mean, std)
        want = preprocess_kernel.normalize_plain(img, mean, std)
        assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(2, 320, 160, 24), (2, 10, 37, 24),
                                   (1, 12, 5, 24), (3, 2, 1, 24)])
def test_stem_kernel_batched(rng, cuda, shape):
    """Batch 2 at the serving shape; a ragged image (odd W2 = 37, 5 output
    rows: not a multiple of the 4 x 16 tile) at batch 2; an image smaller
    than one tile; a single output pixel per image. Within a bf16 step of
    the plain version."""
    xm = rng.normal(0, 1, shape).astype(np.float32)
    ks = rng.normal(0, np.sqrt(2 / 96), (2, 2, 24, 64)).astype(np.float32)
    k1 = rng.normal(0, np.sqrt(2 / 512), (2, 2, 128, 64)).astype(np.float32)
    bs = rng.normal(0, .1, 64).astype(np.float32)
    b1 = rng.normal(0, .1, 64).astype(np.float32)
    bf = torch.bfloat16
    xm, ks, k1 = (torch.from_numpy(a).to(cuda, bf) for a in (xm, ks, k1))
    bs, b1 = torch.from_numpy(bs).to(cuda), torch.from_numpy(b1).to(cuda)
    ksp, k1p = mma_pack.pack_stem_mma(ks), mma_pack.pack_stage1_mma(k1)
    got = _launched(stem_kernel.KERNEL,
                    lambda: stem_kernel.fused_stem_stage1(
                        xm, ksp, bs, k1p, b1)).float()
    want = stem_kernel.fused_stem_stage1_plain(xm, ks, bs, k1, b1).float()
    assert got.shape == (shape[0], shape[1] // 2, shape[2], 64)
    assert bool(((got - want).abs() <= 1e-2 * (1 + want.abs())).all())
    with pytest.raises(ValueError):  # the blocked kernels are the CPU's
        stem_kernel.fused_stem_stage1(xm, ks, bs, k1, b1)


GRIDS, STRIDES = (160, 80, 40), (4, 8, 16)


def _lift(rng, cls, cells, logits):
    """Set one class logit of each of ``cells`` (flat over the
    concatenated levels of every image) to ``logits``."""
    flat = np.concatenate([c.reshape(c.shape[0], -1, c.shape[-1])
                           for c in cls], axis=1)
    for b in range(flat.shape[0]):
        flat[b, cells[b], rng.integers(0, flat.shape[-1], len(cells[b]))] = (
            logits[b])
    at = 0
    for c in cls:
        n = c.shape[1] * c.shape[2]
        c.reshape(c.shape[0], n, -1)[:] = flat[:, at:at + n]
        at += n


def _decode_levels(rng, b, case, grids=GRIDS, k=1024):
    """(cls, reg) per level on the host for one of the decode cases."""
    cells = sum(g * g for g in grids)
    mu, sd = (0.0, 3.0) if case == "all_valid" else (-6.0, 1.0)
    cls = [rng.normal(mu, sd, (b, g, g, 4)).astype(np.float32)
           for g in grids]
    reg = [rng.uniform(0.1, 3.0, (b, g, g, 4)).astype(np.float32)
           for g in grids]
    n = {"ties": 300, "exact_k": k, "k_plus_1": k + 1, "ragged": 40,
         "all_valid": 0, "empty": 0}[case]
    if n:
        picks = [rng.choice(cells, n, replace=False) for _ in range(b)]
        # saturated logits (score exactly 1.0, tied) on a third of them,
        # two levels of moderate ties on the rest
        logits = [np.where(np.arange(n) % 3 == 0, 40.0,
                           np.where(np.arange(n) % 3 == 1, 2.0, 1.0))
                  for _ in range(b)]
        _lift(rng, cls, picks, logits)
    return list(zip(cls, reg))


def _check_decode(levels, strides, k, cuda):
    """The kernel on the card vs its plain version: every field equal
    bit for bit, one launch. -> the kernel's fields."""
    outs = [(torch.from_numpy(c).to(cuda), torch.from_numpy(r).to(cuda))
            for c, r in levels]
    got = _launched(decode_kernel.KERNEL, lambda: decode_kernel.decode_topk(
        outs, strides, 0.5, 0.2116, k))
    want = decode_kernel.decode_topk_plain(outs, strides, 0.5, 0.2116, k)
    for name, g, w in zip(("boxes", "scores", "classes", "valid"), got,
                          want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), f"{name} differ"
    return got


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("case,grids,k", [
    ("all_valid", GRIDS, 1024), ("ties", GRIDS, 1024),
    ("empty", GRIDS, 1024), ("exact_k", GRIDS, 1024),
    ("k_plus_1", GRIDS, 1024), ("ragged", (37, 19, 10), 1024),
    ("ties", (37, 19, 10), 100)])
def test_decode_kernel_matches_plain(cuda, b, case, grids, k):
    """One launch decodes and compacts every level of B images, bit for
    bit the plain version in all four fields, the invalid slots included:
    n > K (random all-valid levels), saturated ties spread across levels
    and blocks, n = 0, n exactly K and K + 1, levels whose cell counts are
    no multiple of the block (and K = 100 there)."""
    rng = np.random.default_rng([b, k, *grids, *case.encode()])
    levels = _decode_levels(rng, b, case, grids, k)
    _, scores, _, valid = _check_decode(levels, STRIDES, k, cuda)
    n = {"empty": 0, "exact_k": k, "k_plus_1": k, "all_valid": k,
         "ties": min(k, 300), "ragged": 40}[case]
    assert valid.sum(dim=1).tolist() == [n] * b
    if case == "ties":
        assert bool((scores[:, 0] == 1.0).all())


def test_decode_kernel_on_served_head_outputs(cuda):
    """The shipped engine's head outputs for 8 scenes, at B = 1 and 8: as
    served (every level contiguous: the int8 conv writes P3's and P4's
    4-wide preds as they are), and with P3 and P4 as channel-slice views
    with a cell stride of 8 (the 8-wide integer product sliced, as the
    int8 layers gave them before their kernel): bit for bit the plain
    version, read without copies."""
    art = ServingArtifact(ARTIFACT)
    frames = np.stack([np.ascontiguousarray(generate_image(
        np.random.default_rng(s), SynthConfig(image_size=640, seed=s))[0][
            ..., ::-1]) for s in range(1, 9)])
    mean, std = preprocess_kernel.channel_constants(24)
    with torch.inference_mode():
        x = preprocess_kernel.normalize(
            torch.from_numpy(merged_frame_np(frames)).to(cuda), mean, std,
            out_dtype=torch.bfloat16)
        for xb in (x[:1], x):
            served = art.model(xb)
            assert all(t.is_contiguous() for lvl in served for t in lvl)

            def sliced(t):   # a cell stride of 8, read as it lies
                wide = torch.zeros((*t.shape[:-1], 8), dtype=t.dtype,
                                   device=t.device)
                wide[..., :t.shape[-1]] = t
                return wide[..., :t.shape[-1]]

            views = [served[0]] + [tuple(sliced(t) for t in lvl)
                                   for lvl in served[1:]]
            assert not views[1][0].is_contiguous()
            for outs in (served, views):
                got = _launched(decode_kernel.KERNEL,
                                lambda: decode_kernel.decode_topk(
                                    outs, STRIDES, 0.5, 0.2116, 1024))
                want = decode_kernel.decode_topk_plain(outs, STRIDES, 0.5,
                                                       0.2116, 1024)
                assert all(torch.equal(g, w) for g, w in zip(got, want))
                assert bool((got[3].sum(dim=1) > 0).all())


def test_decode_kernel_relaunch_and_graph_replay(cuda):
    """The per-image ticket and counter reset themselves: two launches in
    a row and three replays of a captured CUDA graph give equal outputs
    (n > K at B = 8, where the radix select runs), and so does a launch on
    the capture stream between the capture (which made that stream's
    scratch) and the first replay."""
    rng = np.random.default_rng(9)
    levels = [(torch.from_numpy(c).to(cuda), torch.from_numpy(r).to(cuda))
              for c, r in _decode_levels(rng, 8, "all_valid")]

    def run():
        return decode_kernel.decode_topk(levels, STRIDES, 0.5, 0.2116, 1024)

    first, second = run(), run()
    want = decode_kernel.decode_topk_plain(levels, STRIDES, 0.5, 0.2116,
                                           1024)
    assert all(torch.equal(a, w) and torch.equal(b, w)
               for a, b, w in zip(first, second, want))
    torch.cuda.synchronize()
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    with torch.cuda.graph(graph, stream=stream):
        out = run()
    with torch.cuda.stream(stream):
        eager = run()
    torch.cuda.synchronize()
    assert all(torch.equal(e, w) for e, w in zip(eager, want))
    for _ in range(3):
        for t in out:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, w) for o, w in zip(out, want))


def test_decode_kernel_two_streams_at_once(cuda):
    """Launches on two streams at once (n > K at B = 1 on 33,600 cells,
    the engines' shape, where the select runs longest), each stream with
    its own inputs: every output bit for bit its plain version, so the
    streams do not share a ticket or a counter."""
    rng = np.random.default_rng(11)
    sets = [[(torch.from_numpy(c).to(cuda), torch.from_numpy(r).to(cuda))
             for c, r in _decode_levels(rng, 1, "all_valid")]
            for _ in range(2)]
    wants = [decode_kernel.decode_topk_plain(lv, STRIDES, 0.5, 0.2116, 1024)
             for lv in sets]
    streams = [torch.cuda.Stream() for _ in sets]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for got, stream, lv in zip(outs, streams, sets):
            with torch.cuda.stream(stream):
                got.append(decode_kernel.decode_topk(lv, STRIDES, 0.5,
                                                     0.2116, 1024))
    torch.cuda.synchronize()
    for got, want in zip(outs, wants):
        assert all(torch.equal(g, w) for call in got
                   for g, w in zip(call, want))


def _crowd(rng, k, span):
    """k boxes of 20-60 px with centres inside a ``span`` px square."""
    centers = rng.uniform(50, 50 + span, (k, 2))
    wh = rng.uniform(20, 60, (k, 2))
    return np.concatenate([centers - wh / 2, centers + wh / 2], -1)


@pytest.mark.parametrize("k", [1024, 100, 37])
def test_nms_kernel_exact(cuda, k):
    """Random boxes with a prefix mask, and a 60-deep (K = 37: 37-deep)
    suppression chain at IoU 0.5: exact for any chain depth."""
    rng = np.random.default_rng(3)
    centers = rng.uniform(50, 590, (k, 2))
    wh = rng.uniform(5, 60, (k, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1)
    depth = min(60, k)
    chain = np.zeros((k, 4))
    for i in range(depth):
        chain[i] = (6.0 * i, 0, 6.0 * i + 18.0, 18.0)
    for b, cls, n, thr in ((boxes, rng.integers(0, 4, k), k - 20, 0.45),
                           (chain, np.zeros(k), depth, 0.3)):
        bt = torch.tensor(b, dtype=torch.float32, device=cuda)
        ct = torch.tensor(cls, dtype=torch.int32, device=cuda)
        vt = torch.arange(k, device=cuda) < n
        got = _launched(nms_kernel.KERNEL,
                        lambda: nms_kernel.nms_keep(bt, ct, vt, thr))
        assert got.shape == (k,) and got.dtype == torch.bool
        assert torch.equal(got, nms_kernel.nms_keep_plain(bt, ct, vt, thr))
    assert got[:6].tolist() == [True, False, True, False, True, False]


@pytest.mark.parametrize("k,n_valid", [
    (1024, 0), (1024, 1), (1024, 31), (1024, 33), (1024, 96), (1024, 97),
    (1024, 256), (1024, 257), (1024, 1024), (100, 70), (100, 100), (37, 30),
    (37, 37), (1, 1)])
def test_nms_kernel_scattered_mask_exact(cuda, k, n_valid):
    """Valid slots scattered over all K, either side of the 96-candidate
    step between one block and the whole cluster, K not a multiple of 32:
    the keep mask is the plain version's, and one call is one launch."""
    rng = np.random.default_rng(1000 * k + n_valid)
    bt = torch.tensor(_crowd(rng, k, 40 + 12 * int(np.sqrt(n_valid))),
                      dtype=torch.float32, device=cuda)
    ct = torch.tensor(rng.integers(0, 4, k), dtype=torch.int32, device=cuda)
    valid = np.zeros(k, bool)
    valid[rng.choice(k, n_valid, replace=False)] = True
    vt = torch.from_numpy(valid).to(cuda)
    got = _launched(nms_kernel.KERNEL,
                    lambda: nms_kernel.nms_keep(bt, ct, vt, 0.45))
    want = nms_kernel.nms_keep_plain(bt, ct, vt, 0.45)
    assert torch.equal(got, want)
    if n_valid > 30:
        assert 0 < int(got.sum()) < n_valid   # something was suppressed


def test_nms_kernel_one_class_long_chain(cuda):
    """All 1024 candidates of one class in one crowd (most are suppressed),
    and a 1024-deep chain: every word's fixed point runs its full depth."""
    rng = np.random.default_rng(5)
    k = 1024
    ct = torch.zeros(k, dtype=torch.int32, device=cuda)
    vt = torch.ones(k, dtype=torch.bool, device=cuda)
    bt = torch.tensor(_crowd(rng, k, 300), dtype=torch.float32, device=cuda)
    got = nms_kernel.nms_keep(bt, ct, vt, 0.45)
    assert torch.equal(got, nms_kernel.nms_keep_plain(bt, ct, vt, 0.45))
    chain = np.array([(6.0 * i, 0, 6.0 * i + 18.0, 18.0) for i in range(k)])
    bt = torch.tensor(chain, dtype=torch.float32, device=cuda)
    got = nms_kernel.nms_keep(bt, ct, vt, 0.3)
    assert torch.equal(got, nms_kernel.nms_keep_plain(bt, ct, vt, 0.3))
    assert got.tolist() == [i % 2 == 0 for i in range(k)]


def _scenes(seeds):
    return np.stack([np.ascontiguousarray(generate_image(
        np.random.default_rng(s), SynthConfig(image_size=640, seed=s))[0][
            ..., ::-1]) for s in seeds])


def _camera_scenes(seeds):
    """Synthetic 1080x1920 scenes as the camera ring delivers them: BGRA."""
    out = []
    for s in seeds:
        bgr = generate_image(np.random.default_rng(s), SynthConfig(
            image_size=1080, image_width=1920, seed=s))[0]
        out.append(np.concatenate([bgr, np.full((1080, 1920, 1), 255,
                                                np.uint8)], axis=-1))
    return out


def test_serving_path_launches_one_of_each(cuda):
    """One eagerly served frame is one launch each of normalize (bf16 out:
    the backbone's cast is a no-op), the fused stem, decode and NMS, and
    one int8 conv launch a layer of the int8 chain, one SPPF launch and
    nine of the concat kernel; a served batch of 8 too."""
    kernels = (preprocess_kernel.KERNEL, stem_kernel.KERNEL,
               decode_kernel.KERNEL, nms_kernel.KERNEL,
               int8_conv_kernel.KERNEL, sppf_kernel.KERNEL,
               qconcat_kernel.KERNEL)
    for art, frames in ((ServingArtifact(ARTIFACT, graph=False),
                         _scenes([7])[0]),
                        (ServingArtifact(ARTIFACT_B8, graph=False),
                         _scenes(range(1, 9)))):
        art(frames)
        before = [kern.launches for kern in kernels]
        art(frames)
        torch.cuda.synchronize()
        assert [kern.launches - b for kern, b in zip(kernels, before)] == [
            1, 1, 1, 1, INT8_LAYERS, *INT8_GLUE.values()]


def _match(got, want, box_px=0.5, score_tol=1e-2):
    """Same valid count; each of ``want``'s detections has a box of its
    class in ``got`` within ``box_px`` and ``score_tol``."""
    gv, wv = got.valid.cpu().numpy(), want.valid.cpu().numpy()
    assert gv.sum() == wv.sum() >= 1
    gb, gc = got.boxes.cpu().numpy()[gv], got.classes.cpu().numpy()[gv]
    gs = got.scores.cpu().numpy()[gv]
    for box, klass, score in zip(want.boxes.cpu().numpy()[wv],
                                 want.classes.cpu().numpy()[wv],
                                 want.scores.cpu().numpy()[wv]):
        err = np.abs(gb - box).max(axis=1) + 1e9 * (gc != klass)
        j = int(err.argmin())
        assert err[j] <= box_px and abs(gs[j] - score) <= score_tol


def test_batch_artifact_matches_batch1_path(cuda):
    """The b8 artifact serves 8 scenes in one call; each image matches the
    card's batch-1 path on the same frame (the bf16 convolutions may round
    differently at another batch: same count, boxes within 0.5 px, scores
    within 1e-2)."""
    frames = _scenes(range(1, 9))
    got = ServingArtifact(ARTIFACT_B8)(frames)
    assert got.boxes.shape == (8, 1024, 4)
    one = ServingArtifact(ARTIFACT)
    for b in range(8):
        _match(td.Detections(*(f[b] for f in got)), one(frames[b]))


def test_batched_nms_kernel_exact(cuda):
    """Eight images of scattered candidate sets in one launch, either side
    of the one-block step, one with none valid: the plain version's keep
    mask, image by image."""
    rng = np.random.default_rng(17)
    k = 1024
    n_valid = (0, 29, 96, 97, 300, 1024, 5, 700)
    bt = torch.tensor(np.stack([_crowd(rng, k, 40 + 12 * int(np.sqrt(n)))
                                for n in n_valid]), dtype=torch.float32,
                      device=cuda)
    ct = torch.tensor(rng.integers(0, 4, (8, k)), dtype=torch.int32,
                      device=cuda)
    valid = np.zeros((8, k), bool)
    for b, n in enumerate(n_valid):
        valid[b, rng.choice(k, n, replace=False)] = True
    vt = torch.from_numpy(valid).to(cuda)
    got = _launched(nms_kernel.KERNEL,
                    lambda: nms_kernel.nms_keep(bt, ct, vt, 0.45))
    assert got.shape == (8, k)
    assert torch.equal(got, nms_kernel.nms_keep_plain(bt, ct, vt, 0.45))
    for b in range(8):
        assert torch.equal(got[b], nms_kernel.nms_keep(bt[b], ct[b], vt[b],
                                                       0.45))


def test_served_artifact_matches_cpu_port(cuda):
    img, labels = generate_image(np.random.default_rng(7),
                                 SynthConfig(image_size=640, seed=7))
    rgb = np.ascontiguousarray(img[..., ::-1])
    gpu = ServingArtifact(ARTIFACT)(rgb)
    cpu = ServingArtifact(ARTIFACT, device="cpu")(rgb)
    gv, cv = gpu.valid.cpu().numpy(), cpu.valid.numpy()
    assert gv.sum() == cv.sum() >= 1
    gb, gc = gpu.boxes.cpu().numpy()[gv], gpu.classes.cpu().numpy()[gv]
    cb, cc = cpu.boxes.numpy()[cv], cpu.classes.numpy()[cv]
    for box, klass in zip(cb, cc):
        err = np.abs(gb - box).max(axis=1) + 1e9 * (gc != klass)
        assert err.min() <= 0.5


def _bf16_steps(got, want):
    """|got - want| in bf16 steps of |want| (elementwise max)."""
    got, want = got.float(), want.float()
    step = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-30))))
    return float(((got - want).abs() / (step / 128)).max())


def _camera_frame(rng, geom):
    return torch.from_numpy(rng.integers(0, 256, geom.frame_shape,
                                         dtype=np.uint8))


# the lookup form (every weight 0 or 1), exact: the served geometry first
CAMERA_LOOKUP = [
    (1080, 1920, "bgra", 640, True),
    (1080, 1920, "rgb", 640, True),       # 3-byte pixels, unaligned span
    (640, 640, "rgb", 640, True),         # ratio 1, no pad
    (2160, 3840, "bgra", 1280, True),     # 15 KB rows: two staged steps
    (3840, 2160, "bgra", 1280, True),     # steps with pad columns
]
# then the division form (fractional weights, NV12)
CAMERA_GEOMETRIES = CAMERA_LOOKUP + [
    (1080, 1920, "bgra", 640, False),
    (720, 1280, "rgb", 640, True),
    (480, 640, "nv12", 640, True),
    (38, 54, "nv12", 40, False),          # ragged, upsampled
    (722, 1282, "rgb", 640, True),        # rows of 3,846 B
    (1282, 722, "rgb", 640, True),        # portrait: pad columns
    (2160, 3840, "bgra", 640, True),      # ratio 6: weights 1/2
    (3840, 2160, "bgra", 640, True),
]


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,w,fmt,size,letterbox", CAMERA_GEOMETRIES)
def test_camera_kernel_matches_plain(rng, cuda, h, w, fmt, size, letterbox,
                                     out_dtype):
    """The camera kernel against its plain version (colour, the two
    interpolation matmuls in full f32, the 114 canvas, normalise): bit for
    bit in the lookup form (every weight 0 or 1, as at the served
    geometry); elsewhere within one bf16 step (bf16 out) and 1e-5 (f32
    out) of the plain version run on the CPU (on the card its matmuls sum
    in another order, and where x / 255 cancels against the mean that is
    many bf16 steps of a result near 0). One call is one launch."""
    geom = camera_kernel.CameraGeometry(h, w, fmt, size, letterbox)
    pre = camera_kernel.CameraPreprocess(geom, out_dtype).to(cuda)
    frame = _camera_frame(rng, geom).to(cuda)
    got = _launched(camera_kernel.KERNEL, lambda: pre(frame))
    want = camera_kernel.camera_preprocess_plain(frame, geom,
                                                 out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (size, size, 3)
    assert pre.table is ((h, w, fmt, size, letterbox) in CAMERA_LOOKUP)
    if pre.table:
        assert torch.equal(got, want)
    else:
        ref = camera_kernel.camera_preprocess_plain(
            frame.cpu(), geom, out_dtype=out_dtype).to(cuda)
        if out_dtype == torch.bfloat16:
            assert _bf16_steps(got, ref) <= 1.0
        else:
            assert float((got - ref).abs().max()) <= 1e-5
    _, new_h, new_w, pad_y, pad_x = geom.window
    if letterbox and pad_y:   # the pad rows are the normalised 114
        assert torch.equal(got[:pad_y], want[:pad_y])


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,w,fmt,size,letterbox", CAMERA_GEOMETRIES)
def test_camera_kernel_pad_region_exact(rng, cuda, h, w, fmt, size,
                                        letterbox, out_dtype):
    """Outside the resized window (pad rows and pad columns) the kernel
    writes the plain version's normalised 114 bit for bit, whatever the
    frame holds."""
    geom = camera_kernel.CameraGeometry(h, w, fmt, size, letterbox)
    pre = camera_kernel.CameraPreprocess(geom, out_dtype).to(cuda)
    frame = _camera_frame(rng, geom).to(cuda)
    got = pre(frame)
    want = camera_kernel.camera_preprocess_plain(frame, geom,
                                                 out_dtype=out_dtype)
    _, new_h, new_w, pad_y, pad_x = geom.window
    pad = torch.ones((size, size), dtype=torch.bool, device=cuda)
    pad[pad_y:pad_y + new_h, pad_x:pad_x + new_w] = False
    assert torch.equal(got[pad], want[pad])
    assert int(pad.sum()) == size * size - new_h * new_w


@pytest.mark.parametrize("letterbox,kernel", [
    (True, "camera_preprocess_kernel"), (False, "camera_pixel_kernel")])
def test_camera_kernel_one_launch_in_a_graph(cuda, letterbox, kernel):
    """Captured into a CUDA graph, one call is one kernel node (the form's
    camera kernel: the served letterbox takes the lookup form, the stretch
    the division form) and nothing else; the replay equals the eager
    call."""
    geom = camera_kernel.CameraGeometry(1080, 1920, "bgra", 640, letterbox)
    pre = camera_kernel.CameraPreprocess(geom, torch.bfloat16).to(cuda)
    frame = _camera_frame(np.random.default_rng(9), geom).to(cuda)
    want = pre(frame)
    graph, stream = torch.cuda.CUDAGraph(keep_graph=True), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    before = camera_kernel.KERNEL.launches
    with torch.cuda.graph(graph, stream=stream):
        got = pre(frame)
    assert camera_kernel.KERNEL.launches == before + 1
    nodes = aot.graph_nodes(graph.raw_cuda_graph())
    assert len(nodes) == 1 and nodes[0][0] == "kernel"
    assert kernel in nodes[0][1]
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert camera_kernel.KERNEL.launches == before + 1


def test_camera_artifact_matches_cpu_port(cuda):
    """The camera artifact on the card (its graph) against the port's CPU
    path on the seed-7 1080x1920 BGRA scene: the same count, boxes within
    1.5 camera px, scores within 1e-2."""
    bgra = _camera_scenes([7])[0]
    gpu = ServingArtifact(ARTIFACT_CAM)(bgra)
    cpu = ServingArtifact(ARTIFACT_CAM, device="cpu")(bgra)
    gv, cv = gpu.valid.cpu().numpy(), cpu.valid.numpy()
    assert gv.sum() == cv.sum() >= 1
    gb, gc, gs = (a.cpu().numpy()[gv] for a in (gpu.boxes, gpu.classes,
                                                 gpu.scores))
    cb, cc, cs = (a.numpy()[cv] for a in (cpu.boxes, cpu.classes,
                                           cpu.scores))
    for box, klass, score in zip(cb, cc, cs):
        err = np.abs(gb - box).max(axis=1) + 1e9 * (gc != klass)
        j = int(err.argmin())
        assert err[j] <= 1.5 and abs(gs[j] - score) <= 1e-2


def _within(got, want, rel=1e-2):
    """|err| <= rel * (1 + |ref|) everywhere (bf16 rounding steps)."""
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= rel * (1 + want.abs())).all())


def _act(rng, shape, cuda):
    """Post-ReLU-like bf16 activations."""
    a = np.maximum(rng.normal(0, 1, shape), 0).astype(np.float32)
    return torch.from_numpy(a).to(cuda, torch.bfloat16)


def _kb(rng, shape):
    fan = int(np.prod(shape[:-1]))
    return (rng.normal(0, np.sqrt(2 / fan), shape).astype(np.float32),
            rng.normal(0, .1, shape[-1]).astype(np.float32))


def _to(ws, cuda):
    return [w.to(cuda) for w in ws]


@pytest.mark.parametrize("shape", [(2, 320, 160, 64), (1, 6, 5, 64),
                                   (2, 10, 37, 64), (3, 2, 1, 64)])
def test_stage1_kernel_batched(rng, cuda, shape):
    """Batch 2 at the serving shape; an image smaller than one 4 x 16
    tile; a ragged one (W2 = 37, not a multiple of 8, 5 output rows); a
    single output pixel per image."""
    xm = _act(rng, shape, cuda)
    wb, b = _kb(rng, (2, 2, 128, 64))
    wb = torch.from_numpy(wb).to(cuda, torch.bfloat16)
    b = torch.from_numpy(b).to(cuda)
    packed = mma_pack.pack_stage1_mma(wb)
    got = _launched(stage1_kernel.KERNEL,
                    lambda: stage1_kernel.fused_downsample_merged(
                        xm, packed, b))
    want = stage1_kernel.fused_downsample_merged_plain(xm, wb, b)
    assert got.shape == (shape[0], shape[1] // 2, shape[2], 64)
    assert _within(got, want)
    with pytest.raises(ValueError):  # the blocked kernel is the CPU's
        stage1_kernel.fused_downsample_merged(xm, wb, b)


def _c3k2_weights(rng, cin, n, cuda, ca=0):
    """``pack_c3k2_weights``' operands on the card, and the kernel's B-tile
    image of them (split at ``ca`` for the pair form)."""
    hd, f = c3k2_kernel.KERNEL_HID, c3k2_kernel.KERNEL_F
    ws = c3k2_kernel.pack_c3k2_weights(
        _kb(rng, (1, 1, cin, hd)), _kb(rng, (1, 1, cin, hd)),
        _kb(rng, (1, 1, 2 * hd, f)),
        [(_kb(rng, (1, 1, hd, hd)), _kb(rng, (3, 3, hd, hd)))
         for _ in range(n)], torch.bfloat16)
    ws = _to(ws, cuda)
    return ws, mma_pack.pack_c3k2_mma(ws[0], ws[6], ws[2], ws[4], ws[8], ca)


@pytest.mark.parametrize("shape,n,shortcut", [((2, 160, 160, 64), 1, True),
                                              ((1, 37, 45, 64), 2, False),
                                              ((1, 6, 5, 64), 1, True),
                                              ((2, 6, 5, 24), 2, True)])
def test_c3k2_kernel(rng, cuda, shape, n, shortcut):
    """Batch 2 at the stage1_block shape; a ragged 37 x 45 image with two
    bottlenecks covers the tile edges and the 2-pixel halo; images smaller
    than one 8 x 16 tile, one of them with Cin = 24 (a zero-filled K
    chunk)."""
    x = _act(rng, shape, cuda)
    ws, wpk = _c3k2_weights(rng, shape[-1], n, cuda)
    got = _launched(c3k2_kernel.KERNEL, lambda: c3k2_kernel.fused_c3k2(
        x, *ws, shortcut=shortcut, wpk=wpk))
    want = c3k2_kernel.fused_c3k2_plain(x, *ws, shortcut=shortcut)
    assert got.shape == (*shape[:-1], 64)
    assert _within(got, want)
    with pytest.raises(ValueError):  # the B tiles are the card's operand
        c3k2_kernel.fused_c3k2(x, *ws, shortcut=shortcut)


@pytest.mark.parametrize("hb,wb_,up_a,n,ca", [(160, 160, True, 1, 64),
                                              (38, 46, True, 2, 64),
                                              (37, 45, False, 1, 64),
                                              (6, 4, True, 1, 64),
                                              (6, 5, False, 2, 72)])
def test_c3k2_cat_kernel(rng, cuda, hb, wb_, up_a, n, ca):
    """Batch 2 at the fpn_c3k2_2 shapes (xa 80^2 upsampled, xb 160^2),
    ragged images with and without the upsample, and images smaller than
    one tile (one with Ca = 72: two xa chunks, the second zero-filled)."""
    sa = (hb // 2, wb_ // 2) if up_a else (hb, wb_)
    xa = _act(rng, (2, *sa, ca), cuda)
    xb = _act(rng, (2, hb, wb_, 64), cuda)
    ws, wpk = _c3k2_weights(rng, ca + 64, n, cuda, ca)
    got = _launched(c3k2_kernel.KERNEL_CAT,
                    lambda: c3k2_kernel.fused_c3k2_cat(xa, xb, *ws,
                                                       up_a=up_a, wpk=wpk))
    want = c3k2_kernel.fused_c3k2_cat_plain(xa, xb, *ws, up_a=up_a)
    assert got.shape == (2, hb, wb_, 64)
    assert _within(got, want)


@pytest.mark.parametrize("hb,wb_,up_a,n,ca,shortcut",
                         [(37, 45, False, 2, 0, True),
                          (38, 46, True, 2, 64, True),
                          (37, 45, False, 2, 72, False),
                          (22, 18, True, 1, 8, True)])
def test_c3k2_kernels_bit_exact_on_grid_inputs(rng, cuda, hb, wb_, up_a, n,
                                               ca, shortcut):
    """Inputs on binary grids (activations k/2, sparse weights k/4, biases
    k/8) make every f32 sum exact in any order, so the kernel must equal
    the plain version bit for bit: any difference is a fault of tiling,
    masking or a rounding point, not of summation order. ``ca`` = 0 is the
    single form."""
    def act(shape):
        a = (rng.integers(0, 5, shape) * 0.5).astype(np.float32)
        return torch.from_numpy(a).to(cuda, torch.bfloat16)

    def kb(shape):
        fan = int(np.prod(shape[:-1]))
        k = np.where(rng.random(shape) < min(1.0, 8 / fan),
                     rng.choice([-.5, -.25, .25, .5], shape), 0.0)
        return (k.astype(np.float32),
                (rng.integers(-2, 3, shape[-1]) / 8).astype(np.float32))

    hd, f = c3k2_kernel.KERNEL_HID, c3k2_kernel.KERNEL_F
    ws = _to(c3k2_kernel.pack_c3k2_weights(
        kb((1, 1, ca + 64, hd)), kb((1, 1, ca + 64, hd)),
        kb((1, 1, 2 * hd, f)),
        [(kb((1, 1, hd, hd)), kb((3, 3, hd, hd))) for _ in range(n)],
        torch.bfloat16), cuda)
    wpk = mma_pack.pack_c3k2_mma(ws[0], ws[6], ws[2], ws[4], ws[8], ca)
    xb = act((2, hb, wb_, 64))
    if ca:
        xa = act((2, hb // 2, wb_ // 2, ca) if up_a else (2, hb, wb_, ca))
        got = c3k2_kernel.fused_c3k2_cat(xa, xb, *ws, shortcut=shortcut,
                                         up_a=up_a, wpk=wpk)
        want = c3k2_kernel.fused_c3k2_cat_plain(xa, xb, *ws,
                                                shortcut=shortcut, up_a=up_a)
    else:
        got = c3k2_kernel.fused_c3k2(xb, *ws, shortcut=shortcut, wpk=wpk)
        want = c3k2_kernel.fused_c3k2_plain(xb, *ws, shortcut=shortcut)
    torch.cuda.synchronize()
    assert float(want.float().abs().max()) > 1.0   # not a degenerate case
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(2, 160, 160, 64), (1, 37, 45, 64),
                                   (1, 3, 5, 64), (2, 16, 21, 64)])
def test_head_kernel(rng, cuda, shape):
    """Batch 2 at the head_p2 shape, a ragged image, one smaller than an
    8 x 16 tile and one whose W is not a multiple of 8; the f32 preds
    within 1e-2 (1 + |ref|) of the plain version."""
    x = _act(rng, shape, cuda)
    ws = head_kernel.pack_head_weights(
        [_kb(rng, (3, 3, 64, 64)), _kb(rng, (3, 3, 64, 64))],
        _kb(rng, (1, 1, 64, 4)),
        [_kb(rng, (3, 3, 64, 64)), _kb(rng, (3, 3, 64, 64))],
        _kb(rng, (1, 1, 64, 4)), torch.bfloat16)
    ws = _to(ws, cuda)
    w33 = mma_pack.pack_head_mma(ws[0], ws[6], ws[2], ws[8], ws[4],
                                 ws[10])
    cls, reg = _launched(head_kernel.KERNEL,
                         lambda: head_kernel.fused_head(x, *ws, w33=w33))
    wc, wr = head_kernel.fused_head_plain(x, *ws)
    assert cls.dtype == reg.dtype == torch.float32
    assert cls.shape == reg.shape == (*shape[:-1], 4)
    assert cls.is_contiguous() and reg.is_contiguous()
    assert _within(cls, wc) and _within(reg, wr)


# ---- the wide forms (hidden != 32 or F != 64; head width != 64) ----

def _grid_act(rng, shape, cuda):
    """Activations on a binary grid (k/2): with grid weights every f32
    sum is exact in any order."""
    a = (rng.integers(0, 5, shape) * 0.5).astype(np.float32)
    return torch.from_numpy(a).to(cuda, torch.bfloat16)


def _grid_kb(rng, shape):
    fan = int(np.prod(shape[:-1]))
    k = np.where(rng.random(shape) < min(1.0, 8 / fan),
                 rng.choice([-.5, -.25, .25, .5], shape), 0.0)
    return (k.astype(np.float32),
            (rng.integers(-2, 3, shape[-1]) / 8).astype(np.float32))


def _wide_c3k2_weights(rng, cin, hd, f, n, cuda, ca=0, kb=_kb):
    ws = _to(c3k2_kernel.pack_c3k2_weights(
        kb(rng, (1, 1, cin, hd)), kb(rng, (1, 1, cin, hd)),
        kb(rng, (1, 1, 2 * hd, f)),
        [(kb(rng, (1, 1, hd, hd)), kb(rng, (3, 3, hd, hd)))
         for _ in range(n)], torch.bfloat16), cuda)
    return ws, mma_pack.pack_c3k2_mma(ws[0], ws[6], ws[2], ws[4], ws[8], ca)


# (batch, H, W, Cin, hidden, F, n): stage2_c3k2 and stage3_c3k2 of the bf16
# engines at 640, stage1_block and stage3_c3k2 of a base-16 engine, then
# ragged images that cut the 8 x 8 tile's edges; base 64's stage3_c3k2
# (hidden 256: the owned plan, clusters of 4) at 640 and ragged, hidden 256
# with one bottleneck and with the widest input the plan takes (12
# planes); base 64's stage2_c3k2 (hidden 128 at 80 x 80: the owned plan,
# clusters of 2) and ragged batches large enough for that plan
WIDE_C3K2 = [(1, 80, 80, 128, 64, 128, 2), (1, 40, 40, 256, 128, 256, 2),
             (1, 160, 160, 32, 16, 32, 1), (1, 40, 40, 128, 64, 128, 2),
             (2, 37, 45, 128, 64, 128, 2), (2, 5, 3, 256, 128, 256, 1),
             (1, 13, 22, 64, 64, 128, 1), (2, 11, 9, 64, 128, 256, 2),
             (2, 9, 14, 40, 16, 32, 2), (1, 40, 40, 512, 256, 512, 2),
             (2, 11, 13, 512, 256, 512, 2), (2, 9, 14, 256, 256, 512, 1),
             (1, 17, 9, 768, 256, 512, 1), (1, 80, 80, 256, 128, 256, 2),
             (4, 37, 45, 128, 128, 256, 1), (2, 57, 61, 256, 128, 256, 2)]


@pytest.mark.parametrize("b,h,w,cin,hd,f,n", WIDE_C3K2)
def test_c3k2_wide_kernel(rng, cuda, b, h, w, cin, hd, f, n):
    """The wide form against the plain version: bit for bit on binary-grid
    inputs, within 1e-2 (1 + |ref|) on normal ones with one bottleneck
    (two chain far enough for a single bf16 flip to grow past that)."""
    x = _grid_act(rng, (b, h, w, cin), cuda)
    ws, wpk = _wide_c3k2_weights(rng, cin, hd, f, n, cuda, kb=_grid_kb)
    got = _launched(c3k2_kernel.KERNEL,
                    lambda: c3k2_kernel.fused_c3k2(x, *ws, wpk=wpk))
    want = c3k2_kernel.fused_c3k2_plain(x, *ws)
    assert got.shape == (b, h, w, f)
    assert float(want.float().abs().max()) > 1.0   # not a degenerate case
    assert torch.equal(got, want)
    if n == 1:
        x = _act(rng, (b, h, w, cin), cuda)
        ws, wpk = _wide_c3k2_weights(rng, cin, hd, f, n, cuda)
        got = c3k2_kernel.fused_c3k2(x, *ws, wpk=wpk)
        assert _within(got, c3k2_kernel.fused_c3k2_plain(x, *ws))


# (batch, H, W, Ca, Cb, hidden, F, up_a): fpn_c3k2_1, pan_c3k2_1 and
# pan_c3k2_2 of the bf16 engines at 640, fpn_c3k2_2 and pan_c3k2_2 of a
# base-16 engine, then ragged ones; base 64's pan_c3k2_2 (hidden 256, the
# owned plan) and fpn_c3k2_1 (hidden 128 at 80 x 80, the owned plan; xa at
# its coarse window) at 640 and ragged, hidden 256 upsampled, and base
# 64's pan_c3k2_1 (hidden 128 at 80 x 80)
WIDE_CAT = [(1, 80, 80, 128, 128, 64, 128, True),
            (1, 80, 80, 64, 128, 64, 128, False),
            (1, 40, 40, 128, 256, 128, 256, False),
            (1, 160, 160, 32, 32, 16, 32, True),
            (1, 40, 40, 64, 128, 64, 128, False),
            (2, 38, 46, 128, 128, 64, 128, True),
            (2, 37, 45, 64, 128, 64, 128, False),
            (2, 14, 22, 128, 64, 128, 256, True),
            (1, 6, 10, 8, 8, 16, 32, True),
            (1, 40, 40, 256, 512, 256, 512, False),
            (1, 80, 80, 256, 256, 128, 256, True),
            (2, 11, 13, 256, 512, 256, 512, False),
            (2, 14, 22, 256, 256, 128, 256, True),
            (2, 12, 18, 256, 256, 256, 512, True),
            (1, 80, 80, 128, 256, 128, 256, False)]


@pytest.mark.parametrize("b,h,w,ca,cb,hd,f,up", WIDE_CAT)
def test_c3k2_cat_wide_kernel(rng, cuda, b, h, w, ca, cb, hd, f, up):
    """The pair form's wide kernel against the plain version, bit for bit
    on binary-grid inputs and within 1e-2 (1 + |ref|) on normal ones."""
    sa = (h // 2, w // 2) if up else (h, w)
    for act, kb, exact in ((_grid_act, _grid_kb, True), (_act, _kb, False)):
        xa, xb = act(rng, (b, *sa, ca), cuda), act(rng, (b, h, w, cb), cuda)
        ws, wpk = _wide_c3k2_weights(rng, ca + cb, hd, f, 1, cuda, ca, kb)
        got = _launched(c3k2_kernel.KERNEL_CAT,
                        lambda: c3k2_kernel.fused_c3k2_cat(
                            xa, xb, *ws, up_a=up, wpk=wpk))
        want = c3k2_kernel.fused_c3k2_cat_plain(xa, xb, *ws, up_a=up)
        assert got.shape == (b, h, w, f)
        if exact:
            assert float(want.float().abs().max()) > 1.0
            assert torch.equal(got, want)
        else:
            assert _within(got, want)


def test_c3k2_wide_kernel_refuses_other_shapes(rng, cuda):
    """A width the wide form does not take raises, as does a window past
    shared memory: no fallback to the plain version."""
    x = _act(rng, (1, 8, 8, 64), cuda)
    ws, wpk = _wide_c3k2_weights(rng, 64, 64, 128, 1, cuda)
    bad = list(ws)
    bad[0] = bad[0][:, :40].contiguous()   # hidden 40, not a multiple of 16
    with pytest.raises(ValueError):
        c3k2_kernel.fused_c3k2(x, *bad, wpk=wpk)
    big = _act(rng, (1, 8, 8, 1024), cuda)
    ws, wpk = _wide_c3k2_weights(rng, 1024, 128, 256, 2, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        c3k2_kernel.fused_c3k2(big, *ws, wpk=wpk)


def _head_ws(rng, c, cuda, kb=_kb):
    ws = _to(head_kernel.pack_head_weights(
        [kb(rng, (3, 3, c, c)), kb(rng, (3, 3, c, c))], kb(rng, (1, 1, c, 4)),
        [kb(rng, (3, 3, c, c)), kb(rng, (3, 3, c, c))], kb(rng, (1, 1, c, 4)),
        torch.bfloat16), cuda)
    return ws, mma_pack.pack_head_mma(ws[0], ws[6], ws[2], ws[8], ws[4],
                                      ws[10])


@pytest.mark.parametrize("shape", [(1, 80, 80, 128), (1, 40, 40, 256),
                                   (1, 160, 160, 32), (1, 40, 40, 128),
                                   (2, 37, 45, 128), (2, 5, 3, 256),
                                   (1, 9, 17, 32), (2, 13, 6, 256),
                                   (1, 40, 40, 512), (2, 13, 7, 512),
                                   (1, 17, 18, 512), (1, 80, 80, 256),
                                   (4, 33, 25, 256)])
def test_head_wide_kernel(rng, cuda, shape):
    """head_p3 and head_p4 of the bf16 engines, head_p2 and head_p4 of a
    base-16 engine, ragged images at batch 2 and a narrow width, base 64's
    head_p4 (512: the owned plan, 8 x 16 tiles, clusters of 4) at 640 and
    ragged across three tile rows, base 64's head_p3 (the owned plan at
    256) and a ragged batch large enough for that plan: bit for bit on
    binary-grid inputs, within 1e-2 (1 + |ref|) on normal ones."""
    c = shape[-1]
    for act, kb, exact in ((_grid_act, _grid_kb, True), (_act, _kb, False)):
        x = act(rng, shape, cuda)
        ws, w33 = _head_ws(rng, c, cuda, kb)
        cls, reg = _launched(head_kernel.KERNEL,
                             lambda: head_kernel.fused_head(x, *ws, w33=w33))
        wc, wr = head_kernel.fused_head_plain(x, *ws)
        assert cls.shape == reg.shape == (*shape[:-1], 4)
        assert cls.is_contiguous() and reg.is_contiguous()
        if exact:
            assert torch.equal(cls, wc) and torch.equal(reg, wr)
        else:
            assert _within(cls, wc) and _within(reg, wr)


# a block's dynamic shared memory on the H100 (227 KB)
SMEM_OPTIN = 232448


def test_wide_planes_match_the_library(cuda):
    """The Python copies of the wide forms' shared-memory plans
    (``c3k2_kernel.wide_smem_bytes``, ``head_kernel.wide_smem_bytes``)
    equal the library's at every compiled (hidden, n) and head width, over
    inputs of 8 to 1,024 channels with and without an ``xa`` (upsampled
    or not); ``kernel_takes`` admits a block exactly where that plan fits
    in a block's 227 KB; widths the library is not compiled for give -1."""
    for hd in mma_pack.C3K2_SPLIT:
        for n in (1, 2):
            for cin in range(8, 1032, 8):
                for ca in (0, 8, 64, 128, 256, 512):
                    if ca >= cin:
                        continue
                    for up in (False, True) if ca else (False,):
                        smem = c3k2_kernel.wide_smem(ca, cin - ca, up, hd, n)
                        assert smem == c3k2_kernel.wide_smem_bytes(
                            ca, cin - ca, up, hd, n), (cin, ca, up, hd, n)
                        takes = c3k2_kernel.kernel_takes(cin, hd, 2 * hd, n,
                                                         ca, up)
                        assert takes == (smem <= SMEM_OPTIN), (
                            cin, ca, up, hd, n, smem)
    for hd in (32, 48, 96, 512):
        assert c3k2_kernel.wide_smem(0, 64, False, hd, 1) == -1
    for c in (16, 32, 48, 96, 128, 256, 512, 1024):
        smem = head_kernel.wide_smem(c)
        if c in mma_pack.HEAD_SPLIT:
            assert smem == head_kernel.wide_smem_bytes(c), (c, smem)
        else:
            assert smem == -1
        assert head_kernel.kernel_takes(c) == (
            c == 64 or 0 < smem <= SMEM_OPTIN), (c, smem)


def test_last_launch_records_the_grid(rng, cuda):
    """The library records the grid, cluster, threads and shared memory of
    each launch as it made it: the tiled C3k2 one block a tile where the
    tiles are fewer than the SMs, the wide C3k2 at stage3_c3k2 one cluster
    of four per 8 x 8 tile, the wide head at head_p4 one cluster of two per
    tile and branch; base 64's owned plans as ``wide_launch`` gives them."""
    x = _act(rng, (2, 37, 45, 64), cuda)
    ws, wpk = _wide_c3k2_weights(rng, 64, 32, 64, 1, cuda)
    c3k2_kernel.fused_c3k2(x, *ws, wpk=wpk)
    rec = c3k2_kernel.last_launch()
    assert rec["grid"] == [2 * 5 * 3, 1, 1]   # 8 x 16 tiles, < the SMs
    assert rec["cluster"] == [1, 1, 1] and rec["threads"] == 256
    x = _act(rng, (1, 40, 40, 256), cuda)
    ws, wpk = _wide_c3k2_weights(rng, 256, 128, 256, 2, cuda)
    c3k2_kernel.fused_c3k2(x, *ws, wpk=wpk)
    assert c3k2_kernel.last_launch() == dict(
        grid=[25 * 4, 1, 1], cluster=[4, 1, 1], threads=256,
        smem_bytes=c3k2_kernel.wide_smem(0, 256, False, 128, 2))
    ws, w33 = _head_ws(rng, 256, cuda)
    head_kernel.fused_head(x, *ws, w33=w33)
    torch.cuda.synchronize()
    assert head_kernel.last_launch() == dict(
        grid=[25 * 2, 2, 1], cluster=[2, 1, 1], threads=256,
        smem_bytes=head_kernel.wide_smem(256))
    # base 64's stage3_c3k2 and head_p4, the owned plan: clusters of 4,
    # one per 8 x 8 and 8 x 16 tile (and branch)
    x = _act(rng, (1, 40, 40, 512), cuda)
    ws, wpk = _wide_c3k2_weights(rng, 512, 256, 512, 2, cuda)
    c3k2_kernel.fused_c3k2(x, *ws, wpk=wpk)
    assert c3k2_kernel.last_launch() == dict(
        grid=[25 * 4, 1, 1], cluster=[4, 1, 1], threads=256,
        smem_bytes=c3k2_kernel.wide_smem(0, 512, False, 256, 2))
    assert c3k2_kernel.last_launch() == c3k2_kernel.wide_launch(
        0, 512, False, 256, 2, 1, 40, 40)
    ws, w33 = _head_ws(rng, 512, cuda)
    head_kernel.fused_head(x, *ws, w33=w33)
    torch.cuda.synchronize()
    assert head_kernel.last_launch() == dict(
        grid=[15 * 4, 2, 1], cluster=[4, 1, 1], threads=256,
        smem_bytes=head_kernel.wide_smem(512))
    # hidden 128: the owned plan at base 64's 80 x 80 (clusters of 2), the
    # replicated one at base 32's 40 x 40 (above)
    x = _act(rng, (1, 80, 80, 256), cuda)
    ws, wpk = _wide_c3k2_weights(rng, 256, 128, 256, 2, cuda)
    c3k2_kernel.fused_c3k2(x, *ws, wpk=wpk)
    assert c3k2_kernel.last_launch() == dict(
        grid=[100 * 2, 1, 1], cluster=[2, 1, 1], threads=256,
        smem_bytes=c3k2_kernel.wide_smem_owned(128, 2))
    assert c3k2_kernel.last_launch() == c3k2_kernel.wide_launch(
        0, 256, False, 128, 2, 1, 80, 80)
    # hidden 64 at base 64's 160 x 160: the persistent plan, one block an
    # SM; at base 32's 80 x 80 the replicated plan, one block a tile; the
    # head at 128: the large plan at 160 x 160, one block an SM, and one
    # block a tile and branch at 80 x 80
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for h in (160, 80):
        x = _act(rng, (1, h, h, 128), cuda)
        ws, wpk = _wide_c3k2_weights(rng, 128, 64, 128, 1, cuda)
        c3k2_kernel.fused_c3k2(x, *ws, wpk=wpk)
        rec = c3k2_kernel.last_launch()
        assert rec == c3k2_kernel.wide_launch(0, 128, False, 64, 1, 1, h, h,
                                              sms=sms)
        assert rec["grid"] == ([sms, 1, 1] if h == 160 else [100, 1, 1])
        ws, w33 = _head_ws(rng, 128, cuda)
        head_kernel.fused_head(x, *ws, w33=w33)
        torch.cuda.synchronize()
        rec = head_kernel.last_launch()
        assert rec == head_kernel.wide_launch(128, 1, h, h, sms=sms)
        assert rec["grid"] == ([sms, 1, 1] if h == 160 else
                               [(h // 8) * (h // 16), 2, 1])


def test_fc_engine_frame_matches_cpu_port(cuda):
    """The int8_s2dm_fc engine (committed weights) on the card through
    the new kernels, against the port's CPU path on the same frame."""
    cfg = ModelConfig(quant=QuantSpec("int8_fused", exclude=PERF_EXCLUDE),
                      deploy=True, stem_s2d=True, s2d_host=True,
                      stage1_s2d=True, s2d_merged=True, fused_c3k2=True,
                      fused_head=True)
    variables = load_msgpack_raw(ARTIFACT / "variables.msgpack")
    img, _ = generate_image(np.random.default_rng(7),
                            SynthConfig(image_size=640, seed=7))
    frame = torch.from_numpy(merged_frame_np(np.ascontiguousarray(
        img[..., ::-1])))
    kw = dict(conf_threshold=0.5, iou_threshold=0.45, q_factor=0.2116)
    kernels = (stage1_kernel.KERNEL, c3k2_kernel.KERNEL,
               c3k2_kernel.KERNEL_CAT, head_kernel.KERNEL)
    before = [k.launches for k in kernels]
    gpu = build_serving_fn(from_jax_variables(variables, cfg), cfg, **kw)(
        frame.to(cuda))
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 1, 1]
    cpu = build_serving_fn(from_jax_variables(variables, cfg, "cpu"), cfg,
                           **kw)(frame)
    gv, cv = gpu.valid.cpu().numpy(), cpu.valid.numpy()
    assert gv.sum() == cv.sum() >= 1
    gb, gc = gpu.boxes.cpu().numpy()[gv], gpu.classes.cpu().numpy()[gv]
    gs = gpu.scores.cpu().numpy()[gv]
    for box, klass, score in zip(cpu.boxes.numpy()[cv],
                                 cpu.classes.numpy()[cv],
                                 cpu.scores.numpy()[cv]):
        err = np.abs(gb - box).max(axis=1) + 1e9 * (gc != klass)
        j = int(err.argmin())
        assert err[j] <= 0.5 and abs(gs[j] - score) <= 1e-2


# ---- the frame as one captured CUDA graph (runtime/aot.py) ----

FC_CFG = dict(quant=QuantSpec("int8_fused", exclude=PERF_EXCLUDE),
              deploy=True, stem_s2d=True, s2d_host=True, stage1_s2d=True,
              s2d_merged=True, fused_c3k2=True, fused_head=True)
# launches per call, and so kernel nodes per graph, of each path
PATH_KERNELS = {
    "shipped": {"normalize": 1, "fused_stem_stage1": 1, "decode_topk": 1,
                "nms": 1, "int8_conv": INT8_LAYERS, **INT8_GLUE},
    "fc": {"normalize": 1, "decode_topk": 1, "nms": 1, "stage1_merged": 1,
           "fused_c3k2": 1, "fused_c3k2_cat": 1, "fused_head": 1,
           "int8_conv": INT8_LAYERS, **INT8_GLUE},
}
PATH_KERNELS["b8"] = PATH_KERNELS["shipped"]
PATH_KERNELS["camera"] = {"camera": 1, "stage1_merged": 1, "decode_topk": 1,
                          "nms": 1, "int8_conv": INT8_LAYERS, **INT8_GLUE}
# kernel nodes of each path's captured frame, the port's and the float
# layers' library kernels together (chip_smoke.py's graph reports on an
# H100 80GB HBM3)
PATH_NODES = {"shipped": 127, "fc": 89, "b8": 127, "camera": 137}


def _fc_pair(device):
    """(graph call, eager call, CapturedFrame) of the fc engine, each
    taking an RGB frame."""
    cfg = ModelConfig(**FC_CFG)
    serve = build_serving_fn(
        from_jax_variables(load_msgpack_raw(ARTIFACT / "variables.msgpack"),
                           cfg), cfg, conf_threshold=0.5, iou_threshold=0.45,
        q_factor=0.2116)
    stager = ServingArtifact(ARTIFACT, graph=False)
    cap = aot.capture_serving_fn(serve, stager.staged_shape, device)
    return (lambda f: cap(stager.stage(f)), lambda f: serve(stager.stage(f)),
            cap)


@pytest.fixture(scope="module")
def paths():
    """path -> (graph call, eager call, CapturedFrame, inputs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scenes = _scenes(range(1, 9))
    ship, ship8 = ServingArtifact(ARTIFACT), ServingArtifact(ARTIFACT_B8)
    cam = ServingArtifact(ARTIFACT_CAM)
    return {
        "camera": (cam, ServingArtifact(ARTIFACT_CAM, graph=False), cam.graph,
                   _camera_scenes(range(1, 9))),
        "shipped": (ship, ServingArtifact(ARTIFACT, graph=False), ship.graph,
                    list(scenes)),
        "fc": (*_fc_pair(torch.device("cuda")), list(scenes)),
        "b8": (ship8, ServingArtifact(ARTIFACT_B8, graph=False), ship8.graph,
               [scenes]),
    }


@pytest.mark.parametrize("path", ["shipped", "fc", "b8", "camera"])
def test_graph_replay_matches_eager_bit_for_bit(paths, path):
    """The replayed frame is the eager frame: every field of every slot
    equal, on 8 scenes (one batch of them for b8)."""
    graph_call, eager_call, _, inputs = paths[path]
    for frames in inputs:
        got = [f.clone() for f in graph_call(frames)]
        want = eager_call(frames)
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("path", ["shipped", "b8", "camera"])
def test_graph_results_do_not_alias(paths, path):
    """ServingArtifact's results are its own: a later call leaves an
    earlier result as it was."""
    art, _, _, inputs = paths[path]
    first = art(inputs[0])
    kept = [f.clone() for f in first]
    second = art(inputs[-1] if path != "b8" else inputs[0][::-1].copy())
    torch.cuda.synchronize()
    for a, b, k in zip(first, second, kept):
        assert a.data_ptr() != b.data_ptr() and torch.equal(a, k)


@pytest.mark.parametrize("path,out_bytes", [("shipped", 25600),
                                            ("fc", 25600), ("b8", 204800),
                                            ("camera", 25600)])
def test_graph_report_clean_with_each_kernel(paths, path, out_bytes):
    """The strict report of each captured frame: no host node, the
    reference artifacts' result size, each of the path's kernels among
    the nodes as often as a call launches it (the others not at all), and
    the path's count of kernel nodes."""
    cap = paths[path][2]
    aot.print_fallback_report(cap.report, strict=True, log_fn=lambda s: None)
    assert cap.report.clean and cap.report.output_bytes == out_bytes
    want = PATH_KERNELS[path]
    assert {k: n for k, n in cap.report.port_kernels.items() if n} == want
    assert cap.report.kernel_nodes == PATH_NODES[path]


@pytest.mark.parametrize("path", ["shipped", "fc", "b8", "camera"])
def test_graph_replays_launch_nothing(paths, path):
    """The capture launched each of the path's kernels once into the
    graph; replays launch no kernel from Python."""
    graph_call, _, cap, inputs = paths[path]
    by_symbol = {k.symbol: k for k in _lib.KERNELS}
    names = {"normalize": preprocess_kernel.KERNEL,
             "fused_stem_stage1": stem_kernel.KERNEL,
             "decode_topk": decode_kernel.KERNEL, "nms": nms_kernel.KERNEL,
             "stage1_merged": stage1_kernel.KERNEL,
             "fused_c3k2": c3k2_kernel.KERNEL,
             "fused_c3k2_cat": c3k2_kernel.KERNEL_CAT,
             "fused_head": head_kernel.KERNEL,
             "camera": camera_kernel.KERNEL,
             "int8_conv": int8_conv_kernel.KERNEL,
             "int8_sppf": sppf_kernel.KERNEL,
             "qconcat": qconcat_kernel.KERNEL}
    assert {n: cap.capture_launches.get(k.symbol, 0)
            for n, k in names.items() if cap.capture_launches.get(
                k.symbol)} == PATH_KERNELS[path]
    before = {s: k.launches for s, k in by_symbol.items()}
    for frames in inputs[:3]:
        graph_call(frames)
    torch.cuda.synchronize()
    assert {s: k.launches for s, k in by_symbol.items()} == before


def test_captured_frame_keeps_its_weights(cuda):
    """A frame whose model only its ``serve`` closure holds stays right
    after the caller drops both and the freed memory is taken again."""
    import gc

    from unina_yolo_dla_torch.runtime.artifact import config_from_artifact

    stager = ServingArtifact(ARTIFACT, graph=False)
    frame = stager.stage(_scenes([7])[0])
    want = [f.clone() for f in stager._serve(frame)]
    cfg = config_from_artifact(stager.config)
    c = stager.config
    cap = aot.capture_serving_fn(build_serving_fn(
        from_jax_variables(load_msgpack_raw(ARTIFACT / "variables.msgpack"),
                           cfg), cfg, c["conf_threshold"], c["iou_threshold"],
        c["q_factor"], c["max_detections"]), stager.staged_shape, cuda)
    gc.collect()
    junk = torch.full((256 << 20,), 7, dtype=torch.uint8, device=cuda)
    got = cap(frame)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    del junk


def test_graph_report_flags_host_copies(cuda):
    """The node walker sees a device-to-host copy captured into a graph,
    and strict mode refuses it."""
    x = torch.ones(256, device=cuda)
    host = torch.empty(256, pin_memory=True)
    graph, stream = torch.cuda.CUDAGraph(keep_graph=True), torch.cuda.Stream()
    with torch.cuda.graph(graph, stream=stream):
        host.copy_(x * 2, non_blocking=True)
    dets = td.Detections(x[:4], x[:1], x[:1].int(), x[:1].bool())
    rep = aot.analyze_graph(graph, dets)
    assert rep.host_nodes and rep.nodes.get("kernel", 0) >= 1
    with pytest.raises(RuntimeError, match="host"):
        aot.print_fallback_report(rep, log_fn=lambda s: None)


def test_server_and_executor_on_the_card(paths):
    """The server's dict and the executor's records of a scene equal the
    eager frame's valid detections; replays launch nothing."""
    import struct

    eager = paths["shipped"][1]
    frame = paths["shipped"][3][6]
    want = eager(frame)
    v = want.valid.cpu().numpy()
    srv = PerceptionServer(ARTIFACT, log_fn=lambda s: None)
    srv.configure()
    srv.activate()
    got = srv.process_frame(frame)
    assert got["count"] == int(v.sum()) >= 1
    assert np.array_equal(got["boxes"], want.boxes.cpu().numpy()[v])
    assert np.array_equal(got["classes"], want.classes.cpu().numpy()[v])
    execute = make_executor(str(ARTIFACT))
    blob = execute(memoryview(frame.tobytes()), 640, 640, 3)
    assert struct.unpack_from("<I", blob, 0)[0] == got["count"]
    rec = np.frombuffer(blob[4:], np.float32).reshape(-1, 6)
    assert np.array_equal(rec[:, :4], got["boxes"])
    assert np.array_equal(rec[:, 4], got["scores"])
    assert execute(memoryview(frame.tobytes()), 320, 640, 3) == \
        struct.pack("<I", 0xFFFFFFFF)


def test_camera_executor_on_the_card(paths):
    """The camera artifact's executor: the ring's BGRA bytes as they are ->
    records of the eager frame's valid detections; another geometry or
    format -> the sentinel; its frames launch nothing from Python."""
    import struct

    eager, scenes = paths["camera"][1], paths["camera"][3][:3]
    wants = [eager(frame) for frame in scenes]
    execute = make_executor(str(ARTIFACT_CAM))
    by_symbol = {k.symbol: k for k in _lib.KERNELS}
    before = {s: k.launches for s, k in by_symbol.items()}
    for frame, want in zip(scenes, wants):
        v = want.valid.cpu().numpy()
        blob = execute(memoryview(frame.tobytes()), 1920, 1080, 4)
        assert struct.unpack_from("<I", blob, 0)[0] == int(v.sum()) >= 1
        rec = np.frombuffer(blob[4:], np.float32).reshape(-1, 6)
        assert np.array_equal(rec[:, :4], want.boxes.cpu().numpy()[v])
        assert np.array_equal(rec[:, 4], want.scores.cpu().numpy()[v])
    for w, h, c in ((1920, 1080, 3), (1920, 1080, 0), (640, 640, 3)):
        assert execute(memoryview(scenes[0].tobytes()), w, h, c) == \
            struct.pack("<I", 0xFFFFFFFF)
    assert {s: k.launches for s, k in by_symbol.items()} == before


# ---- the port's export on the card ----

SOURCE = ARTIFACT.with_name("engine_source.msgpack")
CP = ARTIFACT.with_name("cp_calibration.json")


def test_export_on_the_card_reproduces_the_shipped_artifact(cuda, tmp_path):
    """The shipped flags through the port's export on the card: the
    committed variables byte for byte, the committed config on every key
    the reference writes but ``platforms``, a clean report of a captured
    graph."""
    import json

    from unina_yolo_dla_torch import export

    out = tmp_path / "shipped"
    export.main(["--weights", str(SOURCE), "--int8", "--s2d-merged",
                 "--fused-stem", "--merged-head", "--cp-calibration",
                 str(CP), "--output", str(out)])
    assert (out / "variables.msgpack").read_bytes() == \
        (ARTIFACT / "variables.msgpack").read_bytes()
    got, want = (json.loads((d / "config.json").read_text())
                 for d in (out, ARTIFACT))
    # the keys the port writes for itself (the last two since it records
    # how the engine was built)
    own = ("platforms", "fused_c3k2", "fused_head", "compute_dtype",
           "quant_mode")
    assert {k: v for k, v in got.items() if k not in own} == \
        {k: v for k, v in want.items() if k not in own}
    assert got["platforms"] == ["cuda"]
    assert (got["compute_dtype"], got["quant_mode"]) == ("bfloat16",
                                                         "int8_fused")
    report = json.loads((out / "fallback_report.json").read_text())
    assert report["captured"] and not report["host_nodes"]
    assert report["port_kernels"]["fused_stem_stage1"] == 1


@pytest.mark.parametrize("flags,stem,stage1", [
    (["--int8", "--stem-s2d-host", "--merged-head"], "ShiftDot2x2",
     "MergedDownsample"),
    (["--int8", "--merged-head"], "ConvBlock", "ConvBlock")])
def test_exported_engine_graph_matches_eager(cuda, tmp_path, flags, stem,
                                             stage1):
    """An unmerged s2d_host export (frames staged (320, 320, 12)) and a
    standard-stem export (the 3x3 stride-2 stage1 conv), served from their
    directories: the captured graph equals the eager frame bit for bit on
    three scenes, and the card agrees with the port's CPU path."""
    from unina_yolo_dla_torch import export

    out = tmp_path / "art"
    export.main(["--weights", str(SOURCE), *flags, "--cp-calibration",
                 str(CP), "--output", str(out)])
    graph, eager = ServingArtifact(out), ServingArtifact(out, graph=False)
    bb = eager.model.backbone
    assert (type(bb.stem).__name__, type(bb.stage1_conv).__name__) == \
        (stem, stage1)
    assert graph.graph.report.clean
    for frame in _scenes([1, 2, 7]):
        got = graph(frame)
        want = eager(frame)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    frame = _scenes([7])[0]
    _match(graph(frame), ServingArtifact(out, device="cpu")(frame))


# ---- the 64-wide kernels give the bits they gave before the wide form ----

# SHA-256 of ``_narrow_outputs``' tensors as the tiled kernels computed them
# before the wide form was added beside them (the parent tree's kernels on
# an NVIDIA H100 80GB HBM3, 700 W)
NARROW_DIGESTS = {
    "fused_c3k2":
        "47ac0da9f23dda118fb4b16785ceeafac7ee65d6a6b9c3da77bbb48d552b1b33",
    "fused_c3k2_cat":
        "9dc0a212e167f9e2abb1dbf8cbce310c99610fc28674c7fc13b6a66bb1187ca0",
    "fused_head":
        "8dbb775ceca75497da991ffcc82aebcbe67384ccb21bf85503b21363e5303148",
}


def _narrow_outputs(device):
    """The tiled C3k2, C3k2-cat and head kernels (hidden 32, F 64; head 64)
    on seeded normal inputs at ragged shapes, batch 2: name -> tensors."""
    rng = np.random.default_rng(2024)

    def act(shape):
        a = np.maximum(rng.normal(0, 1, shape), 0).astype(np.float32)
        return torch.from_numpy(a).to(device, torch.bfloat16)

    def ws_c3k2(cin, n):
        ws = [w.to(device) for w in c3k2_kernel.pack_c3k2_weights(
            _kb(rng, (1, 1, cin, 32)), _kb(rng, (1, 1, cin, 32)),
            _kb(rng, (1, 1, 64, 64)),
            [(_kb(rng, (1, 1, 32, 32)), _kb(rng, (3, 3, 32, 32)))
             for _ in range(n)], torch.bfloat16)]
        return ws

    out = {}
    x = act((2, 37, 45, 64))
    ws = ws_c3k2(64, 2)
    out["fused_c3k2"] = (c3k2_kernel.fused_c3k2(
        x, *ws, wpk=mma_pack.pack_c3k2_mma(ws[0], ws[6], ws[2], ws[4],
                                           ws[8])),)
    xa, xb = act((2, 19, 23, 64)), act((2, 38, 46, 64))
    ws = ws_c3k2(128, 1)
    out["fused_c3k2_cat"] = (c3k2_kernel.fused_c3k2_cat(
        xa, xb, *ws, up_a=True, wpk=mma_pack.pack_c3k2_mma(
            ws[0], ws[6], ws[2], ws[4], ws[8], 64)),)
    x = act((2, 37, 45, 64))
    ws = [w.to(device) for w in head_kernel.pack_head_weights(
        [_kb(rng, (3, 3, 64, 64)), _kb(rng, (3, 3, 64, 64))],
        _kb(rng, (1, 1, 64, 4)),
        [_kb(rng, (3, 3, 64, 64)), _kb(rng, (3, 3, 64, 64))],
        _kb(rng, (1, 1, 64, 4)), torch.bfloat16)]
    out["fused_head"] = head_kernel.fused_head(
        x, *ws, w33=mma_pack.pack_head_mma(ws[0], ws[6], ws[2], ws[8],
                                           ws[4], ws[10]))
    torch.cuda.synchronize()
    return out


def narrow_digests(device) -> dict:
    import hashlib

    digests = {}
    for name, tensors in _narrow_outputs(device).items():
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        digests[name] = h.hexdigest()
    return digests


def test_narrow_kernels_unchanged_by_the_wide_form(cuda):
    """The tiled kernels' outputs on normal (not grid) inputs, where the
    tensor cores' summation order shows in the bits, equal those the
    parent tree's kernels gave on the same inputs."""
    assert narrow_digests(cuda) == NARROW_DIGESTS


def _bgra(rgb):
    return np.ascontiguousarray(np.concatenate(
        [rgb[..., ::-1], np.full(rgb.shape[:2] + (1,), 255, np.uint8)],
        axis=-1))


def test_cuda_executor_matches_make_executor(cuda):
    """The native CUDA executor (``runtime/native``, through its C ABI) on
    the shipped artifact: at depth 1 (``infer``) and at depth 2 (four
    frames submitted, then collected in order) its records equal
    ``make_executor``'s byte for byte, RGB and BGRA; a frame of another
    geometry gets the sentinel; frames launch no kernel from Python."""
    from unina_yolo_dla_torch.runtime.native import capi

    execute = make_executor(str(ARTIFACT))
    scenes = list(_scenes(range(1, 5)))
    wants = [execute(memoryview(s.tobytes()), 640, 640, 3) for s in scenes]
    with capi.Executor("cuda", str(ARTIFACT)) as ex:
        assert ex.depth == 2
        before = {k.symbol: k.launches for k in _lib.KERNELS}
        for scene, want in zip(scenes, wants):
            assert ex.infer(scene, 640, 640, 3) == want
            assert ex.infer(_bgra(scene), 640, 640, 4) == want
        for scene in scenes:
            assert ex.submit(scene, 640, 640, 3)
        assert [ex.collect() for _ in scenes] == wants
        assert ex.infer(scenes[0], 640, 320, 3) == capi.SENTINEL
        assert not ex.submit(scenes[0], 640, 640, 2)
        assert {k.symbol: k.launches for k in _lib.KERNELS} == before
    assert all(struct.unpack_from("<I", w)[0] >= 1 for w in wants)


def test_cuda_executor_camera_artifact(cuda):
    """On the camera artifact the ring's BGRA bytes go to the graph as they
    are: records equal the artifact's packed result; another geometry or
    format gets the sentinel."""
    from unina_yolo_dla_torch.runtime.embed import pack_records
    from unina_yolo_dla_torch.runtime.native import capi

    art = ServingArtifact(ARTIFACT_CAM)
    frames = _camera_scenes(range(1, 3))
    wants = [pack_records(art.packed(f)) for f in frames]
    with capi.Executor("cuda", str(ARTIFACT_CAM)) as ex:
        for frame, want in zip(frames, wants):
            assert ex.infer(frame, 1920, 1080, 4) == want
        for frame in frames:
            assert ex.submit(frame, 1920, 1080, 4)
        assert [ex.collect() for _ in frames] == wants
        assert ex.infer(frames[0], 1920, 1080, 3) == capi.SENTINEL
        assert ex.infer(frames[0], 640, 640, 4) == capi.SENTINEL


def test_cuda_executor_refuses_a_batch_artifact(cuda):
    from unina_yolo_dla_torch.runtime.native import capi

    with pytest.raises(RuntimeError, match="batch artifact"):
        capi.Executor("cuda", str(ARTIFACT_B8))


def _train_batch(size: int, seeds, max_boxes: int = 16):
    """Synthetic scenes as a training batch: uint8 RGB, xyxy px labels."""
    n = len(seeds)
    images = np.empty((n, size, size, 3), np.uint8)
    boxes = np.zeros((n, max_boxes, 4), np.float32)
    labels = np.zeros((n, max_boxes), np.int32)
    mask = np.zeros((n, max_boxes), bool)
    for i, seed in enumerate(seeds):
        bgr, lab = generate_image(np.random.default_rng(seed), SynthConfig(
            image_size=size, seed=seed, min_height=6, max_height=24,
            min_cones=2, max_cones=5))
        images[i] = bgr[..., ::-1]
        for j, (c, cx, cy, w, h) in enumerate(lab[:max_boxes]):
            boxes[i, j] = np.array([cx - w / 2, cy - h / 2, cx + w / 2,
                                    cy + h / 2], np.float32) * size
            labels[i, j], mask[i, j] = c, True
    return {"images": images, "boxes": boxes, "labels": labels,
            "mask": mask}


def test_train_step_card_vs_cpu(cuda):
    """One float32 train step of the small model (base 16, 64^2, batch 2,
    TF32 off) on the card and on the CPU from the same initial variables:
    the same assignment, the loss within 1e-4 and the gradient norm within
    1e-3 relative, the step's update as a whole within 1e-2 relative (the
    float32 train-mode gradient is ill-conditioned: BatchNorm over a
    batch of 2 at 64^2), all of the card's state on the card."""
    from unina_yolo_dla_torch.models.detector import (
        init_model, load_variables, variables_of)
    from unina_yolo_dla_torch.train import trainer as tr

    cfg = ModelConfig(base_channels=16, input_size=64,
                      compute_dtype=torch.float32)
    _, variables = init_model(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    batch = _train_batch(64, [11, 12])
    tc = tr.TrainConfig(warmup_steps=1, total_steps=10)
    got = {}
    for dev in ("cuda", "cpu"):
        model, _ = init_model(cfg, device=dev)
        load_variables(model, variables)
        tx = tr.make_optimizer(tc)
        state = tr.create_train_state(variables_of(model), tx, tc)
        before = preprocess_kernel.KERNEL.launches
        new, aux = tr.make_train_step(model, cfg, tx, tc)(
            state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        if dev == "cuda":
            assert preprocess_kernel.KERNEL.launches == before + 1
            assert all(t.is_cuda for tree in (new.params, new.batch_stats)
                       for t in tree.values())
        got[dev] = ({k: float(v) for k, v in aux.items()},
                    torch.cat([(new.params[k] - state.params[k]).cpu().ravel()
                               for k in state.params]))
    (ga, gu), (ca, cu) = got["cuda"], got["cpu"]
    assert ga["num_fg"] == ca["num_fg"] > 0
    assert abs(ga["loss"] - ca["loss"]) <= 1e-4 * abs(ca["loss"])
    assert abs(ga["grad_norm"] - ca["grad_norm"]) <= 1e-3 * ca["grad_norm"]
    assert (gu - cu).norm() <= 1e-2 * cu.norm()


@pytest.mark.parametrize("shape", [(16, 640, 640, 3), (2, 64, 64, 3),
                                   (3, 7, 5, 3)])
def test_ensure_normalized_kernel_bit_equal(rng, cuda, shape):
    """ensure_normalized on a card batch: one normalize launch, float32,
    bit for bit the plain formula on the CPU (the training batch's shape,
    the tests' and a ragged one)."""
    from unina_yolo_dla_torch.ops.preprocess import ensure_normalized

    img = rng.integers(0, 256, shape, dtype=np.uint8)
    before = preprocess_kernel.KERNEL.launches
    got = ensure_normalized(torch.from_numpy(img).to(cuda))
    torch.cuda.synchronize()
    assert preprocess_kernel.KERNEL.launches == before + 1
    assert got.dtype == torch.float32 and got.is_cuda
    want = ensure_normalized(torch.from_numpy(img))
    assert torch.equal(got.cpu(), want)


# ---- the stem and stage1 kernels at every base width ----

def _width_inputs(rng, c, shape, cuda, grid=True):
    """Frame, merged stem output and kernels at width ``c``: on binary
    grids (activations k/2, sparse weights k/4, biases k/8: every f32 sum
    exact in any order), or seeded normal (activations ReLU'd)."""
    bf = torch.bfloat16

    def act(sh, relu):
        if grid:
            a = rng.integers(0 if relu else -4, 5, sh) * 0.5
        else:
            a = rng.normal(0, 1, sh)
            a = np.maximum(a, 0) if relu else a
        return torch.from_numpy(a.astype(np.float32)).to(cuda, bf)

    def kb(sh):
        fan = int(np.prod(sh[:-1]))
        if grid:
            k = np.where(rng.random(sh) < min(1.0, 8 / fan),
                         rng.choice([-.5, -.25, .25, .5], sh), 0.0)
            b = rng.integers(-2, 3, sh[-1]) / 8
        else:
            k = rng.normal(0, np.sqrt(2 / fan), sh)
            b = rng.normal(0, .1, sh[-1])
        return (torch.from_numpy(k.astype(np.float32)).to(cuda, bf),
                torch.from_numpy(b.astype(np.float32)).to(cuda))

    return (act((*shape, 24), False), act((*shape, c), True),
            *kb((2, 2, 24, c)), *kb((2, 2, 2 * c, c)))


@pytest.mark.parametrize("c", mma_pack.STEM_STAGE1_WIDTHS)
@pytest.mark.parametrize("shape", [(1, 320, 160), (2, 10, 37), (3, 2, 1),
                                   (3, 34, 61)])
def test_stem_stage1_every_width_bit_exact_on_grid_inputs(rng, cuda, c,
                                                          shape):
    """Base 16, 32 and 64 (C = 32, 64, 128): the served shape, ragged
    batches of 2 and 3, a single output pixel; each launch counted on its
    width's entry point."""
    frame, xm, ks, bs, k1, b1 = _width_inputs(rng, c, shape, cuda)
    ksp, k1p = mma_pack.pack_stem_mma(ks), mma_pack.pack_stage1_mma(k1)
    got = _launched(stem_kernel.KERNELS[c], lambda: (
        stem_kernel.fused_stem_stage1(frame, ksp, bs, k1p, b1)))
    want = stem_kernel.fused_stem_stage1_plain(frame, ks, bs, k1, b1)
    # a single output pixel a row may be small, never all 0
    assert float(want.float().abs().max()) > (1.0 if shape[1] > 2 else 0.0)
    assert got.shape == (shape[0], shape[1] // 2, shape[2], c)
    assert torch.equal(got, want)
    got = _launched(stage1_kernel.KERNELS[c], lambda: (
        stage1_kernel.fused_downsample_merged(xm, k1p, b1)))
    assert torch.equal(got, stage1_kernel.fused_downsample_merged_plain(
        xm, k1, b1))


# SHA-256 of the 64-wide kernels' outputs on seeded normal inputs
# (``_width_inputs(grid=False)``, seeds 11 and 12) as they computed them
# before the kernels took other widths (on an NVIDIA H100 80GB HBM3,
# 700 W); chip_smoke.py holds the same digests
WIDTH64_DIGESTS = {
    "stem_1x320x160":
        "c402c8cc7209ea7de25a2ac2eb5e5bfb6a4ff335f53961af4ed93da09545d94f",
    "stage1_1x320x160":
        "0e5637cd6dc70b3249b8a7a49ca2ff3877fd45410b0f29cd5806048dca2a1367",
    "stem_2x10x37":
        "f0420fd53b7b81f04e6bbc330d3369b3093bd75a9e3d2796538494b5fe4b012c",
    "stage1_2x10x37":
        "cbe071e224f13573d70a2d6e027aa5d975cf40e29fad3415aec19e807f0a273c",
}


# The same at C = 128 and 32 (seeds 11, 12 and 13; the third shape a
# ragged batch of 3), as the kernels computed them before the C = 128
# forms became clusters of two blocks: the cluster form sums the same
# products in the same order. chip_smoke.py holds the same digests.
WIDTH128_DIGESTS = {
    "stem_1x320x160":
        "38c2782fc490706b624869b9d00af96630264ca9108fe1bd2a162ceb022df339",
    "stage1_1x320x160":
        "57711f950311555a71554b596ed0c58ec079fbca4aa30d472e007960f6f17c9e",
    "stem_2x10x37":
        "5bf14566919ff9d018bbeacfc474d32540d9a7ee95454c84a0580511d71af4b9",
    "stage1_2x10x37":
        "3307c4ac5de3924ad499f9cf419947281cdaff81b7f2130caa70a7f42132778f",
    "stem_3x34x61":
        "d58eb18a6089b3d8e313b3e6696827973399bd670320a46b2299dbc808e48c7f",
    "stage1_3x34x61":
        "214fd395a547501ea34dd031fa19d383f334e24065b00cb056d708c0af5440f2",
}
WIDTH32_DIGESTS = {
    "stem_1x320x160":
        "eb092d93590b2e2abe6660480271c8dbb5bc91ebb6c5acf735425844230230b0",
    "stage1_1x320x160":
        "73220cdddefbfb80f021ee84bdaea358951726f7e7e9a298ae424c0e1982d36c",
    "stem_2x10x37":
        "6a0ca758d6a2769de488433288e620668923cd48f5e18fa3a5b66ba31ee53493",
    "stage1_2x10x37":
        "daccae8922591f68f93b2349708fe6eaec82bc34eaec7f8f673ae30f0dd15160",
    "stem_3x34x61":
        "03c8ee3e2ce484439c2819479f43c8978e282184c8afa613c53f66b8cbae56e6",
    "stage1_3x34x61":
        "95eb7aa298cbb75dafecba8f5efba5c19f9a7a208866feda76bb2fd59ae767e7",
}
WIDTH_DIGEST_CASES = {
    64: (((1, 320, 160), 11), ((2, 10, 37), 12)),
    32: (((1, 320, 160), 11), ((2, 10, 37), 12), ((3, 34, 61), 13)),
    128: (((1, 320, 160), 11), ((2, 10, 37), 12), ((3, 34, 61), 13)),
}


def _width_digests(c, cuda):
    import hashlib

    def digest(t):
        return hashlib.sha256(
            t.contiguous().view(torch.int16).cpu().numpy().tobytes()
        ).hexdigest()

    got = {}
    for shape, seed in WIDTH_DIGEST_CASES[c]:
        frame, xm, ks, bs, k1, b1 = _width_inputs(
            np.random.default_rng(seed), c, shape, cuda, grid=False)
        ksp, k1p = mma_pack.pack_stem_mma(ks), mma_pack.pack_stage1_mma(k1)
        tag = "x".join(map(str, shape))
        got[f"stem_{tag}"] = digest(stem_kernel.fused_stem_stage1(
            frame, ksp, bs, k1p, b1))
        got[f"stage1_{tag}"] = digest(stage1_kernel.fused_downsample_merged(
            xm, k1p, b1))
    return got


def test_stem_stage1_64_wide_bits_unchanged(cuda):
    assert _width_digests(64, cuda) == WIDTH64_DIGESTS


@pytest.mark.parametrize("c", [128, 32])
def test_stem_stage1_bits_unchanged_by_the_cluster_form(cuda, c):
    """Base 64's kernels (clusters of two blocks) and base 16's: the bits
    they had before the cluster form, on seeded normal inputs."""
    want = {128: WIDTH128_DIGESTS, 32: WIDTH32_DIGESTS}[c]
    assert _width_digests(c, cuda) == want


@pytest.mark.parametrize("shape,seed", [((1, 320, 160), 11),
                                        ((3, 34, 61), 13)])
def test_cluster_kernels_relaunch_bit_equal(cuda, shape, seed):
    """The C = 128 kernels hand each other windows through distributed
    shared memory and multicast copies; 100 launches back to back, each
    output bit for bit the first (a race in the hand-off would flip bits
    in some launch)."""
    frame, xm, ks, bs, k1, b1 = _width_inputs(
        np.random.default_rng(seed), 128, shape, cuda, grid=False)
    ksp, k1p = mma_pack.pack_stem_mma(ks), mma_pack.pack_stage1_mma(k1)
    for call in (lambda: stem_kernel.fused_stem_stage1(frame, ksp, bs, k1p,
                                                       b1),
                 lambda: stage1_kernel.fused_downsample_merged(xm, k1p, b1)):
        outs = [call() for _ in range(100)]
        torch.cuda.synchronize()
        assert all(torch.equal(o, outs[0]) for o in outs)


def test_other_widths_refused_on_the_card(rng, cuda):
    """Widths outside the compiled sets raise on the card: stage1 at 48,
    the C3k2 at hidden 512, the head at 1,024; no plain fallback."""
    frame, xm, ks, bs, k1, b1 = _width_inputs(rng, 64, (1, 8, 5), cuda)
    with pytest.raises(ValueError, match="compiled|C in"):
        stage1_kernel.fused_downsample_merged(
            xm[..., :48].contiguous(), torch.zeros(
                6, 48, 64, dtype=torch.bfloat16, device=cuda), b1[:48])
    x = _act(rng, (1, 8, 8, 64), cuda)
    ws = _to(c3k2_kernel.pack_c3k2_weights(
        _kb(rng, (1, 1, 64, 512)), _kb(rng, (1, 1, 64, 512)),
        _kb(rng, (1, 1, 1024, 1024)),
        [(_kb(rng, (1, 1, 512, 512)), _kb(rng, (3, 3, 512, 512)))],
        torch.bfloat16), cuda)
    assert not c3k2_kernel.kernel_takes(64, 512, 1024, 1)
    with pytest.raises(ValueError, match="hidden in"):
        c3k2_kernel.fused_c3k2(x, *ws, wpk=torch.zeros(
            1, dtype=torch.bfloat16, device=cuda))
    x = _act(rng, (1, 4, 4, 1024), cuda)
    ws = [torch.zeros(1, device=cuda)] * 12
    assert not head_kernel.kernel_takes(1024)
    with pytest.raises(ValueError, match="kernel takes"):
        head_kernel.fused_head(x, *ws, w33=torch.zeros(
            1, dtype=torch.bfloat16, device=cuda))


# The wide C3k2 and head kernels at every (hidden, n) and head width they
# took before hidden 256 and head 512: the served shapes of the base-32
# and base-16 engines and ragged batches of 2. C3k2: (batch, H, W, Ca (0:
# the single form), Cb, hidden, n, up_a, shortcut); head: (batch, H, W,
# C). SHA-256 of their outputs on seeded normal inputs as the parent
# commit's kernels computed them (on an NVIDIA H100 80GB HBM3);
# chip_smoke.py holds the same shapes and digests.
WIDE_SEED = 2026
WIDE_SHAPES = {
    "c3k2_h16_n1_160": (1, 160, 160, 0, 32, 16, 1, False, True),
    "c3k2_h64_n2_80": (1, 80, 80, 0, 128, 64, 2, False, True),
    "c3k2_h128_n2_40": (1, 40, 40, 0, 256, 128, 2, False, True),
    "c3k2_h64_n1_2x37x45": (2, 37, 45, 0, 128, 64, 1, False, True),
    "c3k2_h128_n1_2x5x3": (2, 5, 3, 0, 256, 128, 1, False, True),
    "c3k2_h16_n2_2x9x14": (2, 9, 14, 0, 40, 16, 2, False, True),
    "cat_h64_n1_up_80": (1, 80, 80, 128, 128, 64, 1, True, False),
    "cat_h64_n1_80": (1, 80, 80, 64, 128, 64, 1, False, False),
    "cat_h128_n1_40": (1, 40, 40, 128, 256, 128, 1, False, False),
    "cat_h16_n1_up_160": (1, 160, 160, 32, 32, 16, 1, True, False),
    "cat_h128_n2_up_2x14x22": (2, 14, 22, 128, 64, 128, 2, True, True),
    "cat_h64_n2_2x37x45": (2, 37, 45, 64, 128, 64, 2, False, True),
    "head_c32_160": (1, 160, 160, 32),
    "head_c128_80": (1, 80, 80, 128),
    "head_c256_40": (1, 40, 40, 256),
    "head_c256_2x13x6": (2, 13, 6, 256),
    "head_c128_2x37x45": (2, 37, 45, 128),
    "head_c32_1x9x17": (1, 9, 17, 32),
}
WIDE_DIGESTS = {
    "c3k2_h16_n1_160":
        "e59361a4ed416bac6a29278ef7861502a8c17bdd8149d1fc9fefb5449a79efe0",
    "c3k2_h64_n2_80":
        "40056322871410b3118789183df0c9f9b7ef85f4d66cbb21a2f9361760957287",
    "c3k2_h128_n2_40":
        "7696212f93d8cae2726f818af1669656be2ddf21815638dbdde20fb7f03ccfeb",
    "c3k2_h64_n1_2x37x45":
        "0c65d91d2f7291e2344ab63d6709d4454e7d6807782ee09e887f67828ffdae49",
    "c3k2_h128_n1_2x5x3":
        "dc594fe2b0a83b2bad3661844cbe40952044d91adf97b0cb646bc85f47284ac8",
    "c3k2_h16_n2_2x9x14":
        "7214c8b71a364846e8208c7a1cc52d21745123c5f36c4dba59c467d7dd918d75",
    "cat_h64_n1_up_80":
        "c4001157ec5cc7da798c99ce5c04a06776bdd0385a551afe52467a8154caa5f6",
    "cat_h64_n1_80":
        "f97b900c895748b80cf1ef12c333e7d27902a5fbd3243a776c02097fe259e2a4",
    "cat_h128_n1_40":
        "498577c4c5bcbb83499f6d4aa9de5dd3cebee4d1e9c2187bdc913f85f6bb6107",
    "cat_h16_n1_up_160":
        "724010f7f3b4a958c9c9ed168e88880a6ab47919dd62e3c135d50c11ba22ff90",
    "cat_h128_n2_up_2x14x22":
        "c5214f258282aee3ce16aadec5ce2ca3b86c6ca390b3bac585663f3412e3dff9",
    "cat_h64_n2_2x37x45":
        "7825f59d3508be3391832dea34f02721cc516c91c7fd338fab04e7358f504e20",
    "head_c32_160":
        "efaece67794cbc3a8e9b4845597ee5881558ebb2a25d49cad4f4011669427723",
    "head_c128_80":
        "51ebd30d4f68e51e9ed8ef31f2d1e866b77e6fb2463f9999838015a7e073b6b4",
    "head_c256_40":
        "6a4d6801eda2b12b46c1783ff792fde0d7db355d91e4c0b9e8bb8aa757e3a4d4",
    "head_c256_2x13x6":
        "ee12a8ccdc24a53f7afd90aa36dba54422f8c5437f208c4c2656b1063030ccdf",
    "head_c128_2x37x45":
        "089dc6b9f853ab5ec846de4afc05e7fa14e5598cb9c43d4973a1544f7d5cc97a",
    "head_c32_1x9x17":
        "dbb6856de1ad338eb731c62b43945817b1a116bff94b1c40d3c0369a3b06bdeb",
}


def _wide_digests(shapes, cuda) -> dict:
    """SHA-256 of the wide kernels' outputs at ``shapes`` (WIDE_SHAPES'
    form) on seeded normal inputs (activations ReLU'd, weights N(0,
    2/fan), biases N(0, 0.1)), name by name."""
    import hashlib

    got = {}
    for name, case in shapes.items():
        rng = np.random.default_rng(WIDE_SEED)
        if name.startswith("head"):
            b, h, w, c = case
            x = _act(rng, (b, h, w, c), cuda)
            ws = _to(head_kernel.pack_head_weights(
                [_kb(rng, (3, 3, c, c)), _kb(rng, (3, 3, c, c))],
                _kb(rng, (1, 1, c, 4)),
                [_kb(rng, (3, 3, c, c)), _kb(rng, (3, 3, c, c))],
                _kb(rng, (1, 1, c, 4)), torch.bfloat16), cuda)
            outs = head_kernel.fused_head(x, *ws, w33=mma_pack.pack_head_mma(
                ws[0], ws[6], ws[2], ws[8], ws[4], ws[10]))
        else:
            b, h, w, ca, cb, hd, n, up, shortcut = case
            xb = _act(rng, (b, h, w, cb), cuda)
            xa = _act(rng, (b, h // 2, w // 2, ca) if up else (b, h, w, ca),
                      cuda) if ca else None
            ws = _to(c3k2_kernel.pack_c3k2_weights(
                _kb(rng, (1, 1, ca + cb, hd)), _kb(rng, (1, 1, ca + cb, hd)),
                _kb(rng, (1, 1, 2 * hd, 2 * hd)),
                [(_kb(rng, (1, 1, hd, hd)), _kb(rng, (3, 3, hd, hd)))
                 for _ in range(n)], torch.bfloat16), cuda)
            wpk = mma_pack.pack_c3k2_mma(ws[0], ws[6], ws[2], ws[4], ws[8],
                                         ca)
            outs = (c3k2_kernel.fused_c3k2(
                xb, *ws, shortcut=shortcut, wpk=wpk) if xa is None else
                c3k2_kernel.fused_c3k2_cat(xa, xb, *ws, shortcut=shortcut,
                                           up_a=up, wpk=wpk),)
        torch.cuda.synchronize()
        d = hashlib.sha256()
        for t in outs:
            d.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        got[name] = d.hexdigest()
    return got


def test_wide_kernels_bits_unchanged_by_the_new_widths(cuda):
    """The wide kernels' outputs at WIDE_SHAPES on seeded normal inputs,
    where the tensor cores' summation order shows in the bits, equal
    those the parent commit's kernels gave (WIDE_DIGESTS)."""
    assert _wide_digests(WIDE_SHAPES, cuda) == WIDE_DIGESTS


# Base 64's ten fused blocks at their served shapes (640²) and as ragged
# batches of 2, in WIDE_SHAPES' form, and the SHA-256 of their outputs
# on the same seeded inputs as the parent commit's kernels computed
# them (on an NVIDIA H100 80GB HBM3, 700.00 W); chip_smoke.py holds the
# same shapes and digests.
WIDE64_SHAPES = {
    "stage1_block_1x160x160": (1, 160, 160, 0, 128, 64, 1, False, True),
    "stage2_c3k2_1x80x80": (1, 80, 80, 0, 256, 128, 2, False, True),
    "stage3_c3k2_1x40x40": (1, 40, 40, 0, 512, 256, 2, False, True),
    "fpn_c3k2_1_1x80x80": (1, 80, 80, 256, 256, 128, 1, True, False),
    "fpn_c3k2_2_1x160x160": (1, 160, 160, 128, 128, 64, 1, True, False),
    "pan_c3k2_1_1x80x80": (1, 80, 80, 128, 256, 128, 1, False, False),
    "pan_c3k2_2_1x40x40": (1, 40, 40, 256, 512, 256, 1, False, False),
    "head_p2_1x160x160": (1, 160, 160, 128),
    "head_p3_1x80x80": (1, 80, 80, 256),
    "head_p4_1x40x40": (1, 40, 40, 512),
    "stage1_block_2x19x23": (2, 19, 23, 0, 128, 64, 1, False, True),
    "stage2_c3k2_2x13x21": (2, 13, 21, 0, 256, 128, 2, False, True),
    "stage3_c3k2_2x11x13": (2, 11, 13, 0, 512, 256, 2, False, True),
    "fpn_c3k2_1_2x14x22": (2, 14, 22, 256, 256, 128, 1, True, False),
    "fpn_c3k2_2_2x18x26": (2, 18, 26, 128, 128, 64, 1, True, False),
    "pan_c3k2_1_2x13x21": (2, 13, 21, 128, 256, 128, 1, False, False),
    "pan_c3k2_2_2x11x13": (2, 11, 13, 256, 512, 256, 1, False, False),
    "head_p2_2x19x23": (2, 19, 23, 128),
    "head_p3_2x13x21": (2, 13, 21, 256),
    "head_p4_2x13x7": (2, 13, 7, 512),
}
WIDE64_DIGESTS = {
    "stage1_block_1x160x160":
        "c8fe27dbbc927132e527b629abba2cd3f40d6f3fbeb345b17ddf96ce10bee9ee",
    "stage2_c3k2_1x80x80":
        "88b89cd74c2b4e3cfd2f3f5075d71bb646e518018863924c7dd752165ee64017",
    "stage3_c3k2_1x40x40":
        "26a09e2f536a564e30c4983df28a469c288aa4317315f114cb312bad10401504",
    "fpn_c3k2_1_1x80x80":
        "f576f6b64930cde415b5bbf005b8015352c3f2db9068caca9dc2ca4dc034d5d9",
    "fpn_c3k2_2_1x160x160":
        "b13bc8ab1d869eae03bb94840a81329eee6c6febc390093c698c9e2c791fbd31",
    "pan_c3k2_1_1x80x80":
        "cf6f1e66dd009a42292f1c0b80652b0edafdd3ed9f66c1ab25f1cce416c2a816",
    "pan_c3k2_2_1x40x40":
        "000832678d3dc4d8c5550ee25555f5c1bf4a7ce2130481f54e3f839edae1694b",
    "head_p2_1x160x160":
        "b397ea56581f27d034dcdea972f1948164ed71709c002d5268a279b99cadf168",
    "head_p3_1x80x80":
        "bfb32fe428084a26e385b7382b21a04d06fb973781635b9d247da4b412919d0f",
    "head_p4_1x40x40":
        "ffa027d310f1df3aea07c448f4186256916d071d3385a9a3a82460ec980e0a05",
    "stage1_block_2x19x23":
        "1103a27e6c2948d1aa60366cf01382e73d105db42a8b0a04322a3b3b1ea9825c",
    "stage2_c3k2_2x13x21":
        "26cf0f67b6848c73c9cb0e5607bf7901510f0d6c9645c118d969a5e24100d2b3",
    "stage3_c3k2_2x11x13":
        "abed6976c46afaf17f2e1c740e2c647d9f0815c07f226de1c56d0aa00cd6400d",
    "fpn_c3k2_1_2x14x22":
        "daa82bb3f3aa9655b66325a996b8b3204871f45218c0b5c781bda538560be365",
    "fpn_c3k2_2_2x18x26":
        "18722582ef21b6e922196525e9f6bbcd2fcc01a3dde3f55c218b5e7dac1c4f96",
    "pan_c3k2_1_2x13x21":
        "0a92e846025a4ff882df4ab2e4c409eb4b508c7cf758f85f4fb9d298c4b11044",
    "pan_c3k2_2_2x11x13":
        "3b2a7742c8eb85361b8c91c5166c9ba1ceb53611991f535cabbb98564d448618",
    "head_p2_2x19x23":
        "897e226c2088591d3dba85ac70eb35b229e7866607478918a147347b480d9058",
    "head_p3_2x13x21":
        "0f6272a3dace21637e89fcd5d9a5210640038c4de449ab285fb3f44d1e83222d",
    "head_p4_2x13x7":
        "c5ef2f12e7006a20721c274e9abbe201c98c592c533095a5c5a2059565501e30",
}
# the shapes whose redesigned kernel sums in another order than the
# parent's (the head's owned plan: at 512, and at 256 on 80 x 80)
WIDE64_REORDERED = ('head_p4_1x40x40', 'head_p4_2x13x7', 'head_p3_1x80x80')


def test_wide64_kernels_bits(cuda):
    """Base 64's ten fused blocks at 640 and ragged at batch 2
    (WIDE64_SHAPES), on seeded normal inputs: the outputs' SHA-256 equal
    those the parent commit's kernels gave (WIDE64_DIGESTS), but where
    the redesigned head sums in another order (WIDE64_REORDERED: its
    owned plan, at 512 and at 256 on 80 x 80)."""
    got = _wide_digests(WIDE64_SHAPES, cuda)
    moved = {k for k, v in got.items() if WIDE64_DIGESTS[k] != v}
    assert moved == set(WIDE64_REORDERED), sorted(moved)


@pytest.mark.parametrize("case", [
    (40, 40, 256), (80, 80, 256), (40, 40, 0, 256, 128, 2, False, True),
    (40, 40, 128, 256, 128, 1, False, False),
    (80, 80, 0, 128, 64, 1, False, True)])
def test_wide_frame_bits_do_not_depend_on_the_batch(rng, cuda, case):
    """A frame gets the same bits alone and inside a batch of 4: the head,
    whose two plans sum in different orders, picks its plan from one
    image's size (base 32's head_p4 at 40 x 40, base 64's head_p3 at 80 x
    80); the C3k2 (base 32's stage3_c3k2 and pan_c3k2_2 at 40 x 40) changes
    plan with the batch, and its plans sum in the same order; so does the
    C3k2 at hidden 64 with one bottleneck at 80 x 80 (the replicated plan
    alone, the persistent one in the batch of 4)."""
    frames = 4
    if len(case) == 3:
        h, w, c = case
        x = _act(rng, (frames, h, w, c), cuda)
        ws = _to(head_kernel.pack_head_weights(
            [_kb(rng, (3, 3, c, c)), _kb(rng, (3, 3, c, c))],
            _kb(rng, (1, 1, c, 4)),
            [_kb(rng, (3, 3, c, c)), _kb(rng, (3, 3, c, c))],
            _kb(rng, (1, 1, c, 4)), torch.bfloat16), cuda)
        w33 = mma_pack.pack_head_mma(ws[0], ws[6], ws[2], ws[8], ws[4],
                                     ws[10])

        def run(xs):
            return head_kernel.fused_head(xs, *ws, w33=w33)
    else:
        h, w, ca, cb, hd, n, up, shortcut = case
        x = _act(rng, (frames, h, w, cb), cuda)
        xa = _act(rng, (frames, h, w, ca), cuda) if ca else None
        ws = _to(c3k2_kernel.pack_c3k2_weights(
            _kb(rng, (1, 1, ca + cb, hd)), _kb(rng, (1, 1, ca + cb, hd)),
            _kb(rng, (1, 1, 2 * hd, 2 * hd)),
            [(_kb(rng, (1, 1, hd, hd)), _kb(rng, (3, 3, hd, hd)))
             for _ in range(n)], torch.bfloat16), cuda)
        wpk = mma_pack.pack_c3k2_mma(ws[0], ws[6], ws[2], ws[4], ws[8], ca)

        def run(xs, k=slice(None)):
            return (c3k2_kernel.fused_c3k2(xs, *ws, shortcut=shortcut,
                                           wpk=wpk) if xa is None else
                    c3k2_kernel.fused_c3k2_cat(xa[k], xs, *ws,
                                               shortcut=shortcut, up_a=up,
                                               wpk=wpk),)
    batch = run(x)
    alone = run(x[2:3]) if len(case) == 3 else run(x[2:3], slice(2, 3))
    for got, want in zip(batch, alone):
        assert torch.equal(got[2:3], want)


# Base 64's two C3k2 blocks at 160 x 160 that the persistent plan takes,
# as ragged batches of 2 large enough for it, and the SHA-256 of their
# outputs on WIDE_SEED's inputs as the parent commit's kernels (the
# replicated plan) computed them (NVIDIA H100 80GB HBM3); chip_smoke.py
# holds the same shapes and digests.
PERSIST_SHAPES = {
    "stage1_block_2x150x134": (2, 150, 134, 0, 128, 64, 1, False, True),
    "fpn_c3k2_2_2x150x134": (2, 150, 134, 128, 128, 64, 1, True, False),
}
PERSIST_DIGESTS = {
    "stage1_block_2x150x134":
        "4bf80a77f79335516da03a4dccddd15e2bc865fefb2d58d27c66d080087befc3",
    "fpn_c3k2_2_2x150x134":
        "fc09e79c3fda63a338ddb03f434fa7c476c0c1cc39da16c1e5e9cc9b96afd564",
}
PERSIST_SERVED = ("stage1_block_1x160x160", "fpn_c3k2_2_1x160x160")


def test_persist_plan_bits_unchanged(cuda):
    """The persistent plan at ragged batches of 2 (PERSIST_SHAPES) gives
    the parent's bits (PERSIST_DIGESTS); at the served shapes the
    WIDE64_DIGESTS test holds it."""
    assert _wide_digests(PERSIST_SHAPES, cuda) == PERSIST_DIGESTS


def _persist_case(rng, case, cuda, kb=_kb, act=_act):
    """A call of the wide C3k2 at one of WIDE_SHAPES' C3k2 cases on
    ``rng``'s inputs (activations from ``act``, weights from ``kb``), and
    of its plain version."""
    b, h, w, ca, cb, hd, n, up, sc = case
    xb = act(rng, (b, h, w, cb), cuda)
    xa = act(rng, (b, h // 2, w // 2, ca) if up else (b, h, w, ca), cuda) \
        if ca else None
    ws = _to(c3k2_kernel.pack_c3k2_weights(
        kb(rng, (1, 1, ca + cb, hd)), kb(rng, (1, 1, ca + cb, hd)),
        kb(rng, (1, 1, 2 * hd, 2 * hd)),
        [(kb(rng, (1, 1, hd, hd)), kb(rng, (3, 3, hd, hd)))
         for _ in range(n)], torch.bfloat16), cuda)
    wpk = mma_pack.pack_c3k2_mma(ws[0], ws[6], ws[2], ws[4], ws[8], ca)
    if xa is None:
        return (lambda: c3k2_kernel.fused_c3k2(xb, *ws, shortcut=sc,
                                               wpk=wpk),
                lambda: c3k2_kernel.fused_c3k2_plain(xb, *ws, shortcut=sc))
    return (lambda: c3k2_kernel.fused_c3k2_cat(xa, xb, *ws, shortcut=sc,
                                               up_a=up, wpk=wpk),
            lambda: c3k2_kernel.fused_c3k2_cat_plain(xa, xb, *ws,
                                                     shortcut=sc, up_a=up))


@pytest.mark.parametrize("name", [*PERSIST_SERVED, *PERSIST_SHAPES])
def test_persist_plan_bit_exact_on_grid_inputs(rng, cuda, name):
    """The persistent plan on binary-grid inputs (every f32 sum exact in
    any order) at the served shapes and ragged batches of 2: bit for bit
    the plain version, and the launch ``wide_launch`` gives for the card's
    SMs."""
    case = {**WIDE64_SHAPES, **PERSIST_SHAPES}[name]
    call, plain = _persist_case(rng, case, cuda, kb=_grid_kb, act=_grid_act)
    got, want = call(), plain()
    torch.cuda.synchronize()
    assert float(want.float().abs().max()) > 1.0
    assert torch.equal(got, want)
    b, h, w, ca, cb, hd, n, up, _ = case
    assert c3k2_kernel.wide_plan(ca, cb, up, hd, n, b, h, w) == "persistent"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert c3k2_kernel.last_launch() == c3k2_kernel.wide_launch(
        ca, cb, up, hd, n, b, h, w, sms=sms)


@pytest.mark.parametrize("name", [*PERSIST_SERVED, *PERSIST_SHAPES])
def test_persist_plan_relaunch_bit_equal(cuda, name):
    """The persistent plan's blocks reuse their ring's slots and windows
    from tile to tile (the next tile's chunks and input copied while this
    tile multiplies): 100 launches back to back on seeded normal inputs,
    each output bit for bit the first (a race would flip a bit in some
    launch)."""
    case = {**WIDE64_SHAPES, **PERSIST_SHAPES}[name]
    call, _ = _persist_case(np.random.default_rng(WIDE_SEED), case, cuda)
    outs = [call() for _ in range(100)]
    torch.cuda.synchronize()
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


# The head at 128 on the large plan (base 64's head_p2 at 160 x 160, and
# a ragged batch of 2 large enough for it: a part tile at the end of each
# row and column), and the SHA-256 of its outputs on WIDE_SEED's inputs as
# the parent commit's kernel (the replicated plan) computed them (NVIDIA
# H100 80GB HBM3); chip_smoke.py holds the same shape and digest in
# PERSIST_SHAPES.
LARGE_SHAPES = {"head_p2_2x150x134": (2, 150, 134, 128)}
LARGE_DIGESTS = {
    "head_p2_2x150x134":
        "1f2541a306ca268a5a524b456aff1bc68a261103cf177ffe551dd06bdfe2bbfe",
}
LARGE_SERVED = ("head_p2_1x160x160",)


def test_large_plan_bits_unchanged(cuda):
    """The large plan at a ragged batch of 2 (LARGE_SHAPES) gives the
    parent's bits (LARGE_DIGESTS); at the served shape the WIDE64_DIGESTS
    test holds it."""
    assert _wide_digests(LARGE_SHAPES, cuda) == LARGE_DIGESTS


@pytest.mark.parametrize("name", [*LARGE_SERVED, *LARGE_SHAPES])
def test_large_plan_bit_exact_on_grid_inputs(rng, cuda, name):
    """The large plan on binary-grid inputs (every f32 sum exact in any
    order) at the served shape and a ragged batch of 2: bit for bit the
    plain version, and the launch ``wide_launch`` gives for the card's
    SMs."""
    b, h, w, c = {**WIDE64_SHAPES, **LARGE_SHAPES}[name]
    assert head_kernel.large_plan(c, h, w)
    x = _grid_act(rng, (b, h, w, c), cuda)
    ws, w33 = _head_ws(rng, c, cuda, kb=_grid_kb)
    got = head_kernel.fused_head(x, *ws, w33=w33)
    want = head_kernel.fused_head_plain(x, *ws)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        assert float(w_.abs().max()) > 1.0
        assert torch.equal(g, w_)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert head_kernel.last_launch() == head_kernel.wide_launch(
        c, b, h, w, sms=sms)


@pytest.mark.parametrize("name", [*LARGE_SERVED, *LARGE_SHAPES])
def test_large_plan_relaunch_bit_equal(cuda, name):
    """The large plan's blocks reuse their ring's slots and windows from
    unit to unit (the next unit's chunks and x window copied while this
    unit multiplies; three warpgroups releasing each slot): 100 launches
    back to back on seeded normal inputs, each output bit for bit the
    first."""
    b, h, w, c = {**WIDE64_SHAPES, **LARGE_SHAPES}[name]
    rng = np.random.default_rng(WIDE_SEED)
    x = _act(rng, (b, h, w, c), cuda)
    ws, w33 = _head_ws(rng, c, cuda)
    outs = [head_kernel.fused_head(x, *ws, w33=w33) for _ in range(100)]
    torch.cuda.synchronize()
    for o in outs[1:]:
        assert all(torch.equal(a, a0) for a, a0 in zip(o, outs[0]))


# ---- the unfused int8 engine and the folded QAT model ----

@pytest.mark.parametrize("flags,mode", [
    (["--int8", "--int8-unfused", "--s2d-merged", "--fused-stem"], "int8"),
    (["--s2d-merged", "--fused-stem", "--merged-head"], "quantize")])
def test_deploy_modes_on_the_card(cuda, tmp_path, flags, mode):
    """Exported on the card from the committed checkpoint: a clean strict
    report; the captured graph equals the eager frame bit for bit on three
    scenes, the card agrees with the port's CPU path (same count, 0.5 px,
    1e-2), one stem launch an eager frame."""
    import json

    from unina_yolo_dla_torch import export

    out = tmp_path / mode
    export.main(["--weights", str(SOURCE), *flags, "--cp-calibration",
                 str(CP), "--output", str(out)])
    conf = json.loads((out / "config.json").read_text())
    assert conf["quant_mode"] == mode
    graph, eager = ServingArtifact(out), ServingArtifact(out, graph=False)
    assert graph.graph.report.clean
    for frame in _scenes([1, 2, 7]):
        got = graph(frame)
        want = _launched(stem_kernel.KERNEL, lambda: eager(frame))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    frame = _scenes([7])[0]
    _match(graph(frame), ServingArtifact(out, device="cpu")(frame))


# ---- fleet serving ----

@pytest.mark.parametrize("devices", [["cuda:0"], ["cuda:0", "cuda:0"]])
def test_fleet_matches_batch8_graph(cuda, devices):
    """The batch-8 artifact's model as a fleet (one program, or two on
    the card with their own streams and graphs): bit for bit the batch-8
    graph's Detections; replays launch nothing."""
    from unina_yolo_dla_torch.parallel import (
        make_sharded_batch_serving_fn, shard_streams)

    scenes = _scenes(range(1, 9))
    art = ServingArtifact(ARTIFACT_B8)
    want = art(scenes)
    c = art.config
    fleet = make_sharded_batch_serving_fn(
        art.model, art.model_config, devices,
        conf_threshold=c["conf_threshold"], iou_threshold=c["iou_threshold"],
        q_factor=c["q_factor"], max_detections=c["max_detections"])
    staged = merged_frame_np(scenes)
    fleet(shard_streams(staged, devices))   # captures each program
    torch.cuda.synchronize()
    assert all(p.graph.report.clean for p in fleet.programs)
    before = {k.symbol: k.launches for k in _lib.KERNELS}
    got = fleet(shard_streams(staged, devices))
    torch.cuda.synchronize()
    assert {k.symbol: k.launches for k in _lib.KERNELS} == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---- the int8 conv ----

# the shipped engine's 46 int8 layers by shape: (kernel, stride, H, W, C,
# N, cout, epilogue) -> layers of that shape in one frame
SHIPPED_INT8 = int8_conv_kernel.SHIPPED_LAYERS
# odd sizes, ragged tiles and narrow channel counts: base 16's narrowest
# (C = 32), the unfused engine's 160 x 160 layers (C = N = 32), C = 16 and
# 48 (a 32-deep K step half past C), N not a multiple of 64
ODD_INT8 = [
    (3, 1, 13, 7, 32, 32, 32, "qres", 3),
    (3, 2, 17, 11, 16, 24, 24, "q", 2),
    (1, 1, 9, 5, 48, 40, 40, "q", 1),
    (3, 1, 21, 19, 32, 8, 3, "f32", 1),
    (3, 2, 160, 160, 64, 128, 128, "f32", 1),
    (1, 1, 160, 160, 32, 32, 32, "f32", 1),
    (3, 1, 11, 13, 96, 72, 72, "qres", 2),
]


def _int8_layer(rng, shape, batch, grid, dev):
    """One layer's inputs: random int8 over the full range, scales and
    biases of the engine's size; or on grids, where comb and the scales
    are powers of two and the biases multiples of 1/8, so many requants
    fall on exact .5 ties (round half to even) and past the clip."""
    k, s, h, w, c, n, cout, mode = shape
    if grid:
        i = np.arange(batch * h * w * c).reshape(batch, h, w, c)
        x = ((i * 37) % 255 - 127).astype(np.int8)
        wq = ((np.arange(n * k * k * c).reshape(n, -1) * 11) % 7 - 3).astype(
            np.int8)
        comb = np.full(n, 2.0 ** -9, np.float32)
        bias = ((np.arange(n) % 17) - 8).astype(np.float32) / 8
        amax = dict(out_amax=np.float32(31.75), res_amax=np.float32(63.5),
                    add_amax=np.float32(15.875))
    else:
        x = rng.integers(-128, 128, (batch, h, w, c), dtype=np.int8)
        wq = rng.integers(-127, 128, (n, k * k * c), dtype=np.int8)
        comb = (rng.uniform(0.5, 1.5, n) * 2.5 / 127
                * np.sqrt(2 / (k * k * c)) / 73).astype(np.float32)
        bias = rng.normal(0, 0.1, n).astype(np.float32)
        amax = dict(out_amax=np.float32(2.5), res_amax=np.float32(3.1),
                    add_amax=np.float32(4.2))
    ho, wo = int8_conv_kernel.out_size(h, w, k, s)
    res = rng.integers(-127, 128, (batch, ho, wo, cout), dtype=np.int8)
    t = [torch.from_numpy(a).to(dev) for a in (x, wq, comb, bias, res)]
    kw = {}
    if mode != "f32":
        kw["out_amax"] = amax["out_amax"]
    if mode == "qres":
        kw.update(res=t[4], res_amax=amax["res_amax"],
                  add_amax=amax["add_amax"])
    return (*t[:4], k, k, s, k // 2, cout), kw


@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("shape", [*SHIPPED_INT8, *ODD_INT8],
                         ids=lambda s: "x".join(map(str, s)))
def test_int8_conv_kernel_bit_exact(rng, cuda, shape, batch, grid):
    """Every layer shape of the shipped engine and odd ones, batch 1 and 8,
    random and grid inputs: the kernel bit for bit ``int8_conv_plain``
    (im2col, ``torch._int_mm``, the float64-emulated FMA, the requants) on
    the card; one wrapper call is one launch."""
    if len(shape) == 9:
        *shape, batch_odd = shape
        batch = batch_odd if batch == 1 else batch
    args, kw = _int8_layer(rng, shape, batch, grid, cuda)
    got = _launched(int8_conv_kernel.KERNEL,
                    lambda: int8_conv_kernel.int8_conv(*args, **kw))
    want = int8_conv_kernel.int8_conv_plain(*args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.is_contiguous()
    diff = (got.float() - want.float()).abs()
    assert torch.equal(got, want), (
        f"{int((diff > 0).sum())} elements differ, max {float(diff.max())}")


def _quant_amaxes(tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "amax":
                yield float(np.float32(v))
            else:
                yield from _quant_amaxes(v)


def test_int8_requant_is_the_true_division(rng, cuda):
    """The kernel's requants (ReLU and clamp(round(v / s_out)); then the
    residual sum's clamp(round(t / s_add))) bit for bit the plain version's
    true division, at every scale of the shipped engine's quantisers: x = 0
    makes acc = 0 and each layer output y = fma(0, comb, bias) = bias, so
    the biases are the values divided: random ones, and every value within
    64 ulps of each half-step tie."""
    amaxes = sorted(set(_quant_amaxes(load_msgpack_raw(
        ARTIFACT / "variables.msgpack")["quant"])))
    assert len(amaxes) > 40
    for i, amax in enumerate(amaxes):
        s = float(np.float32(max(np.float32(amax), np.float32(1e-9)))
                  / np.float32(127))
        ties = (np.arange(-300, 301) * 0.5 * s).astype(np.float32)
        near = (ties.view(np.int32)[:, None]
                + np.arange(-64, 65, dtype=np.int32)).reshape(-1)
        near = near.view(np.float32)
        near = near[np.isfinite(near)]
        vals = np.concatenate([near, rng.uniform(-300 * s, 300 * s, 1 << 14)
                               .astype(np.float32)])
        vals = np.concatenate([vals, np.zeros(-len(vals) % 8, np.float32)])
        n = len(vals)
        x = torch.zeros((1, 17, 1, 16), dtype=torch.int8, device=cuda)
        w = torch.zeros((n, 16), dtype=torch.int8, device=cuda)
        comb = torch.ones(n, device=cuda)
        bias = torch.from_numpy(vals).to(cuda)
        res = torch.from_numpy(rng.integers(-127, 128, (1, 17, 1, n),
                                            dtype=np.int8)).to(cuda)
        add = np.float32(amaxes[(i + 7) % len(amaxes)])
        for kw in ({"out_amax": np.float32(amax)},
                   {"out_amax": np.float32(amax), "res": res,
                    "res_amax": np.float32(amaxes[i - 1]), "add_amax": add}):
            args = (x, w, comb, bias, 1, 1, 1, 0, n)
            got = int8_conv_kernel.int8_conv(*args, **kw)
            want = int8_conv_kernel.int8_conv_plain(*args, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (
                f"amax {amax}: {int((got != want).sum())} of {got.numel()}")


def test_int8_conv_refuses_what_it_does_not_take(rng, cuda):
    """A CUDA tensor the kernel does not take raises; the plain version is
    never run in its place."""
    args, kw = _int8_layer(rng, (3, 1, 9, 9, 32, 32, 32, "q"), 1, False,
                           cuda)
    x, w, comb, bias, *geom = args
    calls = [
        lambda: int8_conv_kernel.int8_conv(x[..., :24].contiguous(),
                                           w[:, :216].contiguous(), comb,
                                           bias, *geom, **kw),
        lambda: int8_conv_kernel.int8_conv(x, w, comb, bias, 3, 3, 1,
                                           ((1, 0), (1, 0)), 32, **kw),
        lambda: int8_conv_kernel.int8_conv(x, w, comb, bias, 1, 1, 2, 0, 32),
        lambda: int8_conv_kernel.int8_conv(x.float(), w, comb, bias, *geom),
        lambda: int8_conv_kernel.int8_conv(x, w.cpu(), comb, bias, *geom),
        lambda: int8_conv_kernel.int8_conv(
            x, w, comb, bias, *geom, out_amax=np.float32(1.0),
            res=torch.zeros((1, 9, 9, 16), dtype=torch.int8, device=cuda),
            res_amax=1.0, add_amax=1.0),
    ]
    before = int8_conv_kernel.KERNEL.launches
    for call in calls:
        with pytest.raises(ValueError):
            call()
    assert int8_conv_kernel.KERNEL.launches == before


def test_int8_quant_conv_on_the_card_launches_the_kernel(cuda, monkeypatch):
    """The shipped engine on the card: every int8 layer is one launch of
    the int8 conv kernel (46 a frame), ``torch._int_mm`` and the im2col
    are never called, and the Detections equal the graph's."""
    from unina_yolo_dla_torch.quant import fake_quant

    art = ServingArtifact(ARTIFACT, graph=False)
    frame = _scenes([7])[0]
    art(frame)
    torch.cuda.synchronize()

    def refuse(*a, **k):
        raise AssertionError("the plain int8 product ran on the card")

    monkeypatch.setattr(torch, "_int_mm", refuse)
    monkeypatch.setattr(fake_quant, "im2col_nhwc", refuse)
    before = int8_conv_kernel.KERNEL.launches
    got = art(frame)
    torch.cuda.synchronize()
    assert int8_conv_kernel.KERNEL.launches == before + INT8_LAYERS
    monkeypatch.undo()
    want = ServingArtifact(ARTIFACT)(frame)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _plans_of(shape, batch):
    """The plans the kernel takes for a layer: the chosen one and every
    other tile width and ring depth."""
    import itertools

    k, s, h, w, c, n = shape[:6]
    chosen = int8_conv_kernel.plan(batch, h, w, c, n, k, s)
    out = [chosen]
    for bn, stages in itertools.product(int8_conv_kernel.TILE_WIDTHS,
                                        (4, 5, 6, 8)):
        p = dict(chosen, bn=bn, stages=stages)
        try:
            int8_conv_kernel.check_plan(p, c, n, k)
        except ValueError:
            continue
        out.append(p)
    return out


@pytest.mark.parametrize("shape", [
    (3, 1, 13, 7, 32, 32, 32, "qres", 3),     # patches cut by the edge
    (3, 2, 17, 11, 16, 24, 24, "q", 2),       # stride 2, odd, C = 16
    (1, 1, 9, 5, 48, 40, 40, "q", 1),         # C = 48 past a 32-byte chunk
    (3, 1, 21, 19, 32, 8, 3, "f32", 1),
    (3, 1, 11, 13, 96, 72, 72, "qres", 2),
    (3, 2, 19, 23, 128, 256, 256, "q", 8),    # stride 2, odd, batch 8
    (3, 1, 40, 40, 256, 256, 256, "q", 8),    # head_p4's: 18 K steps
], ids=lambda s: "x".join(map(str, s)))
def test_int8_conv_every_plan_same_bits(rng, cuda, shape):
    """Every plan the kernel takes (tile width, ring depth) gives the plain
    version's bits: TMA's zero fill at the padding, past the image, past C
    and past N; tiles cut by the image edge; stride 2 at odd sizes; the
    longest K split across the two warpgroups at batch 8."""
    *shape, batch = shape
    args, kw = _int8_layer(rng, shape, batch, False, cuda)
    want = int8_conv_kernel.int8_conv_plain(*args, **kw)
    plans = _plans_of(shape, batch)
    assert len({(p["bn"], p["stages"]) for p in plans}) >= 8
    for p in plans:
        got = int8_conv_kernel.int8_conv(*args, **kw, launch_plan=p)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (p, int((got != want).sum()))


def test_int8_conv_relaunches_graph_and_streams(rng, cuda):
    """One layer of each geometry on its chosen plan: 100 relaunches equal
    the first; a replayed graph of the launch equals the eager launch; two
    streams launching at once each get their own bits."""
    shapes = [(3, 1, 40, 40, 256, 256, 256, "q"),
              (3, 1, 80, 80, 64, 64, 64, "qres"),
              (3, 2, 80, 80, 128, 256, 256, "q"),
              (1, 1, 80, 80, 128, 8, 4, "f32")]
    layers = [_int8_layer(rng, s, 1, False, cuda) for s in shapes]
    for args, kw in layers:
        first = int8_conv_kernel.int8_conv(*args, **kw)
        for _ in range(100):
            again = int8_conv_kernel.int8_conv(*args, **kw)
            assert torch.equal(again, first)
        graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            int8_conv_kernel.int8_conv(*args, **kw)
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            replayed = int8_conv_kernel.int8_conv(*args, **kw)
        for _ in range(10):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(replayed, first)
    want = [int8_conv_kernel.int8_conv_plain(*a, **k) for a, k in layers]
    streams = [torch.cuda.Stream() for _ in layers]
    torch.cuda.synchronize()
    outs = [None] * len(layers)
    for _ in range(20):
        for i, ((args, kw), st) in enumerate(zip(layers, streams)):
            with torch.cuda.stream(st):
                outs[i] = int8_conv_kernel.int8_conv(*args, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(o, w) for o, w in zip(outs, want))


@pytest.mark.parametrize("shape", list(SHIPPED_INT8),
                         ids=lambda s: "x".join(map(str, s)))
def test_int8_conv_launch_records_its_plan(rng, cuda, shape):
    """Each shipped layer shape launches on ``plan``'s choice: the wrapper
    records it, and the library's record of the launch (grid, threads,
    shared memory) is that plan's."""
    args, kw = _int8_layer(rng, shape, 1, False, cuda)
    k, s, h, w, c, n = shape[:6]
    want = int8_conv_kernel.plan(1, h, w, c, n, k, s)
    _launched(int8_conv_kernel.KERNEL,
              lambda: int8_conv_kernel.int8_conv(*args, **kw))
    assert int8_conv_kernel.last_plan() == want
    rec = int8_conv_kernel.last_launch()
    assert rec == dict(grid=want["grid"], threads=want["threads"],
                       smem_bytes=want["smem_bytes"])


def test_int8_conv_dependent_pair_in_a_graph(rng, cuda):
    """Two dependent layers (a bottleneck's cv1 -> cv2 with its residual),
    each a programmatic dependent launch: the eager pair equals the plain
    composition, and each of 1,000 replays of the pair captured in a graph
    equals the eager pair."""
    (x, w1, c1, b1, *g1), kw1 = _int8_layer(
        rng, (1, 1, 40, 40, 128, 128, 128, "q"), 1, False, cuda)
    (_, w2, c2, b2, *g2), kw2 = _int8_layer(
        rng, (3, 1, 40, 40, 128, 128, 128, "qres"), 1, False, cuda)

    def pair():
        y = int8_conv_kernel.int8_conv(x, w1, c1, b1, *g1, **kw1)
        return int8_conv_kernel.int8_conv(y, w2, c2, b2, *g2,
                                          **dict(kw2, res=y))

    want = pair()
    torch.cuda.synchronize()
    assert torch.equal(want, int8_conv_kernel.int8_conv_plain(
        int8_conv_kernel.int8_conv_plain(x, w1, c1, b1, *g1, **kw1), w2, c2,
        b2, *g2, **dict(kw2, res=int8_conv_kernel.int8_conv_plain(
            x, w1, c1, b1, *g1, **kw1))))
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        pair()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph, stream=stream):
        got = pair()
    for i in range(1000):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want), i


# ---- the int8 chain's glue: SPPF's pools (kernel 11), the concat (12) ----

# odd sizes and channel counts, unaligned parts, f32 parts, upsampled
# parts: (B, H, W, the output's amax or None (qconcat's rule), parts),
# a part (channels, kind, amax, up) as in ``SHIPPED_SITES``, "f32" a
# float32 part
ODD_SITES = [
    (2, 7, 9, None, ((16, "s8", 3.0, False), (13, "s8", 1.75, False),
                     (21, "s8", 3.0, False))),
    (1, 6, 10, None, ((24, "s8", 7.90625, True), (17, "s8", 28.125, False))),
    (3, 5, 6, 2.5, ((8, "bf16", None, False), (11, "f32", None, False))),
    (1, 9, 7, 27.125, ((19, "bf16", None, False),)),
    (2, 8, 6, 16.875, ((7, "deq", 12.625, False), (9, "bf16", None, False),
                       (32, "deq", 20.0, True))),
    (1, 4, 6, 9.5, ((16, "deq", 7.8125, True), (5, "f32", None, False))),
    (8, 40, 40, None, ((128, "s8", 12.625, False),
                       (256, "s8", 16.875, False))),
    (1, 80, 80, 23.875, ((64, "bf16", None, True),
                         (128, "deq", 23.875, False))),
]


def _glue_parts(rng, b, h, w, amax, parts, dev):
    """A site's parts on ``dev``: int8 from -127 (what the chain's
    producers emit), floats of the output's scale with a third of them on
    half-step ties; each at half the size where it is upsampled."""
    s = float(np.float32(max(amax or 1.0, 1e-9)) / np.float32(127))
    xs, up = [], []
    for c, kind, a, u in parts:
        shape = (b, h // 2, w // 2, c) if u else (b, h, w, c)
        if kind in ("s8", "deq"):
            q = torch.from_numpy(rng.integers(-127, 128, shape,
                                              dtype=np.int8)).to(dev)
            xs.append(QTensor(q, np.float32(a)))
        else:
            v = rng.normal(0, 64 * s, shape).astype(np.float32)
            ties = ((rng.integers(-260, 260, shape) + 0.5) * s).astype(
                np.float32)
            v = np.where(rng.random(shape) < 0.3, ties, v)
            t = torch.from_numpy(v).to(dev)
            xs.append(t.to(torch.bfloat16) if kind == "bf16" else t)
        up.append(u)
    return xs, up


def _glue_call(xs, up, amax, plain=False):
    if amax is None:
        fn = (qconcat_kernel.int8_concat_plain if plain
              else qconcat_kernel.int8_concat)
        return fn(xs, up)
    fn = (qconcat_kernel.quantize_concat_plain if plain
          else qconcat_kernel.quantize_concat)
    return fn(xs, amax, up)


def _site_args(site, batch):
    name, h, w, amax, parts = site
    # int8_concat where every part is int8 and kept (COPY / REQ); else
    # quantize_concat at the site's amax
    kept = all(kind == "s8" for _, kind, _, _ in parts)
    return batch, h, w, None if kept else amax, parts


GLUE_SITES = [_site_args(site, batch)
              for site in qconcat_kernel.SHIPPED_SITES for batch in (1, 8)]
GLUE_SITE_IDS = [f"{site[0].replace(' ', '_')}_b{batch}"
                 for site in qconcat_kernel.SHIPPED_SITES
                 for batch in (1, 8)]


@pytest.mark.parametrize("site", GLUE_SITES + ODD_SITES, ids=GLUE_SITE_IDS + [
    "odd_" + "_".join(f"{p[1]}{p[0]}" for p in s[4]) for s in ODD_SITES])
def test_qconcat_kernel_bit_exact(rng, cuda, site):
    """Kernel 12 at every shipped site (batch 1 and 8) and at odd sizes,
    channel counts and part layouts: bit for bit its plain version on the
    card (upsample, requantize, dequant, cat, quantize); one wrapper call
    is one launch."""
    b, h, w, amax, parts = site
    xs, up = _glue_parts(rng, b, h, w, amax, parts, cuda)
    got = _launched(qconcat_kernel.KERNEL, lambda: _glue_call(xs, up, amax))
    want = _glue_call(xs, up, amax, plain=True)
    torch.cuda.synchronize()
    assert got.q.dtype == torch.int8 and got.q.shape == want.q.shape
    assert got.q.is_contiguous() and got.amax == want.amax
    assert torch.equal(got.q, want.q), (
        f"{int((got.q != want.q).sum())} of {got.q.numel()} differ")


SPPF_SHAPES = [sppf_kernel.SHIPPED_SHAPE, (8, 40, 40, 128), (1, 7, 9, 5),
               (2, 17, 14, 3), (1, 13, 21, 48), (3, 20, 20, 256),
               (1, 1, 1, 16), (2, 33, 8, 40)]


@pytest.mark.parametrize("shape", SPPF_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_int8_sppf_kernel_bit_exact(rng, cuda, shape):
    """Kernel 11 at SPPF's shipped shape, batch 1 and 8, and at odd sizes
    (below and above the 13-pixel reach of the third pool) and channel
    counts: bit for bit ``qmaxpool`` three times and ``qconcat`` on the
    card, -128 among the inputs; one wrapper call is one launch."""
    q = torch.from_numpy(rng.integers(-128, 128, shape,
                                      dtype=np.int8)).to(cuda)
    x = QTensor(q, np.float32(20.375))
    got = _launched(sppf_kernel.KERNEL, lambda: sppf_kernel.int8_sppf(x))
    want = sppf_kernel.int8_sppf_plain(x)
    torch.cuda.synchronize()
    assert got.q.shape == (*shape[:3], 4 * shape[3]) and got.amax == x.amax
    assert torch.equal(got.q, want.q), (
        f"{int((got.q != want.q).sum())} of {got.q.numel()} differ")


def test_int8_glue_in_a_graph_after_a_dependent_conv(rng, cuda):
    """The glue right after an int8 conv launched with programmatic
    dependent launch on the same stream (the glue's launch waits for the
    conv's grid to end): SPPF's pools of the conv's output, and a concat
    of it with another part, equal the plain versions of the conv's
    output, eager and in each of 200 replays of a captured graph of the
    three launches."""
    (x, w1, c1, b1, *g1), kw1 = _int8_layer(
        rng, (1, 1, 40, 40, 256, 128, 128, "q"), 1, False, cuda)
    other = QTensor(torch.from_numpy(rng.integers(
        -127, 128, (1, 40, 40, 128), dtype=np.int8)).to(cuda),
        np.float32(12.625))
    out_amax = np.float32(kw1["out_amax"])

    def chain():
        y = QTensor(int8_conv_kernel.int8_conv(x, w1, c1, b1, *g1, **kw1),
                    out_amax)
        return (sppf_kernel.int8_sppf(y).q,
                qconcat_kernel.int8_concat([other, y]).q)

    y = QTensor(int8_conv_kernel.int8_conv_plain(x, w1, c1, b1, *g1, **kw1),
                out_amax)
    want = (sppf_kernel.int8_sppf_plain(y).q,
            qconcat_kernel.int8_concat_plain([other, y]).q)
    got = chain()
    torch.cuda.synchronize()
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        chain()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph, stream=stream):
        got = chain()
    for i in range(200):
        for g in got:
            g.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(g, w_) for g, w_ in zip(got, want)), i


def _every_value(kind, n):
    """n values cycling through every int8 value (-128 included) or every
    finite bf16 value."""
    if kind == "bf16":
        v = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
        v = v[np.isfinite(v)]
    else:
        v = np.arange(-128, 128).astype(np.int8)
    return np.resize(v, n)


@pytest.mark.parametrize("site", qconcat_kernel.SHIPPED_SITES,
                         ids=lambda s: s[0].replace(" ", "_"))
def test_qconcat_every_value_at_shipped_site(cuda, site):
    """Each shipped site's modes and amaxes on every value its parts can
    hold (every int8 value, -128 included, and every finite bf16 value),
    and again with its amaxes scaled so that the output's is 18.0, then
    21.875 (the amaxes whose scale the reference's jitted form computes one
    f32 step from the IEEE quotient; ties +-amax / 2 among the bf16
    values): bit for bit the plain version (the rounding by the f32 adder,
    the DEQ_Q table)."""
    _, _, _, amax, parts = site
    w = 10880   # 2 x 10880 x 3 >= the 65024 finite bf16 values
    for shift in (None, 18.0, 21.875):
        arrays, xs, up = [], [], []
        for c, kind, a, u in parts:
            shape = (1, 1, w // 2, 3) if u else (1, 2, w, 3)
            arr = _every_value(kind, int(np.prod(shape))).reshape(shape)
            t = torch.from_numpy(arr).to(cuda)
            if kind == "bf16":
                xs.append(t.to(torch.bfloat16))
            else:   # the site's amaxes scaled so that its output's is shift
                xs.append(QTensor(t, np.float32(a if shift is None else
                                                a * shift / amax)))
            up.append(u)
        target = None if all(k == "s8" for _, k, _, _ in parts) else (
            np.float32(shift or amax))
        got = _launched(qconcat_kernel.KERNEL,
                        lambda: _glue_call(xs, up, target))
        want = _glue_call(xs, up, target, plain=True)
        torch.cuda.synchronize()
        assert torch.equal(got.q, want.q), (shift, int((got.q != want.q).sum()))


def _misaligned(t):
    """``t``'s values in a contiguous tensor whose data starts one element
    past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    out = flat[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out


def test_glue_unaligned_parts_take_the_byte_path(rng, cuda):
    """Parts whose data start off a 16-byte boundary (the byte path, each
    part's other parts still 16-byte ones) and SPPF on such an input:
    bit for bit the plain versions, one launch each."""
    for b, h, w, amax, parts in (GLUE_SITES[3], GLUE_SITES[10],
                                 ODD_SITES[-1]):
        xs, up = _glue_parts(rng, b, h, w, amax, parts, cuda)
        xs[0] = (QTensor(_misaligned(xs[0].q), xs[0].amax)
                 if isinstance(xs[0], QTensor) else _misaligned(xs[0]))
        got = _launched(qconcat_kernel.KERNEL,
                        lambda: _glue_call(xs, up, amax))
        want = _glue_call(xs, up, amax, plain=True)
        torch.cuda.synchronize()
        assert torch.equal(got.q, want.q), parts
    for shape in (sppf_kernel.SHIPPED_SHAPE, (2, 17, 45, 48)):
        q = torch.from_numpy(rng.integers(-128, 128, shape,
                                          dtype=np.int8)).to(cuda)
        x = QTensor(_misaligned(q), np.float32(20.375))
        got = _launched(sppf_kernel.KERNEL, lambda: sppf_kernel.int8_sppf(x))
        want = sppf_kernel.int8_sppf_plain(x)
        torch.cuda.synchronize()
        assert torch.equal(got.q, want.q), shape


def test_int8_glue_between_dependent_convs_in_a_graph(rng, cuda):
    """The chain conv -> glue -> conv as the frame runs it, every launch
    with programmatic dependent launch: an int8 conv, SPPF's pools of its
    output and a 1x1 int8 conv of those; the conv's output concatenated
    with another part (a REQ part) and a 1x1 conv of the concat; a float
    part and the conv's output dequantised and quantised (DEQ_Q + Q) and a
    1x1 conv of that. Eager, and in each of 200 replays of a captured
    graph of the launches: bit for bit the plain composition."""
    (x, w1, c1, b1, *g1), kw1 = _int8_layer(
        rng, (1, 1, 40, 40, 256, 128, 128, "q"), 1, False, cuda)
    out_amax = np.float32(kw1["out_amax"])
    other = QTensor(torch.from_numpy(rng.integers(
        -127, 128, (1, 40, 40, 128), dtype=np.int8)).to(cuda),
        np.float32(12.625))
    flt = torch.from_numpy(rng.normal(0, 1, (1, 40, 40, 64)).astype(
        np.float32)).to(cuda).to(torch.bfloat16)

    def conv1x1(cin, seed):
        r = np.random.default_rng(seed)
        w = torch.from_numpy(r.integers(-127, 128, (64, cin),
                                        dtype=np.int8)).to(cuda)
        comb = torch.from_numpy((r.uniform(0.5, 1.5, 64) * 1e-4).astype(
            np.float32)).to(cuda)
        bias = torch.from_numpy(r.normal(0, 0.1, 64).astype(
            np.float32)).to(cuda)
        return lambda t, conv: conv(t, w, comb, bias, 1, 1, 1, 0, 64,
                                    np.float32(3.5))

    after = [conv1x1(512, 1), conv1x1(256, 2), conv1x1(192, 3)]

    def chain(plain=False):
        conv = (int8_conv_kernel.int8_conv_plain if plain
                else int8_conv_kernel.int8_conv)
        sppf = (sppf_kernel.int8_sppf_plain if plain
                else sppf_kernel.int8_sppf)
        cat = (qconcat_kernel.int8_concat_plain if plain
               else qconcat_kernel.int8_concat)
        quant = (qconcat_kernel.quantize_concat_plain if plain
                 else qconcat_kernel.quantize_concat)
        y = QTensor(conv(x, w1, c1, b1, *g1, **kw1), out_amax)
        return (after[0](sppf(y).q, conv), after[1](cat([other, y]).q, conv),
                after[2](quant([flt, y], np.float32(3.0)).q, conv))

    want = chain(plain=True)
    got = chain()
    torch.cuda.synchronize()
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        chain()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph, stream=stream):
        got = chain()
    for i in range(200):
        for g in got:
            g.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(g, w_) for g, w_ in zip(got, want)), i


def test_int8_glue_refuses_what_it_does_not_take(rng, cuda):
    """A CUDA tensor the kernels do not take raises ValueError; the plain
    version is never run in its place and nothing is launched."""
    q = torch.from_numpy(rng.integers(-127, 128, (1, 8, 8, 16),
                                      dtype=np.int8)).to(cuda)
    a = QTensor(q, np.float32(2.0))
    f = torch.randn((1, 8, 8, 16), device=cuda)
    calls = [
        lambda: sppf_kernel.int8_sppf(a, 3),                  # not 5 x 5
        lambda: sppf_kernel.int8_sppf(QTensor(q.float(), a.amax)),
        lambda: sppf_kernel.int8_sppf(QTensor(q[0], a.amax)),  # not NHWC
        lambda: qconcat_kernel.int8_concat([a, QTensor(q[:, :4], a.amax)]),
        lambda: qconcat_kernel.int8_concat([a, QTensor(q.cpu(), a.amax)]),
        lambda: qconcat_kernel.int8_concat([a] * 9),         # > 8 parts
        lambda: qconcat_kernel.int8_concat([a, a], up=[True]),
        lambda: qconcat_kernel.quantize_concat([f.double()], 2.0),
        lambda: qconcat_kernel.quantize_concat([f.half()], 2.0),
        lambda: qconcat_kernel.quantize_concat([f, f[:, :6]], 2.0, [True,
                                                                   False]),
        lambda: qconcat_kernel.quantize_concat([f, QTensor(q.to(torch.int16),
                                                           a.amax)], 2.0),
    ]
    before = (sppf_kernel.KERNEL.launches, qconcat_kernel.KERNEL.launches)
    for call in calls:
        with pytest.raises(ValueError):
            call()
    assert (sppf_kernel.KERNEL.launches,
            qconcat_kernel.KERNEL.launches) == before


def test_int8_glue_on_the_card_launches_the_kernels(cuda):
    """The shipped engine on the card: SPPF is one launch of kernel 11 and
    the seven int8 concats and two quantises nine of kernel 12 a frame,
    no int8 ``torch.cat`` or float max-pool runs, and the Detections equal
    the graph's and the CPU path's bits of the glue."""
    art = ServingArtifact(ARTIFACT, graph=False)
    frame = _scenes([7])[0]
    art(frame)
    torch.cuda.synchronize()
    before = (sppf_kernel.KERNEL.launches, qconcat_kernel.KERNEL.launches)
    got = art(frame)
    torch.cuda.synchronize()
    assert (sppf_kernel.KERNEL.launches - before[0],
            qconcat_kernel.KERNEL.launches - before[1]) == (1, 9)
    want = ServingArtifact(ARTIFACT)(frame)
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))
