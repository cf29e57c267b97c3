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
    mma_pack,
    nms_kernel,
    preprocess_kernel,
    stage1_kernel,
    stem_kernel,
)
from unina_yolo_dla_torch.ops import decode as td
from unina_yolo_dla_torch.ops.preprocess import merged_frame_np
from unina_yolo_dla_torch.quant.fake_quant import PERF_EXCLUDE, QuantSpec
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
    """The shipped engine's head outputs for 8 scenes (P2 contiguous, P3
    and P4 channel-slice views with a cell stride of 8), at B = 1 and 8:
    bit for bit the plain version, read without copies."""
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
            outs = art.model(xb)
            assert not outs[1][0].is_contiguous()   # read as it lies
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
    the backbone's cast is a no-op), the fused stem, decode and NMS; a
    served batch of 8 too."""
    kernels = (preprocess_kernel.KERNEL, stem_kernel.KERNEL,
               decode_kernel.KERNEL, nms_kernel.KERNEL)
    for art, frames in ((ServingArtifact(ARTIFACT, graph=False),
                         _scenes([7])[0]),
                        (ServingArtifact(ARTIFACT_B8, graph=False),
                         _scenes(range(1, 9)))):
        art(frames)
        before = [kern.launches for kern in kernels]
        art(frames)
        torch.cuda.synchronize()
        assert [kern.launches - b for kern, b in zip(kernels, before)] == [
            1, 1, 1, 1]


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
# ragged images that cut the 8 x 8 tile's edges
WIDE_C3K2 = [(1, 80, 80, 128, 64, 128, 2), (1, 40, 40, 256, 128, 256, 2),
             (1, 160, 160, 32, 16, 32, 1), (1, 40, 40, 128, 64, 128, 2),
             (2, 37, 45, 128, 64, 128, 2), (2, 5, 3, 256, 128, 256, 1),
             (1, 13, 22, 64, 64, 128, 1), (2, 11, 9, 64, 128, 256, 2),
             (2, 9, 14, 40, 16, 32, 2)]


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
# base-16 engine, then ragged ones
WIDE_CAT = [(1, 80, 80, 128, 128, 64, 128, True),
            (1, 80, 80, 64, 128, 64, 128, False),
            (1, 40, 40, 128, 256, 128, 256, False),
            (1, 160, 160, 32, 32, 16, 32, True),
            (1, 40, 40, 64, 128, 64, 128, False),
            (2, 38, 46, 128, 128, 64, 128, True),
            (2, 37, 45, 64, 128, 64, 128, False),
            (2, 14, 22, 128, 64, 128, 256, True),
            (1, 6, 10, 8, 8, 16, 32, True)]


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
                                   (1, 9, 17, 32), (2, 13, 6, 256)])
def test_head_wide_kernel(rng, cuda, shape):
    """head_p3 and head_p4 of the bf16 engines, head_p2 and head_p4 of a
    base-16 engine, ragged images at batch 2 and a narrow width: bit for
    bit on binary-grid inputs, within 1e-2 (1 + |ref|) on normal ones."""
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
    """``kernel_takes`` admits a wide C3k2 exactly where the library's own
    shared-memory plan fits (an upsampled ``xa`` counted at full
    resolution: admitted only where it fits), and every wide head width
    fits."""
    for (hd, n), pl in c3k2_kernel.WIDE_PLANES.items():
        for cin in range(8, 64 * (pl + 2), 8):
            for ca in (0, 8, 64, 128):
                if ca >= cin:
                    continue
                takes = c3k2_kernel.kernel_takes(cin, hd, 2 * hd, n, ca)
                smem = c3k2_kernel.wide_smem(ca, cin - ca, False, hd, n)
                assert smem > 0 and takes == (smem <= SMEM_OPTIN), (
                    cin, ca, hd, n, smem)
                if takes and ca:
                    assert 0 < c3k2_kernel.wide_smem(
                        ca, cin - ca, True, hd, n) <= SMEM_OPTIN
    assert c3k2_kernel.wide_smem(0, 64, False, 32, 1) == -1
    for c in (16, 32, 48, 96, 128, 256, 512):
        smem = head_kernel.wide_smem(c)
        assert head_kernel.kernel_takes(c) == (0 < smem <= SMEM_OPTIN), (
            c, smem)


def test_last_launch_records_the_grid(rng, cuda):
    """The library records the grid, cluster, threads and shared memory of
    each launch as it made it: the tiled C3k2 one block a tile where the
    tiles are fewer than the SMs, the wide C3k2 at stage3_c3k2 one cluster of four per
    8 x 8 tile, the wide head at head_p4 one cluster of two per tile and
    branch."""
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
                "nms": 1},
    "fc": {"normalize": 1, "decode_topk": 1, "nms": 1, "stage1_merged": 1,
           "fused_c3k2": 1, "fused_c3k2_cat": 1, "fused_head": 1},
}
PATH_KERNELS["b8"] = PATH_KERNELS["shipped"]
PATH_KERNELS["camera"] = {"camera": 1, "stage1_merged": 1, "decode_topk": 1,
                          "nms": 1}


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
    reference artifacts' result size, and each of the path's kernels among
    the nodes as often as a call launches it (the others not at all)."""
    cap = paths[path][2]
    aot.print_fallback_report(cap.report, strict=True, log_fn=lambda s: None)
    assert cap.report.clean and cap.report.output_bytes == out_bytes
    want = PATH_KERNELS[path]
    assert {k: n for k, n in cap.report.port_kernels.items() if n} == want
    assert cap.report.kernel_nodes > 100


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
             "camera": camera_kernel.KERNEL}
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
@pytest.mark.parametrize("shape", [(1, 320, 160), (2, 10, 37), (3, 2, 1)])
def test_stem_stage1_every_width_bit_exact_on_grid_inputs(rng, cuda, c,
                                                          shape):
    """Base 16, 32 and 64 (C = 32, 64, 128): the served shape, a ragged
    batch of 2, a single output pixel; each launch counted on its width's
    entry point."""
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


def test_stem_stage1_64_wide_bits_unchanged(cuda):
    import hashlib

    def digest(t):
        return hashlib.sha256(
            t.contiguous().view(torch.int16).cpu().numpy().tobytes()
        ).hexdigest()

    got = {}
    for shape, seed in (((1, 320, 160), 11), ((2, 10, 37), 12)):
        frame, xm, ks, bs, k1, b1 = _width_inputs(
            np.random.default_rng(seed), 64, shape, cuda, grid=False)
        ksp, k1p = mma_pack.pack_stem_mma(ks), mma_pack.pack_stage1_mma(k1)
        tag = "x".join(map(str, shape))
        got[f"stem_{tag}"] = digest(stem_kernel.fused_stem_stage1(
            frame, ksp, bs, k1p, b1))
        got[f"stage1_{tag}"] = digest(stage1_kernel.fused_downsample_merged(
            xm, k1p, b1))
    assert got == WIDTH64_DIGESTS


def test_other_widths_refused_on_the_card(rng, cuda):
    frame, xm, ks, bs, k1, b1 = _width_inputs(rng, 64, (1, 8, 5), cuda)
    with pytest.raises(ValueError, match="compiled|C in"):
        stage1_kernel.fused_downsample_merged(
            xm[..., :48].contiguous(), torch.zeros(
                6, 48, 64, dtype=torch.bfloat16, device=cuda), b1[:48])


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
