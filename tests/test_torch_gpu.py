"""The port's CUDA kernels on the card against their plain PyTorch
versions, and the served artifact on the card against the port's CPU
path. Every test needs a CUDA device (``gpu`` marker) and skips without
one. This file imports no JAX, so it also runs where only PyTorch is
installed (``--noconftest``: the suite's conftest sets up JAX):

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from unina_yolo_dla_torch.data.synthetic import SynthConfig, generate_image
from unina_yolo_dla_torch.ops.cuda import (
    decode_kernel,
    nms_kernel,
    preprocess_kernel,
    stem_kernel,
)
from unina_yolo_dla_torch.runtime.artifact import ServingArtifact

pytestmark = pytest.mark.gpu

ARTIFACT = Path(__file__).resolve().parents[1] / "artifacts" / \
    "serving_artifact"


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


def test_normalize_kernel_exact(rng, cuda):
    img = torch.from_numpy(rng.integers(0, 256, (320, 160, 24),
                                        dtype=np.uint8)).to(cuda)
    mean, std = preprocess_kernel.channel_constants(24)
    got = _launched(preprocess_kernel.KERNEL,
                    lambda: preprocess_kernel.normalize(img, mean, std))
    want = preprocess_kernel.normalize_plain(img, mean, std)
    assert float((got - want).abs().max()) <= 1e-6
    bgra = torch.from_numpy(rng.integers(0, 256, (64, 64, 4),
                                         dtype=np.uint8)).to(cuda)
    got = preprocess_kernel.normalize(bgra, swap_rb=True)
    want = preprocess_kernel.normalize_plain(
        bgra, preprocess_kernel.IMAGENET_MEAN, preprocess_kernel.IMAGENET_STD,
        swap_rb=True)
    assert float((got - want).abs().max()) <= 1e-6


def test_stem_kernel_batched(rng, cuda):
    """Batch 2 on the grid; within a bf16 step of the plain version."""
    xm = rng.normal(0, 1, (2, 320, 160, 24)).astype(np.float32)
    ks = rng.normal(0, np.sqrt(2 / 96), (2, 2, 24, 64)).astype(np.float32)
    k1 = rng.normal(0, np.sqrt(2 / 512), (2, 2, 128, 64)).astype(np.float32)
    bs = rng.normal(0, .1, 64).astype(np.float32)
    b1 = rng.normal(0, .1, 64).astype(np.float32)
    bf = torch.bfloat16
    args = (torch.from_numpy(xm).to(cuda, bf), torch.from_numpy(ks).to(
        cuda, bf), torch.from_numpy(bs).to(cuda), torch.from_numpy(k1).to(
        cuda, bf), torch.from_numpy(b1).to(cuda))
    got = _launched(stem_kernel.KERNEL,
                    lambda: stem_kernel.fused_stem_stage1(*args)).float()
    want = stem_kernel.fused_stem_stage1_plain(*args).float()
    assert got.shape == (2, 160, 160, 64)
    assert bool(((got - want).abs() <= 1e-2 * (1 + want.abs())).all())


def test_decode_kernel_matches_plain(rng, cuda):
    for g, stride in ((160, 4), (80, 8), (40, 16)):
        cls = rng.normal(0, 3, (g, g, 4)).astype(np.float32)
        cls.reshape(-1, 4)[rng.choice(g * g, 20, replace=False), 1] = 40.0
        reg = rng.uniform(0.1, 3.0, (g, g, 4)).astype(np.float32)
        c, r = torch.from_numpy(cls).to(cuda), torch.from_numpy(reg).to(cuda)
        got = _launched(decode_kernel.KERNEL,
                        lambda: decode_kernel.decode_level_packed(
                            c, r, stride, 0.5, 0.2116))
        want = decode_kernel.decode_level_plain(c, r, stride, 0.5, 0.2116)
        assert torch.equal(got[:, 5:], want[:, 5:])
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [1024, 100])
def test_nms_kernel_exact(cuda, k):
    rng = np.random.default_rng(3)
    centers = rng.uniform(50, 590, (k, 2))
    wh = rng.uniform(5, 60, (k, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1)
    chain = np.zeros((k, 4))
    for i in range(60):        # a 60-deep suppression chain at IoU 0.5
        chain[i] = (6.0 * i, 0, 6.0 * i + 18.0, 18.0)
    for b, cls, n, thr in ((boxes, rng.integers(0, 4, k), k - 20, 0.45),
                           (chain, np.zeros(k), 60, 0.3)):
        bt = torch.tensor(b, dtype=torch.float32, device=cuda)
        ct = torch.tensor(cls, dtype=torch.int32, device=cuda)
        vt = torch.arange(k, device=cuda) < n
        got = _launched(nms_kernel.KERNEL,
                        lambda: nms_kernel.nms_keep(bt, ct, vt, thr))
        assert torch.equal(got, nms_kernel.nms_keep_plain(bt, ct, vt, thr))


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
