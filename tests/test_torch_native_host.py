"""The port's native perception host (``unina_yolo_dla_torch/runtime/
native``) on the CPU.

- The host, the ring tool and the C ABI build with ``g++`` (module
  fixture).
- Staging: the C++ staging of RGB, BGRA and NV12 frames into the merged,
  blocked and plain layouts, at 64 and 640, byte for byte against the
  port's ``merged_frame_np``, ``space_to_depth_np`` and ``embed.py``'s BGRA
  slice; NV12 against a numpy transcription of the reference PJRT
  executor's rounding formula, and against the truncating Python executor
  by the rounding alone.
- Compaction: the C++ compaction of random (K, 7) packed rows equals
  ``pack_records``.
- The ring protocol: ``frame_ring.hpp`` is the reference's, comments
  aside, and a ring the port's ``ring_tool`` writes has the reference's
  header and frames.
- End to end: ``perception_host --executor python`` under
  ``UNINA_FORCE_CPU=1`` over a small folded artifact exported by the
  reference, fed by the port's ``ring_tool``; the out block's records equal
  ``make_executor``'s on the regenerated frame of its ``result_seq``. The
  Python executor through the C ABI equals ``make_executor`` too.
- Refusals: ``--executor cuda`` under ``UNINA_FORCE_CPU=1`` and without a
  card exits non-zero and names the reason; no fallback.
- ``serve_cli``: batch mode equals ``PerceptionServer``; ``--native``
  builds the CUDA-executor command line.

The CUDA executor's card tests are in ``tests/test_torch_gpu.py``.
"""
import dataclasses
import json
import os
import re
import struct
import subprocess
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unina_yolo_dla_torch.ops.preprocess import (
    merged_frame_np,
    nv12_to_rgb,
    space_to_depth_np,
)
from unina_yolo_dla_torch.runtime import serve_cli
from unina_yolo_dla_torch.runtime.embed import make_executor, pack_records
from unina_yolo_dla_torch.runtime.native import build, capi
from unina_yolo_dla_torch.runtime.serving import PerceptionServer
from unina_yolo_dla_tpu.models import ModelConfig, init_model
from unina_yolo_dla_tpu.models.detector import UninaYoloDla
from unina_yolo_dla_tpu.quant.deploy import (
    fold_batchnorm,
    fold_downsample_space_to_depth,
    fold_stem_space_to_depth,
    merge_stem_columns,
)
from unina_yolo_dla_tpu.runtime.aot import export_serving_artifact

REPO = Path(__file__).resolve().parents[1]
IMG = 32
CONF = 0.92
HOST_TIMEOUT = 120


@pytest.fixture(scope="module")
def native():
    """The build directory (perception_host, ring_tool, libunina_host.so)."""
    out = build.build()
    for name in (build.HOST, build.RING_TOOL, build.CAPI):
        assert (out / name).exists(), name
    return out


@pytest.fixture(scope="module")
def artifact_dir(tmp_path_factory):
    """A small folded ``s2d_merged`` float artifact exported by the
    reference (as ``tests/test_torch_runtime.py`` makes it): the init
    model's weights, class logits scaled 30x about 0."""
    cfg = ModelConfig(num_classes=4, base_channels=16, input_size=IMG,
                      compute_dtype=jnp.float32)
    _, variables = init_model(jax.random.key(0), cfg)
    merged = dataclasses.replace(cfg, deploy=True, stem_s2d=True,
                                 s2d_host=True, stage1_s2d=True,
                                 s2d_merged=True)
    m_vars = jax.device_get(merge_stem_columns(
        fold_downsample_space_to_depth(fold_stem_space_to_depth(
            fold_batchnorm(variables)))))
    for head in ("head_p2", "head_p3", "head_p4"):
        pred = m_vars["params"][head]["cls_pred"]
        pred["kernel"] = np.asarray(pred["kernel"]) * np.float32(30.0)
        pred["bias"] = np.zeros_like(np.asarray(pred["bias"]))
    out = tmp_path_factory.mktemp("native_artifact")
    export_serving_artifact(UninaYoloDla(merged), m_vars, out,
                            conf_threshold=CONF, max_detections=64)
    return out


def _env(force_cpu: bool) -> dict:
    env = build.host_env()
    env.pop("UNINA_FORCE_CPU", None)
    if force_cpu:
        env["UNINA_FORCE_CPU"] = "1"
    return env


def nv12_rounded_np(nv12: np.ndarray, width: int, height: int
                    ) -> np.ndarray:
    """The reference PJRT executor's NV12 -> RGB (its nv12_to_rgb), in
    numpy float32: each product and sum rounded on its own, clamped, +0.5,
    truncated."""
    y_plane = nv12[:height * width].reshape(height, width)
    uv = nv12[height * width:].reshape(height // 2, width // 2, 2)
    uv = uv.repeat(2, axis=0).repeat(2, axis=1).astype(np.float32)
    f = np.float32
    y = f(1.164) * (y_plane.astype(np.float32) - f(16.0))
    u, v = uv[..., 0] - f(128.0), uv[..., 1] - f(128.0)
    rgb = np.stack([y + f(1.596) * v,
                    y - f(0.392) * u - f(0.813) * v,
                    y + f(2.017) * u], axis=-1)
    out = np.where(rgb < 0, f(0), np.where(rgb > 255, f(255),
                                           rgb + f(0.5)))
    return out.astype(np.uint8)


def _frame(fmt: str, size: int, seed: int) -> tuple[np.ndarray, int]:
    rng = np.random.default_rng(seed)
    if fmt == "nv12":
        return rng.integers(0, 256, size * size * 3 // 2, dtype=np.uint8), 0
    ch = 3 if fmt == "rgb" else 4
    return rng.integers(0, 256, (size, size, ch), dtype=np.uint8), ch


# ---- staging and compaction ----

@pytest.mark.parametrize("size", [64, 640])
@pytest.mark.parametrize("layout", ["merged", "blocked", "rgb"])
@pytest.mark.parametrize("fmt", ["rgb", "bgra", "nv12"])
def test_staging_matches_python(native, fmt, layout, size):
    frame, ch = _frame(fmt, size, seed=size + len(fmt))
    if fmt == "rgb":
        rgb = frame
    elif fmt == "bgra":
        rgb = np.ascontiguousarray(frame[..., 2::-1])   # embed.py's slice
    else:
        rgb = nv12_rounded_np(frame, size, size)
    want = {"merged": merged_frame_np, "blocked": space_to_depth_np,
            "rgb": np.ascontiguousarray}[layout](rgb)
    got = capi.stage(layout, frame, size, size, ch)
    assert got is not None
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("size", [64, 640])
def test_nv12_rounds_where_the_python_executor_truncates(native, size):
    """The C++ NV12 conversion is the reference PJRT executor's (rounded);
    the Python executor's (the port's ``nv12_to_rgb`` cast to uint8, as
    the reference ``embed.py`` does) is the same formula truncated, so the
    two differ by the rounding alone: 0 or +1."""
    frame, _ = _frame("nv12", size, seed=size)
    got = capi.stage("rgb", frame, size, size, 0).reshape(size, size, 3)
    y = frame[:size * size].reshape(size, size)
    uv = frame[size * size:].reshape(size // 2, size // 2, 2)
    trunc = nv12_to_rgb(torch.from_numpy(y.copy()),
                        torch.from_numpy(uv.copy())).numpy().astype(np.uint8)
    assert np.array_equal(got, nv12_rounded_np(frame, size, size))
    diff = got.astype(np.int16) - trunc
    assert set(np.unique(diff)) == {0, 1}


def test_staging_refuses_other_geometry(native):
    frame, _ = _frame("rgb", 64, seed=0)
    assert capi.stage("merged", frame, 64, 32, 3) is None
    assert capi.stage("merged", frame, 64, 64, 2) is None


@pytest.mark.parametrize("k,seed", [(1, 0), (64, 1), (1024, 2), (1024, 3)])
def test_compaction_matches_pack_records(native, k, seed):
    rng = np.random.default_rng(seed)
    packed = (rng.standard_normal((k, 7)) * 100).astype(np.float32)
    packed[:, 5] = rng.uniform(-0.9, 4.9, k).astype(np.float32)
    packed[:, 6] = rng.choice(np.float32([0, 0.5, 0.50001, 1, 0.3]), k)
    assert capi.compact(packed) == pack_records(packed)


# ---- the ring protocol ----

def _code(path: Path) -> list[str]:
    """A header's lines without comments and blank lines."""
    lines = (re.sub(r"//.*", "", ln).rstrip()
             for ln in path.read_text().splitlines())
    return [ln for ln in lines if ln.strip()]


def test_frame_ring_protocol_is_the_reference(native, tmp_path):
    ours = build.HERE / "include" / "frame_ring.hpp"
    ref = (REPO / "unina_yolo_dla_tpu" / "runtime" / "native" / "include"
           / "frame_ring.hpp")
    assert _code(ours) == _code(ref)
    ring = tmp_path / "frames.ring"
    subprocess.run([str(native / build.RING_TOOL), "produce", "--ring",
                    str(ring), "--width", "8", "--height", "4", "--frames",
                    "3", "--slots", "4", "--format", "bgra"],
                   check=True, capture_output=True, timeout=30)
    raw = ring.read_bytes()
    magic, version, slots, w, h, ch, fmt, nbytes = struct.unpack_from(
        "<QIIIIIII", raw, 0)
    write_seq, shutdown = struct.unpack_from("<QQ", raw, 40)
    assert (magic, version, slots, w, h, ch, fmt, nbytes) == (
        0x554E494E41524E47, 1, 4, 8, 4, 4, 1, 128)
    assert (write_seq, shutdown) == (3, 1)
    stride = (16 + nbytes + 63) // 64 * 64
    for seq in (1, 2, 3):
        off = 56 + (seq % 4) * stride
        assert struct.unpack_from("<Q", raw, off)[0] == seq
        px = np.frombuffer(raw, np.uint8, nbytes, off + 16).reshape(-1, 4)
        assert (px[:, :3] == (seq - 1) * 37 % 256).all()
        assert (px[:, 3] == 255).all()


# ---- the host end to end, and the executors through the C ABI ----

def _out_block(path: Path) -> tuple[int, bytes]:
    """(result_seq, the records as an executor blob) of a DetOutHeader."""
    raw = path.read_bytes()
    magic, seq, count = struct.unpack_from("<QQI", raw, 0)
    assert magic == 0x554E494E41524E47
    return seq, struct.pack("<I", count) + raw[32:32 + 24 * count]


def test_host_python_executor_end_to_end(native, artifact_dir, tmp_path,
                                         monkeypatch):
    ring, out = tmp_path / "frames.ring", tmp_path / "dets.out"
    host = subprocess.Popen(
        [str(native / build.HOST), "--artifact", str(artifact_dir),
         "--ring", str(ring), "--out", str(out), "--input", str(IMG),
         "--classes", "4", "--executor", "python", "--max-frames", "5"],
        env=_env(force_cpu=True), stderr=subprocess.PIPE, text=True)
    # slow enough to outlast the host's configure
    producer = subprocess.Popen(
        [str(native / build.RING_TOOL), "produce", "--ring", str(ring),
         "--width", str(IMG), "--height", str(IMG), "--frames", "3000",
         "--fps", "30", "--slots", "4"], stderr=subprocess.PIPE, text=True)
    try:
        _, err = host.communicate(timeout=HOST_TIMEOUT)
    finally:
        producer.terminate()
        producer.wait(timeout=10)
        if host.poll() is None:
            host.kill()
            host.wait()
    assert host.returncode == 0, err
    assert "configured" in err and "executor=python" in err
    assert "active" in err
    assert "frames=5" in err and "pipeline=1" in err
    seq, blob = _out_block(out)
    assert seq >= 5
    fill = (seq - 1) * 37 % 256
    frame = np.full((IMG, IMG, 3), fill, np.uint8)
    monkeypatch.setenv("UNINA_FORCE_CPU", "1")
    execute = make_executor(str(artifact_dir), IMG, 4)
    assert blob == execute(memoryview(frame.tobytes()), IMG, IMG, 3)


def test_python_executor_through_the_c_abi(native, artifact_dir,
                                           monkeypatch):
    monkeypatch.setenv("UNINA_FORCE_CPU", "1")
    execute = make_executor(str(artifact_dir), IMG, 4)
    frames = [_frame(fmt, IMG, seed) for fmt, seed in (
        ("rgb", 0), ("rgb", 1), ("bgra", 2), ("nv12", 3))]
    wants = [execute(memoryview(f.tobytes()), IMG, IMG, ch)
             for f, ch in frames]
    assert sum(struct.unpack_from("<I", w)[0] for w in wants) >= 1
    with capi.Executor("python", str(artifact_dir), IMG, 4) as ex:
        assert ex.depth == 1
        for (f, ch), want in zip(frames, wants):
            assert ex.infer(f, IMG, IMG, ch) == want
        for f, ch in frames:
            assert ex.submit(f, IMG, IMG, ch)
        assert [ex.collect() for _ in frames] == wants
        assert ex.infer(frames[0][0], IMG, IMG // 2, 3) == capi.SENTINEL
        assert not ex.submit(frames[0][0], IMG // 2, IMG, 3)


def _refused(native, artifact_dir, tmp_path, force_cpu: bool) -> str:
    ring = tmp_path / "frames.ring"
    subprocess.run([str(native / build.RING_TOOL), "produce", "--ring",
                    str(ring), "--width", str(IMG), "--height", str(IMG),
                    "--frames", "1"], check=True, capture_output=True,
                   timeout=30)
    t = time.monotonic()
    run = subprocess.run(
        [str(native / build.HOST), "--artifact", str(artifact_dir),
         "--ring", str(ring), "--out", str(tmp_path / "dets.out"),
         "--input", str(IMG), "--classes", "4", "--executor", "cuda"],
        env=_env(force_cpu), capture_output=True, text=True,
        timeout=HOST_TIMEOUT)
    assert run.returncode != 0, run.stderr
    assert "FATAL: configure failed" in run.stderr
    assert "active" not in run.stderr
    assert time.monotonic() - t < HOST_TIMEOUT
    return run.stderr


def test_cuda_executor_refuses_force_cpu(native, artifact_dir, tmp_path):
    err = _refused(native, artifact_dir, tmp_path, force_cpu=True)
    assert "UNINA_FORCE_CPU is set" in err


def test_cuda_executor_refuses_without_a_card(native, artifact_dir,
                                              tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    err = _refused(native, artifact_dir, tmp_path, force_cpu=False)
    assert "no CUDA device" in err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        capi.Executor("cuda", str(artifact_dir), IMG, 4)


def test_host_refuses_an_unknown_executor(native, tmp_path):
    run = subprocess.run(
        [str(native / build.HOST), "--artifact", "x", "--ring",
         str(tmp_path / "r"), "--out", str(tmp_path / "o"), "--executor",
         "pjrt"], capture_output=True, text=True, timeout=30)
    assert run.returncode == 2
    assert "--executor must be python or cuda" in run.stderr


# ---- serve_cli ----

def test_serve_cli_batch_matches_perception_server(artifact_dir, tmp_path,
                                                   capsys):
    import cv2

    images = tmp_path / "images"
    images.mkdir()
    rng = np.random.default_rng(5)
    bgr = rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)
    cv2.imwrite(str(images / "scene.png"), bgr)
    cfg = tmp_path / "serving.yaml"
    cfg.write_text(f"artifact_dir: {artifact_dir}\ninput_size: {IMG}\n"
                   "num_classes: 4\nclass_names:\n  0: yellow_cone\n")
    serve_cli.main(["--config", str(cfg), "--images", str(images),
                    "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])

    from unina_yolo_dla_torch.data.dataset import letterbox_image

    srv = PerceptionServer(artifact_dir, IMG, 4, device="cpu",
                           log_fn=lambda _m: None)
    srv.configure()
    srv.activate()
    canvas, scale, px, py = letterbox_image(
        np.ascontiguousarray(bgr[..., ::-1]), IMG)
    res = srv.process_frame(canvas)
    boxes = (res["boxes"] - np.float32([px, py, px, py])) / scale
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, 40)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, 48)
    want = [{"class": "yellow_cone" if c == 0 else int(c),
             "score": round(float(s), 3),
             "box": [round(float(v), 1) for v in b]}
            for b, s, c in zip(boxes, res["scores"], res["classes"])]
    assert got == {"image": "scene.png", "detections": want}


def test_serve_cli_native_command(monkeypatch, tmp_path):
    cfg = {"frame_ring": "/dev/shm/r", "detections_out": "/dev/shm/d",
           "input_size": 640, "num_classes": 4}
    assert serve_cli.native_command(cfg, "art", "/b/perception_host", 7) == [
        "/b/perception_host", "--artifact", "art", "--ring", "/dev/shm/r",
        "--out", "/dev/shm/d", "--input", "640", "--classes", "4",
        "--executor", "cuda", "--max-frames", "7"]
    calls = []

    class Done:
        returncode = 0

    monkeypatch.setattr(build, "host_binary",
                        lambda: Path("/b/perception_host"))
    monkeypatch.setattr(serve_cli.subprocess, "run",
                        lambda cmd, env: calls.append((cmd, env)) or Done)
    conf = tmp_path / "serving.yaml"
    conf.write_text("artifact_dir: art\nframe_ring: /dev/shm/r\n"
                    "detections_out: /dev/shm/d\n")
    with pytest.raises(SystemExit) as done:
        serve_cli.main(["--config", str(conf), "--native"])
    assert done.value.code == 0
    (cmd, env), = calls
    assert cmd == serve_cli.native_command(
        {"frame_ring": "/dev/shm/r", "detections_out": "/dev/shm/d"}, "art",
        "/b/perception_host")
    assert str(REPO) in env["PYTHONPATH"].split(os.pathsep)
