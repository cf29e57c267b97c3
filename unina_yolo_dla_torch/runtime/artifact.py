"""Loaded serving artifact: ``config.json`` + ``variables.msgpack`` of an
exported engine directory -> a frame -> ``Detections`` callable.

The port's counterpart of the reference ``ServingArtifact``: the same
directory, the same call (one (S, S, 3) uint8 RGB frame, (B, S, S, 3) for
a batch artifact, or one raw camera frame for a camera artifact), served
by the port's modules instead of the serialized program. The weights go to
the device once, at load. Every engine configuration the port's export
writes loads (``config_from_artifact``); the reference's ``config.json``
files load unchanged.

On the card the frame is captured at load as one CUDA graph at the
artifact's static shape (``runtime/aot.py``), the counterpart of the
reference compiling its program for the local chip; ``graph=False`` keeps
the eager frame. Frames are staged on the host straight into a pinned
buffer (blocked, and merged, for the s2d_host engines; the RGB frame or
the camera's raw bytes as they are, one copy) and copied from it to the
card without blocking the host. With ``device="cpu"`` the frame is eager
and unpinned: the plain versions of the kernels.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..models.config import (
    DEFAULT_CONF_THRESHOLD,
    DEFAULT_CP_Q,
    DEFAULT_IOU_THRESHOLD,
    MAX_DETECTIONS,
    ModelConfig,
)
from ..models.detector import from_jax_variables
from ..ops.cuda.camera_kernel import CameraGeometry
from ..ops.decode import Detections
from ..ops.preprocess import merged_frame_np, space_to_depth_np
from ..quant.fake_quant import PERF_EXCLUDE, QuantSpec
from ..utils.checkpoint import load_msgpack_raw
from ..utils.device import resolve_device
from .aot import capture_serving_fn, pack_detections
from .pipeline import (
    build_batch_serving_fn,
    build_camera_serving_fn,
    build_serving_fn,
    staged_shape,
)


def config_from_artifact(conf: dict) -> ModelConfig:
    """The engine configuration an exported ``config.json`` describes
    (a batch artifact's engine is the batch-1 one; ``batch`` only sets
    the leading axis of its frames).

    The deploy flags are read as written (``fused_c3k2``/``fused_head``,
    which the port's export records, default to false); a quantised
    artifact is the fused int8 chain with the measured exclusion list, as
    the export's ``--int8`` writes it. A camera with a batch or with host
    space-to-depth, which the export never writes, raises ``ValueError``."""
    if conf.get("camera"):
        if conf.get("batch"):
            raise ValueError("camera and batch artifacts are mutually "
                             "exclusive")
        if conf.get("s2d_host") or conf.get("s2d_merged"):
            raise ValueError("a camera artifact cannot take host "
                             "space-to-depth frames")
    quant = (QuantSpec("int8_fused", exclude=PERF_EXCLUDE)
             if conf.get("quantized") else None)
    flags = {k: bool(conf.get(k, False)) for k in (
        "stem_s2d", "s2d_host", "stage1_s2d", "s2d_merged", "fused_stem",
        "merged_head", "fused_c3k2", "fused_head")}
    return ModelConfig(
        num_classes=conf["num_classes"],
        base_channels=conf["base_channels"],
        lite_p2=conf.get("lite_p2", False),
        input_size=conf["input_size"], quant=quant, deploy=True, **flags)


class ServingArtifact:
    """Frame(s) -> Detections with weights resident on ``device``.

    A batch artifact (``"batch": B`` in its config) takes (B, S, S, 3)
    frames and returns Detections whose fields have a leading B axis. A
    camera artifact (``"camera"``) takes one raw frame of its camera:
    rgb (H, W, 3), bgra (H, W, 4) or nv12 (H*3/2, W).

    On the card, ``graph=True`` (the default) captures the frame as one
    CUDA graph at load and replays it per call; a failure to capture or to
    replay raises. Calls come one at a time; each returns tensors of its
    own, which later calls do not overwrite."""

    def __init__(self, directory: str | Path, device=None,
                 graph: bool = True) -> None:
        self.dir = Path(directory)
        missing = [f for f in ("config.json", "variables.msgpack")
                   if not (self.dir / f).exists()]
        if missing:
            raise FileNotFoundError(
                f"incomplete serving artifact at {self.dir}: missing "
                f"{', '.join(missing)}")
        self.device = resolve_device(device)
        self.config = json.loads((self.dir / "config.json").read_text())
        self.model_config = config_from_artifact(self.config)
        self.batch = self.config.get("batch")
        variables = load_msgpack_raw(self.dir / "variables.msgpack")
        self.model = from_jax_variables(variables, self.model_config,
                                        self.device)
        c = self.config
        kw = dict(conf_threshold=c.get("conf_threshold",
                                       DEFAULT_CONF_THRESHOLD),
                  iou_threshold=c.get("iou_threshold", DEFAULT_IOU_THRESHOLD),
                  q_factor=c.get("q_factor", DEFAULT_CP_Q),
                  max_detections=c.get("max_detections", MAX_DETECTIONS))
        s = self.model_config.input_size
        lead = (self.batch,) if self.batch else ()
        self.camera = c.get("camera")
        if self.camera:
            cam = self.camera
            self.geometry = CameraGeometry(
                cam["height"], cam["width"], cam["format"], s,
                cam.get("letterbox", False))
            self._serve = build_camera_serving_fn(
                self.model, self.model_config, cam["height"], cam["width"],
                cam["format"], letterbox=cam.get("letterbox", False),
                box_space=cam.get("box_space", "model"), **kw)
            self.frame_shape = self.staged_shape = self.geometry.frame_shape
        else:
            build = (build_batch_serving_fn if self.batch
                     else build_serving_fn)
            self._serve = build(self.model, self.model_config, **kw)
            self.frame_shape = (*lead, s, s, 3)
            self.staged_shape = (*lead, *staged_shape(self.model_config))
        self.graph = None
        if self.device.type == "cuda":
            k = c.get("max_detections", MAX_DETECTIONS)
            self._pinned = torch.empty(self.staged_shape, dtype=torch.uint8,
                                       pin_memory=True)
            self._result = torch.empty((*lead, k, 7), dtype=torch.float32,
                                       pin_memory=True)
            self._staged = torch.cuda.Event()   # the last copy out of
            self._fetched = torch.cuda.Event()  # _pinned; into _result
            if graph:
                self.graph = capture_serving_fn(self._serve,
                                                self.staged_shape,
                                                self.device)

    def _check(self, frames: np.ndarray) -> np.ndarray:
        frames = np.asarray(frames)
        if frames.shape != self.frame_shape or frames.dtype != np.uint8:
            kind = self.camera["format"] if self.camera else "RGB"
            raise ValueError(f"expected {self.frame_shape} uint8 {kind} "
                             f"frames, got {frames.shape} {frames.dtype}")
        return frames

    def _host_stage(self, frames: np.ndarray, out: np.ndarray | None = None
                    ) -> np.ndarray:
        """The staged host bytes: the s2d_host engines' blocked (and
        merged) frame, or the RGB or raw camera frame as it is (one copy
        into ``out`` where given)."""
        frames = self._check(frames)
        cfg = self.model_config
        if cfg.s2d_merged:
            return merged_frame_np(frames, out=out)
        if cfg.s2d_host:
            return space_to_depth_np(frames, out=out)
        if out is None:
            return frames.copy()
        np.copyto(out, frames)
        return out

    def _stage_into(self, frames: np.ndarray, dst: torch.Tensor) -> None:
        """Stage into the pinned buffer, then copy it to ``dst`` on the
        card without blocking the host."""
        self._staged.synchronize()   # the previous copy out has run
        self._host_stage(frames, out=self._pinned.numpy())
        with torch.inference_mode():
            dst.copy_(self._pinned, non_blocking=True)
        self._staged.record()

    def stage(self, frames: np.ndarray) -> torch.Tensor:
        """(S, S, 3) uint8 RGB -> the engine's input layout on the device
        (merged (S/2, S/4, 24), blocked (S/2, S/2, 12) or as it is); a
        batch artifact takes (B, S, S, 3) -> (B, ...); a camera artifact's
        raw frame goes as it is."""
        if self.device.type != "cuda":
            return torch.from_numpy(self._host_stage(frames))
        with torch.inference_mode():
            dst = torch.empty(self.staged_shape, dtype=torch.uint8,
                              device=self.device)
        self._stage_into(frames, dst)
        return dst

    def _run(self, frames: np.ndarray) -> Detections:
        """Serve; on the graph path the result is the graph's own static
        outputs, overwritten by the next call."""
        if self.graph is None:
            return self._serve(self.stage(frames))
        self._stage_into(frames, self.graph.frame)
        self.graph.replay()
        return self.graph.dets

    def __call__(self, frames: np.ndarray) -> Detections:
        dets = self._run(frames)
        if self.graph is None:
            return dets
        with torch.inference_mode():
            return Detections(*(t.clone() for t in dets))

    def packed(self, frames: np.ndarray) -> np.ndarray:
        """Frame(s) -> ([B,] K, 7) float32 ``[x1, y1, x2, y2, score, cls,
        valid]`` on the host (``aot.pack_detections``): on the card one
        device-to-host copy into pinned memory (the graph packs its own
        result), then a host copy the caller keeps."""
        if self.graph is not None:
            self._run(frames)
            packed = self.graph.packed
        else:
            packed = pack_detections(self._run(frames))
        if self.device.type != "cuda":
            return packed.numpy()
        self._result.copy_(packed, non_blocking=True)
        self._fetched.record()
        self._fetched.synchronize()
        return self._result.numpy().copy()
