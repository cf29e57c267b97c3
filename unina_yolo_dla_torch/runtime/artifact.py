"""Loaded serving artifact: ``config.json`` + ``variables.msgpack`` of an
exported engine directory -> a frame -> ``Detections`` callable.

The port's counterpart of the reference ``ServingArtifact``: the same
directory, the same call (one (S, S, 3) uint8 RGB frame, (B, S, S, 3) for
a batch artifact, or one raw camera frame for a camera artifact), served
by the port's modules instead of the serialized program. The weights go to
the device once, at load. Every engine configuration the port's export
writes loads (``config_from_artifact``); the reference's ``config.json``
files load unchanged. The weight tree says which form to build: folded
weights the deploy engine its flags describe, an unfolded tree (BatchNorm
statistics, as the train CLI's ``--export`` writes it) the train form in
eval mode, float or, with a ``quant`` collection, the QAT fake-quant
model.

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
from ..quant.fake_quant import DEFAULT_EXCLUDE, PERF_EXCLUDE, QuantSpec
from ..utils.checkpoint import load_msgpack_raw
from ..utils.device import resolve_device
from .aot import capture_serving_fn, pack_detections
from .pipeline import (
    build_batch_serving_fn,
    build_camera_serving_fn,
    build_serving_fn,
    staged_shape,
)


# how an engine was built, where an exported config.json may lack it: the
# reference's export records none of these, the port's records all four
BUILD_KEYS = ("compute_dtype", "quant_mode", "fused_c3k2", "fused_head")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _build_value(conf: dict, key: str, override):
    """``key`` as ``config.json`` says it, else as the caller says it;
    both present and different raises."""
    if key == "compute_dtype" and isinstance(override, torch.dtype):
        override = str(override).removeprefix("torch.")
    if key in conf and override is not None and conf[key] != override:
        raise ValueError(f"the artifact's config.json says {key}="
                         f"{conf[key]!r}, the caller {override!r}")
    return conf.get(key, override)


def _quant(conf: dict, mode, unfolded: bool = False,
           int8_kernels: bool = True) -> QuantSpec | None:
    """The quantisation an artifact was built with. A known ``mode``
    (``config.json``'s ``quant_mode`` or the caller's) is checked against
    ``quantized``. Without a mode, a quantised artifact is read from its
    weight tree: an ``unfolded`` one is the QAT fake-quant model with the
    train CLI's exclusions (``quantize``); a folded one with int8 kernels
    the fused int8 chain with the measured exclusion list, as the export's
    ``--int8`` writes it (the reference's ``config.json`` says only
    ``"quantized"``, so an ``--int8-unfused`` export of the reference is
    read so too unless the caller says ``quant_mode="int8"``); a folded
    one without (``int8_kernels`` false) the folded QAT model
    (``quantize``). ``int8`` and ``quantize`` keep the reference's default
    exclusions. A deploy mode with an unfolded tree raises."""
    quantized = conf.get("quantized")
    if mode is None:
        mode = ("off" if not quantized else "quantize"
                if unfolded or not int8_kernels else "int8_fused")
    if mode not in ("off", "int8_fused", "int8", "quantize"):
        raise ValueError(f"unknown quant mode {mode!r}")
    if quantized is not None and bool(quantized) != (mode != "off"):
        raise ValueError(f"the artifact's config.json says quantized="
                         f"{quantized}, its quant mode is {mode!r}")
    if unfolded and mode not in ("off", "quantize"):
        raise ValueError(f"quant mode {mode!r} is a deploy mode; this "
                         "artifact holds an unfolded (train-form) model")
    if mode == "off":
        return None
    return QuantSpec(mode, exclude=PERF_EXCLUDE if mode == "int8_fused"
                     else DEFAULT_EXCLUDE)


# the deploy transforms an engine's config.json may record; the train form
# (an unfolded artifact) has none of them
DEPLOY_FLAGS = ("stem_s2d", "s2d_host", "stage1_s2d", "s2d_merged",
                "fused_stem", "merged_head")


def config_from_artifact(conf: dict, unfolded: bool = False,
                         int8_kernels: bool = True, **build
                         ) -> ModelConfig:
    """The engine configuration an exported ``config.json`` describes
    (a batch artifact's engine is the batch-1 one; ``batch`` only sets
    the leading axis of its frames).

    ``unfolded``: the weight tree holds the train form (BatchNorm
    statistics; ``is_unfolded``): the model is then the train form, in
    float or, quantised, as the QAT fake-quant model, and no deploy flag
    may be set. Otherwise the deploy flags are read as written;
    ``int8_kernels`` (``has_int8_kernels``) tells a folded quantised tree's
    int8 engines from its QAT model where no mode is given. ``build``
    gives what the reference's ``config.json`` does not record
    (``BUILD_KEYS``: ``compute_dtype`` a dtype or its name,
    ``quant_mode``, ``fused_c3k2``, ``fused_head``); each is used where
    the file lacks its key, and raises where the file says otherwise.
    Where neither says, the compute dtype is bfloat16, the C3k2s and heads
    unfused, and the quantisation as ``_quant`` reads it. A camera with a
    batch or with host space-to-depth, which the export never writes,
    raises ``ValueError``."""
    unknown = set(build) - set(BUILD_KEYS)
    if unknown:
        raise TypeError(f"unknown build keys {sorted(unknown)}")
    if conf.get("camera"):
        if conf.get("batch"):
            raise ValueError("camera and batch artifacts are mutually "
                             "exclusive")
        if conf.get("s2d_host") or conf.get("s2d_merged"):
            raise ValueError("a camera artifact cannot take host "
                             "space-to-depth frames")
    got = {k: _build_value(conf, k, build.get(k)) for k in BUILD_KEYS}
    dtype = got["compute_dtype"] or "bfloat16"
    if dtype not in _DTYPES:
        raise ValueError(f"unknown compute dtype {dtype!r}")
    flags = {k: bool(conf.get(k, False)) for k in DEPLOY_FLAGS}
    fused = {k: bool(got[k]) for k in ("fused_c3k2", "fused_head")}
    if unfolded and any({**flags, **fused}.values()):
        raise ValueError(
            "an unfolded (train-form) artifact with deploy flags "
            f"{sorted(k for k, v in {**flags, **fused}.items() if v)}: "
            "every deploy transform folds BatchNorm first")
    return ModelConfig(
        num_classes=conf["num_classes"],
        base_channels=conf["base_channels"],
        lite_p2=conf.get("lite_p2", False),
        input_size=conf["input_size"], compute_dtype=_DTYPES[dtype],
        quant=_quant(conf, got["quant_mode"], unfolded, int8_kernels),
        deploy=not unfolded, **fused, **flags)


def is_unfolded(variables: dict) -> bool:
    """Whether an artifact's weight tree holds an unfolded (train-form,
    BatchNorm) model. The tree is the only evidence (``config.json``
    records no such flag): a non-empty ``batch_stats`` collection, or
    BatchNorm nodes (``bn``, or ``scale`` without ``kernel``) under
    ``params``."""
    def has_bn(node) -> bool:
        if not isinstance(node, dict):
            return False
        if "bn" in node or ("scale" in node and "kernel" not in node):
            return True
        return any(has_bn(v) for v in node.values())

    return bool(variables.get("batch_stats")) or has_bn(
        variables.get("params", {}))


def has_int8_kernels(variables: dict) -> bool:
    """Whether any conv kernel of the weight tree is int8 (an int8 engine's
    tree; the folded QAT model's kernels are float)."""
    def walk(node) -> bool:
        if not isinstance(node, dict):
            return False
        k = node.get("kernel")
        if k is not None and not isinstance(k, dict) and \
                np.asarray(k).dtype == np.int8:
            return True
        return any(walk(v) for v in node.values())

    return walk(variables.get("params", {}))


class ServingArtifact:
    """Frame(s) -> Detections with weights resident on ``device``.

    A batch artifact (``"batch": B`` in its config) takes (B, S, S, 3)
    frames and returns Detections whose fields have a leading B axis. A
    camera artifact (``"camera"``) takes one raw frame of its camera:
    rgb (H, W, 3), bgra (H, W, 4) or nv12 (H*3/2, W).

    On the card, ``graph=True`` (the default) captures the frame as one
    CUDA graph at load and replays it per call; a failure to capture or to
    replay raises. Calls come one at a time; each returns tensors of its
    own, which later calls do not overwrite.

    ``build`` says how the engine was built where ``config.json`` does not
    (``compute_dtype``, ``quant_mode``, ``fused_c3k2``, ``fused_head``:
    ``config_from_artifact``)."""

    def __init__(self, directory: str | Path, device=None,
                 graph: bool = True, **build) -> None:
        self.dir = Path(directory)
        missing = [f for f in ("config.json", "variables.msgpack")
                   if not (self.dir / f).exists()]
        if missing:
            raise FileNotFoundError(
                f"incomplete serving artifact at {self.dir}: missing "
                f"{', '.join(missing)}")
        self.device = resolve_device(device)
        self.config = json.loads((self.dir / "config.json").read_text())
        variables = load_msgpack_raw(self.dir / "variables.msgpack")
        self.model_config = config_from_artifact(
            self.config, unfolded=is_unfolded(variables),
            int8_kernels=has_int8_kernels(variables), **build)
        self.batch = self.config.get("batch")
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
