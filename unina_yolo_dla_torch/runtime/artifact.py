"""Loaded serving artifact: ``config.json`` + ``variables.msgpack`` of an
exported engine directory -> a frame -> ``Detections`` callable.

The port's counterpart of the reference ``ServingArtifact``: the same
directory, the same call (one (S, S, 3) uint8 RGB frame, or (B, S, S, 3)
for a batch artifact), served by the port's modules instead of the
serialized program. Frames are blocked and merged on the host; the
weights go to the device once, at load.
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
from ..ops.decode import Detections
from ..ops.preprocess import merged_frame_np
from ..quant.fake_quant import PERF_EXCLUDE, QuantSpec
from ..utils.checkpoint import load_msgpack_raw
from ..utils.device import resolve_device
from .pipeline import build_batch_serving_fn, build_serving_fn


def config_from_artifact(conf: dict) -> ModelConfig:
    """The engine configuration an exported ``config.json`` describes
    (a batch artifact's engine is the batch-1 one; ``batch`` only sets
    the leading axis of its frames)."""
    if conf.get("camera"):
        raise NotImplementedError("camera artifacts are not ported yet")
    if not conf.get("s2d_merged"):
        raise NotImplementedError("the port serves s2d_merged artifacts")
    quant = (QuantSpec("int8_fused", exclude=PERF_EXCLUDE)
             if conf.get("quantized") else None)
    return ModelConfig(
        num_classes=conf["num_classes"],
        base_channels=conf["base_channels"],
        lite_p2=conf.get("lite_p2", False),
        input_size=conf["input_size"],
        quant=quant, deploy=True, stem_s2d=True, s2d_host=True,
        stage1_s2d=True, s2d_merged=True,
        fused_stem=conf.get("fused_stem", False),
        merged_head=conf.get("merged_head", False))


class ServingArtifact:
    """Frame(s) -> Detections with weights resident on ``device``.

    A batch artifact (``"batch": B`` in its config) takes (B, S, S, 3)
    frames and returns Detections whose fields have a leading B axis."""

    def __init__(self, directory: str | Path, device=None) -> None:
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
        build = build_batch_serving_fn if self.batch else build_serving_fn
        self._serve = build(
            self.model, self.model_config,
            c.get("conf_threshold", DEFAULT_CONF_THRESHOLD),
            c.get("iou_threshold", DEFAULT_IOU_THRESHOLD),
            c.get("q_factor", DEFAULT_CP_Q),
            c.get("max_detections", MAX_DETECTIONS))

    def stage(self, frames: np.ndarray) -> torch.Tensor:
        """(S, S, 3) uint8 RGB -> merged (S/2, S/4, 24) on the device; a
        batch artifact takes (B, S, S, 3) -> (B, S/2, S/4, 24)."""
        s = self.model_config.input_size
        shape = (s, s, 3) if not self.batch else (self.batch, s, s, 3)
        frames = np.asarray(frames)
        if frames.shape != shape or frames.dtype != np.uint8:
            raise ValueError(f"expected {shape} uint8 RGB frames, got "
                             f"{frames.shape} {frames.dtype}")
        return torch.from_numpy(merged_frame_np(frames)).to(self.device)

    def __call__(self, frames: np.ndarray) -> Detections:
        return self._serve(self.stage(frames))
