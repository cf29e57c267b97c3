"""Executor entry point for the native C++ host.

The port's counterpart of the reference executor: the host calls
``make_executor`` once at configure time, then invokes the returned
callable per frame with a memoryview of the shared-memory slot. The return
value is a packed bytes blob matching ``unina::Detection``
(``frame_ring.hpp``): u32 count, then count * {f32 x1,y1,x2,y2,score;
i32 cls}; a frame of the wrong geometry gets the ``0xFFFFFFFF`` sentinel.

Frames are RGB (3 channels), BGRA (4) or NV12 (channels 0: planar Y, then
interleaved UV), converted on the host as the reference does. A camera
artifact takes its camera's frames only (geometry and format), and their
bytes go to the artifact as they are: colour and resize run on the card.
The frame runs on the card (its captured graph) unless ``UNINA_FORCE_CPU``
is set, which serves the plain path on the CPU.
"""
from __future__ import annotations

import os
import struct

import numpy as np
import torch

from ..ops.preprocess import nv12_to_rgb
from .aot import validate_artifact_shapes
from .artifact import ServingArtifact

GEOMETRY_ERROR = struct.pack("<I", 0xFFFFFFFF)
FORMAT_CHANNELS = {"rgb": 3, "bgra": 4, "nv12": 0}
RECORD = np.dtype([("x1", "<f4"), ("y1", "<f4"), ("x2", "<f4"),
                   ("y2", "<f4"), ("score", "<f4"), ("cls", "<i4")])


def pack_records(packed: np.ndarray) -> bytes:
    """(K, 7) packed detections -> u32 count + the valid records."""
    keep = packed[:, 6] > 0.5
    p = packed[keep]
    rec = np.zeros(len(p), dtype=RECORD)
    rec["x1"], rec["y1"], rec["x2"], rec["y2"] = p[:, 0], p[:, 1], p[:, 2], \
        p[:, 3]
    rec["score"] = p[:, 4]
    rec["cls"] = p[:, 5].astype(np.int32)
    return struct.pack("<I", len(rec)) + rec.tobytes()


def make_executor(artifact_dir: str, expected_input: int = 640,
                  expected_classes: int = 4, **build):
    """-> ``execute(buf, width, height, channels) -> bytes``; ``build``
    goes to ``ServingArtifact``."""
    device = "cpu" if os.environ.get("UNINA_FORCE_CPU") else None
    artifact = ServingArtifact(artifact_dir, device=device, **build)
    validate_artifact_shapes(artifact, expected_input, expected_classes)
    s = expected_input
    camera = artifact.camera
    warm = artifact.frame_shape if camera else (s, s, 3)
    artifact.packed(np.zeros(warm, np.uint8))
    if camera:
        geometry = (camera["height"], camera["width"],
                    FORMAT_CHANNELS[camera["format"]])
        n_bytes = int(np.prod(artifact.frame_shape))

        def execute_camera(buf, width: int, height: int,
                           channels: int) -> bytes:
            if (height, width, channels) != geometry:
                return GEOMETRY_ERROR
            frame = np.frombuffer(buf, np.uint8)[:n_bytes]
            return pack_records(artifact.packed(
                frame.reshape(artifact.frame_shape)))

        return execute_camera

    def execute(buf, width: int, height: int, channels: int) -> bytes:
        frame = np.frombuffer(buf, np.uint8)
        if channels == 0:  # NV12: planar Y + interleaved UV
            n_y = height * width
            y = frame[:n_y].reshape(height, width)
            uv = frame[n_y:n_y + n_y // 2].reshape(height // 2,
                                                   width // 2, 2)
            rgb = nv12_to_rgb(torch.from_numpy(y.copy()),
                              torch.from_numpy(uv.copy()))
            frame = rgb.numpy().astype(np.uint8)
        else:
            frame = frame[: height * width * channels].reshape(
                height, width, channels)
            if channels == 4:  # BGRA -> RGB
                frame = np.ascontiguousarray(frame[..., 2::-1])
        if (height, width) != (s, s):
            return GEOMETRY_ERROR
        return pack_records(artifact.packed(frame))

    return execute
