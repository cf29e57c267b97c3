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
is set, which serves the plain path on the CPU. The NV12 conversion
truncates to uint8, as the reference's ``embed.py`` does (the CUDA
executor rounds, as the reference's PJRT executor does).

``make_graph_executor`` is the native CUDA executor's configure step: it
loads the artifact on the card and hands the host its captured graph and
static buffers as plain integers; the host then replays the graph with no
Python in the frame loop.
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


class GraphHandle:
    """What the native CUDA executor needs of an artifact's captured frame,
    as plain integers, with the artifact kept alive (the graph reads its
    weights and owns its memory pool).

    ``graph_exec``: the ``cudaGraphExec_t``; ``input_ptr``/``input_bytes``:
    the static uint8 input; ``packed_ptr``/``max_detections``: the static
    (K, 7) float32 packed result; ``stream``: the stream the graph was
    captured on (the decode kernel's scratch is that stream's);
    ``device_index``; ``layout``: how a frame is staged (``merged``,
    ``blocked``, ``rgb``, or ``camera``: the raw frame of ``frame_width``
    x ``frame_height``, ``frame_channels`` 3 RGB, 4 BGRA or 0 NV12);
    ``input_size``: the model's."""

    def __init__(self, artifact: ServingArtifact) -> None:
        cap = artifact.graph
        self.artifact = artifact
        self.graph_exec = cap.graph.raw_cuda_graph_exec()
        if not self.graph_exec:
            raise RuntimeError("the captured graph has no executable")
        frame, packed = cap.frame, cap.packed
        if frame.dtype != torch.uint8 or not frame.is_contiguous():
            raise RuntimeError("the graph's input is no contiguous uint8 "
                               "tensor")
        if packed.dtype != torch.float32 or not packed.is_contiguous() or \
                packed.dim() != 2 or packed.shape[1] != 7:
            raise RuntimeError(f"the graph's packed result is "
                               f"{tuple(packed.shape)} {packed.dtype}")
        self.input_ptr = frame.data_ptr()
        self.input_bytes = frame.numel()
        self.packed_ptr = packed.data_ptr()
        self.max_detections = packed.shape[0]
        self.stream = cap.stream.cuda_stream
        self.device_index = cap.device.index or 0
        cfg = artifact.model_config
        self.input_size = cfg.input_size
        cam = artifact.camera
        if cam:
            self.layout = "camera"
            self.frame_width, self.frame_height = cam["width"], cam["height"]
            self.frame_channels = FORMAT_CHANNELS[cam["format"]]
        else:
            self.layout = ("merged" if cfg.s2d_merged else
                           "blocked" if cfg.s2d_host else "rgb")


def make_graph_executor(artifact_dir: str, expected_input: int = 640,
                        expected_classes: int = 4, **build) -> GraphHandle:
    """Load an artifact on the card for the native CUDA executor, which
    replays its captured graph from C++ -> ``GraphHandle``. Refuses
    ``UNINA_FORCE_CPU``, a host without a card and batch artifacts (the
    host serves one frame a call); ``build`` goes to ``ServingArtifact``."""
    if os.environ.get("UNINA_FORCE_CPU"):
        raise RuntimeError("UNINA_FORCE_CPU is set: the CUDA executor serves "
                           "the card only (the python executor serves the "
                           "CPU)")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the CUDA executor serves the "
                           "card only")
    artifact = ServingArtifact(artifact_dir, graph=True, **build)
    if artifact.batch:
        raise ValueError(f"a batch artifact ({artifact.batch} frames a "
                         "call): the native host serves one frame a call")
    validate_artifact_shapes(artifact, expected_input, expected_classes)
    return GraphHandle(artifact)
