"""Frame -> boxes serving pipeline, at batch 1 and batch B, and from a
raw camera frame.

    uint8 frames in the engine's input layout (``staged_shape``): merged
    ([B,] S/2, S/4, 24) or blocked ([B,] S/2, S/2, 12), both blocked on
    the host, or plain ([B,] S, S, 3) RGB
    -> normalize kernel (mean/std tiled to the layout), in the model's
       compute dtype
    -> detector (stem and stage1 kernels, bf16 and int8 layers)
    -> decode kernel: every level of every image into K slots each
    -> NMS kernel (or, with ``use_greedy_nms=False``, the one-pass matrix
       form ``nms_fast`` in plain PyTorch) -> Detections

One launch of each of the four kernels per call, whatever B is. The camera
path replaces the first step: the raw camera frame (BGRA, RGB or NV12 at
camera resolution) -> camera kernel (colour, bilinear resize, letterbox
pad, normalise) -> the camera engine (standard stem, stage1 kernel) ->
decode -> NMS, with the boxes mapped back to camera pixels if asked.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..models.config import (
    DEFAULT_CONF_THRESHOLD,
    DEFAULT_CP_Q,
    DEFAULT_IOU_THRESHOLD,
    MAX_DETECTIONS,
    ModelConfig,
)
from ..models.detector import UninaYoloDla
from ..ops.cuda.camera_kernel import CameraGeometry, CameraPreprocess
from ..ops.cuda.preprocess_kernel import (
    OUT_DTYPES,
    channel_constants,
    normalize,
)
from ..ops.decode import Detections, decode_batch
from ..ops.nms import nms, nms_fast


def _out_dtype(cfg: ModelConfig) -> torch.dtype:
    """The preprocessing kernels write the model's compute dtype where they
    have that form, so the model's first cast is a no-op."""
    return (cfg.compute_dtype if cfg.compute_dtype in OUT_DTYPES
            else torch.float32)


def staged_shape(cfg: ModelConfig) -> tuple[int, int, int]:
    """One frame in the engine's input layout: merged (S/2, S/4, 24) for
    ``s2d_merged``, blocked (S/2, S/2, 12) for ``s2d_host``, else (S, S, 3)
    RGB (blocked on the device when ``stem_s2d``)."""
    s = cfg.input_size
    if cfg.s2d_merged:
        return (s // 2, s // 4, 24)
    if cfg.s2d_host:
        return (s // 2, s // 2, 12)
    return (s, s, 3)


def _build_detect(model: UninaYoloDla, cfg: ModelConfig,
                  conf_threshold: float, iou_threshold: float,
                  q_factor: float, max_detections: int,
                  use_greedy_nms: bool = True
                  ) -> Callable[[torch.Tensor], Detections]:
    """Normalised model input (B, ...) -> Detections with a leading B."""
    suppress = nms if use_greedy_nms else nms_fast

    def detect(x: torch.Tensor) -> Detections:
        dets = decode_batch(model(x), cfg.strides, conf_threshold, q_factor,
                            max_detections)
        return suppress(dets, iou_threshold)

    return detect


def build_batch_serving_fn(
    model: UninaYoloDla,
    cfg: ModelConfig,
    conf_threshold: float = DEFAULT_CONF_THRESHOLD,
    iou_threshold: float = DEFAULT_IOU_THRESHOLD,
    q_factor: float = DEFAULT_CP_Q,
    max_detections: int = MAX_DETECTIONS,
    use_greedy_nms: bool = True,
) -> Callable[[torch.Tensor], Detections]:
    """Returns ``serve(frames) -> Detections`` for uint8 frames (B,
    *``staged_shape(cfg)``) on the model's device; every field of the
    result has a leading B axis. ``use_greedy_nms=False`` suppresses with
    ``nms_fast`` (one pass, no chains) in place of the greedy kernel."""
    mean, std = channel_constants(staged_shape(cfg)[-1])
    out_dtype = _out_dtype(cfg)
    detect = _build_detect(model, cfg, conf_threshold, iou_threshold,
                           q_factor, max_detections, use_greedy_nms)

    @torch.inference_mode()
    def serve(frames: torch.Tensor) -> Detections:
        return detect(normalize(frames, mean, std, out_dtype=out_dtype))

    return serve


def build_serving_fn(
    model: UninaYoloDla,
    cfg: ModelConfig,
    conf_threshold: float = DEFAULT_CONF_THRESHOLD,
    iou_threshold: float = DEFAULT_IOU_THRESHOLD,
    q_factor: float = DEFAULT_CP_Q,
    max_detections: int = MAX_DETECTIONS,
    use_greedy_nms: bool = True,
) -> Callable[[torch.Tensor], Detections]:
    """Returns ``serve(frame) -> Detections`` for one uint8 frame of
    ``staged_shape(cfg)`` on the model's device: the batch path at B = 1,
    the leading axis dropped from the result (views)."""
    serve_batch = build_batch_serving_fn(model, cfg, conf_threshold,
                                         iou_threshold, q_factor,
                                         max_detections, use_greedy_nms)

    @torch.inference_mode()
    def serve(frame: torch.Tensor) -> Detections:
        return Detections(*(f[0] for f in serve_batch(frame[None])))

    return serve


def build_camera_serving_fn(
    model: UninaYoloDla,
    cfg: ModelConfig,
    camera_height: int,
    camera_width: int,
    camera_format: str = "bgra",
    conf_threshold: float = DEFAULT_CONF_THRESHOLD,
    iou_threshold: float = DEFAULT_IOU_THRESHOLD,
    q_factor: float = DEFAULT_CP_Q,
    max_detections: int = MAX_DETECTIONS,
    letterbox: bool = False,
    box_space: str = "model",
) -> Callable[[torch.Tensor], Detections]:
    """Returns ``serve(frame) -> Detections`` for one raw camera frame on
    the model's device: rgb (H, W, 3), bgra (H, W, 4) or nv12 (H*3/2, W)
    uint8 (``camera_format``).

    ``letterbox=False`` stretches the frame to the square model input;
    ``letterbox=True`` resizes it keeping its aspect and pads the rest
    with 114, the training geometry. ``box_space="camera"`` maps the boxes
    back to camera pixels (pad and scale undone, clamped to the frame);
    ``"model"`` keeps model-space boxes."""
    if cfg.s2d_host or cfg.s2d_merged:
        raise ValueError(
            "host space-to-depth engines cannot serve a camera: the frame "
            "is resized on the card, so there is no host staging pass to "
            "block it in")
    if box_space not in ("model", "camera"):
        raise ValueError(f"box_space: 'model' or 'camera', got {box_space!r}")
    geom = CameraGeometry(camera_height, camera_width, camera_format,
                          cfg.input_size, letterbox)
    device = next(model.buffers()).device
    pre = CameraPreprocess(geom, _out_dtype(cfg)).to(device)
    detect = _build_detect(model, cfg, conf_threshold, iou_threshold,
                           q_factor, max_detections)
    ch, cw, s = camera_height, camera_width, cfg.input_size

    def f32(values):
        return torch.tensor(values, dtype=torch.float32, device=device)

    scale, _, _, pad_y, pad_x = geom.window
    # 0-d tensor divisor: a Python number would divide by its reciprocal
    pads, scale_t = f32([pad_x, pad_y, pad_x, pad_y]), f32(scale)
    stretch = f32([cw / s, ch / s, cw / s, ch / s])
    lim = f32([cw, ch, cw, ch])

    @torch.inference_mode()
    def serve(frame: torch.Tensor) -> Detections:
        dets = Detections(*(f[0] for f in detect(pre(frame)[None])))
        if box_space == "model":
            return dets
        b = (dets.boxes - pads) / scale_t if letterbox else \
            dets.boxes * stretch
        return dets._replace(boxes=b.clamp(min=0.0).minimum(lim))

    return serve
