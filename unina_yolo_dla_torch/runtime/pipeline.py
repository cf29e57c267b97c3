"""Frame -> boxes serving pipeline, at batch 1 and batch B.

    merged uint8 frames ([B,] S/2, S/4, 24), blocked on the host
    -> normalize kernel (mean/std tiled 8x), in the model's compute dtype
    -> detector (fused stem+stage1 kernel, bf16 and int8 layers)
    -> decode kernel: every level of every image into K slots each
    -> NMS kernel -> Detections

One launch of each of the four kernels per call, whatever B is.
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
from ..ops.cuda.preprocess_kernel import (
    OUT_DTYPES,
    channel_constants,
    normalize,
)
from ..ops.decode import Detections, decode_batch
from ..ops.nms import nms


def build_batch_serving_fn(
    model: UninaYoloDla,
    cfg: ModelConfig,
    conf_threshold: float = DEFAULT_CONF_THRESHOLD,
    iou_threshold: float = DEFAULT_IOU_THRESHOLD,
    q_factor: float = DEFAULT_CP_Q,
    max_detections: int = MAX_DETECTIONS,
) -> Callable[[torch.Tensor], Detections]:
    """Returns ``serve(frames) -> Detections`` for merged uint8 frames
    (B, S/2, S/4, 24) on the model's device; every field of the result
    has a leading B axis."""
    if not cfg.s2d_merged:
        raise NotImplementedError("the port serves the s2d_merged engine")
    mean, std = channel_constants(24)
    # the kernel writes the model's compute dtype where it has that form,
    # so the model's first cast is a no-op
    out_dtype = (cfg.compute_dtype if cfg.compute_dtype in OUT_DTYPES
                 else torch.float32)

    @torch.inference_mode()
    def serve(frames: torch.Tensor) -> Detections:
        x = normalize(frames, mean, std, out_dtype=out_dtype)
        dets = decode_batch(model(x), cfg.strides, conf_threshold, q_factor,
                            max_detections)
        return nms(dets, iou_threshold)

    return serve


def build_serving_fn(
    model: UninaYoloDla,
    cfg: ModelConfig,
    conf_threshold: float = DEFAULT_CONF_THRESHOLD,
    iou_threshold: float = DEFAULT_IOU_THRESHOLD,
    q_factor: float = DEFAULT_CP_Q,
    max_detections: int = MAX_DETECTIONS,
) -> Callable[[torch.Tensor], Detections]:
    """Returns ``serve(frame) -> Detections`` for one merged uint8 frame
    (S/2, S/4, 24) on the model's device: the batch path at B = 1, the
    leading axis dropped from the result (views)."""
    serve_batch = build_batch_serving_fn(model, cfg, conf_threshold,
                                         iou_threshold, q_factor,
                                         max_detections)

    @torch.inference_mode()
    def serve(frame: torch.Tensor) -> Detections:
        return Detections(*(f[0] for f in serve_batch(frame[None])))

    return serve
