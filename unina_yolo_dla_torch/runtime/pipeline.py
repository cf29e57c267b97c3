"""Frame -> boxes serving pipeline at batch 1.

    merged uint8 frame (S/2, S/4, 24), blocked on the host
    -> normalize kernel (mean/std tiled 8x), in the model's compute dtype
    -> detector (fused stem+stage1 kernel, bf16 and int8 layers)
    -> decode kernel x 3 levels -> stable masked top-k into K slots
    -> NMS kernel -> Detections
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
from ..ops.decode import Detections, decode_outputs
from ..ops.nms import nms


def build_serving_fn(
    model: UninaYoloDla,
    cfg: ModelConfig,
    conf_threshold: float = DEFAULT_CONF_THRESHOLD,
    iou_threshold: float = DEFAULT_IOU_THRESHOLD,
    q_factor: float = DEFAULT_CP_Q,
    max_detections: int = MAX_DETECTIONS,
) -> Callable[[torch.Tensor], Detections]:
    """Returns ``serve(frame) -> Detections`` for one merged uint8 frame
    (S/2, S/4, 24) on the model's device."""
    if not cfg.s2d_merged:
        raise NotImplementedError("the port serves the s2d_merged engine")
    mean, std = channel_constants(24)
    # the kernel writes the model's compute dtype where it has that form,
    # so the model's first cast is a no-op
    out_dtype = (cfg.compute_dtype if cfg.compute_dtype in OUT_DTYPES
                 else torch.float32)

    @torch.inference_mode()
    def serve(frame: torch.Tensor) -> Detections:
        x = normalize(frame, mean, std, out_dtype=out_dtype)[None]
        outputs = model(x)
        dets = decode_outputs(outputs, cfg.strides, conf_threshold,
                              q_factor, max_detections)
        return nms(dets, iou_threshold)

    return serve
