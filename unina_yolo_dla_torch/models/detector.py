"""Full UNINA-YOLO-DLA detector: backbone + FPN/PAN neck + 3 heads, and
the weight carrier from the reference's variable tree.

Forward takes the normalised model input, the merged frame (B, S/2, S/4,
24) of an ``s2d_merged`` engine or (B, S, S, 3) of the camera engine, and
returns ``[(p2_cls, p2_reg), (p3_cls, p3_reg), (p4_cls, p4_reg)]`` NHWC
float32.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ..utils.device import resolve_device
from .backbone import Backbone
from .blocks import WeightTree
from .config import ModelConfig
from .head import DetectionHead
from .neck import Neck


class UninaYoloDla(nn.Module):
    """YOLOv11-inspired, ReLU-only, P2/P3/P4 anchor-free detector."""

    def __init__(self, tree: WeightTree, cfg: ModelConfig) -> None:
        super().__init__()
        self.config = cfg
        self.backbone = Backbone(tree, cfg)
        self.neck = Neck(tree, cfg)
        self.head_p2 = DetectionHead(tree, cfg, "head_p2")
        self.head_p3 = DetectionHead(tree, cfg, "head_p3")
        self.head_p4 = DetectionHead(tree, cfg, "head_p4")

    def forward(self, x: torch.Tensor):
        feats = self.backbone(x.to(self.config.compute_dtype))
        p2, p3, p4 = self.neck(feats)
        return [self.head_p2(p2), self.head_p3(p3), self.head_p4(p4)]


def from_jax_variables(variables: dict[str, Any], cfg: ModelConfig,
                       device=None) -> UninaYoloDla:
    """The reference's ``{"params", "quant"}`` tree of numpy arrays ->
    the port's detector on ``device`` (``cuda`` by default; ``"cpu"``
    runs the plain versions of the kernels).

    int8 kernels stay int8 (reshaped to the integer product's (N, K)),
    ``w_scale``, biases and ``amax`` stay float32, float kernels take the
    compute dtype, and the merged P2 head weights are built here."""
    model = UninaYoloDla(WeightTree(variables, cfg.quant, cfg.compute_dtype),
                         cfg).eval()
    return model.to(resolve_device(device))
