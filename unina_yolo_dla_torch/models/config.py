"""Model configuration and serving constants.

The reference ``ModelConfig`` but ``param_dtype`` (always float32) and
``fused_impl`` (the XLA form, which here is the plain version):
architecture widths, the deploy-graph flags of the served engines
(``s2d_merged``, ``fused_stem``, ``merged_head``, ``fused_c3k2``,
``fused_head``, ``fused_only``) and the ``QuantSpec``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..quant.fake_quant import QuantSpec


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static architecture + numerics configuration.

    Attributes:
        num_classes: number of object classes (4 cone classes).
        base_channels: widths are ``base_channels * {1, 2, 4, 8, 16}``.
        lite_p2: P2 stage as one plain conv instead of a C3k2.
        input_size: static square input resolution.
        compute_dtype: activation dtype of the float layers.
        quant: quantisation behaviour; None is the float model.
        deploy: BatchNorm folded into conv weight + bias (the served
            engines); False is the train form (BatchNorm, trainable).
        stem_s2d / s2d_host / stage1_s2d / s2d_merged: the space-to-depth
            stem and its input contract: with ``s2d_merged`` the frame
            arrives as (S/2, S/4, 24) merged columns, with ``s2d_host``
            alone as (S/2, S/2, 12) blocked pixels, otherwise as (S, S, 3)
            (``stem_s2d`` without ``s2d_host`` blocks it on the device).
            ``stage1_s2d`` runs stage1 as the blocked downsample, else it
            is the standard 3x3 stride-2 conv.
        fused_stem: stem + stage1 as one fused kernel over the merged frame;
            without it an ``s2d_merged`` engine runs the stem as a shift-dot
            matmul and stage1 as its own kernel.
        merged_head: float-path heads as one channel-concat/block-diagonal
            conv chain (takes precedence over ``fused_head``).
        fused_c3k2: every float-path C3k2 as one fused kernel.
        fused_head: every float-path decoupled head as one fused kernel.
        fused_only: when set, only the named blocks/heads (module names:
            ``"stage1_block"``, ``"fpn_c3k2_2"``, ``"head_p2"``, ...) fuse.
    """

    num_classes: int = 4
    base_channels: int = 32
    lite_p2: bool = False
    input_size: int = 640
    compute_dtype: torch.dtype = torch.bfloat16
    num_anchors: int = 1
    quant: QuantSpec | None = None
    deploy: bool = False
    stem_s2d: bool = False
    s2d_host: bool = False
    stage1_s2d: bool = False
    s2d_merged: bool = False
    fused_stem: bool = False
    merged_head: bool = False
    fused_c3k2: bool = False
    fused_head: bool = False
    fused_only: tuple[str, ...] | None = None

    def with_quant(self, mode: str, **kw) -> "ModelConfig":
        """The same architecture in quant mode ``mode`` (``QuantSpec``
        fields in ``kw``): the QAT and calibration twins share this
        config's parameter tree."""
        base = self.quant or QuantSpec()
        return dataclasses.replace(
            self, quant=dataclasses.replace(base, mode=mode, **kw))

    def fuses(self, flag: bool, name: str) -> bool:
        """The per-block fusion gate: ``flag`` (``fused_c3k2`` or
        ``fused_head``) narrowed by ``fused_only``."""
        return flag and (self.fused_only is None or name in self.fused_only)

    @property
    def widths(self) -> tuple[int, int, int, int, int]:
        bc = self.base_channels
        return (bc, bc * 2, bc * 4, bc * 8, bc * 16)

    @property
    def strides(self) -> tuple[int, int, int]:
        """Feature strides of the P2/P3/P4 heads."""
        return (4, 8, 16)

    @property
    def grid_sizes(self) -> tuple[int, int, int]:
        s = self.input_size
        return (s // 4, s // 8, s // 16)

    @property
    def num_cells(self) -> int:
        """Total decode workload per frame (33,600 cells at 640)."""
        return sum(g * g for g in self.grid_sizes)


DEFAULT_CLASS_NAMES = ("yellow_cone", "blue_cone", "orange_cone",
                       "large_orange_cone")

DEFAULT_CONF_THRESHOLD = 0.5
DEFAULT_IOU_THRESHOLD = 0.45
DEFAULT_CP_Q = 0.1
MAX_DETECTIONS = 1024

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
