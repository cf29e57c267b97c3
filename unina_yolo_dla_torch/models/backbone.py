"""CSP-Darknet backbone emitting P2 (s4), P3 (s8), P4 (s16) + SPPF(P4).

The deployed ``s2d_merged`` + ``fused_stem`` engine only: the stem and the
stage1 downsample run as ONE fused kernel over the merged frame
(``ops/cuda/stem_kernel.py``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.cuda.stem_kernel import fused_stem_stage1
from .blocks import C3k2, ConvBlock, SPPF, WeightTree
from .config import ModelConfig


class Backbone(nn.Module):
    def __init__(self, tree: WeightTree, cfg: ModelConfig) -> None:
        super().__init__()
        if not (cfg.s2d_merged and cfg.fused_stem and cfg.deploy):
            raise NotImplementedError(
                "the port serves the deploy s2d_merged + fused_stem engine")
        dt = cfg.compute_dtype
        stem = tree.node("backbone/stem/conv")
        s1 = tree.node("backbone/stage1_conv/conv")

        def buf(name, a, dtype):
            self.register_buffer(name, torch.from_numpy(
                np.array(a, np.float32)).to(dtype))

        # kernels in the compute dtype (as the fused pass reads them),
        # biases in f32
        buf("stem_kernel", stem["kernel"], dt)
        buf("stem_bias", stem["bias"], torch.float32)
        buf("stage1_kernel", s1["kernel"], dt)
        buf("stage1_bias", s1["bias"], torch.float32)
        self.dtype = dt
        if cfg.lite_p2:
            self.stage1_block = ConvBlock(tree, "backbone/stage1_block", 3)
        else:
            self.stage1_block = C3k2(tree, "backbone/stage1_block")
        self.stage2_conv = ConvBlock(tree, "backbone/stage2_conv", 3, 2)
        self.stage2_c3k2 = C3k2(tree, "backbone/stage2_c3k2")
        self.stage3_conv = ConvBlock(tree, "backbone/stage3_conv", 3, 2)
        self.stage3_c3k2 = C3k2(tree, "backbone/stage3_c3k2")
        self.sppf = SPPF(tree, "backbone/sppf")

    def forward(self, x: torch.Tensor):
        x = fused_stem_stage1(x.to(self.dtype).contiguous(),
                              self.stem_kernel, self.stem_bias,
                              self.stage1_kernel, self.stage1_bias)
        p2 = self.stage1_block(x)
        p3 = self.stage2_c3k2(self.stage2_conv(p2))
        p4 = self.stage3_c3k2(self.stage3_conv(p3))
        return p2, p3, p4, self.sppf(p4)
