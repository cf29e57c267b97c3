"""CSP-Darknet backbone emitting P2 (s4), P3 (s8), P4 (s16) + SPPF(P4).

``TrainBackbone`` is the train form (BatchNorm blocks, the standard 3x3
stride-2 stem and stage1, widths ``base_channels * {1, 2, 4, 8}``);
``Backbone`` the deploy form. The deploy stems and stage1 downsamples, as the reference's export writes
them:

- ``s2d_merged`` + ``fused_stem``: stem and stage1 as ONE fused kernel
  over the merged frame (``ops/cuda/stem_kernel.py``).
- ``s2d_merged``: the stem as a shift-dot matmul emitting merged columns,
  then stage1 as its own kernel over them (``ops/cuda/stage1_kernel.py``).
- ``stem_s2d``: the stem as a shift-dot matmul with c1 outputs over the
  (S/2, S/2, 12) blocked frame, blocked on the host (``s2d_host``) or here
  (``ops.preprocess.space_to_depth``).
- otherwise the standard 3x3 stride-2 stem conv.

After an unmerged stem, ``stage1_s2d`` runs the blocked stage1 downsample
as the same stage1 kernel over the stem output viewed with adjacent column
pairs merged (a free view of the contiguous NHWC tensor); without it
stage1 is the standard 3x3 stride-2 conv. ``fused_c3k2`` fuses the
float-path C3k2s.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.cuda.mma_pack import pack_stage1_mma, pack_stem_mma, \
    stem_stage1_takes
from ..ops.cuda.stem_kernel import fused_stem_stage1
from ..ops.preprocess import space_to_depth
from .blocks import C3k2, ConvBlock, MergedDownsample, ShiftDot2x2, SPPF, \
    TrainC3k2, TrainConvBlock, TrainSPPF, WeightTree
from .config import ModelConfig

# deploy-graph stem forms, which the train form does not take
_DEPLOY_STEMS = ("stem_s2d", "s2d_host", "stage1_s2d", "s2d_merged",
                 "fused_stem")


class TrainBackbone(nn.Module):
    def __init__(self, cfg: ModelConfig) -> None:
        super().__init__()
        flags = [f for f in _DEPLOY_STEMS if getattr(cfg, f)]
        if flags:
            raise ValueError(f"{flags} are deploy-graph forms: the train "
                             "form has the standard stem and stage1")
        c1, c2, c3, c4, _ = cfg.widths

        def conv(name, cin, cout, k, s=1):
            return TrainConvBlock(cin, cout, k, s, cfg, f"backbone/{name}")

        def c3k2(name, c, n):
            return TrainC3k2(c, c, n, cfg, f"backbone/{name}")

        self.stem = conv("stem", 3, c1, 3, 2)
        self.stage1_conv = conv("stage1_conv", c1, c2, 3, 2)
        self.stage1_block = (conv("stage1_block", c2, c2, 3) if cfg.lite_p2
                             else c3k2("stage1_block", c2, 1))
        self.stage2_conv = conv("stage2_conv", c2, c3, 3, 2)
        self.stage2_c3k2 = c3k2("stage2_c3k2", c3, 2)
        self.stage3_conv = conv("stage3_conv", c3, c4, 3, 2)
        self.stage3_c3k2 = c3k2("stage3_c3k2", c4, 2)
        self.sppf = TrainSPPF(c4, c4, cfg, "backbone/sppf")

    def forward(self, x: torch.Tensor):
        p2 = self.stage1_block(self.stage1_conv(self.stem(x)))
        p3 = self.stage2_c3k2(self.stage2_conv(p2))
        p4 = self.stage3_c3k2(self.stage3_conv(p3))
        return p2, p3, p4, self.sppf(p4)


class Backbone(nn.Module):
    def __init__(self, tree: WeightTree, cfg: ModelConfig) -> None:
        super().__init__()
        dt = cfg.compute_dtype
        self.fused_stem = cfg.s2d_merged and cfg.fused_stem
        self.merged = cfg.s2d_merged
        # the stem's input arrives blocked from the host, or is blocked here
        self.device_s2d = cfg.stem_s2d and not cfg.s2d_host
        self.blocked_stage1 = cfg.s2d_merged or cfg.stage1_s2d
        if self.fused_stem:
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
            # the same kernels as the CUDA kernel's B tiles, packed once
            packs = stem_stage1_takes(self.stem_kernel.shape[-1])
            self.register_buffer("stem_kernel_mma", pack_stem_mma(
                self.stem_kernel) if packs else None)
            self.register_buffer("stage1_kernel_mma", pack_stage1_mma(
                self.stage1_kernel) if packs else None)
        else:
            # the stem is quant-excluded: a shift-dot matmul (ReLU after)
            # or the standard conv block in the compute dtype
            self.stem = (ShiftDot2x2(tree, "backbone/stem/conv")
                         if cfg.stem_s2d or cfg.s2d_merged else
                         ConvBlock(tree, "backbone/stem", 3, 2))
            self.stage1_conv = (
                MergedDownsample(tree, "backbone/stage1_conv/conv")
                if self.blocked_stage1 else
                ConvBlock(tree, "backbone/stage1_conv", 3, 2))
        self.dtype = dt

        def c3k2(name):
            return C3k2(tree, f"backbone/{name}",
                        fused=cfg.fuses(cfg.fused_c3k2, name))

        if cfg.lite_p2:
            self.stage1_block = ConvBlock(tree, "backbone/stage1_block", 3)
        else:
            self.stage1_block = c3k2("stage1_block")
        self.stage2_conv = ConvBlock(tree, "backbone/stage2_conv", 3, 2)
        self.stage2_c3k2 = c3k2("stage2_c3k2")
        self.stage3_conv = ConvBlock(tree, "backbone/stage3_conv", 3, 2)
        self.stage3_c3k2 = c3k2("stage3_c3k2")
        self.sppf = SPPF(tree, "backbone/sppf")

    def forward(self, x: torch.Tensor):
        x = x.to(self.dtype).contiguous()
        if self.fused_stem:
            ks, k1 = ((self.stem_kernel_mma, self.stage1_kernel_mma)
                      if x.is_cuda else
                      (self.stem_kernel, self.stage1_kernel))
            x = fused_stem_stage1(x, ks, self.stem_bias, k1,
                                  self.stage1_bias)
        else:
            if self.device_s2d:
                x = space_to_depth(x, 2)
            x = self.stem(x)
            if isinstance(self.stem, ShiftDot2x2):
                x = torch.relu(x)   # a ConvBlock's ReLU is its own
            if self.blocked_stage1 and not self.merged:
                # the merged view needs contiguous NHWC
                x = x.contiguous()
                b, h, w, c = x.shape
                x = x.view(b, h, w // 2, 2 * c)
            x = self.stage1_conv(x)
        p2 = self.stage1_block(x)
        p3 = self.stage2_c3k2(self.stage2_conv(p2))
        p4 = self.stage3_c3k2(self.stage3_conv(p3))
        return p2, p3, p4, self.sppf(p4)
