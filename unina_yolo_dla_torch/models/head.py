"""Decoupled anchor-free detection head, one per feature level.

cls branch = 2x ConvBlock(3x3) + 1x1 pred -> ``num_classes``; reg branch =
2x ConvBlock(3x3) + 1x1 pred -> 4 TLBR. Quantized levels (P3/P4 of the
int8 engine) run the standard per-conv path; float levels of a
``merged_head`` engine (P2) run the branch-merged form: conv1 concatenates
output channels, conv2 and the preds are block-diagonal over the doubled
channels, built once at load exactly as the reference builds them. Float
levels of a ``fused_head`` engine (without ``merged_head``) run both
branches as one kernel (``ops/cuda/head_kernel.py``), whose preds stay
float32. ``TrainHead`` is the train form: BatchNorm conv blocks, the preds
with a bias (the cls bias initialised to a 0.01 prior).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops.cuda.head_kernel import fused_head, kernel_takes, \
    pack_head_weights
from ..ops.cuda.mma_pack import pack_head_mma
from ..quant.fake_quant import QuantConv, TrainQuantConv
from ..quant.qtensor import QTensor
from .blocks import ConvBlock, TrainConvBlock, WeightTree
from .config import ModelConfig

# sigmoid(CLS_BIAS_INIT) ~= 0.01 prior
CLS_BIAS_INIT = -math.log((1 - 0.01) / 0.01)


class TrainHead(nn.Module):
    """Decoupled head over a ``hidden``-channel level: two 3x3 blocks and a
    1x1 pred a branch; float32 logits."""

    def __init__(self, hidden: int, cfg: ModelConfig, name: str) -> None:
        super().__init__()
        na = cfg.num_anchors

        def block(sub):
            return TrainConvBlock(hidden, hidden, 3, 1, cfg, f"{name}/{sub}")

        def pred(sub, n, bias):
            return TrainQuantConv(hidden, n, 1, use_bias=True, bias_init=bias,
                                  dtype=cfg.compute_dtype, spec=cfg.quant,
                                  path=f"{name}/{sub}")

        self.cls_conv1, self.cls_conv2 = block("cls_conv1"), block("cls_conv2")
        self.cls_pred = pred("cls_pred", cfg.num_classes * na, CLS_BIAS_INIT)
        self.reg_conv1, self.reg_conv2 = block("reg_conv1"), block("reg_conv2")
        self.reg_pred = pred("reg_pred", 4 * na, 0.0)

    def forward(self, x):
        cls = self.cls_pred(self.cls_conv2(self.cls_conv1(x)))
        reg = self.reg_pred(self.reg_conv2(self.reg_conv1(x)))
        return cls.float(), reg.float()


class DetectionHead(nn.Module):
    _FUSED = ("wc1", "bc1", "wc2", "bc2", "wcp", "bcp",
              "wr1", "br1", "wr2", "br2", "wrp", "brp")

    def __init__(self, tree: WeightTree, cfg: ModelConfig, name: str
                 ) -> None:
        super().__init__()
        float_path = cfg.deploy and not tree.spec.active(name)
        self.merged = cfg.merged_head and float_path
        self.fused = (not self.merged and float_path
                      and cfg.fuses(cfg.fused_head, name))
        self.nc = cfg.num_classes * cfg.num_anchors
        self.dtype = cfg.compute_dtype
        if self.merged:
            self._build_merged(tree, name)
            return
        if self.fused:
            def kb(path):
                p = tree.node(f"{name}/{path}")
                return p["kernel"], p["bias"]

            ws = pack_head_weights(
                [kb("cls_conv1/conv"), kb("cls_conv2/conv")],
                kb("cls_pred"),
                [kb("reg_conv1/conv"), kb("reg_conv2/conv")],
                kb("reg_pred"), self.dtype)
            for n, t in zip(self._FUSED, ws):
                self.register_buffer(n, t)
            # the 3x3s (and the preds) once more as the CUDA kernel's B
            # operand
            w33 = (ws[0], ws[6], ws[2], ws[8], ws[4], ws[10])
            packs = kernel_takes(ws[0].shape[-1])
            self.register_buffer("w33", pack_head_mma(*w33) if packs else None)
            return
        self.cls_conv1 = ConvBlock(tree, f"{name}/cls_conv1", 3)
        self.cls_conv2 = ConvBlock(tree, f"{name}/cls_conv2", 3)
        self.cls_pred = tree.conv(f"{name}/cls_pred")
        self.reg_conv1 = ConvBlock(tree, f"{name}/reg_conv1", 3)
        self.reg_conv2 = ConvBlock(tree, f"{name}/reg_conv2", 3)
        self.reg_pred = tree.conv(f"{name}/reg_pred")

    def _build_merged(self, tree: WeightTree, name: str) -> None:
        def kb(path):
            p = tree.node(f"{name}/{path}")
            return (np.asarray(p["kernel"], np.float32),
                    np.asarray(p["bias"], np.float32))

        ck1, cb1 = kb("cls_conv1/conv")
        ck2, cb2 = kb("cls_conv2/conv")
        ckp, cbp = kb("cls_pred")
        rk1, rb1 = kb("reg_conv1/conv")
        rk2, rb2 = kb("reg_conv2/conv")
        rkp, rbp = kb("reg_pred")
        h, nc, nr = ck1.shape[2], ckp.shape[-1], rkp.shape[-1]
        z33 = np.zeros((3, 3, h, h), np.float32)
        k1 = np.concatenate([ck1, rk1], axis=-1)
        b1 = np.concatenate([cb1, rb1])
        k2 = np.concatenate([np.concatenate([ck2, z33], axis=-1),
                             np.concatenate([z33, rk2], axis=-1)], axis=2)
        b2 = np.concatenate([cb2, rb2])
        kp = np.concatenate(
            [np.concatenate([ckp, np.zeros((1, 1, h, nr), np.float32)], -1),
             np.concatenate([np.zeros((1, 1, h, nc), np.float32), rkp], -1)],
            axis=2)
        bp = np.concatenate([cbp, rbp])
        self.conv1 = QuantConv(k1, b1, 1, 1, dtype=self.dtype)
        self.conv2 = QuantConv(k2, b2, 1, 1, dtype=self.dtype)
        self.pred = QuantConv(kp, bp, 1, 0, dtype=self.dtype)

    def forward(self, x):
        if self.fused:
            if isinstance(x, QTensor):
                x = x.dequant(self.dtype)
            return fused_head(x.to(self.dtype).contiguous(),
                              *(getattr(self, n) for n in self._FUSED),
                              w33=self.w33)
        if self.merged:
            if isinstance(x, QTensor):
                x = x.dequant(self.dtype)
            y = torch.relu(self.conv1(x))
            y = torch.relu(self.conv2(y))
            y = self.pred(y)
            return y[..., :self.nc].float(), y[..., self.nc:].float()
        cls = self.cls_pred(self.cls_conv2(self.cls_conv1(x)))
        reg = self.reg_pred(self.reg_conv2(self.reg_conv1(x)))
        return cls.float(), reg.float()
