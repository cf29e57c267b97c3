"""FPN top-down + PAN bottom-up neck over P2/P3/P4: lateral 1x1 convs,
nearest 2x upsample, concat fusion, strided-conv downsampling. The
upsample + concat go through C3k2's ``x2``/``up_x`` so that a fused C3k2
(``fpn_c3k2_2`` in the int8 ``fused_c3k2`` engine) folds them into its
first dots. ``TrainNeck`` is the train form."""
from __future__ import annotations

import numpy as np
from torch import nn

from .blocks import C3k2, ConvBlock, TrainC3k2, TrainConvBlock, WeightTree
from .config import ModelConfig


def _forward(neck, features):
    p2_in, p3_in, p4_in, p4_sppf = features
    # top-down (FPN): 40 -> 80 -> 160
    p3_fused = neck.fpn_c3k2_1(neck.lateral_p3(p4_sppf), x2=p3_in, up_x=True)
    p2_fused = neck.fpn_c3k2_2(neck.lateral_p2(p3_fused), x2=p2_in, up_x=True)
    # bottom-up (PAN)
    p3_out = neck.pan_c3k2_1(neck.down1(p2_fused), x2=p3_fused)
    p4_out = neck.pan_c3k2_2(neck.down2(p3_out), x2=p4_in)
    return p2_fused, p3_out, p4_out


class TrainNeck(nn.Module):
    def __init__(self, cfg: ModelConfig) -> None:
        super().__init__()
        _, c2, c3, c4, _ = cfg.widths

        def conv(name, cin, cout, k, s=1):
            return TrainConvBlock(cin, cout, k, s, cfg, f"neck/{name}")

        def c3k2(name, cin, c):
            return TrainC3k2(cin, c, 1, cfg, f"neck/{name}")

        self.lateral_p3 = conv("lateral_p3", c4, c3, 1)
        self.fpn_c3k2_1 = c3k2("fpn_c3k2_1", 2 * c3, c3)
        self.lateral_p2 = conv("lateral_p2", c3, c2, 1)
        self.fpn_c3k2_2 = c3k2("fpn_c3k2_2", 2 * c2, c2)
        self.down1 = conv("down1", c2, c2, 3, 2)
        self.pan_c3k2_1 = c3k2("pan_c3k2_1", c2 + c3, c3)
        self.down2 = conv("down2", c3, c3, 3, 2)
        self.pan_c3k2_2 = c3k2("pan_c3k2_2", c3 + c4, c4)

    forward = _forward


class Neck(nn.Module):
    def __init__(self, tree: WeightTree, cfg: ModelConfig) -> None:
        super().__init__()

        def c3k2(name, first, up=False):
            # `first` makes the block's first input; its width is where a
            # fused block's packed weights split; `up`: it is upsampled
            split = np.shape(tree.node(f"neck/{first}/conv")["kernel"])[-1]
            return C3k2(tree, f"neck/{name}", split=split, up=up,
                        fused=cfg.fuses(cfg.fused_c3k2, name))

        self.lateral_p3 = ConvBlock(tree, "neck/lateral_p3", 1)
        self.fpn_c3k2_1 = c3k2("fpn_c3k2_1", "lateral_p3", up=True)
        self.lateral_p2 = ConvBlock(tree, "neck/lateral_p2", 1)
        self.fpn_c3k2_2 = c3k2("fpn_c3k2_2", "lateral_p2", up=True)
        self.down1 = ConvBlock(tree, "neck/down1", 3, 2)
        self.pan_c3k2_1 = c3k2("pan_c3k2_1", "down1")
        self.down2 = ConvBlock(tree, "neck/down2", 3, 2)
        self.pan_c3k2_2 = c3k2("pan_c3k2_2", "down2")

    forward = _forward
