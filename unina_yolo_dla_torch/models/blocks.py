"""Building blocks of the deployed engine: ConvBlock, Bottleneck, C3k2,
SPPF, nearest 2x upsample and the int8-aware concat.

Deploy mode only (BatchNorm folded into conv weight + bias). Each block is
built from the reference's variable tree by ``WeightTree`` at the block's
scope path (``backbone/stage2_c3k2``, ...), which also decides, with the
``QuantSpec``, whether each conv runs the int8 or the float branch and
which activation quantisers exist. Activations are NHWC tensors or
``QTensor``s between blocks.
"""
from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..quant.fake_quant import ActQuant, QuantConv, QuantSpec
from ..quant.qtensor import (
    QTensor,
    fma_f32,
    qconcat,
    qmaxpool,
    upsample_nearest_2x_q,
)
from ..quant.qtensor import upsample_nearest_2x as _upsample_tensor


class WeightTree:
    """Read access to a reference variable tree (``{"params", "quant"}``
    nested dicts of numpy arrays) by scope path."""

    def __init__(self, variables: dict[str, Any], spec: QuantSpec | None,
                 dtype: torch.dtype) -> None:
        self.params = variables["params"]
        self.quant = variables.get("quant", {})
        self.spec = spec or QuantSpec()
        self.dtype = dtype

    @staticmethod
    def _get(tree: dict, path: str):
        node = tree
        for key in path.split("/"):
            if not isinstance(node, dict) or key not in node:
                return None
            node = node[key]
        return node

    def node(self, path: str) -> dict:
        node = self._get(self.params, path)
        if node is None:
            raise KeyError(f"no parameters at {path!r}")
        return node

    def amax(self, path: str) -> np.float32 | None:
        leaf = self._get(self.quant, path + "/amax")
        return None if leaf is None else np.float32(leaf)

    def act_quant(self, path: str) -> ActQuant | None:
        """The ``int8_fused`` quantiser at ``path`` (None where the spec
        leaves the path in float)."""
        if not self.spec.active(path):
            return None
        amax = self.amax(path)
        if amax is None:
            raise KeyError(f"calibrated amax missing at quant/{path}")
        return ActQuant(amax)

    def conv(self, path: str, stride: int = 1, padding=0) -> QuantConv:
        """The QuantConv whose ``kernel``/``bias``/``w_scale`` live at
        ``path`` (``<block>/conv`` or a head's ``cls_pred``)."""
        p = self.node(path)
        kernel = np.asarray(p["kernel"])
        int8 = self.spec.active(path)
        if int8 != (kernel.dtype == np.int8):
            raise ValueError(f"{path}: kernel dtype {kernel.dtype} does not "
                             f"match the quant spec (int8={int8})")
        in_amax = self.amax(path + "/in_q") if int8 else None
        return QuantConv(kernel, p.get("bias"), stride, padding,
                         w_scale=p.get("w_scale"), in_amax=in_amax,
                         dtype=self.dtype)

    def count(self, path: str, prefix: str) -> int:
        return sum(1 for k in self.node(path) if k.startswith(prefix))


def upsample_nearest_2x(x):
    """Nearest 2x upsample; int8 tensors upsample as int8."""
    if isinstance(x, QTensor):
        return upsample_nearest_2x_q(x)
    return _upsample_tensor(x)


def concat_features(xs, dim: int = -1):
    """Concat that keeps a fused int8 chain int8 (scale-matched); with any
    float input, int8 inputs dequantise to bf16 first, as the reference."""
    if all(isinstance(x, QTensor) for x in xs):
        return qconcat(list(xs), dim=dim)
    xs = [x.dequant(torch.bfloat16) if isinstance(x, QTensor) else x
          for x in xs]
    dt = functools.reduce(torch.promote_types, [x.dtype for x in xs])
    return torch.cat([x.to(dt) for x in xs], dim=dim)


class ConvBlock(nn.Module):
    """Conv (+ folded bias) + ReLU, then ``out_q`` requant where int8."""

    def __init__(self, tree: WeightTree, path: str, kernel_size: int,
                 stride: int = 1) -> None:
        super().__init__()
        self.conv = tree.conv(path + "/conv", stride, kernel_size // 2)
        self.out_q = tree.act_quant(path + "/out_q")

    def forward(self, x):
        y = torch.relu(self.conv(x))
        return self.out_q(y) if self.out_q is not None else y


class Bottleneck(nn.Module):
    """1x1 -> 3x3 with residual; on the int8 chain the residual sum is
    requantised to its calibrated ``add_q`` amax."""

    def __init__(self, tree: WeightTree, path: str, shortcut: bool = True
                 ) -> None:
        super().__init__()
        self.cv1 = ConvBlock(tree, path + "/cv1", 1)
        self.cv2 = ConvBlock(tree, path + "/cv2", 3)
        self.shortcut = shortcut
        self.add_q = tree.act_quant(path + "/add_q")

    def forward(self, x):
        out = self.cv2(self.cv1(x))
        if not (self.shortcut and x.shape[-1] == out.shape[-1]):
            return out
        if isinstance(out, QTensor) and isinstance(x, QTensor):
            # dequant both (f32) and add; XLA contracts the first product
            # into the add, so the sum is one fused multiply-add
            s = fma_f32(out.q.float(), float(out.scale),
                        x.q.float() * float(x.scale))
            if self.add_q is None:
                raise ValueError("int8 residual without add_q")
            return self.add_q(s)
        if isinstance(out, QTensor) or isinstance(x, QTensor):
            raise ValueError("mixed int8/float residual")
        return x + out


class C3k2(nn.Module):
    """Cross-stage-partial block: two 1x1 projections, ``n`` bottlenecks on
    one path, concat, 1x1 out conv. ``x2``/``up_x`` carry the neck's
    ``C3k2(concat([upsample2x?(x), x2]))`` pattern."""

    def __init__(self, tree: WeightTree, path: str, shortcut: bool = True
                 ) -> None:
        super().__init__()
        n = tree.count(path, "bottleneck_")
        self.cv1 = ConvBlock(tree, path + "/cv1", 1)
        self.bottlenecks = nn.ModuleList(
            Bottleneck(tree, f"{path}/bottleneck_{i}", shortcut)
            for i in range(n))
        self.cv2 = ConvBlock(tree, path + "/cv2", 1)
        self.cv3 = ConvBlock(tree, path + "/cv3", 1)

    def forward(self, x, x2=None, up_x: bool = False):
        if x2 is not None:
            x = upsample_nearest_2x(x) if up_x else x
            x = concat_features([x, x2])
        path1 = self.cv1(x)
        for b in self.bottlenecks:
            path1 = b(path1)
        path2 = self.cv2(x)
        return self.cv3(concat_features([path1, path2]))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): three chained 5x5 stride-1 max-pools
    (on int8 values when the chain is int8)."""

    def __init__(self, tree: WeightTree, path: str, pool_size: int = 5
                 ) -> None:
        super().__init__()
        self.cv1 = ConvBlock(tree, path + "/cv1", 1)
        self.cv2 = ConvBlock(tree, path + "/cv2", 1)
        self.k = pool_size

    def _pool(self, t):
        if isinstance(t, QTensor):
            return qmaxpool(t, self.k)
        y = F.max_pool2d(t.permute(0, 3, 1, 2), self.k, 1, self.k // 2)
        return y.permute(0, 2, 3, 1)

    def forward(self, x):
        x = self.cv1(x)
        y1 = self._pool(x)
        y2 = self._pool(y1)
        y3 = self._pool(y2)
        return self.cv2(concat_features([x, y1, y2, y3]))
