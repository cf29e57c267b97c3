"""Building blocks of the deployed engines and of the train form.

Deploy form (BatchNorm folded into conv weight + bias): ConvBlock,
Bottleneck, C3k2 (standard and fused), SPPF, the merged-layout stem
(ShiftDot2x2) and stage1 downsample (MergedDownsample), nearest 2x
upsample and the int8-aware concat. Each block is built from the
reference's variable tree by ``WeightTree`` at the block's scope path
(``backbone/stage2_c3k2``, ...), which also decides, with the
``QuantSpec``, whether each conv runs the int8 or the float branch and
which activation quantisers exist. Activations are NHWC tensors or
``QTensor``s between blocks.

Train form (``Train*``, and ``BatchNorm``): conv (no bias) + BatchNorm +
ReLU blocks whose parameters are ``nn.Parameter``s and whose statistics
are buffers, named as the reference's variable tree names them (module
attribute ``bottleneck_0``, parameter ``kernel``: ``.../bottleneck_0/cv1/
conv/kernel``). ``train()`` / ``eval()`` pick batch or running statistics.
Each block takes its scope path, which decides with the ``QuantSpec``
which quantisers exist (calibration and QAT modes).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.cuda.c3k2_kernel import (
    fused_c3k2,
    fused_c3k2_cat,
    kernel_takes,
    pack_c3k2_weights,
)
from ..ops.cuda.mma_pack import pack_c3k2_mma, pack_stage1_mma, \
    stem_stage1_takes
from ..ops.cuda.stage1_kernel import fused_downsample_merged
from ..parallel.distributed import all_reduce_sum
from ..quant.fake_quant import (
    CALIB_MODES,
    INT8_MODES,
    ActQuant,
    FakeQuant,
    QuantConv,
    QuantSpec,
    TrainActQuant,
    TrainQuantConv,
    quant_weight,
)
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
    nested dicts of numpy arrays) by scope path, and the deploy form's
    quantisers of its ``QuantSpec``: the fused int8 chain (``int8_fused``),
    the unfused int8 engine (``int8``) or the folded QAT model
    (``quantize``); calibration modes are the train form's."""

    DEPLOY_MODES = ("off", "quantize") + INT8_MODES

    def __init__(self, variables: dict[str, Any], spec: QuantSpec | None,
                 dtype: torch.dtype) -> None:
        self.params = variables["params"]
        self.quant = variables.get("quant", {})
        self.spec = spec or QuantSpec()
        if self.spec.mode not in self.DEPLOY_MODES:
            raise ValueError(
                f"quant mode {self.spec.mode!r} is the train form's "
                "(deploy=False); a deploy model takes "
                f"{self.DEPLOY_MODES}")
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

    def _calibrated(self, path: str) -> np.float32:
        amax = self.amax(path)
        if amax is None:
            raise KeyError(f"calibrated amax missing at quant/{path}")
        return amax

    def act_quant(self, path: str) -> ActQuant | None:
        """The ``int8_fused`` quantiser at ``path`` (None in the other
        modes, or where the spec leaves the path in float)."""
        if self.spec.mode != "int8_fused" or not self.spec.active(path):
            return None
        return ActQuant(self._calibrated(path))

    def fake_quant(self, path: str) -> FakeQuant | None:
        """The folded QAT model's fake-quantiser at ``path`` (None in the
        other modes, or where the spec excludes the path)."""
        if self.spec.mode != "quantize" or not self.spec.active(path):
            return None
        return FakeQuant(self._calibrated(path), self.spec.num_bits)

    def conv(self, path: str, stride: int = 1, padding=0) -> QuantConv:
        """The QuantConv whose ``kernel``/``bias``/``w_scale`` live at
        ``path`` (``<block>/conv`` or a head's ``cls_pred``)."""
        p = self.node(path)
        kernel = np.asarray(p["kernel"])
        active = self.spec.active(path)
        int8 = active and self.spec.mode in INT8_MODES
        if int8 != (kernel.dtype == np.int8):
            raise ValueError(f"{path}: kernel dtype {kernel.dtype} does not "
                             f"match the quant spec (int8={int8})")
        in_amax = self.amax(path + "/in_q") if int8 else None
        fake_in = self.fake_quant(path + "/in_q")
        if fake_in is not None:
            # the reference fake-quantises the float32 kernel every call;
            # it is a constant here, so once
            kernel = quant_weight(torch.from_numpy(kernel.astype(
                np.float32)), self.spec, path).numpy()
        out = (self.dtype if self.spec.mode == "int8" else torch.float32)
        return QuantConv(kernel, p.get("bias"), stride, padding,
                         w_scale=p.get("w_scale"), in_amax=in_amax,
                         dtype=self.dtype, int8_out=out, fake_in=fake_in)

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


class _KernelBias(nn.Module):
    """A conv's kernel at ``path`` in the compute dtype, its bias in f32."""

    def __init__(self, tree: WeightTree, path: str) -> None:
        super().__init__()
        p = tree.node(path)
        self.register_buffer("kernel", torch.from_numpy(
            np.array(p["kernel"], np.float32)).to(tree.dtype))
        self.register_buffer("bias", torch.from_numpy(
            np.array(p["bias"], np.float32)))


class ShiftDot2x2(_KernelBias):
    """The merged stem conv: 2x2 stride-1, pad ((1,0),(1,0)), as four
    shifted slices concatenated to (N, 4C) and one float32 matmul of the
    compute-dtype values, bias added in float32, the result rounded to
    the compute dtype (ReLU follows in the caller)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *lead, h, w, c = x.shape
        o = self.kernel.shape[-1]
        xp = F.pad(x.to(self.kernel.dtype), (0, 0, 1, 0, 1, 0))
        patches = torch.cat([xp[..., kh:kh + h, kw:kw + w, :]
                             for kh in range(2) for kw in range(2)], dim=-1)
        y = patches.reshape(-1, 4 * c).float() @ \
            self.kernel.float().reshape(4 * c, o)
        return (y + self.bias).reshape(*lead, h, w, o).to(self.kernel.dtype)


class MergedDownsample(_KernelBias):
    """stage1_conv of an ``s2d_merged`` engine without ``fused_stem``:
    the blocked 2x2 conv + bias + ReLU over the column-merged stem output,
    one kernel (``ops/cuda/stage1_kernel.py``). The kernel's B-tile image
    of the weights is packed here, once."""

    def __init__(self, tree: WeightTree, path: str) -> None:
        super().__init__(tree, path)
        packs = stem_stage1_takes(self.kernel.shape[-1])
        self.register_buffer(
            "kernel_mma", pack_stage1_mma(self.kernel) if packs else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_downsample_merged(
            x.to(self.kernel.dtype).contiguous(),
            self.kernel_mma if x.is_cuda else self.kernel, self.bias)


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
        self.residual_q = tree.fake_quant(path + "/residual_q")

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
        if self.residual_q is not None:
            x = self.residual_q(x)
        return x + out


class C3k2(nn.Module):
    """Cross-stage-partial block: two 1x1 projections, ``n`` bottlenecks on
    one path, concat, 1x1 out conv. ``x2``/``up_x`` carry the neck's
    ``C3k2(concat([upsample2x?(x), x2]))`` pattern.

    ``fused`` (float-path blocks only): the whole block is one kernel
    (``ops/cuda/c3k2_kernel.py``; the pair form folds the upsample and
    the concat into its first dots), its weights packed once here, also
    as the CUDA kernel's B tiles. ``split`` is the channel count of ``x``
    where the block is called with ``x2`` (the tiles keep the two inputs'
    channels apart), else 0."""

    _FUSED = ("w1", "b1", "wb1", "bb1", "wb2", "bb2", "w2", "b2", "w3", "b3")

    def __init__(self, tree: WeightTree, path: str, shortcut: bool = True,
                 fused: bool = False, split: int = 0) -> None:
        super().__init__()
        n = tree.count(path, "bottleneck_")
        self.shortcut = shortcut
        self.fused = fused and not tree.spec.active(path)
        if self.fused:
            self.dtype = tree.dtype

            def kb(sub):
                p = tree.node(f"{path}/{sub}/conv")
                return p["kernel"], p["bias"]

            ws = pack_c3k2_weights(
                kb("cv1"), kb("cv2"), kb("cv3"),
                [(kb(f"bottleneck_{i}/cv1"), kb(f"bottleneck_{i}/cv2"))
                 for i in range(n)], tree.dtype)
            for name, t in zip(self._FUSED, ws):
                self.register_buffer(name, t)
            w1, _, wb1, _, wb2, _, w2, _, w3, _ = ws
            packs = kernel_takes(w1.shape[0], w1.shape[1], w3.shape[1],
                                 wb1.shape[0], split)
            self.register_buffer("wpk", pack_c3k2_mma(
                w1, w2, wb1, wb2, w3, split) if packs else None)
            return
        self.cv1 = ConvBlock(tree, path + "/cv1", 1)
        self.bottlenecks = nn.ModuleList(
            Bottleneck(tree, f"{path}/bottleneck_{i}", shortcut)
            for i in range(n))
        self.cv2 = ConvBlock(tree, path + "/cv2", 1)
        self.cv3 = ConvBlock(tree, path + "/cv3", 1)

    def _forward_fused(self, x, x2, up_x: bool):
        def deq(t):   # the int8 -> float boundary, as QuantConv's
            t = t.dequant(self.dtype) if isinstance(t, QTensor) else t
            return t.to(self.dtype).contiguous()

        ws = [getattr(self, n) for n in self._FUSED]
        if x2 is not None:
            return fused_c3k2_cat(deq(x), deq(x2), *ws, wpk=self.wpk,
                                  shortcut=self.shortcut, up_a=up_x)
        return fused_c3k2(deq(x), *ws, wpk=self.wpk, shortcut=self.shortcut)

    def forward(self, x, x2=None, up_x: bool = False):
        if self.fused:
            return self._forward_fused(x, x2, up_x)
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


# ---------------------------------------------------------------- train form


class BatchNorm(nn.Module):
    """BatchNorm over the channels (last axis) of an NHWC tensor, as the
    reference's (flax, momentum 0.9, eps 1e-5) computes it:

    - statistics in float32 at least (float64 stays float64), the
      variance in the fast form E[x^2] - E[x]^2 floored at 0;
    - in training the running statistics take 0.1 of the batch's, the
      variance biased (``nn.BatchNorm2d`` keeps it unbiased);
    - ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in that type,
      the result in ``dtype``.

    ``scale``/``bias`` are parameters, ``mean``/``var`` the buffers of the
    ``batch_stats`` collection.

    ``process_group`` (None by default, set by ``batchnorm_group``): in
    training, each process's batch mean and E[x^2] are averaged over the
    group's processes (equal rows each) before use, differentiably, so the
    statistics are the global batch's, as the reference's SPMD program
    computes them over a sharded batch."""

    collection = "batch_stats"

    def __init__(self, features: int, dtype: torch.dtype,
                 momentum: float = 0.9, eps: float = 1e-5) -> None:
        super().__init__()
        self.dtype, self.momentum, self.eps = dtype, momentum, eps
        self.process_group = None
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            mean = xf.mean(dim=(0, 1, 2))
            mean2 = (xf * xf).mean(dim=(0, 1, 2))
            if self.process_group is not None:
                ws = dist.get_world_size(self.process_group)
                both = all_reduce_sum(torch.stack([mean, mean2]),
                                      self.process_group)
                mean, mean2 = both / both.new_tensor(ws)
            var = torch.maximum(mean2 - mean * mean, mean.new_zeros(()))
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.scale)
        return (y + self.bias).to(self.dtype)


@contextlib.contextmanager
def batchnorm_group(model: nn.Module, group):
    """Within the block, every ``BatchNorm`` of ``model`` takes its
    training statistics over ``group``'s processes (None: this process's
    batch alone, as without the block)."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.process_group = group
    try:
        yield
    finally:
        for m in bns:
            m.process_group = None


class TrainConvBlock(nn.Module):
    """Conv (no bias) + BatchNorm + ReLU; in the calibration modes an
    ``out_q`` quantiser collects the block's output."""

    def __init__(self, cin: int, features: int, kernel_size: int,
                 stride: int, cfg, path: str) -> None:
        super().__init__()
        dt, spec = cfg.compute_dtype, cfg.quant
        self.conv = TrainQuantConv(cin, features, kernel_size, stride,
                                   kernel_size // 2, dtype=dt, spec=spec,
                                   path=path + "/conv")
        self.bn = BatchNorm(features, dt)
        self.out_q = (TrainActQuant.at(spec, path + "/out_q", CALIB_MODES)
                      if spec is not None and not spec.excluded(path)
                      else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn(self.conv(x)))
        return self.out_q(y) if self.out_q is not None else y


class TrainBottleneck(nn.Module):
    """1x1 -> 3x3, with the residual where the widths allow it; the
    residual input gets its own quantiser (calibration and QAT) and the
    sum an ``add_q`` (calibration, for the int8 engine's requant)."""

    def __init__(self, cin: int, features: int, shortcut: bool,
                 expansion: float, cfg, path: str) -> None:
        super().__init__()
        hidden = int(features * expansion)
        self.cv1 = TrainConvBlock(cin, hidden, 1, 1, cfg, path + "/cv1")
        self.cv2 = TrainConvBlock(hidden, features, 3, 1, cfg, path + "/cv2")
        self.add = shortcut and cin == features
        spec = cfg.quant if self.add else None
        self.residual_q = TrainActQuant.at(spec, path + "/residual_q")
        self.add_q = TrainActQuant.at(spec, path + "/add_q", CALIB_MODES)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.cv2(self.cv1(x))
        if not self.add:
            return out
        if self.residual_q is not None:
            x = self.residual_q(x)
        out = x + out
        return self.add_q(out) if self.add_q is not None else out


class TrainC3k2(nn.Module):
    """Cross-stage-partial block: two 1x1 projections to ``features // 2``,
    ``n`` bottlenecks (expansion 1) on one path, concat, 1x1 out conv.
    ``x2``/``up_x``: the block's input is ``concat([upsample2x?(x), x2])``
    (``cin`` counts both)."""

    def __init__(self, cin: int, features: int, n: int, cfg, path: str,
                 shortcut: bool = True) -> None:
        super().__init__()
        hidden = int(features * 0.5)
        self.n = n
        self.cv1 = TrainConvBlock(cin, hidden, 1, 1, cfg, path + "/cv1")
        for i in range(n):
            self.add_module(f"bottleneck_{i}", TrainBottleneck(
                hidden, hidden, shortcut, 1.0, cfg, f"{path}/bottleneck_{i}"))
        self.cv2 = TrainConvBlock(cin, hidden, 1, 1, cfg, path + "/cv2")
        self.cv3 = TrainConvBlock(2 * hidden, features, 1, 1, cfg,
                                  path + "/cv3")

    def forward(self, x, x2=None, up_x: bool = False):
        if x2 is not None:
            x = torch.cat([_upsample_tensor(x) if up_x else x, x2], dim=-1)
        path1 = self.cv1(x)
        for i in range(self.n):
            path1 = getattr(self, f"bottleneck_{i}")(path1)
        return self.cv3(torch.cat([path1, self.cv2(x)], dim=-1))


class TrainSPPF(nn.Module):
    """Spatial pyramid pooling (fast): 1x1 to half width, three chained
    5x5 stride-1 max-pools (-inf padding), concat, 1x1."""

    def __init__(self, cin: int, features: int, cfg, path: str,
                 pool_size: int = 5) -> None:
        super().__init__()
        hidden = cin // 2
        self.cv1 = TrainConvBlock(cin, hidden, 1, 1, cfg, path + "/cv1")
        self.cv2 = TrainConvBlock(4 * hidden, features, 1, 1, cfg,
                                  path + "/cv2")
        self.k = pool_size

    def forward(self, x):
        x = self.cv1(x)
        ys = [x]
        for _ in range(3):
            y = F.max_pool2d(ys[-1].permute(0, 3, 1, 2), self.k, 1,
                             self.k // 2)
            ys.append(y.permute(0, 2, 3, 1))
        return self.cv2(torch.cat(ys, dim=-1))
