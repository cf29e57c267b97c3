"""Full UNINA-YOLO-DLA detector: backbone + FPN/PAN neck + 3 heads, and
the weight carriers to and from the reference's variable tree.

Forward takes the normalised model input, the merged frame (B, S/2, S/4,
24) of an ``s2d_merged`` engine or (B, S, S, 3) of the camera engine and
the train form, and returns ``[(p2_cls, p2_reg), (p3_cls, p3_reg),
(p4_cls, p4_reg)]`` NHWC float32.

A deploy config (``cfg.deploy``) builds the served engine from a folded
weight tree; otherwise the model is the train form, whose state is the
port's *variables*: ``{collection: {name: tensor}}`` with the collections
of the reference (``params``; ``batch_stats``; ``quant`` or
``quant_calib`` in a quantised mode) and the module names of the model
(``backbone.stem.conv.kernel`` for the reference's
``params/backbone/stem/conv/kernel``), as ``torch.func.functional_call``
takes them.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from ..quant.fake_quant import TRAIN_MODES, TrainQuantConv
from ..utils.checkpoint import sorted_tree
from ..utils.device import resolve_device
from .backbone import Backbone, TrainBackbone
from .blocks import WeightTree
from .config import ModelConfig
from .head import DetectionHead, TrainHead
from .neck import Neck, TrainNeck


class UninaYoloDla(nn.Module):
    """YOLOv11-inspired, ReLU-only, P2/P3/P4 anchor-free detector: the
    deploy form from ``tree`` where ``cfg.deploy``, else the train form
    (``tree`` None)."""

    def __init__(self, tree: WeightTree | None, cfg: ModelConfig) -> None:
        super().__init__()
        self.config = cfg
        if not cfg.deploy:
            if tree is not None:
                raise ValueError("the train form is built from its config; "
                                 "load weights with load_variables")
            mode = cfg.quant.mode if cfg.quant is not None else "off"
            if mode not in TRAIN_MODES:
                raise ValueError(f"quant mode {mode!r} is a deploy mode")
            _, c2, c3, c4, _ = cfg.widths
            self.backbone = TrainBackbone(cfg)
            self.neck = TrainNeck(cfg)
            self.head_p2 = TrainHead(c2, cfg, "head_p2")
            self.head_p3 = TrainHead(c3, cfg, "head_p3")
            self.head_p4 = TrainHead(c4, cfg, "head_p4")
            return
        self.backbone = Backbone(tree, cfg)
        self.neck = Neck(tree, cfg)
        self.head_p2 = DetectionHead(tree, cfg, "head_p2")
        self.head_p3 = DetectionHead(tree, cfg, "head_p3")
        self.head_p4 = DetectionHead(tree, cfg, "head_p4")

    def forward(self, x: torch.Tensor):
        feats = self.backbone(x.to(self.config.compute_dtype))
        p2, p3, p4 = self.neck(feats)
        return [self.head_p2(p2), self.head_p3(p3), self.head_p4(p4)]


def create_model(cfg: ModelConfig | None = None, *,
                 generator: torch.Generator | None = None,
                 device=None) -> UninaYoloDla:
    """The train form of ``cfg`` (``ModelConfig()`` by default), its
    kernels drawn lecun-normal from ``generator`` on the CPU (the
    reference's initialisers; its random bits differ), BatchNorm at scale
    1, bias 0, mean 0, var 1, quantiser state 0; on ``device`` (``cuda``
    by default), in training mode."""
    cfg = cfg or ModelConfig()
    if cfg.deploy:
        raise ValueError("a deploy model is built from its weights "
                         "(from_jax_variables)")
    model = UninaYoloDla(None, cfg)
    for m in model.modules():
        if isinstance(m, TrainQuantConv):
            m.reset_parameters(generator)
    return model.to(resolve_device(device))


def init_model(cfg: ModelConfig | None = None, *,
               generator: torch.Generator | None = None, device=None
               ) -> tuple[UninaYoloDla, dict[str, dict[str, torch.Tensor]]]:
    """``create_model`` and its variables (the model's own tensors)."""
    model = create_model(cfg, generator=generator, device=device)
    return model, variables_of(model)


def param_count(variables: dict[str, dict[str, torch.Tensor]]) -> int:
    return sum(int(p.numel()) for p in variables["params"].values())


def variables_of(model: nn.Module) -> dict[str, dict[str, torch.Tensor]]:
    """The train-form model's variables by collection: its parameters
    (``params``) and its buffers under their module's collection
    (``batch_stats``, ``quant``, ``quant_calib``); the model's own
    tensors, not copies."""
    out: dict[str, dict[str, torch.Tensor]] = {
        "params": dict(model.named_parameters())}
    for mod_name, mod in model.named_modules():
        coll = getattr(mod, "collection", None)
        if coll is None:
            continue
        for name, buf in mod.named_buffers(recurse=False):
            out.setdefault(coll, {})[f"{mod_name}.{name}"] = buf
    return out


def model_inputs(model: nn.Module, variables) -> dict[str, torch.Tensor]:
    """The entries of port ``variables`` ({collection: {name: tensor}})
    that the model holds, as ``torch.func.functional_call`` takes them (a
    calibrated ``quant`` collection names quantisers only the int8 engine
    has); None gives none: the model's own tensors."""
    own = variables_of(model)
    return {name: t for coll, tree in (variables or {}).items()
            for name, t in tree.items() if name in own.get(coll, {})}


def to_jax_variables(variables) -> dict[str, Any]:
    """Port variables (or a train-form model's) -> the reference's
    variable tree: nested dicts of numpy arrays in the tensors' dtypes,
    keys sorted at every level as the reference's tree utilities sort
    them. The exact inverse of ``variables_from_jax``."""
    if isinstance(variables, nn.Module):
        variables = variables_of(variables)
    out: dict[str, Any] = {}
    for coll, leaves in variables.items():
        tree: dict[str, Any] = {}
        for name, t in leaves.items():
            *parents, leaf = name.split(".")
            node = tree
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = t.detach().cpu().numpy().copy()
        out[coll] = tree
    return sorted_tree(out)


def variables_from_jax(variables: dict[str, Any], device=None
                           ) -> dict[str, dict[str, torch.Tensor]]:
    """The reference's variable tree (nested dicts of numpy arrays) ->
    port variables on ``device`` (``cuda`` by default), every collection
    and leaf as it is, float32 kept bit for bit."""
    dev = resolve_device(device)
    out: dict[str, dict[str, torch.Tensor]] = {}
    for coll, tree in variables.items():
        if not isinstance(tree, dict):
            continue
        flat: dict[str, torch.Tensor] = {}

        def walk(node, prefix):
            for k, v in node.items():
                name = f"{prefix}.{k}" if prefix else k
                if isinstance(v, dict):
                    walk(v, name)
                else:
                    flat[name] = torch.from_numpy(
                        np.array(v, copy=True)).to(dev)

        walk(tree, "")
        out[coll] = flat
    return out


def load_variables(model: nn.Module,
                   variables: dict[str, dict[str, torch.Tensor]]
                   ) -> nn.Module:
    """Copy port variables into a train-form model: every variable the
    model holds must be there, with its shape; extra entries (a whole
    calibrated ``quant`` collection in a model that reads only some of it)
    are left alone."""
    with torch.no_grad():
        for coll, own in variables_of(model).items():
            given = variables.get(coll, {})
            for name, t in own.items():
                if name not in given:
                    raise KeyError(f"{coll}/{name.replace('.', '/')} missing")
                src = given[name]
                if tuple(src.shape) != tuple(t.shape):
                    raise ValueError(
                        f"{coll}/{name.replace('.', '/')}: shape "
                        f"{tuple(src.shape)}, the model's {tuple(t.shape)}")
                t.copy_(src)
    return model


def from_jax_variables(variables: dict[str, Any], cfg: ModelConfig,
                       device=None) -> UninaYoloDla:
    """The reference's variable tree of numpy arrays -> the port's
    detector on ``device`` (``cuda`` by default; ``"cpu"`` runs the plain
    versions of the kernels), in eval mode.

    Deploy form (``{"params", "quant"}``, folded): int8 kernels stay int8
    (reshaped to the integer product's (N, K)), ``w_scale``, biases and
    ``amax`` stay float32, float kernels take the compute dtype, and the
    merged P2 head weights are built here. Train form (``{"params",
    "batch_stats", ["quant"]}``): every variable the model holds, float32
    bit for bit (``load_variables``)."""
    if not cfg.deploy:
        model = load_variables(UninaYoloDla(None, cfg),
                               variables_from_jax(variables, "cpu"))
        return model.eval().to(resolve_device(device))
    model = UninaYoloDla(WeightTree(variables, cfg.quant, cfg.compute_dtype),
                         cfg).eval()
    return model.to(resolve_device(device))
