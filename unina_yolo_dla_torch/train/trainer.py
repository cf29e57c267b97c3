"""Train state and the train and eval steps (the reference's
``train/trainer.py``): optax's optimiser chain written over tensors,
warmup + cosine schedule, EMA of the parameters, BatchNorm statistics
updated in training mode, and a pure ``(state, batch) -> (state, aux)``
step.

The model is the train form (``models/detector.py``); its variables are
dicts of tensors by module name (``variables_of``), which the step feeds
through ``torch.func.functional_call``. Recipe constants as the
reference's: SGD lr0 0.01, Nesterov momentum 0.937, weight decay 5e-4 on
every parameter, gradient norm clipped at 10, EMA decay 0.9999 with a
ramp; the QAT phase runs lr0 1e-3, ``warmup_steps=1`` and no EMA, with the
calibrated ``quant`` collection frozen in ``extra_variables``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
from torch.func import functional_call

from ..models.config import ModelConfig
from ..models.detector import variables_of
from ..ops.preprocess import ensure_normalized
from .losses import LossConfig, detection_loss

Tensors = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr0: float = 0.01
    lrf: float = 0.01            # final LR fraction (cosine floor)
    momentum: float = 0.937
    weight_decay: float = 5e-4
    warmup_steps: int = 300
    total_steps: int = 10_000
    ema_decay: float = 0.9999
    use_ema: bool = True
    grad_clip_norm: float = 10.0
    batch_size: int = 16
    optimizer: str = "sgd"       # "sgd" | "adamw"


class TrainState(NamedTuple):
    step: int
    params: Tensors
    batch_stats: Tensors
    opt_state: Any
    ema_params: Tensors          # the params themselves without EMA


class Optimizer(NamedTuple):
    """An optax ``GradientTransformation``: ``init(params)`` ->
    state, ``update(grads, state, params)`` -> (updates, state)."""
    init: Callable[[Tensors], Any]
    update: Callable[[Tensors, Any, Tensors], tuple[Tensors, Any]]


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float) -> Callable[[int], float]:
    """optax's schedule of the same name, evaluated in float32: linear
    from ``init_value`` to ``peak_value`` over ``warmup_steps``, then
    cosine to ``end_value`` at ``decay_steps``."""
    f = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if not cos_steps > 0:
        # as optax refuses it (TrainConfig's default 300 warmup steps need
        # total_steps above 300)
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={cos_steps}.")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            c = f(min(max(count, 0), warmup_steps))
            frac = f(1) - c / f(warmup_steps)
            return float(f(init_value - peak_value) * frac + f(peak_value))
        c = f(min(count - warmup_steps, cos_steps))
        cosine = f(0.5) * (f(1) + np.cos(f(math.pi) * c / f(cos_steps)))
        return float(f(peak_value) * (f(1 - alpha) * cosine + f(alpha)))

    return schedule


def global_norm(tree: Tensors) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares (float32)."""
    return torch.sqrt(sum((t * t).sum() for t in tree.values()))


def make_optimizer(tc: TrainConfig) -> Optimizer:
    """``clip_by_global_norm(grad_clip_norm)``, then SGD: decayed weights
    (every leaf) and Nesterov momentum; or AdamW (b1 0.9, b2 0.999, eps
    1e-8, the decay after the Adam scaling); the schedule's rate at the
    count before the step."""
    schedule = warmup_cosine_decay_schedule(
        tc.lr0 * 0.01, tc.lr0, max(tc.warmup_steps, 1),
        max(tc.total_steps, 2), tc.lr0 * tc.lrf)
    adamw = tc.optimizer == "adamw"
    if not adamw and tc.optimizer != "sgd":
        raise ValueError(f"optimizer: 'sgd' or 'adamw', got {tc.optimizer!r}")
    b1, b2, eps, wd, mom = 0.9, 0.999, 1e-8, tc.weight_decay, tc.momentum

    def init(params: Tensors):
        zeros = {k: torch.zeros_like(p) for k, p in params.items()}
        if adamw:
            return {"count": 0, "mu": zeros,
                    "nu": {k: torch.zeros_like(p) for k, p in params.items()}}
        return {"count": 0, "trace": zeros}

    def update(grads: Tensors, state, params: Tensors):
        g_norm = global_norm(grads)
        max_norm = g_norm.new_tensor(tc.grad_clip_norm)
        # optax: where(norm < max, g, g / norm * max), no epsilon
        g = {k: torch.where(g_norm < max_norm, t, t / g_norm * max_norm)
             for k, t in grads.items()}
        count = state["count"]
        lr = schedule(count)
        if adamw:
            mu = {k: (1 - b1) * g[k] + b1 * state["mu"][k] for k in g}
            nu = {k: (1 - b2) * (g[k] * g[k]) + b2 * state["nu"][k]
                  for k in g}
            c1 = float(np.float32(1) - np.float32(b1) ** np.float32(count + 1))
            c2 = float(np.float32(1) - np.float32(b2) ** np.float32(count + 1))
            u = {k: (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
                 for k in g}
            u = {k: u[k] + wd * params[k] for k in g}
            new_state = {"count": count + 1, "mu": mu, "nu": nu}
        else:
            u = {k: g[k] + wd * params[k] for k in g}
            trace = {k: u[k] + mom * state["trace"][k] for k in g}
            u = {k: u[k] + mom * trace[k] for k in g}
            new_state = {"count": count + 1, "trace": trace}
        return {k: -lr * t for k, t in u.items()}, new_state

    return Optimizer(init, update)


def ema_update(ema: Tensors, params: Tensors, step: int, decay: float
               ) -> Tensors:
    """``ema * d + params * (1 - d)``, d = decay (1 - exp(-(step + 1) /
    2000)) in float32: the warmup ramp (Ultralytics ModelEMA) keeps d near
    0 early, so short runs track the live params."""
    f = np.float32
    d = float(f(decay) * (f(1) - np.exp(-f(step + 1) / f(2000.0))))
    return {k: e * d + params[k] * (1.0 - d) for k, e in ema.items()}


def _copy(tree: Tensors) -> Tensors:
    return {k: t.detach().clone() for k, t in tree.items()}


def create_train_state(variables: dict[str, Tensors], tx: Optimizer,
                       tc: TrainConfig) -> TrainState:
    """A state of copies of ``variables``' params and batch statistics."""
    params = _copy(variables["params"])
    return TrainState(step=0, params=params,
                      batch_stats=_copy(variables.get("batch_stats", {})),
                      opt_state=tx.init(params),
                      ema_params=_copy(params) if tc.use_ema else params)


def _model_inputs(model, extra: dict[str, Tensors] | None) -> Tensors:
    """The frozen collections' entries the model reads (a calibrated
    ``quant`` tree holds amaxes of quantisers only the int8 engine has)."""
    own = variables_of(model)
    return {name: t for coll, tree in (extra or {}).items()
            for name, t in tree.items() if name in own.get(coll, {})}


def make_train_step(model, cfg: ModelConfig, tx: Optimizer,
                    tc: TrainConfig, loss_cfg: LossConfig = LossConfig(),
                    grid_sizes=None,
                    extra_variables: dict[str, Tensors] | None = None
                    ) -> Callable[[TrainState, dict[str, torch.Tensor]],
                                  tuple[TrainState, dict[str, Any]]]:
    """A pure ``(state, batch) -> (state, aux)`` step; ``state`` is not
    changed. ``batch``: images (B, H, W, 3) uint8 RGB (normalised on the
    device; float32 taken as normalised), boxes (B, G, 4) xyxy px, labels
    (B, G) int, mask (B, G) bool. ``extra_variables``: frozen collections
    (the calibrated ``quant`` amaxes during QAT). aux: loss, cls_loss,
    box_loss, num_fg and grad_norm (of the raw gradients)."""
    extra = _model_inputs(model, extra_variables)

    def train_step(state: TrainState, batch):
        params = {k: p.detach().requires_grad_() for k, p in
                  state.params.items()}
        stats = _copy(state.batch_stats)    # updated in place by BatchNorm
        model.train()
        outputs = functional_call(model, {**params, **stats, **extra},
                                  (ensure_normalized(batch["images"]),))
        loss, aux = detection_loss(outputs, batch["boxes"], batch["labels"],
                                   batch["mask"], cfg, loss_cfg, grid_sizes)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        with torch.no_grad():
            updates, opt_state = tx.update(grads, state.opt_state,
                                           state.params)
            new_params = {k: state.params[k] + u for k, u in updates.items()}
            new_ema = (ema_update(state.ema_params, new_params, state.step,
                                  tc.ema_decay) if tc.use_ema else new_params)
            aux["grad_norm"] = global_norm(grads)
        return TrainState(state.step + 1, new_params, stats, opt_state,
                          new_ema), aux

    return train_step


def make_eval_step(model, cfg: ModelConfig,
                   loss_cfg: LossConfig = LossConfig(), grid_sizes=None,
                   use_ema: bool = True,
                   extra_variables: dict[str, Tensors] | None = None):
    """``(state, batch) -> (outputs, aux)``: eval mode (running
    statistics), the EMA params by default."""
    extra = _model_inputs(model, extra_variables)

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        params = state.ema_params if use_ema else state.params
        model.eval()
        outputs = functional_call(model, {**params, **state.batch_stats,
                                          **extra},
                                  (ensure_normalized(batch["images"]),))
        _, aux = detection_loss(outputs, batch["boxes"], batch["labels"],
                                batch["mask"], cfg, loss_cfg, grid_sizes)
        return outputs, aux

    return eval_step
