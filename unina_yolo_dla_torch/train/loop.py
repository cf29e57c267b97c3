"""The fit loop: epochs, per-epoch validation, checkpoints, resume and data
parallelism, the port's counterpart of the reference's ``train/loop.py``.

An epoch runs the batch iterator (in a background thread, numpy only)
through the train step on the model's device, then validates (mAP and
small-object metrics, ``evaluate.evaluate_model``), keeps the best
checkpoint by the Ultralytics fitness (0.1 mAP50 + 0.9 mAP50-95), writes
the full training state for ``--resume`` and appends the epoch's metrics to
``history.jsonl``. With several processes (``parallel.initialize_
distributed``) each loads and steps on its rows of every global batch, the
step reduces over them (``parallel/dp.py``), validation is sharded and
gathered, and only rank 0 writes.
"""
from __future__ import annotations

import dataclasses
import json
import queue
import threading
import time
from pathlib import Path
from typing import Any, Callable, Iterator

import numpy as np
import torch

from ..data.dataset import YoloDataset, batch_iterator, load_difficulty_weights
from ..evaluate import evaluate_model, model_device
from ..models.config import ModelConfig
from ..models.detector import to_jax_variables, variables_from_jax
from ..parallel import create_mesh, make_parallel_train_step
from ..parallel.distributed import is_main_process, make_global_batch, \
    process_count
from ..utils.checkpoint import CheckpointManager, load_msgpack_raw, \
    save_msgpack
from .losses import LossConfig
from .trainer import (
    TrainConfig,
    TrainState,
    create_train_state,
    make_optimizer,
    make_train_step,
)


def prefetch(batches: Iterator, depth: int = 2) -> Iterator:
    """Run the (CPU-bound) batch pipeline in a background thread, ``depth``
    batches ahead, so loading and augmentation overlap the device's work.
    The thread makes numpy batches only; the caller moves them to the
    device."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()

    def worker():
        try:
            for b in batches:
                q.put(b)
            q.put(sentinel)
        except BaseException as e:  # propagate into the consumer thread
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def fitness(metrics: dict[str, float]) -> float:
    """Ultralytics fitness: 0.1*mAP50 + 0.9*mAP50-95."""
    return 0.1 * metrics.get("map50", 0.0) + 0.9 * metrics.get("map50_95", 0.0)


@dataclasses.dataclass
class FitResult:
    state: TrainState
    best_variables: dict[str, Any]   # port variables on the device
    metrics: dict[str, float]
    history: list[dict[str, float]]


def _state_tree(state: TrainState) -> dict[str, Any]:
    """The full training state as a tree of numpy arrays (JAX layout per
    variable collection), for ``last_state.msgpack``."""
    opt = {k: (np.int64(v) if k == "count" else to_jax_variables({"t": v})["t"])
           for k, v in state.opt_state.items()}
    return {"step": np.int64(state.step),
            "params": to_jax_variables({"t": state.params})["t"],
            "batch_stats": to_jax_variables({"t": state.batch_stats})["t"],
            "opt_state": opt,
            "ema_params": to_jax_variables({"t": state.ema_params})["t"]}


def _in_order(tree: dict[str, torch.Tensor], like: dict[str, Any]
              ) -> dict[str, torch.Tensor]:
    """``tree``'s entries in ``like``'s order (sums over the leaves, such
    as the gradient norm, run in dict order)."""
    return {k: tree[k] for k in like}


def _state_from_tree(tree: dict[str, Any], like: TrainState,
                     tc: TrainConfig, device) -> TrainState:
    """The inverse of ``_state_tree``, every dict in ``like``'s order."""
    def port(t, order):
        return _in_order(variables_from_jax({"t": t}, device).get("t", {}),
                         order)

    params = port(tree["params"], like.params)
    opt = {k: (int(tree["opt_state"][k]) if k == "count"
               else port(tree["opt_state"][k], v))
           for k, v in like.opt_state.items()}
    return TrainState(step=int(tree["step"]), params=params,
                      batch_stats=port(tree["batch_stats"],
                                       like.batch_stats),
                      opt_state=opt,
                      ema_params=port(tree["ema_params"], like.ema_params)
                      if tc.use_ema else params)


def _clone(variables: dict[str, Any]) -> dict[str, Any]:
    return {c: {k: t.detach().clone() for k, t in tree.items()}
            for c, tree in variables.items()}


def fit(
    model,
    variables: dict[str, Any],
    train_ds: YoloDataset,
    val_ds: YoloDataset | None,
    tc: TrainConfig,
    epochs: int,
    output_dir: str | Path,
    loss_cfg: LossConfig = LossConfig(),
    difficulty_map: str | dict | None = None,
    augment: bool = True,
    mosaic_p: float = 0.0,
    mixup_p: float = 0.0,
    copy_paste=None,
    corruption_p: float = 0.0,
    n_devices: int | None = None,
    extra_variables: dict[str, Any] | None = None,
    seed: int = 0,
    resume: bool = False,
    log_fn: Callable[[str], None] = print,
) -> FitResult:
    """Train ``model`` (the train form, on its device) from port
    ``variables`` for ``epochs`` over ``train_ds``; returns the best
    variables (port variables on the device) and the history.

    ``extra_variables`` carries the frozen ``quant`` collection of the QAT
    phase. ``resume=True`` restores the full training state (step, params,
    batch statistics, optimiser state, EMA, and the data RNG's position)
    from ``<output_dir>/weights/last_state.msgpack`` and ``last_state.json``:
    a resumed run is bit for bit one that never stopped.

    Several processes (``torch.distributed`` initialised): ``tc.batch_size``
    is the GLOBAL batch, each process loads its rows of it and steps on its
    own device, and only rank 0 writes (``output_dir`` must be shared for
    ``--resume`` to see rank 0's state). ``n_devices`` is the reference's
    device count; here a process drives one device, so it must be None or
    the number of processes."""
    cfg: ModelConfig = model.config
    output_dir = Path(output_dir)
    ckpts = CheckpointManager(output_dir / "weights")
    device = model_device(model)

    pcount = process_count()
    main = is_main_process()
    if n_devices not in (None, pcount):
        raise ValueError(f"{n_devices} devices asked for, {pcount} "
                         "processes running: the port drives one device a "
                         "process (launch one process per device)")

    steps_per_epoch = max(len(train_ds) // tc.batch_size, 1)
    tc = dataclasses.replace(
        tc, total_steps=max(tc.total_steps, steps_per_epoch * epochs))
    tx = make_optimizer(tc)
    state = create_train_state(variables, tx, tc)
    step_fn = make_train_step(model, cfg, tx, tc, loss_cfg,
                              extra_variables=extra_variables)
    if pcount > 1:
        p_step = make_parallel_train_step(step_fn, create_mesh(device))
        process_slice = (torch.distributed.get_rank(), pcount)
    else:
        p_step, process_slice = step_fn, None

    weights = load_difficulty_weights(train_ds, difficulty_map) \
        if difficulty_map is not None else None
    rng = np.random.default_rng(seed)

    def eval_variables(st: TrainState) -> dict[str, Any]:
        return {"params": st.ema_params if tc.use_ema else st.params,
                "batch_stats": st.batch_stats, **(extra_variables or {})}

    history: list[dict[str, float]] = []
    best_fit = -1.0
    best_variables = _clone(variables)
    start_epoch = 0

    resume_path = output_dir / "weights" / "last_state.msgpack"
    resume_meta_path = output_dir / "weights" / "last_state.json"
    if resume and resume_path.exists():
        state = _state_from_tree(load_msgpack_raw(resume_path), state, tc,
                                 device)
        meta = json.loads(resume_meta_path.read_text())
        start_epoch = int(meta["epoch"]) + 1
        best_fit = float(meta["best_fit"])
        rng.bit_generator.state = meta["rng_state"]
        try:
            like = eval_variables(state)
            best = variables_from_jax(
                ckpts.load_best(to_jax_variables(like)), device)
            best_variables = {c: _in_order(best[c], like[c]) for c in like}
        except FileNotFoundError:
            pass
        log_fn(f"resumed from epoch {start_epoch - 1} "
               f"(step={state.step}, best_fit={best_fit:.4f})")
    elif resume:
        log_fn(f"--resume requested but {resume_path} not found; "
               "starting fresh")

    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        losses = []
        for batch in prefetch(batch_iterator(
                train_ds, tc.batch_size, rng,
                steps=steps_per_epoch, weights=weights,
                augment=augment, mosaic_p=mosaic_p,
                mixup_p=mixup_p,
                copy_paste=copy_paste,
                corruption_p=corruption_p,
                process_slice=process_slice)):
            batch.pop("sample_valid", None)
            batch.pop("indices", None)
            state, aux = p_step(state, make_global_batch(batch, device))
            losses.append(aux["loss"])

        mean_loss = float(np.mean([float(v) for v in losses]))
        train_s = time.time() - t0
        epoch_metrics: dict[str, float] = {"loss": mean_loss, "epoch": epoch}

        eval_vars = eval_variables(state)
        t1 = time.time()
        if val_ds is not None and len(val_ds) > 0:
            if pcount > 1:
                # every process predicts its rows of each (deterministic)
                # val batch; the records are gathered, so every process
                # computes the same metrics and the best decision stays in
                # lockstep
                val_bs = max(pcount,
                             min(tc.batch_size, len(val_ds))
                             // pcount * pcount)

                def val_batches():
                    return prefetch(batch_iterator(
                        val_ds, val_bs, np.random.default_rng(0),
                        shuffle=False, augment=False,
                        process_slice=process_slice))

                val_metrics = evaluate_model(model, eval_vars, val_batches,
                                             process_gather=True)
            else:
                def val_batches():
                    return prefetch(batch_iterator(
                        val_ds, min(tc.batch_size, len(val_ds)),
                        np.random.default_rng(0),
                        shuffle=False, augment=False))

                val_metrics = evaluate_model(model, eval_vars, val_batches)
            epoch_metrics.update(val_metrics)
            fit_val = fitness(val_metrics)
        else:
            fit_val = -mean_loss  # fall back to loss when no val set

        epoch_metrics["fitness"] = fit_val
        epoch_metrics["time_s"] = time.time() - t0
        epoch_metrics["train_s"] = train_s
        epoch_metrics["eval_s"] = time.time() - t1
        history.append(epoch_metrics)
        if main:
            log_fn(
                f"epoch {epoch}: loss={mean_loss:.4f} fitness={fit_val:.4f} "
                f"map50={epoch_metrics.get('map50', float('nan')):.4f} "
                f"small_f1={epoch_metrics.get('small_object_f1', float('nan')):.4f} "
                f"({epoch_metrics['time_s']:.1f}s)")

        save_vars = to_jax_variables(eval_vars)
        if main:
            ckpts.save(epoch, save_vars, fitness=fit_val)
        if fit_val > best_fit:
            best_fit = fit_val
            best_variables = _clone(eval_vars)

        if main:
            # the full state for --resume, with the data RNG's position
            save_msgpack(_state_tree(state), resume_path)
            resume_meta_path.write_text(json.dumps({
                "epoch": epoch,
                "best_fit": best_fit,
                "rng_state": rng.bit_generator.state,
            }))
            # append-only metrics log (results.csv analogue)
            with open(output_dir / "history.jsonl", "a") as f:
                f.write(json.dumps(
                    {k: (float(v) if isinstance(v, (int, float)) else v)
                     for k, v in epoch_metrics.items()
                     if not isinstance(v, (list, dict))}) + "\n")

    return FitResult(state=state, best_variables=best_variables,
                     metrics=history[-1] if history else {},
                     history=history)
