"""The port's data parallelism (``parallel/``) on the CPU: two gloo
processes, each with its rows of one global batch, against one process
with the whole batch and against the JAX package's single-device step.

The small model (base 16, 64^2, float32 compute, the JAX init variables
carried across), a global batch of 4 synthetic scenes (labels padded to
16), fed to both packages as the reference's normalised batch; one SGD
step (lr0 0.01, one warmup step, no EMA), as the reference's
``test_dp_matches_single_device`` runs it.

- 2 processes against 1 (the port), in float32 and in float64 compute
  (tolerances in ``test_dp_step_matches_single_process``): num_fg equal,
  the loss terms, gradient norm, new params and running statistics equal
  up to the order of the sums: the JAX SPMD semantics (global BatchNorm
  statistics, the global loss normaliser, gradients summed over the
  processes). Both processes end with the same state, bit for bit.
- 2 processes against the reference's single device: the loss within
  1e-4 relative, params within rtol 2e-3 / atol 2e-5 (the reference's
  own DP tolerances), the running statistics within 1e-5 (1 + |ref|).
- ``evaluate_model(process_gather=True)``: each process predicts its rows
  of every validation batch, the gathered metrics equal the single
  process's (within 1e-6) on both processes.
- ``fit`` over the two processes (one epoch, float64 compute) against one
  process: the same loss, metrics and params; only rank 0 writes.
- ``initialize_distributed`` through the UNINA_* environment channel;
  without one it is a no-op.
"""
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from unina_yolo_dla_torch.data import dataset as tds
from unina_yolo_dla_torch.data import synthetic as tsyn
from unina_yolo_dla_torch.evaluate import evaluate_model
from unina_yolo_dla_torch.models import detector as tdet
from unina_yolo_dla_torch.models.config import ModelConfig as TCfg
from unina_yolo_dla_torch.parallel import (
    create_mesh,
    initialize_distributed,
    is_main_process,
    make_global_batch,
    make_parallel_eval_step,
    make_parallel_train_step,
    process_count,
    process_index,
    shard_batch,
)
from unina_yolo_dla_torch.train import trainer as ttr
from unina_yolo_dla_torch.train.loop import fit
from unina_yolo_dla_torch.utils.checkpoint import load_msgpack_raw, \
    save_msgpack

SMALL = dict(num_classes=4, base_channels=16, input_size=64)
TC = dict(lr0=0.01, warmup_steps=1, total_steps=10, use_ema=False)
CONF = 0.02   # the model at init scores ~0.01: a few detections an image


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this module runs: the suite runs it
    beside other worker processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port(variables_path, dtype=torch.float32):
    cfg = TCfg(**SMALL, compute_dtype=dtype)
    model = tdet.from_jax_variables(load_msgpack_raw(variables_path), cfg,
                                    "cpu").to(dtype)
    tc = ttr.TrainConfig(**TC)
    tx = ttr.make_optimizer(tc)
    state = ttr.create_train_state(tdet.variables_of(model), tx, tc)
    return model, cfg, tx, tc, state


def _result(state, aux):
    out = {f"aux/{k}": np.asarray(float(v)) for k, v in aux.items()}
    for coll, tree in (("params", state.params),
                       ("batch_stats", state.batch_stats)):
        out.update({f"{coll}/{k}": t.numpy() for k, t in tree.items()})
    return out


def _val(root):
    ds = tds.YoloDataset(tds.load_dataset_yaml(root / "fsd_synth.yaml")[
        "val"], img_size=64, max_boxes=16)
    return ds


def _worker(rank, world, root):
    torch.set_num_threads(2)
    root = Path(root)
    os.environ.update(UNINA_COORDINATOR=f"file://{root / 'store'}",
                      UNINA_NUM_PROCESSES=str(world),
                      UNINA_PROCESS_ID=str(rank))
    assert initialize_distributed(device="cpu")
    assert (process_count(), process_index()) == (world, rank)
    assert is_main_process() == (rank == 0)
    model, cfg, tx, tc, state = _port(root / "variables.msgpack")
    mesh = create_mesh("cpu")
    assert (mesh.world_size, mesh.rank) == (world, rank)
    batch = dict(np.load(root / "batch.npz"))
    step = make_parallel_train_step(ttr.make_train_step(model, cfg, tx, tc),
                                    mesh)
    new, aux = step(state, shard_batch(batch, mesh))
    np.savez(root / f"dp_{rank}.npz", **_result(new, aux))
    m64, cfg64, tx64, tc64, s64 = _port(root / "variables.msgpack",
                                        torch.float64)
    step64 = make_parallel_train_step(
        ttr.make_train_step(m64, cfg64, tx64, tc64), mesh)
    np.savez(root / f"dp64_{rank}.npz",
             **_result(*step64(s64, shard_batch(batch, mesh))))
    # the eval step's aux is the global batch's too
    rows = {k: v[rank * 2:(rank + 1) * 2] for k, v in batch.items()}
    _, eaux = make_parallel_eval_step(
        ttr.make_eval_step(model, cfg, use_ema=False), mesh)(
        new, make_global_batch(rows, "cpu", global_batch_size=4))
    ds = _val(root)

    def val_batches():
        return tds.batch_iterator(ds, 4, np.random.default_rng(0),
                                  shuffle=False, process_slice=(rank, world))

    metrics = evaluate_model(model, tdet.variables_of(model), val_batches,
                             conf_threshold=CONF, process_gather=True)
    np.savez(root / f"eval_{rank}.npz",
             **{f"eval/{k}": np.asarray(float(v)) for k, v in eaux.items()},
             **{f"metric/{k}": np.asarray(v) for k, v in metrics.items()},
             local=np.asarray(evaluate_model.last_local_images))
    res = _fit(root, root / "fit_dp")
    np.savez(root / f"fit_{rank}.npz", **_fit_result(res))
    torch.distributed.destroy_process_group()


def _fit(root, out):
    """One epoch of ``fit`` (float64 compute, no augmentation) over the 8
    training scenes in global batches of 4, validated on the 6 val ones:
    the whole loop, rank 0 writing, when two processes run it."""
    model = _port(root / "variables.msgpack", torch.float64)[0]
    train = tds.YoloDataset(root / "images" / "train", 64, 16)
    return fit(model, tdet.variables_of(model), train, _val(root),
               ttr.TrainConfig(**dict(TC, batch_size=4)), epochs=1,
               output_dir=out, augment=False, seed=5,
               log_fn=lambda *_: None)


def _fit_result(res):
    return {"loss": np.asarray(res.history[0]["loss"]),
            "map50": np.asarray(res.history[0]["map50"]),
            "fitness": np.asarray(res.history[0]["fitness"]),
            **{f"params/{k}": t.numpy() for k, t in res.state.params.items()}}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX init variables, the global batch (normalised by the
    reference), and the reference's single-device step on it."""
    import jax
    import jax.numpy as jnp

    from test_torch_train_step import jax_init, make_batch
    from unina_yolo_dla_tpu.models import ModelConfig as JCfg
    from unina_yolo_dla_tpu.ops.preprocess import ensure_normalized
    from unina_yolo_dla_tpu.train import trainer as jtr

    root = tmp_path_factory.mktemp("dp")
    jcfg = JCfg(**SMALL, compute_dtype=jnp.float32)
    model, variables = jax_init(jcfg)
    save_msgpack(variables, root / "variables.msgpack")
    batch = make_batch([31, 32, 33, 34], 64, 16)
    batch = dict(batch, images=np.asarray(jax.jit(ensure_normalized)(
        batch["images"])))
    np.savez(root / "batch.npz", **batch)
    tsyn.generate_dataset(root, 8, 6, tsyn.SynthConfig(
        image_size=64, seed=4, min_height=6, max_height=24, min_cones=2,
        max_cones=5))
    jtc = jtr.TrainConfig(**TC)
    tx = jtr.make_optimizer(jtc)
    state, aux = jax.jit(jtr.make_train_step(model, jcfg, tx, jtc))(
        jtr.create_train_state(variables, tx, jtc), batch)
    want = {f"aux/{k}": np.asarray(v) for k, v in aux.items()}
    for coll, tree in (("params", state.params),
                       ("batch_stats", state.batch_stats)):
        want.update({f"{coll}/{'.'.join(str(p.key) for p in path)}":
                     np.asarray(v) for path, v in
                     jax.tree_util.tree_flatten_with_path(tree)[0]})
    return root, batch, want


@pytest.fixture(scope="module")
def two_processes(setup):
    root = setup[0]
    mp.spawn(_worker, args=(2, str(root)), nprocs=2, join=True)
    load = lambda name: [dict(np.load(root / f"{name}_{r}.npz"))  # noqa
                         for r in range(2)]
    return load("dp"), load("eval"), load("dp64"), load("fit")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_dp_step_matches_single_process(setup, two_processes, dtype):
    """float32: loss terms within 1e-5 and the gradient norm within 1e-4
    relative (measured 1.5e-6 and 1.9e-5: BatchNorm's train-mode backward
    at init magnifies the order of the statistics' float32 sums), params
    and statistics within 1e-6 (1 + |ref|). float64 compute (the loss
    float32, as the reference keeps it): loss terms within 1e-6, the
    gradient norm within 1e-6, params and statistics within 1e-9."""
    root, batch, _ = setup
    dp = two_processes[0 if dtype == "float32" else 2]
    for k in dp[0]:
        np.testing.assert_array_equal(dp[0][k], dp[1][k], err_msg=k)
    model, cfg, tx, tc, state = _port(root / "variables.msgpack",
                                      getattr(torch, dtype))
    new, aux = ttr.make_train_step(model, cfg, tx, tc)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    single = _result(new, aux)
    assert single.keys() == dp[0].keys()
    assert int(dp[0]["aux/num_fg"]) == int(single["aux/num_fg"]) > 0
    loss_tol, norm_tol, tol = ((1e-5, 1e-4, 1e-6) if dtype == "float32"
                               else (1e-6, 1e-6, 1e-9))
    for k in ("loss", "cls_loss", "box_loss"):
        np.testing.assert_allclose(dp[0][f"aux/{k}"], single[f"aux/{k}"],
                                   rtol=loss_tol)
    np.testing.assert_allclose(dp[0]["aux/grad_norm"],
                               single["aux/grad_norm"], rtol=norm_tol)
    for k, w in single.items():
        if not k.startswith("aux/"):
            assert np.max(np.abs(dp[0][k] - w) / (1 + np.abs(w))) < tol, k


def test_dp_step_matches_reference_single_device(setup, two_processes):
    _, _, want = setup
    got = two_processes[0][0]
    np.testing.assert_allclose(got["aux/loss"], want["aux/loss"], rtol=1e-4)
    assert int(got["aux/num_fg"]) == int(want["aux/num_fg"])
    moved = 0
    for k, w in want.items():
        if k.startswith("params/"):
            np.testing.assert_allclose(got[k], w, rtol=2e-3, atol=2e-5,
                                       err_msg=k)
        elif k.startswith("batch_stats/"):
            assert np.max(np.abs(got[k] - w) / (1 + np.abs(w))) < 1e-5, k
            moved += k.endswith("mean") and bool(np.any(w != 0))
    assert moved > 10


def test_dp_eval_and_gathered_metrics(setup, two_processes):
    root, batch, _ = setup
    ev = two_processes[1]
    for k in ev[0]:
        if k != "local":
            np.testing.assert_array_equal(ev[0][k], ev[1][k], err_msg=k)
    # 6 images in global batches of 4: rank 0 has rows 0-1 of each, rank
    # 1 rows 2-3 (the second batch's are tail padding)
    assert [int(e["local"]) for e in ev] == [4, 2]
    model, cfg, tx, tc, _ = _port(root / "variables.msgpack")
    ds = _val(root)
    want = evaluate_model(model, tdet.variables_of(model),
                          lambda: tds.batch_iterator(
                              ds, 4, np.random.default_rng(0),
                              shuffle=False),
                          conf_threshold=CONF)
    assert want["small_object_fn"] > 0
    for k, w in want.items():
        np.testing.assert_allclose(ev[0][f"metric/{k}"], w, rtol=0,
                                   atol=1e-6, err_msg=k)


def test_single_process_defaults(monkeypatch):
    for name in ("UNINA_COORDINATOR", "UNINA_NUM_PROCESSES",
                 "UNINA_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert initialize_distributed(device="cpu") is False
    assert initialize_distributed("localhost:1", 1, 0, "cpu") is False
    assert (process_count(), process_index(), is_main_process()) == \
        (1, 0, True)
    mesh = create_mesh("cpu")
    assert (mesh.world_size, mesh.rank, mesh.device.type) == (1, 0, "cpu")
    batch = {"a": np.arange(6).reshape(3, 2)}
    np.testing.assert_array_equal(shard_batch(batch, mesh)["a"].numpy(),
                                  batch["a"])
    with pytest.raises(ValueError, match="global batch"):
        make_global_batch(batch, "cpu", global_batch_size=4)


def test_fit_over_two_processes(setup, two_processes):
    """``fit`` in two processes against one: the epoch's loss within 1e-6
    relative, the same validation metrics, the params within 1e-9 (1 +
    |ref|) (float64 compute, the loss float32); both processes end alike,
    and only rank 0 wrote (one history line, one checkpoint)."""
    root = setup[0]
    runs = two_processes[3]
    for k in runs[0]:
        np.testing.assert_array_equal(runs[0][k], runs[1][k], err_msg=k)
    want = _fit_result(_fit(root, root / "fit_single"))
    np.testing.assert_allclose(runs[0]["loss"], want["loss"], rtol=1e-6)
    for k in ("map50", "fitness"):
        np.testing.assert_allclose(runs[0][k], want[k], rtol=0, atol=1e-6)
    for k, w in want.items():
        if k.startswith("params/"):
            assert np.max(np.abs(runs[0][k] - w) / (1 + np.abs(w))) < 1e-9, k
    out = root / "fit_dp"
    assert len((out / "history.jsonl").read_text().splitlines()) == 1
    assert sorted(p.name for p in (out / "weights").iterdir()) == [
        "last_state.json", "last_state.msgpack", "state.json",
        "step_0.msgpack"]
