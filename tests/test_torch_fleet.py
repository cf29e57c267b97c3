"""Fleet serving (``parallel/serving.py``) on the CPU against the
reference's sharded program on its 8-device virtual mesh
(``tests/test_parallel_serving.py``'s setup, with the committed
checkpoint's float model folded in place of the init weights, whose
scores all sit at the class prior: base 32, 64^2, float32, 8 synthetic
scenes, K = 64, conf 0.3).

- The port's fleet over two programs (``["cpu"] * 2``) against the
  reference's ``make_sharded_batch_serving_fn``: ``valid`` and
  ``classes`` equal, valid boxes within 1e-3 (the reference test's own
  tolerance against its single program; the two frameworks' float32 sums
  run in other orders).
- Against the port's own single batch program: bit for bit (each program
  runs the same plain code on its rows).
- No process group is made and a profiler trace of a call holds no
  collective or NCCL event; ``B`` not a multiple of the devices raises.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from unina_yolo_dla_torch.models import config as tconfig
from unina_yolo_dla_torch.models.detector import from_jax_variables
from unina_yolo_dla_torch.parallel import (
    make_sharded_batch_serving_fn as t_fleet,
)
from unina_yolo_dla_torch.parallel import shard_streams as t_shard
from unina_yolo_dla_torch.runtime.pipeline import build_batch_serving_fn
from unina_yolo_dla_torch.utils import annotate, trace
from unina_yolo_dla_torch.utils.checkpoint import load_msgpack_raw
from unina_yolo_dla_tpu.models import ModelConfig
from unina_yolo_dla_tpu.models.detector import UninaYoloDla
from unina_yolo_dla_tpu.parallel import (
    create_mesh,
    make_sharded_batch_serving_fn,
    shard_streams,
)
from unina_yolo_dla_tpu.quant.deploy import fold_batchnorm


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this module runs: the suite runs it
    beside other worker processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


IMG = 64
BOX_ATOL = 1e-3
SOURCE = Path(__file__).resolve().parents[1] / "artifacts" / \
    "engine_source.msgpack"
SERVE = dict(max_detections=64, conf_threshold=0.3)


@pytest.fixture(scope="module")
def setup():
    """The committed checkpoint's float model, folded, in float32, and 8
    synthetic scenes."""
    from unina_yolo_dla_torch.data.synthetic import SynthConfig, \
        generate_image

    cfg = ModelConfig(num_classes=4, base_channels=32, input_size=IMG,
                      compute_dtype=jnp.float32, deploy=True)
    v = load_msgpack_raw(SOURCE)
    v = fold_batchnorm({k: v[k] for k in ("params", "batch_stats")})
    tcfg = tconfig.ModelConfig(num_classes=4, base_channels=32,
                               input_size=IMG, compute_dtype=torch.float32,
                               deploy=True)
    frames = np.stack([np.ascontiguousarray(generate_image(
        np.random.default_rng(s), SynthConfig(
            image_size=IMG, seed=s, min_height=8, max_height=20))[0][..., ::-1])
        for s in range(1, 9)])
    mesh = create_mesh(8)
    sharded = make_sharded_batch_serving_fn(UninaYoloDla(cfg), cfg, mesh,
                                            **SERVE)
    want = jax.device_get(sharded(v, shard_streams(jnp.asarray(frames),
                                                   mesh)))
    port = from_jax_variables(v, tcfg, device="cpu")
    return port, tcfg, frames, want


def test_fleet_matches_reference_sharded_program(setup):
    port, tcfg, frames, want = setup
    got = t_fleet(port, tcfg, ["cpu", "cpu"], **SERVE)(frames)
    assert got.valid.shape == (8, 64)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    v = got.valid.numpy()
    assert v.sum() > 0
    # the valid slots' boxes (an invalid slot's box is left unspecified)
    np.testing.assert_allclose(got.boxes.numpy()[v],
                               np.asarray(want.boxes)[v], rtol=0,
                               atol=BOX_ATOL)


def test_fleet_equals_single_program_and_makes_no_collective(setup,
                                                             tmp_path):
    port, tcfg, frames, _ = setup
    fleet = t_fleet(port, tcfg, ["cpu"] * 2, **SERVE)
    assert len(fleet.programs) == 2
    assert all(p.model is not port for p in fleet.programs)
    shards = t_shard(frames, ["cpu", "cpu"])
    assert [tuple(s.shape) for s in shards] == [(4, IMG, IMG, 3)] * 2
    with trace(tmp_path) as t:
        with annotate("fleet_call"):
            got = fleet(shards)
    single = build_batch_serving_fn(port, tcfg, **SERVE)(
        torch.from_numpy(frames))
    assert all(torch.equal(a, b) for a, b in zip(got, single))
    assert not dist.is_initialized()
    names = [e.name.lower() for e in t.profile.events()]
    assert "fleet_call" in names
    for word in ("nccl", "c10d", "all_reduce", "allreduce", "all_gather",
                 "broadcast", "reduce_scatter"):
        assert not any(word in n for n in names), word
    assert "fleet_call" in t.path.read_text()
    with pytest.raises(ValueError, match="split"):
        fleet(frames[:7])
