"""The port's flax-free msgpack reader against the reference loader."""
from pathlib import Path

import jax
import numpy as np
import pytest

from unina_yolo_dla_torch.utils.checkpoint import load_msgpack_raw
from unina_yolo_dla_tpu.utils.checkpoint import load_msgpack_raw as ref_load

ARTIFACTS = Path(__file__).resolve().parents[1] / "artifacts"


@pytest.mark.parametrize("rel", [
    "serving_artifact/variables.msgpack",
    "serving_artifact_b8/variables.msgpack",
    "serving_artifact_cam/variables.msgpack",
    "int8_engine_vars.msgpack",
    "engine_source.msgpack",
])
def test_every_leaf_equals_reference_loader(rel):
    """Same tree structure, and every leaf equal in dtype, shape and
    value (exact)."""
    path = ARTIFACTS / rel
    got = load_msgpack_raw(path)
    want = ref_load(path)
    got_leaves, got_def = jax.tree_util.tree_flatten_with_path(got)
    want_leaves, want_def = jax.tree_util.tree_flatten_with_path(want)
    assert got_def == want_def
    assert len(got_leaves) > 0
    for (gp, g), (wp, w) in zip(got_leaves, want_leaves):
        assert gp == wp
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype, (gp, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=str(gp))
