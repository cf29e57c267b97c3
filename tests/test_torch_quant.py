"""Port QTensor ops and the int8 conv vs the reference (CPU)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unina_yolo_dla_torch.models.blocks import ConvBlock, WeightTree
from unina_yolo_dla_torch.quant import qtensor as tq
from unina_yolo_dla_torch.quant.fake_quant import QuantSpec as TSpec
from unina_yolo_dla_torch.quant.fake_quant import int8_conv2d
from unina_yolo_dla_tpu.models.blocks import ConvBlock as JConvBlock
from unina_yolo_dla_tpu.quant import qtensor as jq
from unina_yolo_dla_tpu.quant.fake_quant import QuantSpec as JSpec

# stated tolerance of the requantised int8 output: equal except at most
# 0.1% of the elements off by one (a different f32 rounding before a
# round-half-to-even tie)
MAX_OFF_BY_ONE = 1e-3


def _jq(q, amax):
    return jq.QTensor(jnp.asarray(q), jnp.float32(amax))


def _tq(q, amax):
    return tq.QTensor(torch.from_numpy(np.array(q)), np.float32(amax))


def test_quantize_exact(rng):
    x = rng.normal(0, 2, (2, 8, 8, 16)).astype(np.float32)
    # values on exact rounding ties and past the clip
    x.reshape(-1)[:6] = [0.5, 1.5, -2.5, 100.0, -100.0, 2.5]
    for amax in (np.float32(3.7), np.float32(127.0)):
        want = np.asarray(jq.quantize(jnp.asarray(x), amax).q)
        got = tq.quantize(torch.from_numpy(x), amax).q.numpy()
        np.testing.assert_array_equal(got, want)


def test_requantize_qconcat_qadd_exact(rng):
    a = rng.integers(-127, 128, (1, 6, 6, 8), dtype=np.int8)
    b = rng.integers(-127, 128, (1, 6, 6, 8), dtype=np.int8)
    ja, jb = _jq(a, 2.5), _jq(b, 4.25)
    ta, tb = _tq(a, 2.5), _tq(b, 4.25)
    np.testing.assert_array_equal(tq.requantize(ta, 3.1).q.numpy(),
                                  np.asarray(jq.requantize(ja, 3.1).q))
    jc, tc = jq.qconcat([ja, jb]), tq.qconcat([ta, tb])
    np.testing.assert_array_equal(tc.q.numpy(), np.asarray(jc.q))
    assert tc.amax == np.float32(jc.amax)
    np.testing.assert_array_equal(
        tq.qadd(ta, tb, 5.0).q.numpy(), np.asarray(jq.qadd(ja, jb, 5.0).q))


def test_qmaxpool_and_upsample_exact(rng):
    a = rng.integers(-128, 128, (1, 9, 7, 5), dtype=np.int8)
    np.testing.assert_array_equal(
        tq.qmaxpool(_tq(a, 1.0), 5).q.numpy(),
        np.asarray(jq.qmaxpool(_jq(a, 1.0), 5).q))
    np.testing.assert_array_equal(
        tq.upsample_nearest_2x_q(_tq(a, 1.0)).q.numpy(),
        np.asarray(jq.upsample_nearest_2x_q(_jq(a, 1.0)).q))
    np.testing.assert_array_equal(
        tq.QTensor(torch.from_numpy(a), np.float32(2.0)).dequant(
            torch.float32).numpy(),
        np.asarray(_jq(a, 2.0).dequant(jnp.float32)))


@pytest.mark.parametrize("k,stride,cin,cout", [(3, 1, 16, 24), (3, 2, 32, 16),
                                               (1, 1, 64, 4)])
def test_int8_conv_accumulators_exact(rng, k, stride, cin, cout):
    x = rng.integers(-127, 128, (1, 12, 12, cin), dtype=np.int8)
    w = rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride),
        ((k // 2, k // 2),) * 2, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    n8 = -(-cout // 8) * 8
    w_nk = np.zeros((n8, k * k * cin), np.int8)
    w_nk[:cout] = w.reshape(-1, cout).T
    got = int8_conv2d(torch.from_numpy(x), torch.from_numpy(w_nk), k, k,
                      stride, k // 2)[..., :cout].numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,stride,qt_in", [(3, 1, False), (3, 2, True),
                                            (1, 1, True)])
def test_int8_convblock_requant_matches_reference(rng, k, stride, qt_in):
    """A whole int8 ConvBlock (in_q or QTensor input, int8 conv, dequant +
    bias epilogue, ReLU, out_q requant) against the reference module."""
    cin, cout = 32, 48
    spec = JSpec(mode="int8_fused")
    blk = JConvBlock(cout, k, stride, dtype=jnp.float32, quant=spec,
                     deploy=True)
    fan = k * k * cin
    params = {"conv": {
        "kernel": rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8),
        "w_scale": (np.sqrt(2 / fan) / 73.0
                    * rng.uniform(0.8, 1.2, cout)).astype(np.float32),
        "bias": rng.normal(0, 0.1, cout).astype(np.float32)}}
    quant = {"conv": {"in_q": {"amax": np.float32(3.0)}},
             "out_q": {"amax": np.float32(2.5)}}
    x = np.maximum(rng.normal(0, 1, (1, 20, 20, cin)), 0).astype(np.float32)
    if qt_in:
        xq = np.asarray(jq.quantize(jnp.asarray(x), 3.0).q)
        jin, tin = _jq(xq, 3.0), _tq(xq, 3.0)
    else:
        jin, tin = jnp.asarray(x), torch.from_numpy(x)
    want = blk.apply({"params": params, "quant": quant}, jin)
    tree = WeightTree({"params": {"blk": params}, "quant": {"blk": quant}},
                      TSpec("int8_fused"), torch.float32)
    got = ConvBlock(tree, "blk", k, stride)(tin)
    wq, gq = np.asarray(want.q).astype(int), got.q.numpy().astype(int)
    assert wq.shape == gq.shape
    diff = np.abs(wq - gq)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= MAX_OFF_BY_ONE


def test_quant_spec_paths():
    spec = TSpec("int8_fused", exclude=("backbone/stage2_conv",))
    assert spec.active("backbone/stage2_c3k2/cv1/conv")
    assert not spec.active("backbone/stage2_conv/conv")
    assert not dataclasses.replace(spec, mode="off").active("neck/down2")
    # the train form's modes are ported; the unfused int8 engine is not
    assert TSpec("quantize").qmax == 127.0
    with pytest.raises(ValueError, match="8d"):
        TSpec("int8")
    with pytest.raises(ValueError):
        TSpec("quantise")
