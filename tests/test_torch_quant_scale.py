"""The scale of an amax as the reference's jitted programs compute it
(CPU).

The reference writes ``scale = max(amax, 1e-9) / 127`` (``QTensor.scale``,
``quantize``, ``requantize``, ``qadd``; ``fake_quant_tensor``'s ``amax /
qmax``). Under ``jax.jit``, as the reference serves (its variables are
arguments of the graph) and trains, XLA computes the division by the
constant 127 as ``max(amax, 1e-9) * f32(1 / 127)``, one f32 step from the
IEEE quotient at some amaxes: 9 of the shipped engine's 132, all 18.0 or
21.875. The port takes that form (``quant/qtensor.py scale_of``,
``quant/fake_quant.py fake_quant_tensor``); a quotient of two values
(``requantize``'s ratio, ``v / scale``) stays an IEEE division, as XLA
computes it. Here, with every amax an argument of the jitted graph:
``scale_of`` at the shipped amaxes and a seeded sweep; ``quantize`` on
every finite bf16 value and seeded f32 values with the ties +-amax / 2,
``requantize``, ``qconcat`` and ``qadd`` on every int8 value, and the int8
conv's plain version in its Q and QRES epilogues, at 18.0 and 21.875;
``fake_quant_tensor``'s value and its gradient to ``amax``, per tensor and
per channel; the export's weight scale, which both sides compute in numpy
(an IEEE division). Stated tolerance: exact equality, but for the
gradient to an amax that also flows through ``x / scale``: each element's
share there is a difference of two terms of up to 128 steps, which
autograd and XLA's derivative round to f32 in their own order at any
scale form (one element alone already lands 3e-8 apart), so it is held
within 2^-20 of those terms' size; it is bit for bit where it reaches the
amax through the scale alone (every element clipped).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unina_yolo_dla_torch.ops.cuda import int8_conv_kernel as k8
from unina_yolo_dla_torch.ops.cuda import qconcat_kernel as k12
from unina_yolo_dla_torch.quant import deploy as tdeploy
from unina_yolo_dla_torch.quant import fake_quant as tfq
from unina_yolo_dla_torch.quant import qtensor as tq
from unina_yolo_dla_torch.utils.checkpoint import load_msgpack_raw
from unina_yolo_dla_tpu.models.blocks import Bottleneck as JBottleneck
from unina_yolo_dla_tpu.models.blocks import ConvBlock as JConvBlock
from unina_yolo_dla_tpu.quant import deploy as jdeploy
from unina_yolo_dla_tpu.quant import fake_quant as jfq
from unina_yolo_dla_tpu.quant import qtensor as jq

ARTIFACT = "artifacts/serving_artifact/variables.msgpack"
# the two shipped amaxes whose scale forms differ
AMAXES = (18.0, 21.875)
INT8 = np.arange(-127, 128, dtype=np.int8)


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@jax.jit
def _j_scale(amax):
    return jq.QTensor(jnp.zeros((1,), jnp.int8), amax).scale


def _leaves(tree):
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in _leaves(v)]
    return [np.float32(np.asarray(tree).reshape(-1)[0])]


def _ieee(a):
    return np.maximum(a, np.float32(1e-9)) / np.float32(127)


def test_scale_equals_jitted_reference_at_shipped_amaxes():
    """``scale_of`` at each of the shipped artifact's 132 amax leaves:
    the jitted reference's ``QTensor.scale`` with the amax an argument,
    bit for bit; 9 of them, all 18.0 or 21.875, one f32 step from the
    IEEE quotient."""
    amaxes = np.array(_leaves(load_msgpack_raw(ARTIFACT)["quant"]),
                      np.float32)
    assert amaxes.size == 132
    want = np.asarray(_j_scale(amaxes))
    got = np.array([tq.scale_of(a) for a in amaxes], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    apart = amaxes[_ieee(amaxes) != want]
    assert apart.size == 9 and set(apart.tolist()) == set(AMAXES)


def test_scale_equals_jitted_reference_on_a_sweep():
    """``scale_of`` and ``scale_tensor`` at 100,000 seeded f32 amaxes
    (1e-12 to 1e6, with 0, negatives and the 1e-9 floor): the jitted
    reference's ``jnp.maximum(amax, 1e-9) / QMAX``, bit for bit."""
    rng = np.random.default_rng(24)
    amaxes = (10.0 ** rng.uniform(-12, 6, 100_000)).astype(np.float32)
    amaxes[:6] = [0.0, -1.0, 1e-9, 1e-10, 18.0, 21.875]
    want = np.asarray(jax.jit(lambda a: jnp.maximum(a, 1e-9) / jq.QMAX)(
        amaxes))
    got = np.array([tq.scale_of(a) for a in amaxes], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (_ieee(amaxes) != want).sum() > 1000   # the forms differ often
    for a, s in zip(amaxes[:6], want[:6]):
        assert tq.scale_tensor(a, "cpu").item() == s


@pytest.mark.parametrize("amax", AMAXES)
def test_quantize_equals_jitted_reference(amax):
    """``quantize`` at 18.0 and 21.875 on every finite bf16 value and on
    seeded f32 values with the ties +-amax / 2 and values within a few
    ulps of half steps: the jitted reference's ``quantize`` with the amax
    an argument, bit for bit."""
    fn = jax.jit(lambda x, a: jq.quantize(x, a).q)
    a = np.float32(amax)
    bf = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    bf = bf[np.isfinite(bf)]
    assert {a / 2, -a / 2} <= set(bf.tolist())
    want = np.asarray(fn(jnp.asarray(bf, jnp.bfloat16), a))
    got = tq.quantize(torch.from_numpy(bf).to(torch.bfloat16), a).q.numpy()
    np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(int(amax * 8))
    s = tq.scale_of(a)
    halves = ((rng.integers(-130, 130, 20_000) + 0.5) * s).astype(np.float32)
    f = np.concatenate([[a / 2, -a / 2], halves,
                        np.nextafter(halves, np.float32(np.inf)),
                        rng.normal(0, amax, 20_000).astype(np.float32)])
    want = np.asarray(fn(f, a))
    got = tq.quantize(torch.from_numpy(f), a).q.numpy()
    np.testing.assert_array_equal(got, want)


# (the input's amax, the target's): from and to 18.0 and 21.875
REQUANT_PAIRS = [(18.0, 21.875), (21.875, 18.0), (18.0, 32.25),
                 (7.90625, 21.875), (21.875, 57.25)]


@pytest.mark.parametrize("pair", REQUANT_PAIRS, ids=lambda p: "%g_%g" % p)
def test_requantize_and_qconcat_equal_jitted_reference(pair):
    """``requantize`` of every int8 value from one amax to another, and
    ``qconcat`` (and the concat kernel's plain version) of two parts at
    the two amaxes, with the amaxes arguments of the jitted reference:
    bit for bit."""
    a, t = map(np.float32, pair)
    want = np.asarray(jax.jit(lambda q, a, t: jq.requantize(
        jq.QTensor(q, a), t).q)(INT8, a, t))
    got = tq.requantize(tq.QTensor(torch.from_numpy(INT8), a), t)
    np.testing.assert_array_equal(got.q.numpy(), want)
    assert got.amax == t
    q2 = INT8[::-1].copy()
    jc = jax.jit(lambda x, y, a, t: jq.qconcat(
        [jq.QTensor(x, a), jq.QTensor(y, t)]))(INT8[:, None], q2[:, None],
                                               a, t)
    parts = [tq.QTensor(torch.from_numpy(INT8[:, None]), a),
             tq.QTensor(torch.from_numpy(q2[:, None]), t)]
    for tc in (tq.qconcat(parts), k12.int8_concat([
            tq.QTensor(p.q.reshape(1, 1, -1, 1), p.amax) for p in parts])):
        np.testing.assert_array_equal(tc.q.numpy().reshape(-1, 2),
                                      np.asarray(jc.q))
        assert tc.amax == np.float32(jc.amax)


@pytest.mark.parametrize("amaxes", [(18.0, 21.875, 21.875),
                                    (21.875, 18.0, 18.0),
                                    (18.0, 18.0, 21.875)],
                         ids=lambda a: "%g_%g_%g" % a)
def test_qadd_equals_jitted_reference(amaxes):
    """``qadd`` of every pair of int8 values at 18.0 and 21.875, the
    amaxes arguments of the jitted reference: bit for bit."""
    aa, ab, ao = map(np.float32, amaxes)
    A, B = (m.reshape(-1) for m in np.meshgrid(INT8, INT8, indexing="ij"))
    want = np.asarray(jax.jit(lambda a, b, x, y, o: jq.qadd(
        jq.QTensor(a, x), jq.QTensor(b, y), o).q)(A, B, aa, ab, ao))
    got = tq.qadd(tq.QTensor(torch.from_numpy(A), aa),
                  tq.QTensor(torch.from_numpy(B), ab), ao)
    np.testing.assert_array_equal(got.q.numpy(), want)


def _conv_params(rng, k, cin, cout):
    fan = k * k * cin
    return {"kernel": rng.integers(-127, 128, (k, k, cin, cout),
                                   dtype=np.int8),
            "w_scale": (np.sqrt(2 / fan) / 73.0
                        * rng.uniform(0.8, 1.2, cout)).astype(np.float32),
            "bias": rng.normal(0, 0.1, cout).astype(np.float32)}


def _weights(p):
    k, _, cin, cout = p["kernel"].shape
    n8 = -(-cout // 8) * 8
    w = np.zeros((n8, k * k * cin), np.int8)
    w[:cout] = p["kernel"].reshape(-1, cout).T
    ws, b = np.zeros(n8, np.float32), np.zeros(n8, np.float32)
    ws[:cout], b[:cout] = p["w_scale"], p["bias"]
    return [torch.from_numpy(a) for a in (w, ws, b)]


def _amax(v):
    return {"amax": np.float32(v)}


@pytest.mark.parametrize("epilogue", ["q", "qres"])
def test_int8_conv_plain_equals_jitted_reference(epilogue):
    """The int8 conv's plain version, its Q epilogue (``ConvBlock``: ReLU,
    ``out_q`` at 18.0) and QRES (``Bottleneck``'s ``cv2``: ``out_q`` at
    21.875 on ``cv1``'s output at 18.0, the residual's sum at ``add_q``
    18.0), against the reference's jitted layer with its variables (the
    amaxes among them) arguments of the graph and its input quantised at
    a constant amax in the same graph (as ``tests/test_torch_int8_conv.py``
    holds it): bit for bit; each comb ``w_scale * scale_of(x's amax)``."""
    rng = np.random.default_rng(7 if epilogue == "q" else 8)
    in_amax = np.float32(21.875)
    spec = jfq.QuantSpec(mode="int8_fused")
    xf = np.maximum(rng.normal(0, 9, (1, 9, 11, 32)), 0).astype(np.float32)
    if epilogue == "q":
        p = _conv_params(rng, 3, 32, 32)
        params, quant = {"conv": p}, {"out_q": _amax(18.0)}
        module = JConvBlock(32, 3, 1, dtype=jnp.float32, quant=spec,
                            deploy=True)
    else:
        p1, p2 = _conv_params(rng, 1, 32, 32), _conv_params(rng, 3, 32, 32)
        params = {"cv1": {"conv": p1}, "cv2": {"conv": p2}}
        quant = {"cv1": {"out_q": _amax(18.0)},
                 "cv2": {"out_q": _amax(21.875)}, "add_q": _amax(18.0)}
        module = JBottleneck(32, True, 1.0, dtype=jnp.float32, quant=spec,
                             deploy=True)
    want = jax.jit(lambda v, x: module.apply(v, jq.quantize(x, in_amax)))(
        {"params": params, "quant": quant}, jnp.asarray(xf))
    x = tq.quantize(torch.from_numpy(xf), in_amax)

    def comb(ws, amax):
        return ws * float(tq.scale_of(amax))

    if epilogue == "q":
        w, ws, b = _weights(p)
        got = k8.int8_conv_plain(x.q, w, comb(ws, in_amax), b, 3, 3, 1, 1,
                                 32, np.float32(18.0))
    else:
        w1, ws1, b1 = _weights(p1)
        w2, ws2, b2 = _weights(p2)
        h = k8.int8_conv_plain(x.q, w1, comb(ws1, in_amax), b1, 1, 1, 1, 0,
                               32, np.float32(18.0))
        got = k8.int8_conv_plain(h, w2, comb(ws2, 18.0), b2, 3, 3, 1, 1, 32,
                                 np.float32(21.875), res=x.q,
                                 res_amax=in_amax, add_amax=np.float32(18.0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.q))


def _fake_quant_case(rng, amax, per_channel, clipped):
    """x and the amax (0-d, or one per channel of x's last axis) with the
    ties +-amax / 2 among x; ``clipped``: x one element past each amax."""
    am = (np.array([*AMAXES, 2.0, 3.3, 7.75], np.float32) if per_channel
          else np.float32(amax))
    # clipped: one element an amax, so no sum orders the gradient
    shape = ((1 if clipped else 6, 5) if per_channel
             else (1 if clipped else 40,))
    x = rng.normal(0, 0.5, shape).astype(np.float32) * am
    if clipped:
        x = np.sign(x + 1e-3) * (np.abs(x) + 1.5 * am)
    else:
        x[:2] = [am / 2, -am / 2]
    return x, am


@pytest.mark.parametrize("case", ["tensor", "channel", "tensor_clipped",
                                  "channel_clipped"])
@pytest.mark.parametrize("amax", AMAXES)
def test_fake_quant_tensor_equals_jitted_reference(amax, case):
    """``fake_quant_tensor``'s value (f32 and bf16 x) and its gradient to
    the amax (under a seeded cotangent) against the jitted reference's,
    per tensor and per channel: the value bit for bit; the gradient bit
    for bit where every element is clipped (it reaches the amax through
    the scale alone), elsewhere within 2^-20 of its terms' size (see the
    module's docstring)."""
    per_channel, clipped = case.startswith("channel"), case.endswith("clipped")
    rng = np.random.default_rng(int(amax * 8) + len(case))
    x, am = _fake_quant_case(rng, amax, per_channel, clipped)
    cot = rng.normal(0, 1, x.shape).astype(np.float32)
    fq = jax.jit(lambda x, a: jfq.fake_quant_tensor(x, a, 127.0))
    for dtype in ("float32", "bfloat16"):
        xj = jnp.asarray(x, dtype)
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
            getattr(torch, dtype))
        want = np.asarray(fq(xj, am).astype(jnp.float32))
        got = tfq.fake_quant_tensor(xt, torch.from_numpy(np.asarray(am)),
                                    127.0)
        assert got.dtype == xt.dtype
        np.testing.assert_array_equal(got.float().numpy(), want)
    want_g = np.asarray(jax.jit(jax.grad(lambda a, x, c: jnp.sum(
        jfq.fake_quant_tensor(x, a, 127.0) * c)))(am, x, cot))
    at = torch.tensor(am, requires_grad=True)
    (tfq.fake_quant_tensor(torch.from_numpy(x), at, 127.0)
     * torch.from_numpy(cot)).sum().backward()
    if clipped:
        np.testing.assert_array_equal(at.grad.numpy(), want_g)
    else:
        # each element's share, (round(u) - u) * scale' with u = x / scale,
        # is a difference of two terms of up to 128 that both sides round
        # to f32 in their own order: within a few of their f32 steps
        axis = 0 if per_channel else None
        tol = 2.0 ** -20 * np.sum(np.abs(cot) * 128, axis=axis) / 127
        np.testing.assert_array_less(np.abs(at.grad.numpy() - want_g), tol)


@pytest.mark.parametrize("per_channel", [True, False])
def test_export_weight_scale_is_the_references_numpy(per_channel):
    """The export's int8 weights (``quantize_weights_int8``): numpy on
    both sides, ``max(amax, 1e-9) / qmax`` an IEEE division there, so the
    port's ``w_scale`` and kernels equal the reference's bit for bit, with
    channel maxima at 18.0 and 21.875 among them, and the scale is not
    ``scale_of``'s form where the two differ."""
    rng = np.random.default_rng(3)
    k = rng.normal(0, 4, (3, 3, 8, 6)).astype(np.float32)
    k[0, 0, 0, :2] = AMAXES
    k[1, 1, 1, :2] = [-9.0, 10.9375]   # ties of the two scales
    variables = {"params": {"blk": {"conv": {"kernel": k}}}}
    jspec = jfq.QuantSpec(mode="int8_fused", per_channel_weights=per_channel)
    tspec = tfq.QuantSpec(mode="int8_fused", per_channel_weights=per_channel)
    want = jdeploy.quantize_weights_int8(variables, jspec)
    got = tdeploy.quantize_weights_int8(variables, tspec)
    wc, gc = want["params"]["blk"]["conv"], got["params"]["blk"]["conv"]
    np.testing.assert_array_equal(gc["w_scale"].view(np.int32),
                                  np.asarray(wc["w_scale"]).view(np.int32))
    np.testing.assert_array_equal(gc["kernel"], np.asarray(wc["kernel"]))
    if per_channel:
        np.testing.assert_array_equal(gc["w_scale"][:2],
                                      _ieee(np.array(AMAXES, np.float32)))
        assert all(gc["w_scale"][i] != tq.scale_of(a)
                   for i, a in enumerate(AMAXES))
