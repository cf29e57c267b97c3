"""The int8 conv's plain version and the rebuilt int8 blocks against the
reference's jitted int8 layers (CPU).

``int8_conv_plain`` (the CUDA kernel's plain version, which the port runs
on the CPU) in its three epilogues, F32 (a conv alone; a 4-wide pred padded
to 8), Q (``ConvBlock``: ReLU and the ``out_q`` requant) and QRES
(``Bottleneck``'s ``cv2``: plus the residual sum and its ``add_q``
requant), at the three geometries and odd sizes, against the reference's
``QuantConv`` / ``ConvBlock`` / ``Bottleneck`` under ``jax.jit`` (XLA
contracts the epilogues into FMAs only when it compiles them whole, as the
served engine is compiled; eager ``apply`` rounds them unfused). Stated
tolerance: int8 and f32 outputs equal exactly (the port's float64-emulated
FMA rounds as XLA's FMA but for a double rounding, which these seeds do
not meet). The reference quantises its float input at a constant amax in
the jitted graph, as the engine's layers take int8 made in the same graph
at calibrated constants: where the int8 input or its amax is an argument
of the graph, XLA contracts the residual sum's other product
(``x.q * x.scale``) into the FMA, and 0.5% of the sums land one step
apart. The port's ``QuantConv``, ``ConvBlock`` and ``Bottleneck``, which
now hand the epilogue to the conv, give the bytes of the composition they
ran before (written out here step by step).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unina_yolo_dla_torch.models.blocks import Bottleneck, ConvBlock, \
    WeightTree
from unina_yolo_dla_torch.ops.cuda import int8_conv_kernel as k8
from unina_yolo_dla_torch.quant import qtensor as tq
from unina_yolo_dla_torch.quant.fake_quant import QuantSpec as TSpec
from unina_yolo_dla_torch.quant.fake_quant import int8_conv2d
from unina_yolo_dla_tpu.models.blocks import Bottleneck as JBottleneck
from unina_yolo_dla_tpu.models.blocks import ConvBlock as JConvBlock
from unina_yolo_dla_tpu.quant import qtensor as jq
from unina_yolo_dla_tpu.quant.fake_quant import QuantConv as JQuantConv
from unina_yolo_dla_tpu.quant.fake_quant import QuantSpec as JSpec

SPEC = JSpec(mode="int8_fused")
IN_AMAX = np.float32(3.0)


@functools.partial(jax.jit, static_argnums=0)
def _reference(module, variables, xf):
    """The reference module, jitted, on ``xf`` quantised at the constant
    ``IN_AMAX`` in the same graph (see the module's docstring)."""
    return module.apply(variables, jq.quantize(xf, IN_AMAX))


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _conv_params(rng, k, cin, cout):
    fan = k * k * cin
    return {"kernel": rng.integers(-127, 128, (k, k, cin, cout),
                                   dtype=np.int8),
            "w_scale": (np.sqrt(2 / fan) / 73.0
                        * rng.uniform(0.8, 1.2, cout)).astype(np.float32),
            "bias": rng.normal(0, 0.1, cout).astype(np.float32)}


def _weights(p):
    """The conv as ``QuantConv`` holds it: (N8, k*k*C) int8, f32 scales
    and bias padded to N8."""
    k, _, cin, cout = p["kernel"].shape
    n8 = -(-cout // 8) * 8
    w = np.zeros((n8, k * k * cin), np.int8)
    w[:cout] = p["kernel"].reshape(-1, cout).T
    ws, b = np.zeros(n8, np.float32), np.zeros(n8, np.float32)
    ws[:cout], b[:cout] = p["w_scale"], p["bias"]
    return [torch.from_numpy(a) for a in (w, ws, b)]


# (epilogue, kernel size, stride, batch, H, W, C in, C out)
CASES = {
    "f32_pred_1x1": ("f32", 1, 1, 1, 11, 9, 64, 4),
    "f32_3x3_s1": ("f32", 3, 1, 2, 9, 11, 32, 24),
    "q_3x3_s2": ("q", 3, 2, 1, 11, 11, 64, 32),
    "q_1x1_c48": ("q", 1, 1, 1, 12, 12, 48, 64),
    "q_3x3_s1_c16": ("q", 3, 1, 2, 7, 9, 16, 16),
    "qres_c32": ("qres", 3, 1, 1, 9, 11, 32, 32),
    "qres_c64": ("qres", 3, 1, 2, 12, 12, 64, 64),
}


def _case(name):
    """The epilogue, geometry, int8 input, parameters, quantiser amaxes and
    the reference's output of one case."""
    mode, k, stride, b, h, w, cin, cout = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    xf = np.maximum(rng.normal(0, 1, (b, h, w, cin)), 0).astype(np.float32)
    xq = np.array(jq.quantize(jnp.asarray(xf), IN_AMAX).q)
    if mode == "qres":
        p1, p2 = _conv_params(rng, 1, cin, cin), _conv_params(rng, 3, cin, cin)
        params = {"cv1": {"conv": p1}, "cv2": {"conv": p2}}
        quant = {"cv1": {"out_q": {"amax": np.float32(2.5)}},
                 "cv2": {"out_q": {"amax": np.float32(2.0)}},
                 "add_q": {"amax": np.float32(4.0)}}
        module = JBottleneck(cin, True, 1.0, dtype=jnp.float32, quant=SPEC,
                             deploy=True)
    else:
        p1 = _conv_params(rng, k, cin, cout)
        if mode == "f32":
            params = p1
            quant = {}
            module = JQuantConv(cout, (k, k), (stride, stride), k // 2,
                                use_bias=True, dtype=jnp.float32, quant=SPEC)
        else:
            params = {"conv": p1}
            quant = {"out_q": {"amax": np.float32(2.5)}}
            module = JConvBlock(cout, k, stride, dtype=jnp.float32,
                                quant=SPEC, deploy=True)
    want = _reference(module, {"params": params, "quant": quant},
                      jnp.asarray(xf))
    want = np.asarray(want.q if isinstance(want, jq.QTensor) else want)
    return mode, k, stride, xq, params, quant, want


def _comb(ws, amax):
    return ws * float(tq.scale_of(amax))


@pytest.mark.parametrize("name", list(CASES))
def test_plain_layer_matches_jitted_reference(name):
    """``int8_conv_plain`` in the case's epilogue against the reference's
    jitted layer: exactly equal."""
    mode, k, stride, xq, params, quant, want = _case(name)
    x = torch.from_numpy(xq)
    if mode == "qres":
        w1, ws1, b1 = _weights(params["cv1"]["conv"])
        w2, ws2, b2 = _weights(params["cv2"]["conv"])
        a1 = quant["cv1"]["out_q"]["amax"]
        h = k8.int8_conv_plain(x, w1, _comb(ws1, IN_AMAX), b1, 1, 1, 1, 0,
                               w1.shape[0], a1)
        got = k8.int8_conv_plain(
            h, w2, _comb(ws2, a1), b2, 3, 3, 1, 1, w2.shape[0],
            quant["cv2"]["out_q"]["amax"], res=x, res_amax=IN_AMAX,
            add_amax=quant["add_q"]["amax"])
        assert got.dtype == torch.int8
    else:
        p = params if mode == "f32" else params["conv"]
        w, ws, b = _weights(p)
        cout = p["kernel"].shape[-1]
        got = k8.int8_conv_plain(
            x, w, _comb(ws, IN_AMAX), b, k, k, stride, k // 2, cout,
            None if mode == "f32" else quant["out_q"]["amax"])
        assert got.dtype == (torch.float32 if mode == "f32" else torch.int8)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _old_composition(x: tq.QTensor, p, k, stride, out_amax=None):
    """The int8 layer as the port composed it before the epilogue moved
    into the conv: im2col + integer product, the f32 FMA, ReLU, requant."""
    w, ws, b = _weights(p)
    cout = p["kernel"].shape[-1]
    acc = int8_conv2d(x.q, w, k, k, stride, k // 2)
    y = tq.fma_f32(acc.float(), ws * float(x.scale), b)[..., :cout]
    if out_amax is None:
        return y
    return tq.quantize(torch.relu(y), out_amax)


@pytest.mark.parametrize("name", list(CASES))
def test_rebuilt_blocks_give_the_same_bytes(name):
    """The port's int8 ``QuantConv`` (F32), ``ConvBlock`` (Q) and
    ``Bottleneck`` (QRES) on the CPU: the bytes of the old composition and
    of the reference's jitted layer."""
    mode, k, stride, xq, params, quant, want = _case(name)
    x = tq.QTensor(torch.from_numpy(xq), IN_AMAX)
    tree = WeightTree({"params": {"blk": params}, "quant": {"blk": quant}},
                      TSpec("int8_fused"), torch.float32)
    if mode == "f32":
        conv = tree.conv("blk", stride, k // 2)
        got = conv(x)
        old = _old_composition(x, params, k, stride)
        assert conv.out_amax is None and got.dtype == torch.float32
    elif mode == "q":
        blk = ConvBlock(tree, "blk", k, stride)
        assert blk.requant_in_conv and blk.conv.out_amax == quant["out_q"]["amax"]
        got = blk(x).q
        old = _old_composition(x, params["conv"], k, stride,
                               quant["out_q"]["amax"]).q
    else:
        blk = Bottleneck(tree, "blk", True)
        assert blk.cv2.requant_in_conv
        got = blk(x).q
        h = _old_composition(x, params["cv1"]["conv"], 1, 1,
                             quant["cv1"]["out_q"]["amax"])
        out = _old_composition(h, params["cv2"]["conv"], 3, 1,
                               quant["cv2"]["out_q"]["amax"])
        s = tq.fma_f32(out.q.float(), float(out.scale),
                       x.q.float() * float(x.scale))
        old = tq.quantize(s, quant["add_q"]["amax"]).q
    assert k8.KERNEL.launches == 0   # the CPU path never launches it
    assert got.dtype == old.dtype and got.shape == old.shape
    assert torch.equal(got, old)
    np.testing.assert_array_equal(got.numpy(), want)


def test_comb_kept_per_input_scale():
    """``comb`` is computed once for each input amax, as the f32 product
    the layer computed on every call before; moving the module drops it."""
    rng = np.random.default_rng(3)
    p = _conv_params(rng, 1, 32, 16)
    conv = WeightTree({"params": {"c": p}, "quant": {}}, TSpec("int8_fused"),
                      torch.float32).conv("c")
    xq = torch.from_numpy(rng.integers(-127, 128, (1, 5, 5, 32),
                                       dtype=np.int8))
    for amax in (IN_AMAX, np.float32(1.7), IN_AMAX):
        conv(tq.QTensor(xq, amax))
    assert sorted(conv._combs) == sorted(
        float(tq.scale_of(a)) for a in (IN_AMAX, np.float32(1.7)))
    kept = conv._combs[float(tq.scale_of(IN_AMAX))]
    assert torch.equal(kept, conv.w_scale * float(tq.scale_of(IN_AMAX)))
    assert conv._comb(tq.scale_of(IN_AMAX)) is kept
    conv.to(torch.float32)
    assert conv._combs == {}


@pytest.mark.parametrize("kh,kw,stride,padding,c,n,takes", [
    (1, 1, 1, 0, 64, 8, True), (3, 3, 1, 1, 32, 32, True),
    (3, 3, 2, 1, 128, 256, True), (3, 3, 1, 1, 16, 16, True),
    (3, 3, 1, ((1, 1), (1, 1)), 64, 64, True),
    (3, 3, 1, ((1, 0), (1, 0)), 64, 64, False), (1, 1, 2, 0, 64, 64, False),
    (3, 3, 1, 1, 24, 64, False), (3, 3, 1, 1, 64, 12, False),
    (2, 2, 1, 1, 64, 64, False)])
def test_kernel_takes(kh, kw, stride, padding, c, n, takes):
    """The geometries and widths the CUDA kernel is compiled for: 1x1 s1,
    3x3 s1 and s2 at padding k // 2, C % 16 == 0, N % 8 == 0."""
    assert k8.kernel_takes(kh, kw, stride, padding, c, n) is takes


# ---- the CUDA kernel's plans (pure Python: what each block computes) ----

# (kernel, stride, H, W, C, N): the shipped frame's 18 int8 layer shapes,
# the card tests' odd ones, and the unfused int8 engine's 160 x 160 layers
PLAN_SHAPES = [
    *(shape[:6] for shape in k8.SHIPPED_LAYERS),
    (3, 1, 13, 7, 32, 32), (3, 2, 17, 11, 16, 24), (1, 1, 9, 5, 48, 40),
    (3, 1, 21, 19, 32, 8), (3, 2, 160, 160, 64, 128),
    (1, 1, 160, 160, 32, 32), (3, 1, 11, 13, 96, 72),
    (1, 1, 160, 160, 64, 32), (1, 1, 160, 160, 64, 64),
    (1, 1, 160, 160, 128, 32), (3, 1, 160, 160, 32, 32),
    (3, 2, 160, 160, 64, 64),
]


def _blocks(p, bsz, h, w, c, k, stride):
    """What each block of plan ``p``'s grid computes, as the kernel
    (``csrc/int8_conv.cu``) decodes its block index: (image, first output
    row, first output column, first channel, the K steps of each consumer
    warpgroup). K step s is tap s // chunks at channels (s % chunks) * kc
    .. + kc."""
    ho, wo = k8.out_size(h, w, k, stride)
    tiles_w = -(-wo // k8.TILE[1])
    tiles_img = tiles_w * -(-ho // k8.TILE[0])
    steps = k * k * -(-c // p["kc"])
    for by in range(p["grid"][1]):
        for bx in range(p["grid"][0]):
            img, pt = divmod(bx, tiles_img)
            yield (img, pt // tiles_w * k8.TILE[0], pt % tiles_w * k8.TILE[1],
                   by * p["bn"], [list(range(g, steps, 2)) for g in (0, 1)])


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_covers_every_output_and_k_step_once(shape, batch):
    """The plan of each layer shape: its blocks' 8 x 8 patches cover every
    output pixel once and its N tiles every channel once; each tile's K
    steps, split across the two warpgroups, are every (tap, channel chunk)
    once, and the chunks cover every channel; the shared memory fits the
    H100's 227 KB (and two blocks an SM where the grid is larger than the
    card)."""
    k, s, h, w, c, n = shape
    p = k8.plan(batch, h, w, c, n, k, s)
    k8.check_plan(p, c, n, k)
    assert p["smem_bytes"] == k8.smem_bytes(p["bn"], p["kc"],
                                            p["stages"]) <= 232448
    if p["grid"][0] * p["grid"][1] > 132:
        assert 2 * (p["smem_bytes"] + 1024) <= 228 * 1024
    ho, wo = k8.out_size(h, w, k, s)
    cover = np.zeros((batch, ho, wo, p["grid"][1] * p["bn"]), np.int32)
    kdone = {}
    for img, r0, c0, n0, wg_steps in _blocks(p, batch, h, w, c, k, s):
        cover[img, r0:r0 + 8, c0:c0 + 8, n0:n0 + p["bn"]] += 1
        kdone.setdefault((img, r0, c0, n0), []).extend(
            wg_steps[0] + wg_steps[1])
    # each output pixel and channel in one block's tile
    assert cover[..., :n].min() == cover.max() == 1
    assert p["grid"][1] * p["bn"] - n < p["bn"]
    steps = k * k * -(-c // p["kc"])
    chunks = steps // (k * k)
    assert (chunks - 1) * p["kc"] < c <= chunks * p["kc"]
    for done in kdone.values():
        assert sorted(done) == list(range(steps))
        assert {(st // chunks, st % chunks) for st in done} == {
            (t, ch) for t in range(k * k) for ch in range(chunks)}
