"""The int8 chain's glue kernels' plain versions and the blocks routed
through them against the reference's jitted functions (CPU).

Kernel 11 (``ops/cuda/sppf_kernel.py``): SPPF's three chained int8
max-pools and their concat; its plain version against ``jq.qmaxpool``
three times and ``jq.qconcat``, at sizes below and above the 13-pixel
reach of the third pool (every clipped window) and odd channel counts.
Kernel 12 (``ops/cuda/qconcat_kernel.py``): an int8 concat whose parts are
copied, requantised or quantised; its plain versions in each mode (COPY,
REQ, REQ of an upsampled part, Q of bf16 and f32 parts, Q with a
dequantised int8 part, upsampled float parts) against the reference's
``qconcat``, ``upsample_nearest_2x(_q)``, ``concat_features`` and
``quantize``. The routed ``SPPF`` and ``C3k2`` (``x2`` / ``up_x``, an
int8 block fed bf16 or a mixed pair, one shared quantise or two) give the
bytes of the composition they ran before, written out step by step, and
of the reference's jitted block. Stated tolerance: exact equality.

Every amax of kernel 12's cases is a constant of the jitted graph, as
the engine's are (``tests/test_torch_int8_conv.py``), but where a case
quantises a float32 part: XLA multiplies such a part by the f32
reciprocal of a constant scale, where the port divides (ROADMAP Queue C,
"Multiply versus divide"), and f32 values at half-step ties land one
int8 step apart; those cases pass the amax as an argument of the graph,
where the reference divides. The engine quantises bf16, which takes no
such tie at its amaxes: at each of the nine shipped sites, every int8
value of each int8 part and every finite bf16 value of each float part
give the reference's bytes with the site's amaxes constants of the
graph. XLA also computes a scale ``amax / 127`` as ``amax * f32(1 /
127)``, one f32 step from the port's IEEE quotient (``scale_of``) at 9 of
the shipped engine's 132 amaxes, all 18.0 or 21.875 (ROADMAP Queue C,
"Scale of an amax"): no shipped site of kernel 12 has one as a part's or
its output's scale but the REQ part at 21.875 of ``stage3_c3k2``, whose
every value the site's case holds; a quantise at either amax gives
another int8 than the reference's at the bf16 values +-amax / 2, which
``test_quantize_where_xla_scale_differs`` pins.
The blocks' bottlenecks add no
residual: XLA contracts the residual sum into an FMA differently where
its input's amax is an argument, which ``tests/test_torch_int8_conv.py``
holds, and which these blocks do not route.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unina_yolo_dla_torch.models.blocks import C3k2, SPPF, WeightTree
from unina_yolo_dla_torch.ops.cuda import qconcat_kernel as k12
from unina_yolo_dla_torch.ops.cuda import sppf_kernel as k11
from unina_yolo_dla_torch.quant import qtensor as tq
from unina_yolo_dla_torch.quant.fake_quant import QuantSpec as TSpec
from unina_yolo_dla_tpu.models.blocks import C3k2 as JC3k2
from unina_yolo_dla_tpu.models.blocks import SPPF as JSPPF
from unina_yolo_dla_tpu.models.blocks import concat_features as j_concat
from unina_yolo_dla_tpu.models.blocks import upsample_nearest_2x as j_up
from unina_yolo_dla_tpu.quant import qtensor as jq
from unina_yolo_dla_tpu.quant.fake_quant import QuantSpec as JSpec

SPEC = JSpec(mode="int8_fused")


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _int8(rng, shape, lo=-127):
    """int8 values from ``lo``: -127 is the least that the chain's int8
    producers (every quantise and requant clips to +-127, and a max-pool
    keeps its inputs) emit; a COPY part keeps its bytes, where the
    reference's rescale by 1 would clip a -128."""
    return rng.integers(lo, 128, shape, dtype=np.int8)


# ---- kernel 11: SPPF's pools and their concat ----

@functools.partial(jax.jit, static_argnums=1)
def _j_sppf(q, amax):
    x = jq.QTensor(q, jnp.float32(amax))
    y1 = jq.qmaxpool(x, 5)
    y2 = jq.qmaxpool(y1, 5)
    y3 = jq.qmaxpool(y2, 5)
    out = jq.qconcat([x, y1, y2, y3])
    return out.q, out.amax


@pytest.mark.parametrize("shape", [(1, 7, 9, 5), (2, 17, 14, 3),
                                   (1, 11, 19, 16)])
def test_sppf_plain_matches_jitted_reference(shape):
    """``int8_sppf_plain`` against the reference's three chained
    ``qmaxpool``s and ``qconcat`` (no rescale: one amax): exactly equal,
    the amax kept."""
    rng = np.random.default_rng(sum(shape))
    q = _int8(rng, shape, -128)   # the padding's value inside the image
    amax = np.float32(20.375)
    want_q, want_a = _j_sppf(jnp.asarray(q), float(amax))
    got = k11.int8_sppf(tq.QTensor(torch.from_numpy(q), amax))
    assert got.q.shape == (*shape[:3], 4 * shape[3])
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want_q))
    assert got.amax == np.float32(want_a) == amax
    assert k11.KERNEL.launches == 0   # the CPU path never launches it


# ---- kernel 12: the concat's modes ----

def _j_qt(q, amax):
    return jq.QTensor(q, jnp.float32(amax))


# name -> (parts, the output's amax or None for qconcat's rule); a part
# (kind, shape, amax, up): "s8" an int8 part, "bf16" / "f32" a float one
CONCAT_CASES = {
    "copy_req": ([("s8", (2, 5, 7, 16), 3.0, False),
                  ("s8", (2, 5, 7, 13), 1.75, False),
                  ("s8", (2, 5, 7, 21), 3.0, False)], None),
    "req_shrink_clip": ([("s8", (1, 6, 4, 8), 0.5, False),
                         ("s8", (1, 6, 4, 8), 57.25, False)], None),
    "req_up": ([("s8", (1, 3, 5, 24), 7.90625, True),
                ("s8", (1, 6, 10, 17), 28.125, False)], None),
    "q_bf16": ([("bf16", (1, 5, 6, 19), None, False)], 27.125),
    "q_bf16_f32": ([("bf16", (2, 4, 5, 8), None, False),
                    ("f32", (2, 4, 5, 11), None, False)], 2.5),
    "q_deq": ([("bf16", (1, 6, 6, 16), None, False),
               ("s8", (1, 6, 6, 32), 23.875, False)], 23.875),
    "q_deq_other_amax": ([("s8", (1, 5, 3, 7), 12.625, False),
                          ("bf16", (1, 5, 3, 9), None, False)], 16.875),
    "q_up": ([("bf16", (1, 3, 4, 16), None, True),
              ("bf16", (1, 6, 8, 16), None, False)], 27.25),
    "q_deq_up": ([("s8", (1, 2, 3, 16), 7.8125, True),
                  ("f32", (1, 4, 6, 5), None, False)], 9.5),
}


def _concat_inputs(name):
    parts, amax = CONCAT_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    arrays = []
    for kind, shape, a, _ in parts:
        if kind == "s8":
            arrays.append(_int8(rng, shape))
        else:
            # activations of the scale of the amax, some past it, and
            # values within a few ulps of every half-step tie
            s = tq.scale_of(amax)
            v = rng.normal(0, amax / 2, shape).astype(np.float32)
            ties = ((rng.integers(-260, 260, shape) + 0.5) * s).astype(
                np.float32)
            v = np.where(rng.random(shape) < 0.3, ties, v)
            if kind == "bf16":
                v = np.asarray(jnp.asarray(v, jnp.bfloat16))
            arrays.append(v)
    return parts, amax, arrays


def _j_concat(name, arrays):
    parts, amax = CONCAT_CASES[name]

    # the output's amax a constant of the graph, an argument where a
    # float32 part is quantised (see the module's docstring)
    const = all(kind != "f32" for kind, *_ in parts)

    @jax.jit
    def fn(target, *arrays):
        if const:
            target = np.float32(amax or 0)
        xs = []
        for (kind, _, a, up), arr in zip(parts, arrays):
            x = _j_qt(arr, a) if kind == "s8" else arr
            if up:
                x = jq.upsample_nearest_2x_q(x) if kind == "s8" else j_up(x)
            xs.append(x)
        if amax is None:
            out = jq.qconcat(xs)
        else:
            out = jq.quantize(j_concat(xs), target)
        return out.q, out.amax

    q, a = fn(np.float32(amax or 0), *[jnp.asarray(x) for x in arrays])
    return np.asarray(q), np.float32(a)


def _torch_part(kind, arr, a):
    if kind == "s8":
        return tq.QTensor(torch.from_numpy(arr), np.float32(a))
    t = torch.from_numpy(np.asarray(arr, np.float32))
    return t.to(torch.bfloat16) if kind == "bf16" else t


@pytest.mark.parametrize("name", list(CONCAT_CASES))
def test_concat_plain_matches_jitted_reference(name):
    """``int8_concat`` (COPY and REQ at the largest amax) and
    ``quantize_concat`` (Q and DEQ_Q at a given amax), each part
    upsampled where the case says, on the CPU: the reference's jitted
    composition, exactly."""
    parts, amax, arrays = _concat_inputs(name)
    want_q, want_a = _j_concat(name, arrays)
    xs = [_torch_part(kind, arr, a)
          for (kind, _, a, _), arr in zip(parts, arrays)]
    up = [p[3] for p in parts]
    if amax is None:
        got = k12.int8_concat(xs, up)
        plain = k12.int8_concat_plain(xs, up)
    else:
        got = k12.quantize_concat(xs, amax, up)
        plain = k12.quantize_concat_plain(xs, amax, up)
    assert got.q.dtype == torch.int8 and got.q.shape == want_q.shape
    np.testing.assert_array_equal(got.q.numpy(), want_q)
    assert torch.equal(got.q, plain.q)
    assert np.float32(got.amax) == want_a
    assert k12.KERNEL.launches == 0


def _every_value(kind, shape):
    """``shape`` filled with every int8 value from -127 (``kind`` "s8" or
    "deq") or every finite bf16 value, cycled."""
    if kind == "bf16":
        v = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
        v = v[np.isfinite(v)]
    else:
        v = np.arange(-127, 128, dtype=np.int8)
    return np.resize(v, shape)


@pytest.mark.parametrize("site", k12.SHIPPED_SITES, ids=lambda s: s[0])
def test_concat_every_value_at_shipped_site(site):
    """Each shipped site's parts, modes and amaxes, three channels a part,
    on every value its parts can hold (every int8 value from -127, every
    finite bf16 value), against the reference's jitted ``qconcat`` or
    ``concat_features`` then ``quantize`` with the site's amaxes constants
    of the graph: exactly equal."""
    _, _, _, amax, parts = site
    w = 10840   # 2 x 10840 x 3 >= the 65024 finite bf16 values
    arrays = [_every_value(kind, (1, 1, w // 2, 3) if up else (1, 2, w, 3))
              for _, kind, _, up in parts]

    @jax.jit
    def fn(*arrays):
        xs = []
        for (_, kind, a, up), arr in zip(parts, arrays):
            x = arr if kind == "bf16" else _j_qt(arr, a)
            if up:
                x = jq.upsample_nearest_2x_q(x) if kind != "bf16" else j_up(x)
            xs.append(x)
        if all(kind == "s8" for _, kind, _, _ in parts):
            out = jq.qconcat(xs)
        else:
            out = jq.quantize(j_concat(xs), amax)
        return out.q, out.amax

    want_q, want_a = fn(*[jnp.asarray(x, jnp.bfloat16) if x.dtype ==
                          np.float32 else jnp.asarray(x) for x in arrays])
    xs = [torch.from_numpy(arr).to(torch.bfloat16) if kind == "bf16"
          else tq.QTensor(torch.from_numpy(arr), a)
          for (_, kind, a, _), arr in zip(parts, arrays)]
    up = [p[3] for p in parts]
    got = (k12.int8_concat(xs, up)
           if all(kind == "s8" for _, kind, _, _ in parts)
           else k12.quantize_concat(xs, amax, up))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want_q))
    assert np.float32(got.amax) == np.float32(want_a) == amax


@pytest.mark.parametrize("amax", [18.0, 21.875])
def test_quantize_where_xla_scale_differs(amax):
    """The two shipped amaxes whose scale XLA computes one f32 step from
    the port's (ROADMAP Queue C, "Scale of an amax"), a constant of the
    jitted graph, on every finite bf16 value: the port quantises with the
    IEEE quotient ``amax / 127``, the reference with ``amax * f32(1 /
    127)``, and the two give other int8s at +-amax / 2 alone (63 against
    64), the values whose exact quotient is the tie 63.5."""
    v = _every_value("bf16", (65024,))
    a = np.float32(amax)
    s_port = a / np.float32(127)
    s_xla = a * (np.float32(1) / np.float32(127))
    assert s_port != s_xla and s_port == tq.scale_of(a)

    def q_of(scale):
        with np.errstate(over="ignore"):
            return np.clip(np.rint(v / scale), -127, 127).astype(np.int8)

    want = np.asarray(jax.jit(lambda x: jq.quantize(x, amax).q)(
        jnp.asarray(v, jnp.bfloat16)))
    got = k12.quantize_concat([torch.from_numpy(v).to(torch.bfloat16)],
                              a).q.numpy()
    np.testing.assert_array_equal(got, q_of(s_port))
    np.testing.assert_array_equal(want, q_of(s_xla))
    apart = np.nonzero(got != want)[0]
    np.testing.assert_array_equal(v[apart], [a / 2, -a / 2])
    np.testing.assert_array_equal(got[apart], [63, -63])
    np.testing.assert_array_equal(want[apart], [64, -64])


def test_launch_args_ratios_are_numpys_f32():
    """The host side of a launch at every shipped site: one
    ``(channels, mode, dtype, up)`` a part, each REQ ratio numpy's f32
    ``scale_of(a) / scale_of(t)`` (what ``requantize`` multiplies by),
    each DEQ_Q part's scale, the output's scale; built once a site."""
    kinds = {"s8": 0, "deq": 0, "bf16": 1}
    for site, h, w, amax, parts in k12.SHIPPED_SITES:
        s_t = np.float32(max(amax, np.float32(1e-9))) / np.float32(127)
        key, modes = [], []
        for c, kind, a, up in parts:
            mode = (k12.DEQ_Q if kind == "deq" else k12.Q if kind == "bf16"
                    else k12.COPY if a == amax else k12.REQ)
            key.append((c, mode, kinds[kind], up, a))
            modes.append(mode)
        meta, f, got_s = k12._launch_args(tuple(key), amax)
        assert k12._launch_args(tuple(key), amax) is not None
        assert got_s == float(s_t), site
        assert list(meta) == [v for c, m, d, up, _ in key
                              for v in (c, m, d, int(up))], site
        for (c, kind, a, up), mode, got in zip(parts, modes, f):
            if mode == k12.REQ:
                s_a = np.float32(max(a, np.float32(1e-9))) / np.float32(127)
                ratio = np.float32(s_a / s_t)
                assert got == float(ratio), site
                assert ratio == tq.scale_of(a) / tq.scale_of(amax)
            elif mode == k12.DEQ_Q:
                assert got == float(tq.scale_of(a)), site
            else:
                assert got == 0.0, site
        assert k12._launch_args(tuple(key), amax)[0] is meta
    assert len(k12.SHIPPED_SITES) == 9


# ---- the routed blocks ----

def _conv(rng, k, cin, cout):
    fan = k * k * cin
    return {"conv": {
        "kernel": rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8),
        "w_scale": (np.sqrt(2 / fan) / 73.0
                    * rng.uniform(0.8, 1.2, cout)).astype(np.float32),
        "bias": rng.normal(0, 0.1, cout).astype(np.float32)}}


def _amax(v):
    return {"amax": np.float32(v)}


def _c3k2_vars(rng, cin, features, in_amaxes):
    hid = features // 2
    params = {"cv1": _conv(rng, 1, cin, hid), "cv2": _conv(rng, 1, cin, hid),
              "cv3": _conv(rng, 1, 2 * hid, features),
              "bottleneck_0": {"cv1": _conv(rng, 1, hid, hid),
                               "cv2": _conv(rng, 3, hid, hid)}}
    quant = {"cv1": {"out_q": _amax(2.5)}, "cv2": {"out_q": _amax(1.75)},
             "cv3": {"out_q": _amax(3.0)},
             "bottleneck_0": {"cv1": {"out_q": _amax(2.0)},
                              "cv2": {"out_q": _amax(2.375)},
                              "add_q": _amax(3.5)}}
    if in_amaxes:
        quant["cv1"]["conv"] = {"in_q": _amax(in_amaxes[0])}
        quant["cv2"]["conv"] = {"in_q": _amax(in_amaxes[1])}
    return {"params": params, "quant": quant}


def _tree(variables):
    return WeightTree({"params": {"blk": variables["params"]},
                       "quant": {"blk": variables["quant"]}},
                      TSpec("int8_fused"), torch.bfloat16)


def _j_block(module, variables, inputs, args):
    """The reference block, jitted, its variables arguments of the graph;
    ``args(arrays)`` -> its positional and keyword inputs."""
    fn = jax.jit(lambda v, *a: module.apply(v, *args(a)[0], **args(a)[1]))
    out = fn(variables, *[jnp.asarray(x) for x in inputs])
    return np.asarray(out.q), np.float32(out.amax)


def test_sppf_block_routes_through_its_kernel():
    """The int8 ``SPPF`` on the CPU: the bytes of cv1, three ``qmaxpool``s,
    ``qconcat`` and cv2 written out, and of the reference's jitted SPPF."""
    rng = np.random.default_rng(5)
    cin, feats = 32, 24
    variables = {"params": {"cv1": _conv(rng, 1, cin, cin // 2),
                            "cv2": _conv(rng, 1, 2 * cin, feats)},
                 "quant": {"cv1": {"out_q": _amax(20.375)},
                           "cv2": {"out_q": _amax(4.0)}}}
    xq = _int8(rng, (1, 15, 9, cin))
    amax = np.float32(6.25)
    blk = SPPF(_tree(variables), "blk")
    x = tq.QTensor(torch.from_numpy(xq), amax)
    got = blk(x)
    h = blk.cv1(x)
    y1 = tq.qmaxpool(h, 5)
    y2 = tq.qmaxpool(y1, 5)
    y3 = tq.qmaxpool(y2, 5)
    old = blk.cv2(tq.qconcat([h, y1, y2, y3]))
    assert torch.equal(got.q, old.q) and got.amax == old.amax
    want_q, want_a = _j_block(
        JSPPF(feats, quant=SPEC, deploy=True, dtype=jnp.bfloat16),
        variables, [xq], lambda a: ((_j_qt(a[0], amax),), {}))
    np.testing.assert_array_equal(got.q.numpy(), want_q)
    assert got.amax == want_a
    assert k11.KERNEL.launches == 0 and k12.KERNEL.launches == 0


# name -> (x kind, x shape, x2 kind or None, x2 shape, up_x, in_q amaxes
# of cv1 and cv2 or None)
C3K2_CASES = {
    "int8_pair_up": ("s8", (1, 4, 5, 16), "s8", (1, 8, 10, 16), True,
                     None),
    "int8_pair": ("s8", (1, 6, 5, 16), "s8", (1, 6, 5, 32), False, None),
    "bf16_shared_q": ("bf16", (1, 7, 6, 32), None, None, False,
                      (27.125, 27.125)),
    "bf16_two_q": ("bf16", (1, 7, 6, 32), None, None, False, (27.125, 9.5)),
    "mixed_shared_q": ("bf16", (1, 6, 6, 16), "s8", (1, 6, 6, 32), False,
                       (23.875, 23.875)),
    "mixed_up_two_q": ("s8", (1, 3, 4, 16), "bf16", (1, 6, 8, 16), True,
                       (12.0, 11.5)),
}


def _c3k2_inputs(rng, kind, shape, amax):
    if kind == "s8":
        arr = _int8(rng, shape)
        return arr, tq.QTensor(torch.from_numpy(arr), np.float32(amax))
    arr = np.asarray(jnp.asarray(
        np.maximum(rng.normal(0, 8, shape), 0), jnp.bfloat16))
    return arr, torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("name", list(C3K2_CASES))
def test_c3k2_block_routes_through_the_concat_kernel(name):
    """The unfused int8 ``C3k2`` on the CPU, int8 ``x`` / ``x2`` (the
    upsample inside the concat) or a float or mixed input quantised once
    for both convs (twice where their ``in_q`` amaxes differ): the bytes
    of the upsample, ``concat_features``, each conv's own quantise and
    the rest written out, and of the reference's jitted block."""
    kx, sx, k2, s2, up_x, in_amaxes = C3K2_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    cin = sx[-1] + (s2[-1] if s2 else 0)
    feats = 32
    variables = _c3k2_vars(rng, cin, feats, in_amaxes)
    ax, a2 = np.float32(5.5), np.float32(7.25)
    x_np, x = _c3k2_inputs(rng, kx, sx, ax)
    blk = C3k2(_tree(variables), "blk", shortcut=False, up=up_x)
    if k2 is None:
        got = blk(x)
        inputs, x2 = [x_np], None
    else:
        x2_np, x2 = _c3k2_inputs(rng, k2, s2, a2)
        got = blk(x, x2=x2, up_x=up_x)
        inputs = [x_np, x2_np]
    assert len(blk.in_amax) == (2 if in_amaxes else 0)

    # the composition the block ran before
    xin = x
    if x2 is not None:
        if up_x:
            xin = (tq.upsample_nearest_2x_q(x) if kx == "s8"
                   else tq.upsample_nearest_2x(x))
        if kx == k2 == "s8":
            xin = tq.qconcat([xin, x2])
        else:
            fl = [t.dequant(torch.bfloat16) if isinstance(t, tq.QTensor)
                  else t for t in (xin, x2)]
            xin = torch.cat(fl, dim=-1)
    if in_amaxes:   # each int8 conv quantised its float input itself
        path1 = blk.cv1(tq.quantize(xin, in_amaxes[0]))
        path2 = blk.cv2(tq.quantize(xin, in_amaxes[1]))
    else:
        path1, path2 = blk.cv1(xin), blk.cv2(xin)
    path1 = blk.bottlenecks[0](path1)
    old = blk.cv3(tq.qconcat([path1, path2]))
    assert torch.equal(got.q, old.q) and got.amax == old.amax

    def args(a):   # the reference block's x, and x2 where it has one
        kw = {} if k2 is None else dict(
            x2=_j_qt(a[1], a2) if k2 == "s8" else a[1], up_x=up_x)
        return (_j_qt(a[0], ax) if kx == "s8" else a[0],), kw

    want_q, want_a = _j_block(
        JC3k2(feats, 1, False, quant=SPEC, deploy=True, dtype=jnp.bfloat16),
        variables, inputs, args)
    np.testing.assert_array_equal(got.q.numpy(), want_q)
    assert got.amax == want_a
    assert k12.KERNEL.launches == 0
