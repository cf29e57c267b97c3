"""The camera kernel's host side, on the CPU: what ``CameraPreprocess``
decides once per geometry and hands the kernel.

- the form: the lookup table where every tap weight is 0 or 1 and the
  frame is RGB or BGRA (the served 1080x1920 letterbox), the divisions
  where a weight is fractional and for every NV12 geometry;
- the 3 x 256 table: the plain version's own values, bit for bit, on
  constant frames v = 0..255 (bf16 and f32 out), and the reference's
  normalisation of v / 255 op by op (eager JAX);
- the steps of the lookup form: any run of ``chunk`` window columns fits
  the staged tile, and each step's span is the columns it reads; the
  division form has none;
- the lookup form's affine tap maps equal the tables on every entry;
- the launch arguments: the C struct's fields in order, the tile sizes of
  ``csrc/camera.cu``, rebuilt with the buffers' new pointers when
  ``_apply`` replaces them.
"""
import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unina_yolo_dla_torch.ops.cuda import camera_kernel as ck
from unina_yolo_dla_tpu.ops import preprocess as jp

CSRC = Path(ck.__file__).resolve().parents[2] / "csrc" / "camera.cu"
SERVED = ck.CameraGeometry(1080, 1920, "bgra", 640, True)


@pytest.mark.parametrize("h,w,fmt,letterbox,table", [
    (1080, 1920, "bgra", True, True),     # the served geometry: ratio 3
    (1080, 1920, "rgb", True, True),
    (480, 640, "rgb", True, True),        # ratio 1
    (1080, 1920, "bgra", False, False),   # stretched: fractional rows
    (720, 1280, "rgb", True, False),      # ratio 2: weights 1/2
    (1080, 1920, "nv12", True, False),    # weights 0/1, but NV12
    (480, 640, "nv12", True, False),
    (38, 54, "nv12", False, False),
])
def test_form_selection(h, w, fmt, letterbox, table):
    pre = ck.CameraPreprocess(ck.CameraGeometry(h, w, fmt, 640, letterbox))
    assert pre.table is table and pre._args.table == int(table)
    wts = np.concatenate([pre.y_wts.numpy(), pre.x_wts.numpy()])
    if table:
        assert ((wts[:, 0] == 1) & (wts[:, 1] == 0)).all()
        assert pre.chunk >= 1 and len(pre.spans) >= 1
    else:   # one thread a pixel: no steps, no maps
        assert pre.chunk == pre._args.chunk == 0 and len(pre.spans) == 0
        assert pre._args.y_step == pre._args.x_step == -1


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_formula_table_is_the_plain_formula(out_dtype):
    """Every byte value through ``camera_preprocess_plain`` (a constant
    12x36 BGRA frame letterboxed to 12 at ratio 3, as served): the
    window equals the table's column, the pad its column 114."""
    g = ck.CameraGeometry(12, 36, "bgra", 12, True)
    table = ck.formula_table()
    assert table.dtype == torch.float32 and table.shape == (3, 256)
    pre = ck.CameraPreprocess(g, out_dtype)
    assert pre.table and torch.equal(pre.lut, table)
    _, new_h, new_w, pad_y, pad_x = g.window
    for v in range(256):
        frame = torch.full(g.frame_shape, v, dtype=torch.uint8)
        got = ck.camera_preprocess_plain(frame, g, out_dtype=out_dtype)
        win = got[pad_y:pad_y + new_h, pad_x:pad_x + new_w].reshape(-1, 3)
        assert torch.equal(win, table[:, v].to(out_dtype).expand_as(win))
    assert torch.equal(got[0, 0], table[:, ck.PAD_VALUE].to(out_dtype))
    assert list(pre._args.pad) == table[:, ck.PAD_VALUE].tolist()


def test_formula_table_matches_reference():
    v = jnp.arange(256, dtype=jnp.float32)[:, None] * jnp.ones(3)
    want = np.asarray(jp.normalize(v / 255.0)).T
    np.testing.assert_array_equal(ck.formula_table().numpy(), want)


@pytest.mark.parametrize("h,w,fmt,size,letterbox,steps", [
    (1080, 1920, "bgra", 640, True, 1),
    (1080, 1920, "rgb", 640, True, 1),    # rows of 5,760 B, span from 3
    (640, 640, "rgb", 640, True, 1),
    (2160, 3840, "bgra", 1280, True, 2),  # 15 KB a row: two steps
    (3840, 2160, "bgra", 1280, True, 2),  # the same, with pad columns
    (640, 9600, "rgb", 640, False, 4),    # ratio 15: steps cut by SRC_TILE
])
def test_steps_fit_the_tile(h, w, fmt, size, letterbox, steps):
    g = ck.CameraGeometry(h, w, fmt, size, letterbox)
    pre = ck.CameraPreprocess(g)
    assert pre.table
    x_idx, chunk = pre.x_idx.numpy(), pre.chunk
    assert 1 <= chunk <= ck.OUT_TILE
    bpp = ck.BYTES_PER_PIXEL[fmt]
    lo, hi = x_idx[:, 0], x_idx[:, 1]
    n = len(lo)

    def widest(run):   # bytes of the widest run of `run` window columns
        run = min(run, n)
        return int(((hi[run - 1:] - lo[:n - run + 1] + 1) * bpp).max())

    assert widest(chunk) <= ck.SRC_TILE
    if chunk < min(ck.OUT_TILE, n):   # the most that fits
        assert widest(chunk + 1) > ck.SRC_TILE
    spans = pre.spans.numpy()
    assert spans.shape == (steps, 2) == (-(-size // chunk), 2)
    _, _, new_w, _, pad_x = g.window
    for k, (a, b) in enumerate(spans):
        cols = [p - pad_x for p in range(k * chunk, min((k + 1) * chunk,
                                                        size))
                if 0 <= p - pad_x < new_w]
        if not cols:
            assert b < a
            continue
        want_lo, want_hi = lo[cols[0]], hi[cols[-1]]
        assert (a, b) == (want_lo, want_hi)
        assert (b - a + 1) * bpp <= ck.SRC_TILE


@pytest.mark.parametrize("dst,src,affine", [
    (360, 1080, True), (640, 1920, True), (640, 640, True),
    (640, 9600, True), (360, 720, False), (640, 1080, False),
    (7, 5, False),
])
def test_affine_maps_equal_the_tables(dst, src, affine):
    idx, _ = ck.axis_taps(dst, src)
    i0, step = ck.affine_map(idx)
    assert (step >= 0) is affine
    if affine:
        d = np.arange(dst)
        np.testing.assert_array_equal(idx, np.stack([i0 + step * d] * 2, 1))


def test_launch_arguments_match_the_kernel_source():
    """``_Args`` lists the C ``Args`` struct's fields in order, and the
    tile sizes are the kernel's."""
    src = CSRC.read_text()
    body = re.search(r"struct Args \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = re.findall(r"(\w+)(?:\[\d\])?\s*[,;]", body)
    assert names == [f for f, _ in ck._Args._fields_]
    for name in ("SRC_TILE", "OUT_TILE"):
        value = re.search(rf"constexpr int {name} = (\d+);", src).group(1)
        assert int(value) == getattr(ck, name)


def test_launch_arguments_follow_the_buffers():
    """``_apply`` (what ``.to``/``.cuda`` run) replaces every buffer; the
    cached arguments then hold the new pointers, not the freed ones."""
    pre = ck.CameraPreprocess(SERVED, torch.bfloat16)
    names = ("y_idx", "y_wts", "x_idx", "x_wts", "spans", "lut")

    def pointers():
        return [getattr(pre._args, n) for n in names]

    assert pointers() == [getattr(pre, n).data_ptr() for n in names]
    kept = [getattr(pre, n) for n in names]   # their memory stays taken
    before = pointers()
    pre._apply(lambda t: t.clone())
    after = [getattr(pre, n).data_ptr() for n in names]
    assert pointers() == after and not set(after) & set(before)
    del kept
    assert pre._args_ptr == ctypes.addressof(pre._args)
    a = pre._args
    assert (a.cam_h, a.cam_w, a.size, a.pad_y, a.chunk, a.out_bf16) == (
        1080, 1920, 640, 140, 640, 1)
    # the served ratio 3: row 3 dy + 1, column 3 dx + 1
    assert (a.y_i0, a.y_step, a.x_i0, a.x_step) == (1, 3, 1, 3)
    # the CPU path is unchanged by it
    frame = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, SERVED.frame_shape, dtype=np.uint8))
    assert torch.equal(pre(frame), ck.camera_preprocess_plain(
        frame, SERVED, out_dtype=torch.bfloat16))
