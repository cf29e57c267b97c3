"""Kernel 10: the int8 convolution with its epilogue fused, one launch a
layer of the int8 engines.

CUDA source: ``csrc/int8_conv.cu`` (an implicit GEMM on the int8 tensor
cores: tensor copies into a ring, s8 ``wgmma``, K split across two
warpgroups, programmatic dependent launch).
``int8_conv`` launches it for a CUDA tensor and runs ``int8_conv_plain``
for a CPU tensor. ``plan`` chooses each launch's tile width, K chunk and
ring depth from the layer's shape, here and nowhere else; the wrapper
hands it to the kernel and keeps it (``last_plan``). The plain version is
the port's composition of the reference's XLA layer
(``unina_yolo_dla_tpu/quant/fake_quant.py:235-265`` and the ``out_q`` /
``add_q`` requants of ``models/blocks.py``), step by step:

    acc  = im2col(x) @ w.T                      int8 x int8 -> int32
    y    = fma(f32(acc), comb, bias)[..., :cout]
    out  = y                                    (no ``out_amax``)
    q1   = clip(round(relu(y) / s_out))         (``out_amax``: ConvBlock)
    out  = clip(round(fma(q1, s_out, res * s_res) / s_add))
                                                (``res``: Bottleneck cv2)

with ``s = max(amax, 1e-9) / 127`` for each amax. The kernel computes the
same single-precision steps (fmaf, IEEE division, round half to even), so
both agree bit for bit; the plain version emulates the FMA in float64
(``qtensor.fma_f32``), which can differ from a true FMA only by a double
rounding.

Geometries: 1x1 stride 1, 3x3 stride 1 and 3x3 stride 2, padding k // 2.
The kernel takes int8 NHWC ``x`` (C a multiple of 16), the weights as
``QuantConv`` holds them, (N, kh*kw*C) int8 with N a multiple of 8, f32
``comb`` and ``bias`` (N,), and ``cout <= N`` channels out.
"""
from __future__ import annotations

import ctypes

import torch

from ...quant.qtensor import fma_f32, quantize, scale_of
from . import _lib
from ._lib import F, I, Kernel, P, check_cuda, stream_ptr

KERNEL = Kernel("unina_int8_conv",
                [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, F, F, F,
                 I, I, I, P])
# (kernel size, stride) the kernel is compiled for; padding is k // 2
GEOMETRIES = ((1, 1), (3, 1), (3, 2))
# the epilogue: f32 out, ReLU + requant, and that plus the residual requant
F32, Q, QRES = 0, 1, 2

# The kernel's plans (``csrc/int8_conv.cu``): a tile is an 8 x 8 patch of
# output pixels by ``bn`` output channels (one s8 wgmma width); K is walked
# in chunks of ``kc`` bytes (the swizzled row); a ring of ``stages``; the
# two consumer warpgroups take alternate K steps.
TILE = (8, 8)
TILE_WIDTHS = (8, 32, 64)
CHUNKS = (32, 64, 128)
THREADS = 288                  # two consumer warpgroups, one producer warp
MAX_STAGES = 8
SMEM_LIMIT = 232448            # shared memory a block may use (H100)
SMEM_TWO_PER_SM = 115712       # each of two blocks on one SM's 228 KB
RING_MANY_WAVES = 65536        # the ring's bytes where the grid takes waves
SMS = 132                      # streaming multiprocessors of an H100

# The shipped engine's 46 int8 layers by shape, at which ``plan``'s rules
# were measured: (kernel, stride, H, W, C, N, cout, epilogue) -> layers
# of that shape in one frame
SHIPPED_LAYERS = {
    (1, 1, 40, 40, 128, 128, 128, "q"): 3,
    (1, 1, 40, 40, 256, 8, 4, "f32"): 2,
    (1, 1, 40, 40, 256, 128, 128, "q"): 4,
    (1, 1, 40, 40, 256, 256, 256, "q"): 2,
    (1, 1, 40, 40, 384, 128, 128, "q"): 2,
    (1, 1, 40, 40, 512, 256, 256, "q"): 1,
    (1, 1, 80, 80, 64, 64, 64, "q"): 4,
    (1, 1, 80, 80, 128, 8, 4, "f32"): 2,
    (1, 1, 80, 80, 128, 64, 64, "q"): 2,
    (1, 1, 80, 80, 128, 128, 128, "q"): 3,
    (1, 1, 80, 80, 192, 64, 64, "q"): 2,
    (1, 1, 80, 80, 256, 64, 64, "q"): 2,
    (3, 1, 40, 40, 128, 128, 128, "qres"): 3,
    (3, 1, 40, 40, 256, 256, 256, "q"): 4,
    (3, 1, 80, 80, 64, 64, 64, "qres"): 4,
    (3, 1, 80, 80, 128, 128, 128, "q"): 4,
    (3, 2, 80, 80, 128, 128, 128, "q"): 1,
    (3, 2, 80, 80, 128, 256, 256, "q"): 1,
}


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def smem_bytes(bn: int, kc: int, stages: int) -> int:
    """Dynamic shared memory of a plan: ``layout`` in the source, byte for
    byte (the ring, with the exchange and output tiles over it; comb and
    bias; the residual tile; the mbarriers)."""
    bm = TILE[0] * TILE[1]
    region = max(stages * _round_up((bm + bn) * kc, 1024),
                 bm * (4 * bn + 16))
    return (1024 + _round_up(region, 1024) + 8 * bn
            + bm * (_round_up(bn, 16) + 16) + 8 * (2 * MAX_STAGES + 1))


def chunk_bytes(c: int) -> int:
    """The K chunk for C channels: the least zero-padded K, then the
    longest chunk (C = 48 takes one 64-byte chunk, C = 96 three of 32)."""
    return min(CHUNKS, key=lambda kc: (_round_up(c, kc), -kc))


def plan(bsz: int, h: int, w: int, c: int, n: int, k: int,
         stride: int) -> dict:
    """The launch of a layer: x (bsz, h, w, c) through a k x k conv at
    ``stride`` to n channels. Every choice was measured on the H100 at the
    shipped frame's 18 layer shapes (``SHIPPED_LAYERS``,
    ``tools/torch_int8_plans.py``):

    - ``bn``: 8 for the preds (N = 8); else 32 where the grid of 32-wide
      tiles fits the 132 SMs, else 64: more blocks spread the epilogue's
      requants over more SMs, and beat wide tiles that gather A once
      (bn = 128 or 256 took 1.2-2.5x as long at batch 1);
    - ``kc``: ``chunk_bytes(c)``; ``steps`` = k * k chunks of every tap;
    - ``stages``: the ring holds up to 8 of the K steps, in as much shared
      memory as one block an SM may use where the grid fits the 132 SMs,
      as two blocks an SM may where it fits twice (a second wave cost
      more than a shallower ring), and in at most 64 KB where it takes
      several waves (batch 8: deeper rings were slower); a ring that
      wraps has an even depth (``check_plan``).

    Every launch is a programmatic dependent launch (``csrc/int8_conv.cu``).
    """
    ho, wo = out_size(h, w, k, stride)
    kc = chunk_bytes(c)
    tiles = bsz * -(-ho // TILE[0]) * -(-wo // TILE[1])
    bn = 8 if n <= 8 else 32 if n <= 32 or tiles * -(-n // 32) <= SMS else 64
    n_tiles = -(-n // bn)
    steps = k * k * -(-c // kc)
    blocks = tiles * n_tiles
    stages = min(MAX_STAGES, max(4, steps))
    if blocks > 2 * SMS:
        stages = min(stages, max(4, RING_MANY_WAVES // (
            _round_up((TILE[0] * TILE[1] + bn) * kc, 1024))))
    limit = SMEM_LIMIT if blocks <= SMS else SMEM_TWO_PER_SM
    while stages > 4 and smem_bytes(bn, kc, stages) > limit:
        stages -= 1
    if stages < steps:
        stages -= stages % 2
    return dict(tile=list(TILE), bn=bn, kc=kc, stages=stages, steps=steps,
                grid=[tiles, n_tiles, 1], threads=THREADS,
                smem_bytes=smem_bytes(bn, kc, stages))


def check_plan(p: dict, c: int, n: int, k: int) -> None:
    """Raises ValueError on a plan the kernel does not take."""
    if (p["bn"] not in TILE_WIDTHS or p["kc"] not in CHUNKS
            or not 4 <= p["stages"] <= MAX_STAGES
            # a ring that wraps comes back to the same warpgroup
            or p["stages"] < k * k * -(-c // p["kc"]) and p["stages"] % 2
            or smem_bytes(p["bn"], p["kc"], p["stages"]) > SMEM_LIMIT):
        raise ValueError(f"int8 conv plan {p} not taken for C {c}, N {n}, "
                         f"{k}x{k}")


_last_plan: dict = {}


def last_plan() -> dict:
    """The plan of the wrapper's last launch (no kernel's count moves)."""
    return dict(_last_plan)


def last_launch() -> dict:
    """The last launch's grid, threads and shared memory as the library
    recorded them (no kernel's count moves)."""
    out = (ctypes.c_int * 4)()
    _lib.query("unina_int8_conv_last_launch",
               [ctypes.POINTER(ctypes.c_int)], out)
    gx, gy, threads, smem = out
    return dict(grid=[gx, gy, 1], threads=threads, smem_bytes=smem)


def _geometry(kh: int, kw: int, stride: int, padding) -> tuple[int, int]:
    """(kernel size, padding) of a square kernel with symmetric padding."""
    pads = ((padding,) * 4 if isinstance(padding, int) else
            tuple(p for pair in padding for p in pair))
    if kh != kw or len(set(pads)) != 1:
        return -1, -1
    return kh, pads[0]


def kernel_takes(kh: int, kw: int, stride: int, padding, c: int,
                 n: int) -> bool:
    """Whether the CUDA kernel computes this layer."""
    k, pad = _geometry(kh, kw, stride, padding)
    return ((k, stride) in GEOMETRIES and pad == k // 2 and c % 16 == 0
            and n % 8 == 0)


def out_size(h: int, w: int, k: int, stride: int) -> tuple[int, int]:
    pad = k // 2
    return (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1


def int8_conv_plain(xq: torch.Tensor, w: torch.Tensor, comb: torch.Tensor,
                    bias: torch.Tensor, kh: int, kw: int, stride: int,
                    padding, cout: int, out_amax=None,
                    res: torch.Tensor | None = None, res_amax=None,
                    add_amax=None) -> torch.Tensor:
    """Plain PyTorch version: im2col, ``torch._int_mm``, the float64-
    emulated FMA, then ReLU and the requant at ``out_amax`` and, with
    ``res``, the residual sum requantised at ``add_amax``. Returns the f32
    ``y`` (no ``out_amax``) or the int8 values."""
    from ...quant.fake_quant import int8_conv2d

    acc = int8_conv2d(xq, w, kh, kw, stride, padding)
    y = fma_f32(acc.float(), comb, bias)
    y = y[..., :cout] if y.shape[-1] != cout else y
    if out_amax is None:
        return y
    q1 = quantize(torch.relu(y), out_amax)
    if res is None:
        return q1.q
    s = fma_f32(q1.q.float(), float(q1.scale),
                res.float() * float(scale_of(res_amax)))
    return quantize(s, add_amax).q


def int8_conv(xq: torch.Tensor, w: torch.Tensor, comb: torch.Tensor,
              bias: torch.Tensor, kh: int, kw: int, stride: int, padding,
              cout: int, out_amax=None, res: torch.Tensor | None = None,
              res_amax=None, add_amax=None,
              launch_plan: dict | None = None) -> torch.Tensor:
    """One int8 layer, its epilogue fused: (B, H, W, C) int8 -> (B, Ho, Wo,
    cout), f32 without ``out_amax``, else int8 (ReLU and requant at
    ``out_amax``; with ``res``, an int8 (B, Ho, Wo, cout) tensor at
    ``res_amax``, the residual sum requantised at ``add_amax``). For a
    CUDA tensor the kernel, launched on ``plan``'s choice (or on
    ``launch_plan``, which measurements pass to compare plans; every plan
    gives the same bits); for a CPU tensor ``int8_conv_plain``."""
    if not xq.is_cuda:
        return int8_conv_plain(xq, w, comb, bias, kh, kw, stride, padding,
                               cout, out_amax, res, res_amax, add_amax)
    check_cuda(xq, "xq", torch.int8)
    bsz, h, wd, c = xq.shape
    n = w.shape[0]
    if not kernel_takes(kh, kw, stride, padding, c, n):
        raise ValueError(
            f"int8 conv kernel takes k x k stride s in {GEOMETRIES}, "
            f"padding k // 2, C % 16 == 0, N % 8 == 0; got {kh}x{kw} "
            f"stride {stride} padding {padding}, C {c}, N {n}")
    if not 0 < cout <= n:
        raise ValueError(f"cout {cout} outside 1..{n}")
    check_cuda(w, "w", torch.int8, (n, kh * kw * c))
    check_cuda(comb, "comb", torch.float32, (n,))
    check_cuda(bias, "bias", torch.float32, (n,))
    for t, name in ((xq, "xq"), (w, "w"), (comb, "comb"), (bias, "bias")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: expected 16-byte aligned data")
    ho, wo = out_size(h, wd, kh, stride)
    shape = (bsz, ho, wo, cout)
    s_out = s_res = s_add = 0.0
    if out_amax is None:
        if res is not None:
            raise ValueError("a residual needs out_amax")
        mode, dtype = F32, torch.float32
    else:
        s_out = float(scale_of(out_amax))
        mode, dtype = Q, torch.int8
        if res is not None:
            check_cuda(res, "res", torch.int8, shape)
            if res.data_ptr() % 16:
                raise ValueError("res: expected 16-byte aligned data")
            s_res, s_add = float(scale_of(res_amax)), float(scale_of(
                add_amax))
            mode = QRES
    p = launch_plan or plan(bsz, h, wd, c, n, kh, stride)
    check_plan(p, c, n, kh)
    out = torch.empty(shape, dtype=dtype, device=xq.device)
    KERNEL.launch(xq.data_ptr(), w.data_ptr(), comb.data_ptr(),
                  bias.data_ptr(), 0 if res is None else res.data_ptr(),
                  out.data_ptr(), bsz, h, wd, c, n, cout, kh, stride, mode,
                  s_out, s_res, s_add, p["bn"], p["kc"], p["stages"],
                  stream_ptr(xq.device))
    _last_plan.clear()
    _last_plan.update(p)
    return out

