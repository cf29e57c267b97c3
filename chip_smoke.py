"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``unina_yolo_dla_torch/csrc``, holds
each kernel against its plain PyTorch version on the card at the shapes of
the serving paths, then serves four paths:

- the committed int8 engine (``artifacts/serving_artifact``: fused
  stem+stage1, merged head) on a synthetic scene;
- the fused-subgraph int8 engine ``int8_s2dm_fc`` (the same weights with
  ``s2d_merged`` but no ``fused_stem``, ``fused_c3k2``, ``fused_head``),
  built through ``load_msgpack_raw`` -> ``from_jax_variables`` ->
  ``build_serving_fn``: stage1, C3k2, C3k2-cat and head kernels;
- the batch-8 artifact (``artifacts/serving_artifact_b8``, the shipped
  engine's weights) on 8 synthetic scenes in one call;
- the camera artifact (``artifacts/serving_artifact_cam``: the standard
  stem, stage1 over its merged view, the same int8 chain) on raw
  1080x1920 BGRA frames, letterboxed on the card by the camera kernel
  (colour, bilinear resize, 114 pad, normalise in one pass), boxes in
  camera pixels: camera, stage1, decode and NMS kernels.

For each it checks through the launch counters (set to 0 just before the
path's timed calls, read just after) that every call went through the
path's kernels, checks the card's detections against the port's own CPU
path on the same frames (and the batch's against the card's batch-1 path),
and profiles a few calls. Those four eager paths (``ServingArtifact(...,
graph=False)`` and the plain ``build_serving_fn``) are then served again as
one captured CUDA graph each (``runtime/aot.py``: ``ServingArtifact``'s
default on the card, ``capture_serving_fn`` for the fc engine): the
counters, set to 0 before the capture, must show one launch of each of the
path's kernels per warm-up call and one in the capture, and none in the
timed replays; the graph's strict fallback report must be clean, with each
of the path's kernels among its nodes as often as a call launches it; the
replayed detections must equal the eager ones bit for bit (8 scenes); and
the profiler, under replay, must see each kernel once a call. Last come the
lifecycle server (``runtime/serving.py``: configure, activate, 200 frames,
p50/p99) and the native host's executor entry (``runtime/embed.py``: bytes
per frame, the RGB, BGRA and geometry-sentinel forms), both on the shipped
artifact's graph, their launches counted the same way, and the executor on
the camera artifact (the ring's BGRA bytes as they are, records equal to
``packed()``, the sentinel for any other geometry or format).

The camera kernel is held against its plain version bit for bit at the
served geometry and at the other geometries of its lookup form (a
1080x1920 RGB letterbox, whose staged spans start off a 16-byte boundary;
a 2160x3840 BGRA letterbox to 1280, whose 15 KB rows are staged in two
steps), and within one bf16 step at fractional weights (a stretched
1080x1920 BGRA frame, 720x1280 and 722x1282 RGB letterboxes, a portrait
1282x722 RGB letterbox with pad columns, a 2160x3840 BGRA letterbox, a
480x640 NV12 frame), its pad rows and columns bit for bit at every
geometry; its row also gives the yardstick (``F.interpolate``) on the
device clock and in a graph. The camera artifact's card path is
held against the port's CPU path on the seed-7 scene within 1.5 camera px
(the 0.5 px gate times the letterbox's scale of 3) and 1e-2. Each
profile names the ops that issued memsets on the card, and each graph's
report its memset nodes with the kernels that wait for them.

Then the port's own export (``python -m unina_yolo_dla_torch.export``,
run in this process on the card) from ``artifacts/engine_source.msgpack``
with each committed artifact's flags (shipped; shipped at batch 8;
camera): each ``variables.msgpack`` equal to the committed one (bytes for
the shipped artifact, every leaf for all three), each ``config.json`` on
every key the reference writes but ``platforms``, each strict report of a
captured graph clean; the port-exported shipped artifact, served from its
directory, gives the committed artifact's Detections bit for bit on the 8
scenes. Then the float checkpoint (the same file without ``quant`` and
``calib_meta``, written by the port's ``save_msgpack`` to a temporary
directory) is exported as the two bf16 engines, ``bf16_s2dm_mh`` (merged
head) and ``bf16_s2dm_fc`` (every C3k2 and head fused, at 64, 128 and 256
channels), each served eager (counted launches, against the port's CPU
path on the seed-7 scene: same count, 0.5 px, 1e-2) and as one captured
graph (the same gates as the int8 paths, each kernel among the nodes as
often as a frame launches it: 3 C3k2, 4 C3k2-cat and 3 head launches in
the fc engine), and profiled; each of the fc engine's ten fused modules
runs its kernel on the served frame's own activations against its plain
version (|err| <= 1e-2 (1 + |ref|)) and is timed, beside the same block of
``bf16_s2dm_mh`` (unfused: cuDNN convolutions and elementwise kernels) on
the same activations (``unfused_ms``); each row names the grid, cluster
shape, threads and shared memory its launch used, as the library
recorded them. That gives rows 6-8 of the kernels line a ``widths``
list. The first wide form's times are quoted from PERF.md beside them in
``chip_smoke.json`` (``before_redesign_graph_ms_quoted``), never in the
kernels line.

The five tensor-core kernels (stem+stage1, stage1, both C3k2 forms, head)
are also run at ragged shapes that cut every tile edge, and the built
library's SASS is read for the tensor-core instruction each of them issues
(``mma`` in their rows; ``mma_wide`` for the C3k2 and head kernels' wide
form): every one must issue ``wgmma`` (HGMMA).

The three small kernels around the model (normalize, decode, NMS) are also
timed inside a replayed CUDA graph (``graph_ms``: the card's time per launch
under the host's launch cost), next to an empty kernel timed the same way
(the ``launch_floor`` line): normalize in both output forms (bfloat16, the
served one, in the row's main keys; float32 under ``f32_*``); decode (one
launch for all levels and images, with the top-K compaction) on the served
frame's head outputs in the main keys, on random all-valid levels
(``all_valid_*``) and on 8 scenes at batch 8 (``b8_*``); NMS on the
all-valid set, on the served frame's own candidate set (``served_*``) and
on the 8 scenes' sets in one launch (``b8_served_*``).

At the end, the native perception host (``runtime/native``): it is built with
``g++`` (the time printed), then its CUDA-graph executor, through the
host's C ABI in this process, is held byte for byte against the Python
entry points: on the shipped artifact the executor entry's records of the
8 scenes, RGB and BGRA, at depth 1 and at depth 2 (every frame submitted,
then collected in order), and the sentinel for a wrong geometry; on the
camera artifact the 4 BGRA frames of the camera executor entry; on the
exported ``bf16_s2dm_fc`` artifact ``pack_records`` of its ``packed()``
result. Counters set to 0 before each executor's configure show the path's
kernels captured into its graph, and set to 0 before its frames, no launch
from Python. Then ``ring_tool produce`` (640x640 RGB, 4 slots, 1000
frames/s, above every executor's rate) feeds ``perception_host`` for 200
frames three times: ``--executor python``, ``--executor cuda --pipeline
1`` and ``--pipeline 2``; each shutdown line's p50/p90/p99, fps and drops
are printed with the card's name and power limit, and the out block's
records equal ``make_executor``'s on the regenerated frame of its
``result_seq``. The hosts' logs go to ``chiprun_out/native_host_*.log``.

Last, the port's two-phase training (phase 17) at full width (base 32,
640^2, bf16 compute) from ``artifacts/engine_source.msgpack`` on a batch
of 16 synthetic scenes (seeds 1-16, labels padded to 100 boxes): 10 FP32
steps of the trainer's recipe with the EMA (warmup 3 steps: the default
300 needs more than 10 total steps, as optax requires), the launch
counters set to 0 before and read after (one normalize launch a step, in
its float32 form, held bit for bit against the plain formula on the
batch: the ``train_path`` of the normalize row), step ms, images/s and
peak memory, every loss term finite, the batch statistics moved, all
state on the card; one float32 step of 2 scenes on the card and on the
port's CPU path (num_fg equal, loss within 1e-3, gradient norm within
1e-2 relative); ``prepare_qat_variables`` on 4 batches of 16 (keys equal
to the committed quant collection's, every amax positive, the median
ratio to the committed amaxes printed); 5 QAT steps from the committed
quant collection (lr0 1e-3, one warmup step, no EMA); the QAT state saved
through ``CheckpointManager`` and reloaded with a template bit for bit,
exported with the shipped artifact's flags on the card (strict report),
and served on the seed-7 scene beside the shipped artifact's count.

Prints one JSON line per kernel, a ``{"kernels": [...]}`` line, and as the
last line ``{"ok": true, "device": {...}}``. Exits non-zero (and prints no
result) without a CUDA device or when any phase fails. A copy of the
measurements is written to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
ARTIFACT = REPO / "artifacts" / "serving_artifact"
ARTIFACT_B8 = REPO / "artifacts" / "serving_artifact_b8"
ARTIFACT_CAM = REPO / "artifacts" / "serving_artifact_cam"

# the port's kernels by wrapper, as their device functions are named
DEVICE_FUNCS = {"normalize": ("normalize_merged_kernel",),
                "fused_stem_stage1": ("fused_stem_stage1_kernel",),
                "decode_topk": ("decode_topk_kernel",),
                "nms": ("nms_kernel",),
                "stage1_merged": ("stage1_mma_kernel",),
                "fused_c3k2": ("c3k2_kernel<false>",
                               "c3k2_wide_kernel<false>"),
                "fused_c3k2_cat": ("c3k2_kernel<true>",
                                   "c3k2_wide_kernel<true>"),
                "fused_head": ("head_mma_kernel", "head_wide_kernel"),
                "camera": ("camera_preprocess_kernel",
                           "camera_pixel_kernel")}
# the kernels that run on the tensor cores: checked at ragged shapes too,
# and their SASS read for the instruction they issue
MMA_KERNELS = ("fused_stem_stage1", "stage1_merged", "fused_c3k2",
               "fused_c3k2_cat", "fused_head")
# template instantiations as cuobjdump lists them (mangled)
SASS_NAMES = {"c3k2_kernel<false>": "c3k2_kernelILb0EE",
              "c3k2_kernel<true>": "c3k2_kernelILb1EE",
              "c3k2_wide_kernel<false>": "c3k2_wide_kernelILb0EE",
              "c3k2_wide_kernel<true>": "c3k2_wide_kernelILb1EE"}
# launches per call of each path (a call is a frame, or a batch of 8)
PER_FRAME = {
    "shipped": {"normalize": 1, "fused_stem_stage1": 1, "decode_topk": 1,
                "nms": 1, "stage1_merged": 0, "fused_c3k2": 0,
                "fused_c3k2_cat": 0, "fused_head": 0, "camera": 0},
    "int8_s2dm_fc": {"normalize": 1, "fused_stem_stage1": 0,
                     "decode_topk": 1, "nms": 1, "stage1_merged": 1,
                     "fused_c3k2": 1, "fused_c3k2_cat": 1, "fused_head": 1,
                     "camera": 0},
    "b8": {"normalize": 1, "fused_stem_stage1": 1, "decode_topk": 1,
           "nms": 1, "stage1_merged": 0, "fused_c3k2": 0,
           "fused_c3k2_cat": 0, "fused_head": 0, "camera": 0},
    "camera": {"normalize": 0, "fused_stem_stage1": 0, "decode_topk": 1,
               "nms": 1, "stage1_merged": 1, "fused_c3k2": 0,
               "fused_c3k2_cat": 0, "fused_head": 0, "camera": 1},
    "bf16_s2dm_mh": {"normalize": 1, "fused_stem_stage1": 0,
                     "decode_topk": 1, "nms": 1, "stage1_merged": 1,
                     "fused_c3k2": 0, "fused_c3k2_cat": 0, "fused_head": 0,
                     "camera": 0},
    # every C3k2 and head of the bf16 engine fuses, at 64, 128 and 256
    "bf16_s2dm_fc": {"normalize": 1, "fused_stem_stage1": 0,
                     "decode_topk": 1, "nms": 1, "stage1_merged": 1,
                     "fused_c3k2": 3, "fused_c3k2_cat": 4, "fused_head": 3,
                     "camera": 0},
}
# the port's export, from the committed calibrated checkpoint, with each
# committed artifact's flags
SOURCE = REPO / "artifacts" / "engine_source.msgpack"
CP_CALIBRATION = REPO / "artifacts" / "cp_calibration.json"
EXPORT_FLAGS = {
    "serving_artifact": ["--int8", "--s2d-merged", "--fused-stem",
                         "--merged-head"],
    "serving_artifact_b8": ["--int8", "--s2d-merged", "--fused-stem",
                            "--merged-head", "--batch", "8"],
    "serving_artifact_cam": ["--int8", "--merged-head", "--stage1-s2d",
                             "--camera", "1080x1920", "--format", "bgra"],
}
# config.json keys the reference does not write, or writes for itself
OWN_KEYS = ("platforms", "fused_c3k2", "fused_head", "compute_dtype",
            "quant_mode")
# the bf16 engines, exported from the float checkpoint (engine_source
# without quant and calib_meta)
BF16_FLAGS = {"bf16_s2dm_mh": ["--s2d-merged", "--merged-head"],
              "bf16_s2dm_fc": ["--s2d-merged", "--fused-c3k2",
                               "--fused-head"]}
# the bf16 fc engine's fused modules, by kernel
FC_MODULES = {
    "fused_c3k2": ("backbone.stage1_block", "backbone.stage2_c3k2",
                   "backbone.stage3_c3k2"),
    "fused_c3k2_cat": ("neck.fpn_c3k2_1", "neck.fpn_c3k2_2",
                       "neck.pan_c3k2_1", "neck.pan_c3k2_2"),
    "fused_head": ("head_p2", "head_p3", "head_p4"),
}
# replayed-graph ms of each bf16_s2dm_fc block before the wide form was
# redesigned, quoted in chip_smoke.json beside this run's numbers and
# never measured by it
BEFORE_ORIGIN = (
    "quoted from PERF.md, not measured in this run: the first wide form "
    "(warp-level mma.sync, weights read from L2) on the frame's own "
    "activations, NVIDIA H100 80GB HBM3 at 700 W; the 64-wide blocks ran "
    "the tiled kernels then as now")
BEFORE_GRAPH_MS = {
    "backbone.stage1_block": 0.00961, "backbone.stage2_c3k2": 0.06237,
    "backbone.stage3_c3k2": 0.18012, "neck.fpn_c3k2_1": 0.04503,
    "neck.fpn_c3k2_2": 0.01131, "neck.pan_c3k2_1": 0.04142,
    "neck.pan_c3k2_2": 0.11467, "head_p2": 0.03049, "head_p3": 0.11639,
    "head_p4": 0.36462}
# NVIDIA H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 tensor-core
# FLOP/s, f32 CUDA-core FLOP/s
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

FRAMES = 30
BATCHES = 20
SCENE_SEEDS = range(1, 9)   # the batch-8 path's scenes (and the camera's)
CAMERA_SHAPE = (1080, 1920)  # the camera artifact's frames
SERVER_FRAMES = 200
# phase 16: the native host fed by the ring tool; the producer publishes at
# a fixed rate above every executor's frame rate and runs until the host
# has served HOST_FRAMES (it must also outlast the host's configure)
HOST_FRAMES = 200
PRODUCER_FPS = 1000
PRODUCER_FRAMES = 180_000
HOST_RUNS = (("python", None), ("cuda", 1), ("cuda", 2))
# phase 17: the two-phase training step at full width from the committed
# checkpoint: a batch of TRAIN_BATCH scenes (the train CLI's --batch
# default), labels padded to TRAIN_MAX_BOXES (YoloDataset's max_boxes)
TRAIN_BATCH = 16
TRAIN_MAX_BOXES = 100
FP32_STEPS = 10
QAT_STEPS = 5
CALIB_BATCHES = 4
SHUTDOWN = re.compile(
    r"frames=(\d+) dropped=(\d+) \(torn=(\d+) geom=(\d+)\) "
    r"p50=([\d.]+)ms p90=([\d.]+)ms p99=([\d.]+)ms fps=([\d.]+) "
    r"pipeline=(\d+)")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, launches: int = 20, replays: int = 10) -> float:
    """Mean device time of ``fn`` inside a replayed CUDA graph of
    ``launches`` calls: what the card spends per call when the host's
    launch cost is out of the way."""
    import torch

    # warmed up on the stream it is captured on (the decode kernel's
    # scratch is the stream's own)
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * launches)


def launch_floor(torch) -> dict:
    """An empty kernel (``csrc/launch_floor.cu``) timed the three ways the
    rows are: CUDA events over back-to-back launches, a replayed CUDA graph,
    the profiler's device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from unina_yolo_dla_torch.ops.cuda import _lib

    empty = _lib.Kernel("unina_empty_launch", [_lib.P])
    dev = torch.device("cuda")

    def fn():
        empty.launch(_lib.stream_ptr(dev))

    out = {"ms": cuda_ms(fn, 500), "graph_ms": graph_ms(fn)}
    # the process's first profiler window can drop its first kernel (the
    # tracer starting up): one window of one launch first, not counted
    with profile(activities=[ProfilerActivity.CUDA]):
        fn()
        torch.cuda.synchronize()
    calls = 100
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and "empty_kernel" in e.name]
    assert len(spans) == calls, f"{len(spans)} empty kernels profiled"
    out["profiler_device_ms"] = sum(spans) / 1e3 / calls
    return out


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / peak_flops * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def mma_route(lib_path: Path, func: str, source: Path) -> str:
    """Which tensor-core instruction a device function issues: ``wgmma``
    (HGMMA in the built library's SASS) or ``mma.sync`` (HMMA only), read
    by ``cuobjdump``; where that tool is absent, what the source states."""
    from unina_yolo_dla_torch.ops.cuda import _lib

    tool = Path(_lib._nvcc()).with_name("cuobjdump")
    if tool.exists():
        sass = subprocess.run([str(tool), "-sass", str(lib_path)],
                              capture_output=True, text=True,
                              check=True).stdout
        body = [part for part in sass.split("Function : ")[1:]
                if SASS_NAMES.get(func, func) in part.splitlines()[0]]
        assert len(body) == 1, f"{func}: {len(body)} SASS functions"
        found = ("wgmma" if "HGMMA" in body[0] else
                 "mma.sync" if "HMMA" in body[0] else None)
        log(f"{func}: SASS has {body[0].count('HGMMA')} HGMMA, "
            f"{body[0].count('HMMA')} HMMA")
    else:
        text = source.read_text()
        found = ("wgmma" if "wgmma" in text else
                 "mma.sync" if "mma.sync" in text else None)
    assert found is not None, f"{func}: no tensor-core instruction"
    return found


def check_ragged(torch) -> dict:
    """The tensor-core kernels at shapes that cut every tile edge, random
    weights, against plain: the stem and stage1 at batch 2, H = 10 x
    W2 = 37; the head at 37 x 45; both C3k2 forms with two bottlenecks at
    37 x 45 (and 38 x 46 with the upsample on)."""
    from unina_yolo_dla_torch.ops.cuda import (
        c3k2_kernel, head_kernel, mma_pack, stage1_kernel, stem_kernel)

    dev, bf = torch.device("cuda"), torch.bfloat16
    rng = np.random.default_rng(1)

    def act(shape, relu=True):
        a = rng.normal(0, 1, shape)
        a = np.maximum(a, 0) if relu else a
        return torch.from_numpy(a.astype(np.float32)).to(dev, bf)

    def kb(shape):
        fan = int(np.prod(shape[:-1]))
        return (rng.normal(0, np.sqrt(2 / fan), shape).astype(np.float32),
                rng.normal(0, .1, shape[-1]).astype(np.float32))

    def kb_dev(shape):
        k, b = kb(shape)
        return torch.from_numpy(k).to(dev, bf), torch.from_numpy(b).to(dev)

    def rel(got, want):
        got, want = got.float(), want.float()
        return float(((got - want).abs() / (1.0 + want.abs())).max())

    worst = {}
    wb, b = kb_dev((2, 2, 128, 64))
    wb_mma = mma_pack.pack_stage1_mma(wb)
    frame = act((2, 10, 37, 24), relu=False)
    ks, bs = kb_dev((2, 2, 24, 64))
    got = stem_kernel.fused_stem_stage1(
        frame, mma_pack.pack_stem_mma(ks), bs, wb_mma, b)
    torch.cuda.synchronize()
    worst["fused_stem_stage1"] = rel(
        got, stem_kernel.fused_stem_stage1_plain(frame, ks, bs, wb, b))
    xm = act((2, 10, 37, 64))
    got = stage1_kernel.fused_downsample_merged(xm, wb_mma, b)
    torch.cuda.synchronize()
    worst["stage1_merged"] = rel(
        got, stage1_kernel.fused_downsample_merged_plain(xm, wb, b))
    x = act((2, 37, 45, 64))
    ws = [w.to(dev) for w in head_kernel.pack_head_weights(
        [kb((3, 3, 64, 64)), kb((3, 3, 64, 64))], kb((1, 1, 64, 4)),
        [kb((3, 3, 64, 64)), kb((3, 3, 64, 64))], kb((1, 1, 64, 4)), bf)]
    w33 = mma_pack.pack_head_mma(ws[0], ws[6], ws[2], ws[8], ws[4], ws[10])
    got = head_kernel.fused_head(x, *ws, w33=w33)
    torch.cuda.synchronize()
    want = head_kernel.fused_head_plain(x, *ws)
    worst["fused_head"] = max(rel(g, w) for g, w in zip(got, want))

    # The C3k2 forms chain up to seven rounded products, and with random
    # normal weights one bf16 step of a large p1 can grow past the limit on
    # the way to a small output. Their inputs are drawn on binary grids
    # instead (activations k/2, sparse weights k/4, biases k/8), coarse
    # enough that every f32 sum is exact in any order: kernel and plain
    # must then agree bit for bit, and any difference is a fault of tiling,
    # masking or a rounding point.
    def grid_act(shape):
        a = rng.integers(0, 5, shape) * 0.5
        return torch.from_numpy(a.astype(np.float32)).to(dev, bf)

    def grid_kb(shape):
        fan = int(np.prod(shape[:-1]))
        k = np.where(rng.random(shape) < min(1.0, 8 / fan),
                     rng.choice([-.5, -.25, .25, .5], shape), 0.0)
        return (k.astype(np.float32),
                (rng.integers(-2, 3, shape[-1]) / 8).astype(np.float32))

    def c3k2_ws(cin, ca=0):
        ws = [w.to(dev) for w in c3k2_kernel.pack_c3k2_weights(
            grid_kb((1, 1, cin, 32)), grid_kb((1, 1, cin, 32)),
            grid_kb((1, 1, 64, 64)),
            [(grid_kb((1, 1, 32, 32)), grid_kb((3, 3, 32, 32)))
             for _ in range(2)], bf)]
        return ws, mma_pack.pack_c3k2_mma(ws[0], ws[6], ws[2], ws[4], ws[8],
                                          ca)

    x = grid_act((2, 37, 45, 64))
    ws, wpk = c3k2_ws(64)
    got = c3k2_kernel.fused_c3k2(x, *ws, wpk=wpk)
    torch.cuda.synchronize()
    want = c3k2_kernel.fused_c3k2_plain(x, *ws)
    assert float(want.float().abs().max()) > 1.0, "degenerate grid inputs"
    worst["fused_c3k2"] = rel(got, want)
    ws, wpk = c3k2_ws(128, 64)
    worst["fused_c3k2_cat"] = 0.0
    for (hb, wb_), up in (((38, 46), True), ((37, 45), False)):
        xa = grid_act((2, hb // 2, wb_ // 2, 64) if up else (2, hb, wb_, 64))
        xb = grid_act((2, hb, wb_, 64))
        got = c3k2_kernel.fused_c3k2_cat(xa, xb, *ws, up_a=up, wpk=wpk)
        torch.cuda.synchronize()
        want = c3k2_kernel.fused_c3k2_cat_plain(xa, xb, *ws, up_a=up)
        assert float(want.float().abs().max()) > 1.0, "degenerate grid inputs"
        worst["fused_c3k2_cat"] = max(worst["fused_c3k2_cat"],
                                      rel(got, want))
    for name, r in worst.items():
        assert r <= 1e-2, f"{name} ragged: max |err|/(1+|ref|) {r} > 1e-2"
    return worst


def check_kernels(art, rgb, scenes, torch) -> list[dict]:
    """Each kernel vs its plain version on the card, at serving shapes
    (decode and NMS also at batch 8, on ``scenes``)."""
    from unina_yolo_dla_torch.ops.cuda import (
        decode_kernel, nms_kernel, preprocess_kernel, stem_kernel)
    from unina_yolo_dla_torch.ops.decode import decode_batch, decode_outputs
    from unina_yolo_dla_torch.ops.preprocess import merged_frame_np

    bf = torch.bfloat16

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    s = art.model_config.input_size
    rows_out = []

    # 1. normalize: merged uint8 frame (S/2, S/4, 24) -> bf16 (the served
    # form: the row's main keys) and f32 (the reference kernel's contract)
    frame = torch.from_numpy(
        rng.integers(0, 256, (s // 2, s // 4, 24), dtype=np.uint8)).to(dev)
    mean, std = preprocess_kernel.channel_constants(24)
    want = preprocess_kernel.normalize_plain(frame, mean, std)
    # a ragged merged frame too: 840 bytes, no multiple of a warp's step
    small = torch.from_numpy(
        rng.integers(0, 256, (7, 5, 24), dtype=np.uint8)).to(dev)
    want_small = preprocess_kernel.normalize_plain(small, mean, std)
    n = frame.numel()
    forms = {}
    for dt in (bf, torch.float32):
        def run(img=frame, dt=dt):
            return preprocess_kernel.normalize(img, mean, std, out_dtype=dt)

        def plain(dt=dt):
            return preprocess_kernel.normalize_plain(frame, mean, std,
                                                     out_dtype=dt)

        got, got_small = run(), run(small)
        torch.cuda.synchronize()
        assert got.dtype == dt
        err = float((got.float() - want.to(dt).float()).abs().max())
        # exact: the kernel's table holds the plain version's own values
        assert torch.equal(got, want.to(dt)), f"normalize {dt}: |err| {err}"
        assert torch.equal(got_small, want_small.to(dt)), (
            f"normalize {dt}: ragged frame differs")
        b_ms, b_by = bound(n * (1 + got.element_size()), 2 * n, F32_FLOPS)
        forms[dt] = dict(max_abs_err=err, ms=cuda_ms(run, 500),
                         graph_ms=graph_ms(run), plain_ms=cuda_ms(plain, 200),
                         bound_ms=b_ms, bound_by=b_by)
    rows_out.append(dict(
        name="normalize", route="cuda",
        source="unina_yolo_dla_torch/csrc/normalize.cu",
        replaces="unina_yolo_dla_tpu/ops/pallas/preprocess_kernel.py:66",
        tolerance="exact (both output forms)", form="bfloat16 out",
        **forms[bf], library_ms=None,
        **{f"f32_{k}": v for k, v in forms[torch.float32].items()}))

    # 2. fused stem + stage1 on the normalised frame, real weights
    bb = art.model.backbone
    xm = want.to(bf)[None].contiguous()
    plain_args = (xm, bb.stem_kernel, bb.stem_bias, bb.stage1_kernel,
                  bb.stage1_bias)
    # the B tiles, packed once at load
    args = (xm, bb.stem_kernel_mma, bb.stem_bias, bb.stage1_kernel_mma,
            bb.stage1_bias)
    got = stem_kernel.fused_stem_stage1(*args)
    want_s = stem_kernel.fused_stem_stage1_plain(*plain_args)
    torch.cuda.synchronize()
    g, w = got.float(), want_s.float()
    err = float((g - w).abs().max())
    rel = float(((g - w).abs() / (1.0 + w.abs())).max())
    assert rel <= 1e-2, f"stem: max |err|/(1+|ref|) {rel} > 1e-2"
    h, w2, cm = xm.shape[1:]
    o2, c2 = bb.stem_kernel.shape[-1], bb.stage1_kernel.shape[-1]
    flops = 2 * (h * w2 * o2 * 4 * cm + (h // 2) * w2 * c2 * 8 * o2)
    nbytes = (xm.numel() * 2 + got.numel() * 2
              + (bb.stem_kernel.numel() + bb.stage1_kernel.numel()) * 2
              + (o2 + c2) * 4)
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
    rows_out.append(dict(
        name="fused_stem_stage1", route="cuda",
        source="unina_yolo_dla_torch/csrc/stem.cu",
        replaces="unina_yolo_dla_tpu/ops/pallas/stem_kernel.py:192",
        max_abs_err=err, tolerance="|err| <= 1e-2 * (1 + |ref|)",
        ms=cuda_ms(lambda: stem_kernel.fused_stem_stage1(*args), 100),
        plain_ms=cuda_ms(
            lambda: stem_kernel.fused_stem_stage1_plain(*plain_args), 20),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))

    # 3. decode + top-K compaction, one launch for all levels and images:
    # the served frame's head outputs (the row's main keys), random levels
    # where ~94% of the 33,600 cells are valid (n > K: the radix select),
    # and both at batch 8 (8 scenes)
    conf, q = art.config["conf_threshold"], art.config["q_factor"]
    k_max, strides = art.config["max_detections"], art.model_config.strides
    with torch.inference_mode():
        served1 = art.model(preprocess_kernel.normalize(
            art.stage(rgb), mean, std, out_dtype=bf)[None])
        served8 = art.model(preprocess_kernel.normalize(
            torch.from_numpy(merged_frame_np(scenes)).to(dev), mean, std,
            out_dtype=bf))

    def random_levels(b):
        return [tuple(torch.from_numpy(a).to(dev) for a in (
            rng.normal(0, 3, (b, g_, g_, 4)).astype(np.float32),
            rng.uniform(0.1, 3.0, (b, g_, g_, 4)).astype(np.float32)))
            for g_ in art.model_config.grid_sizes]

    sets = {}
    for which, outs in (("served", served1), ("all_valid", random_levels(1)),
                        ("b8_served", served8),
                        ("b8_all_valid", random_levels(8))):
        def run(outs=outs):
            return decode_kernel.decode_topk(outs, strides, conf, q, k_max)

        def plain(outs=outs):
            return decode_kernel.decode_topk_plain(outs, strides, conf, q,
                                                   k_max)

        got, want = run(), plain()
        torch.cuda.synchronize()
        for name, g_, w_ in zip(("boxes", "scores", "classes", "valid"), got,
                                want):
            assert torch.equal(g_, w_), f"decode ({which}): {name} differ"
        b = outs[0][0].shape[0]
        cells = sum(c.shape[1] * c.shape[2] for c, _ in outs)
        k = got[1].shape[1]
        # yardstick: the compaction alone as the library does it, a stable
        # sort of the masked scores and one row gather, on the same scores
        rows = torch.cat([decode_kernel.decode_level_plain(
            c, r, st, conf, q) for (c, r), st in zip(outs, strides)], dim=1)
        masked = torch.where(rows[..., 6] > 0.5, rows[..., 4],
                             torch.full_like(rows[..., 4], -1.0))

        def lib(rows=rows, masked=masked, k=k):
            order = torch.sort(masked, dim=1, descending=True, stable=True)[1]
            return rows.gather(1, order[:, :k, None].expand(-1, -1, 7))

        # read each cell's class logits once and the distances of the K
        # cells kept, write K slots of 25 B; ~40 f32 operations a cell
        nc = outs[0][0].shape[-1]
        b_ms, b_by = bound(b * (cells * nc * 4 + k * (16 + 25)),
                           b * cells * 40, F32_FLOPS)
        sets[which] = dict(
            batch=b, valid=got[3].sum(dim=1).tolist(),
            max_abs_err=max(float((g_.float() - w_.float()).abs().max())
                            for g_, w_ in zip(got, want)),
            ms=cuda_ms(run, 200), graph_ms=graph_ms(run),
            plain_ms=cuda_ms(plain, 20), bound_ms=b_ms, bound_by=b_by,
            library_ms=cuda_ms(lib, 50))
    log(f"decode: the served frame has {sets['served']['valid']} valid "
        f"cells, the 8 scenes {sets['b8_served']['valid']}")
    rows_out.append(dict(
        name="decode_topk", route="cuda",
        source="unina_yolo_dla_torch/csrc/decode.cu",
        replaces="unina_yolo_dla_tpu/ops/pallas/decode_kernel.py:94",
        tolerance="exact (all four fields, every slot)",
        per="served frame (3 levels, B = 1)", **sets["served"],
        **{f"{w}_{k}": v for w in ("all_valid", "b8_served", "b8_all_valid")
           for k, v in sets[w].items()}))

    # 4. NMS: the sorted K = 1024 set of the random all-valid levels (every
    # slot valid: the heaviest set the path can hand it), the candidate set
    # the served frame itself hands over (a few valid slots), and the 8
    # scenes' sets in one launch
    thr = art.config["iou_threshold"]
    nsets = {}
    with torch.inference_mode():
        for which, dets in (
                ("all_valid", decode_outputs(random_levels(1), strides, conf,
                                             q, k_max)),
                ("served", decode_outputs(served1, strides, conf, q, k_max)),
                ("b8_served", decode_batch(served8, strides, conf, q,
                                           k_max))):
            nargs = (dets.boxes, dets.classes, dets.valid, thr)
            keep = nms_kernel.nms_keep(*nargs)
            keep_plain = nms_kernel.nms_keep_plain(*nargs)
            torch.cuda.synchronize()
            assert torch.equal(keep, keep_plain), f"nms ({which}): masks differ"
            k = dets.valid.shape[-1]
            cls, val = dets.classes.reshape(-1, k), dets.valid.reshape(-1, k)
            # IoU tests the kernel needs: later, same-class, both-valid pairs
            same = ((cls[:, :, None] == cls[:, None, :])
                    & val[:, :, None] & val[:, None, :]).triu(1)
            b_ms, b_by = bound(val.numel() * (16 + 4 + 1 + 1),
                               int(same.sum()) * 15, F32_FLOPS)
            nsets[which] = dict(
                max_abs_err=float((keep.int() - keep_plain.int()).abs().max()),
                kept=keep.reshape(-1, k).sum(dim=1).tolist(),
                valid=val.sum(dim=1).tolist(),
                ms=cuda_ms(lambda: nms_kernel.nms_keep(*nargs), 200),
                graph_ms=graph_ms(lambda: nms_kernel.nms_keep(*nargs)),
                plain_ms=cuda_ms(lambda: nms_kernel.nms_keep_plain(*nargs), 3,
                                 1),
                bound_ms=b_ms, bound_by=b_by)
    log(f"nms: the served frame hands over {nsets['served']['valid']} valid "
        f"candidates of {k_max}, {nsets['served']['kept']} kept")
    rows_out.append(dict(
        name="nms", route="cuda", source="unina_yolo_dla_torch/csrc/nms.cu",
        replaces="unina_yolo_dla_tpu/ops/pallas/nms_kernel.py:111",
        tolerance="keep mask exact", **nsets["all_valid"], library_ms=None,
        **{f"{w}_{k}": v for w in ("served", "b8_served")
           for k, v in nsets[w].items()}))
    return rows_out


def capture_inputs(model, serve, frame, torch) -> dict:
    """The arguments each fused module of the fc engine receives while one
    frame is served (forward pre-hooks, removed after)."""
    mods = {"stage1_merged": model.backbone.stage1_conv,
            "fused_c3k2": model.backbone.stage1_block,
            "fused_c3k2_cat": model.neck.fpn_c3k2_2,
            "fused_head": model.head_p2}
    caps = {}

    def keep(name):
        def hook(_module, args, kwargs):
            caps[name] = (args, kwargs)
        return hook

    hooks = [m.register_forward_pre_hook(keep(n), with_kwargs=True)
             for n, m in mods.items()]
    try:
        serve(frame)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return {n: (mods[n], *caps[n]) for n in mods}


def check_fc_kernels(model, serve, frame, torch) -> list[dict]:
    """The fc engine's four kernels vs their plain versions on the card,
    on the activations and weights of one served frame."""
    import torch.nn.functional as F

    from unina_yolo_dla_torch.ops.cuda import (
        c3k2_kernel, head_kernel, stage1_kernel)
    from unina_yolo_dla_torch.quant.qtensor import QTensor

    bf = torch.bfloat16
    caps = capture_inputs(model, serve, frame, torch)

    def dev(t):  # the modules' own int8 -> bf16 boundary
        t = t.dequant(bf) if isinstance(t, QTensor) else t
        return t.to(bf).contiguous()

    def compare(outs, wants):
        err = rel = 0.0
        for g, w in zip(outs, wants):
            g, w = g.float(), w.float()
            err = max(err, float((g - w).abs().max()))
            rel = max(rel, float(((g - w).abs() / (1.0 + w.abs())).max()))
        return err, rel

    def row(name, source, replaces, fn, plain, nbytes, flops, iters,
            library_ms=None):
        outs, wants = fn(), plain()
        torch.cuda.synchronize()
        outs = outs if isinstance(outs, tuple) else (outs,)
        wants = wants if isinstance(wants, tuple) else (wants,)
        err, rel = compare(outs, wants)
        assert rel <= 1e-2, f"{name}: max |err|/(1+|ref|) {rel} > 1e-2"
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
        return dict(
            name=name, route="cuda",
            source=f"unina_yolo_dla_torch/csrc/{source}",
            replaces=f"unina_yolo_dla_tpu/ops/pallas/{replaces}",
            max_abs_err=err, tolerance="|err| <= 1e-2 * (1 + |ref|)",
            ms=cuda_ms(fn, iters), plain_ms=cuda_ms(plain, max(iters // 5, 3)),
            bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)

    rows = []
    # 5. stage1 over the merged stem output
    mod, args, _ = caps["stage1_merged"]
    xm = dev(args[0])
    wb, bias = mod.kernel, mod.bias
    _, h, w2, cm = xm.shape
    wb_mma = mod.kernel_mma  # the B tiles, packed once at load
    out = stage1_kernel.fused_downsample_merged(xm, wb_mma, bias)
    # yardstick: one cuDNN conv on the un-merged view (1, C, H, 2*W2),
    # the blocked kernel unfolded to its 4x4 stride-2 form (pad 2, the
    # 161st row/column dropped), bias included, ReLU excluded
    c = cm // 2
    xs = xm.reshape(1, h, 2 * w2, c).permute(0, 3, 1, 2)
    k4 = wb.reshape(2, 2, 2, 2, c, -1).permute(5, 4, 0, 2, 1, 3).reshape(
        -1, c, 4, 4).contiguous()

    def lib():
        return F.conv2d(xs, k4, bias.to(bf), stride=2,
                        padding=2)[..., :h // 2, :w2]

    ref = torch.relu(lib()).permute(0, 2, 3, 1).float()
    lib_rel = float(((out.float() - ref).abs() / (1 + ref.abs())).max())
    assert lib_rel <= 1e-2, f"stage1 yardstick disagrees: {lib_rel}"
    rows.append(row(
        "stage1_merged", "stage1.cu", "stage1_kernel.py:127",
        lambda: stage1_kernel.fused_downsample_merged(xm, wb_mma, bias),
        lambda: stage1_kernel.fused_downsample_merged_plain(xm, wb, bias),
        xm.numel() * 2 + out.numel() * 2 + wb.numel() * 2 + bias.numel() * 4,
        2 * out.numel() * wb.shape[0] * wb.shape[1] * wb.shape[2], 100,
        library_ms=cuda_ms(lib, 100)))

    def weights(mod):
        return [getattr(mod, n) for n in mod._FUSED]

    def c3k2_macs(ws, pixels):  # bottlenecks + cv3 per output pixel
        _, _, wb1, _, wb2, *_ = ws
        return pixels * (wb1[0].numel() * len(wb1) + wb2[0].numel() * len(wb2)
                         + ws[8].numel())

    # 6. stage1_block: the whole C3k2
    mod, args, _ = caps["fused_c3k2"]
    x = dev(args[0])
    ws = weights(mod)
    px = x.shape[1] * x.shape[2]
    nbytes = 2 * x.numel() + 2 * px * ws[8].shape[1] + sum(
        t.numel() * t.element_size() for t in ws)
    macs = px * 2 * ws[0].numel() + c3k2_macs(ws, px)
    rows.append(row(
        "fused_c3k2", "c3k2.cu", "c3k2_kernel.py:324",
        lambda: c3k2_kernel.fused_c3k2(x, *ws, shortcut=mod.shortcut,
                                       wpk=mod.wpk),
        lambda: c3k2_kernel.fused_c3k2_plain(x, *ws, shortcut=mod.shortcut),
        nbytes, 2 * macs, 100))

    # 7. fpn_c3k2_2: upsample + concat folded into the first dots
    mod, args, kwargs = caps["fused_c3k2_cat"]
    xa, xb, up = dev(args[0]), dev(kwargs["x2"]), kwargs["up_x"]
    ws = weights(mod)
    ca = xa.shape[-1]
    pa, pb = xa.shape[1] * xa.shape[2], xb.shape[1] * xb.shape[2]
    nbytes = 2 * (xa.numel() + xb.numel() + pb * ws[8].shape[1]) + sum(
        t.numel() * t.element_size() for t in ws)
    macs = (2 * ws[0].shape[1] * (pa * ca + pb * xb.shape[-1])
            + c3k2_macs(ws, pb))
    rows.append(row(
        "fused_c3k2_cat", "c3k2.cu", "c3k2_kernel.py:356",
        lambda: c3k2_kernel.fused_c3k2_cat(xa, xb, *ws, shortcut=mod.shortcut,
                                           up_a=up, wpk=mod.wpk),
        lambda: c3k2_kernel.fused_c3k2_cat_plain(
            xa, xb, *ws, shortcut=mod.shortcut, up_a=up),
        nbytes, 2 * macs, 100))

    # 8. head_p2: both branches, f32 preds
    mod, args, _ = caps["fused_head"]
    x = dev(args[0])
    ws = weights(mod)
    px = x.shape[1] * x.shape[2]
    npred = ws[4].shape[1] + ws[10].shape[1]
    # the 3x3 weights count once (the kernel reads them as mod.w33, the
    # plain version as ws[0], [2], [6], [8])
    nbytes = 2 * x.numel() + 4 * px * npred + sum(
        t.numel() * t.element_size() for t in ws)
    macs = px * (ws[0].numel() + ws[2].numel() + ws[6].numel()
                 + ws[8].numel() + ws[4].numel() + ws[10].numel())
    rows.append(row(
        "fused_head", "head.cu", "head_kernel.py:127",
        lambda: head_kernel.fused_head(x, *ws, w33=mod.w33),
        lambda: head_kernel.fused_head_plain(x, *ws),
        nbytes, 2 * macs, 50))
    return rows


def camera_bytes(geom, pre) -> int:
    """Bytes the camera kernel must move for ``geom``: the source pixels
    its taps touch (rows x columns of the tables; the NV12 chroma at half
    resolution), the canvas it writes and its tables."""
    rows = np.unique(pre.y_idx.cpu().numpy()).size
    cols = np.unique(pre.x_idx.cpu().numpy()).size
    if geom.fmt == "nv12":
        half_r = np.unique(pre.y_idx.cpu().numpy() // 2).size
        half_c = np.unique(pre.x_idx.cpu().numpy() // 2).size
        src = rows * cols + half_r * half_c * 2
    else:
        src = rows * cols * {"rgb": 3, "bgra": 4}[geom.fmt]
    out = geom.size * geom.size * 3 * (2 if pre.out_dtype.itemsize == 2
                                       else 4)
    tables = sum(t.numel() * t.element_size() for t in pre.buffers())
    return src + out + tables


def profiled_ms(fn, torch, calls: int = 100) -> float:
    """Device ms per call of ``fn``: every CUDA kernel the profiler sees
    in a window of ``calls`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3 / calls


def bf16_steps(got, want) -> float:
    """Largest |got - want| in bf16 steps of |want|."""
    import torch

    got, want = got.float(), want.float()
    step = torch.exp2(torch.floor(torch.log2(
        want.abs().clamp(min=1e-30)))) / 128
    return float(((got - want).abs() / step).max())


def pad_equal(geom, got, want) -> bool:
    """Whether two canvases of ``geom`` agree outside the resized window
    (the pad rows and columns), bit for bit."""
    import torch

    _, new_h, new_w, pad_y, pad_x = geom.window
    pad = torch.ones(got.shape[:2], dtype=torch.bool, device=got.device)
    pad[pad_y:pad_y + new_h, pad_x:pad_x + new_w] = False
    return bool(torch.equal(got[pad], want[pad]))


# the camera kernel's other geometries: (height, width, format, size,
# letterbox). The lookup form's (every weight 0 or 1) are held bit for
# bit, the fractional ones to one bf16 step (1e-5 in f32) of the plain
# version run on the CPU; the pad bit for bit at all
CAMERA_LOOKUP = (
    (1080, 1920, "rgb", 640, True),     # 3-byte pixels: unaligned spans
    (2160, 3840, "bgra", 1280, True),   # 15 KB rows: two staged steps
)
CAMERA_FRACTIONAL = (
    (1080, 1920, "bgra", 640, False),
    (720, 1280, "rgb", 640, True),
    (480, 640, "nv12", 640, False),
    (722, 1282, "rgb", 640, True),      # 3,846-byte rows
    (1282, 722, "rgb", 640, True),      # portrait: pad columns
    (2160, 3840, "bgra", 640, True),    # ratio 6: weights 1/2
)


def check_camera_kernel(art_cam, frame, torch) -> dict:
    """The camera kernel against its plain version: bit for bit at the
    served geometry (``frame``, 1080x1920 BGRA letterboxed, bf16 and f32
    out) and at the lookup form's of CAMERA_LOOKUP; within one bf16 step
    (f32 out: 1e-5) at the fractional geometries of CAMERA_FRACTIONAL; the
    pad rows and columns bit for bit everywhere. At fractional weights the
    plain version runs on the CPU: on the card its two float32 matmuls
    (cuBLAS) sum in another order, up to 7e-7 apart, and where ``x / 255``
    cancels against the mean that is many bf16 steps of a result near 0
    (the card's plain version is reported beside it). Beside it the yardstick, PyTorch's bilinear
    resize of the float frame, on the same three clocks (events, replayed
    graph, profiler)."""
    import torch.nn.functional as F

    from unina_yolo_dla_torch.ops.cuda import camera_kernel as ck

    dev, bf = torch.device("cuda"), torch.bfloat16
    rng = np.random.default_rng(3)
    geom = art_cam.geometry
    served = torch.from_numpy(frame).to(dev)

    def form(pre):
        return {"form": "table" if pre.table else "divide",
                "chunk": pre.chunk, "steps": int(pre.spans.shape[0])}

    forms, others = {}, {}
    for dt in (bf, torch.float32):
        pre = ck.CameraPreprocess(geom, dt).to(dev)
        got = pre(served)
        want = ck.camera_preprocess_plain(served, geom, out_dtype=dt)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        assert torch.equal(got, want), (
            f"camera {dt} at the served geometry: |err| {err}")
        assert pre.table, "the served geometry takes the table form"
        b_ms, b_by = bound(camera_bytes(geom, pre),
                           40 * geom.size * geom.size, F32_FLOPS)
        forms[dt] = dict(
            max_abs_err=err, ms=cuda_ms(lambda: pre(served), 200),
            graph_ms=graph_ms(lambda: pre(served)),
            device_ms=profiled_ms(lambda: pre(served), torch),
            plain_ms=cuda_ms(lambda: ck.camera_preprocess_plain(
                served, geom, out_dtype=dt), 20),
            bound_ms=b_ms, bound_by=b_by, **form(pre))
    for h, w, fmt, size, lb in CAMERA_LOOKUP + CAMERA_FRACTIONAL:
        g = ck.CameraGeometry(h, w, fmt, size, lb)
        exact = (h, w, fmt, size, lb) in CAMERA_LOOKUP
        f = torch.from_numpy(rng.integers(0, 256, g.frame_shape,
                                          dtype=np.uint8)).to(dev)
        res = {}
        for dt in (bf, torch.float32):
            pre = ck.CameraPreprocess(g, dt).to(dev)
            got = pre(f)
            want = ck.camera_preprocess_plain(f, g, out_dtype=dt)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            assert pad_equal(g, got, want), f"camera {g} {dt}: pad differs"
            assert pre.table is exact, f"camera {g}: form"
            name = "bf16" if dt == bf else "f32"
            if exact:
                assert torch.equal(got, want), f"camera {g} {dt}: |err| {err}"
                res[f"{name}_max_abs_err"] = err
                continue
            # the CPU's plain version (see above), the card's beside it
            ref = ck.camera_preprocess_plain(f.cpu(), g, out_dtype=dt).to(dev)
            res[f"{name}_card_plain_max_abs_err"] = err
            err = float((got.float() - ref.float()).abs().max())
            res[f"{name}_max_abs_err"] = err
            if dt == bf:
                st = bf16_steps(got, ref)
                assert st <= 1.0, f"camera {g}: {st} bf16 steps"
                res["bf16_max_steps"] = st
                res["bf16_card_plain_max_steps"] = bf16_steps(got, want)
            else:
                assert err <= 1e-5, f"camera {g} f32: |err| {err}"
        res.update(form(pre))
        others[f"{fmt}_{h}x{w}_to_{size}_"
               f"{'letterbox' if lb else 'stretch'}"] = res
    log(json.dumps({"camera_geometries": others}))
    # yardstick: PyTorch's bilinear resize of the float RGB frame alone
    # (no colour, pad or normalise), the same half-pixel coordinates
    _, new_h, new_w, _, _ = geom.window
    rgb = served[..., [2, 1, 0]].float().permute(2, 0, 1)[None].contiguous()

    def lib():
        return F.interpolate(rgb, size=(new_h, new_w), mode="bilinear",
                             align_corners=False)

    return dict(
        name="camera", route="cuda",
        source="unina_yolo_dla_torch/csrc/camera.cu",
        replaces="unina_yolo_dla_tpu/ops/preprocess.py:97",
        tolerance=("exact at the served geometry and in the lookup form "
                   "(both output dtypes); <= 1 bf16 step (f32 out: 1e-5) "
                   "of the plain version on the CPU at fractional "
                   "weights; the pad exact everywhere"),
        per="bfloat16 out, 1080x1920 BGRA letterboxed to 640",
        **forms[bf], library_ms=cuda_ms(lib, 200),
        library_graph_ms=graph_ms(lib), library_device_ms=profiled_ms(
            lib, torch),
        library="F.interpolate bilinear of the float RGB frame (resize "
                "alone)",
        **{f"f32_{k}": v for k, v in forms[torch.float32].items()},
        geometries=others)


def profile_calls(serve, arg, torch, calls: int = 10,
                  unit: str = "frame") -> dict:
    """Device time per call by kernel (torch.profiler, CUDA activity),
    against the host wall clock of the same calls (a call serves a frame,
    or a batch: ``unit``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    serve(arg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(calls):
            serve(arg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / calls
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            row = by_name.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e3 / calls
            row[1] += 1
    busy = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])

    def ours(wrapper):  # device functions, with or without template args
        return [v for n, v in by_name.items() if any(
            re.search(rf"(^|\W){f}(<[^(]*>)?\(", n)
            for f in DEVICE_FUNCS[wrapper])]

    # each memset on the card, by the chain of ops that issued it
    memsets: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and any(
                "emset" in k.name for k in e.kernels):
            chain, up = [], e
            while up is not None:
                chain.append(up.name)
                up = up.cpu_parent
            key = " < ".join(chain[:6])
            memsets[key] = memsets.get(key, 0.0) + 1.0 / calls
    port = {w: sum(v[0] for v in ours(w)) for w in DEVICE_FUNCS}
    port_calls = {w: sum(v[1] for v in ours(w)) / calls
                  for w in DEVICE_FUNCS}
    return {"calls": calls, "unit": unit, "wall_ms_per_call": wall,
            "device_busy_ms_per_call": busy,
            "device_idle_share": 1.0 - busy / wall,
            "port_kernels_device_ms_per_call": port,
            "port_kernels_calls_per_call": port_calls,
            "kernels_per_call": sum(v[1] for v in by_name.values()) / calls,
            "memsets_per_call": memsets,
            "sort_kernels": [n[:90] for n in by_name if "sort" in n.lower()],
            "top": [{"name": n[:90], "ms_per_call": v[0],
                     "calls_per_call": v[1] / calls}
                    for n, v in top[:25]]}


def match_detections(a, b, box_tol: float, score_tol: float) -> dict:
    """One-to-one match of two valid detection sets by class and box."""
    va, vb = a.valid.cpu().numpy(), b.valid.cpu().numpy()
    ba, bb_ = a.boxes.cpu().numpy()[va], b.boxes.cpu().numpy()[vb]
    sa, sb = a.scores.cpu().numpy()[va], b.scores.cpu().numpy()[vb]
    ca, cb = a.classes.cpu().numpy()[va], b.classes.cpu().numpy()[vb]
    assert len(ba) == len(bb_), f"valid counts differ: {len(ba)} {len(bb_)}"
    used = set()
    worst_box = worst_score = 0.0
    for i in range(len(ba)):
        cand = [j for j in range(len(bb_)) if j not in used and cb[j] == ca[i]]
        assert cand, f"detection {i} (class {ca[i]}) has no match"
        j = min(cand, key=lambda j: np.abs(bb_[j] - ba[i]).max())
        used.add(j)
        worst_box = max(worst_box, float(np.abs(bb_[j] - ba[i]).max()))
        worst_score = max(worst_score, float(abs(sb[j] - sa[i])))
    assert worst_box <= box_tol, f"box error {worst_box} > {box_tol}"
    assert worst_score <= score_tol, f"score error {worst_score} > {score_tol}"
    return {"count": len(ba), "max_box_err_px": worst_box,
            "max_score_err": worst_score}


def drive(serve, rgb, labels, kernels, per_frame, cpu_dets, torch,
          box_tol: float = 0.5) -> dict:
    """One engine end to end at batch 1: warm-up, then FRAMES timed frames
    with every launch counter set to 0 just before and read just after;
    the path's launches per frame, its outputs' sanity and its match with
    the port's CPU path on the same frame (boxes within ``box_tol`` px:
    0.5 in model space, 1.5 in the camera's pixels, the letterbox's
    scale of 3)."""
    for _ in range(5):
        serve(rgb)
    torch.cuda.synchronize()
    for kern in kernels.values():
        kern.launches = 0
    times = []
    for _ in range(FRAMES):
        t = time.perf_counter()
        dets = serve(rgb)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    launches = {name: kern.launches for name, kern in kernels.items()}
    for name, per in per_frame.items():
        assert launches[name] == per * FRAMES, (
            f"{name}: {launches[name]} launches in {FRAMES} frames, "
            f"expected {per * FRAMES}")
    n_valid = dets.count
    assert dets.boxes.shape == (1024, 4)
    assert bool(torch.isfinite(dets.boxes).all())
    assert bool(torch.isfinite(dets.scores).all())
    gt = {int(lbl[0]) for lbl in labels}
    got_cls = {int(c) for c in dets.classes[dets.valid].tolist()}
    assert 1 <= n_valid <= len(labels) + 3, (n_valid, len(labels))
    assert got_cls <= gt, (got_cls, gt)
    match = match_detections(dets, cpu_dets, box_tol=box_tol, score_tol=1e-2)
    return {"frames": FRAMES, "valid": n_valid, "gt_cones": len(labels),
            "frame_ms_median": float(np.median(times)),
            "frame_ms_min": float(np.min(times)), "vs_cpu_port": match,
            "launches": launches}


def drive_batch(serve, frames, labels, kernels, per_batch, b1_dets, cpu_dets,
                torch) -> dict:
    """The batch path end to end: warm-up, then BATCHES timed calls of the
    whole batch with every launch counter set to 0 just before and read
    just after; the path's launches per batch, and each image against the
    card's batch-1 path and the port's CPU batch path on the same frame."""
    for _ in range(3):
        serve(frames)
    torch.cuda.synchronize()
    for kern in kernels.values():
        kern.launches = 0
    times = []
    for _ in range(BATCHES):
        t = time.perf_counter()
        dets = serve(frames)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    launches = {name: kern.launches for name, kern in kernels.items()}
    for name, per in per_batch.items():
        assert launches[name] == per * BATCHES, (
            f"{name}: {launches[name]} launches in {BATCHES} batches, "
            f"expected {per * BATCHES}")
    b = len(frames)
    assert dets.boxes.shape == (b, 1024, 4)
    assert bool(torch.isfinite(dets.boxes).all())
    assert bool(torch.isfinite(dets.scores).all())
    counts = dets.counts().tolist()
    assert sum(counts) >= 1, "no detection in the whole batch"
    images, worst = [], {"b1": [0.0, 0.0], "cpu": [0.0, 0.0]}
    for i in range(b):
        mine = type(dets)(*(f[i] for f in dets))
        vs = {}
        for which, other in (("b1", b1_dets[i]),
                             ("cpu", type(dets)(*(f[i] for f in cpu_dets)))):
            vs[which] = match_detections(mine, other, box_tol=0.5,
                                         score_tol=1e-2)
            worst[which] = [max(worst[which][0], vs[which]["max_box_err_px"]),
                            max(worst[which][1], vs[which]["max_score_err"])]
        images.append({"valid": counts[i], "gt_cones": len(labels[i]),
                       "vs_card_batch1": vs["b1"], "vs_cpu_batch": vs["cpu"]})
    log(f"batch of {b}: max gaps to the card's batch-1 path "
        f"{worst['b1'][0]} px / {worst['b1'][1]}, to the CPU batch path "
        f"{worst['cpu'][0]} px / {worst['cpu'][1]}")
    med = float(np.median(times))
    return {"batches": BATCHES, "batch": b, "valid": counts,
            "batch_ms_median": med, "batch_ms_min": float(np.min(times)),
            "frames_per_s": b * 1e3 / med,
            "max_gap_vs_card_batch1": worst["b1"],
            "max_gap_vs_cpu_batch": worst["cpu"], "images": images,
            "launches": launches}


def _zero(kernels) -> None:
    for kern in kernels.values():
        kern.launches = 0


def _read(kernels) -> dict:
    return {name: kern.launches for name, kern in kernels.items()}


def _same(a, b) -> bool:
    return all(x.shape == y.shape and bool((x == y).all())
               for x, y in zip(a, b))


def drive_graph(capture, call, eager, args, kernels, per_call, out_bytes,
                torch, copies: bool, unit: str = "frame"):
    """One path as a captured CUDA graph. ``capture()`` -> (the entry
    point's object, its ``CapturedFrame``); ``call(owner, arg)`` serves one
    call through the replayed graph (``copies``: its results are its own);
    ``eager(arg)`` through the eager frame; ``args``: the calls' inputs (8
    scenes, or one batch of them).

    Counters are set to 0 just before the capture and read just after,
    and again around the timed replays: the capture must launch each of the
    path's kernels once per warm-up call and once into the graph, the
    replays none. The graph's strict report must be clean, hold each kernel
    as often as a call launches it, and read ``out_bytes`` of result; the
    replayed detections equal the eager ones bit for bit.
    -> (owner, graph, the phase's record)."""
    from unina_yolo_dla_torch.runtime import aot

    _zero(kernels)
    t = time.perf_counter()
    owner, graph = capture()
    capture_s = time.perf_counter() - t
    launches = _read(kernels)
    rep = graph.report
    aot.print_fallback_report(rep, strict=True, log_fn=log)
    assert rep.output_bytes == out_bytes, (rep.output_bytes, out_bytes)
    by_symbol = {kern.symbol: name for name, kern in kernels.items()}
    in_capture = {by_symbol[s]: n for s, n in graph.capture_launches.items()
                  if s in by_symbol}
    for name, per in per_call.items():
        assert launches[name] == (aot.WARMUP + 1) * per, (
            f"{name}: {launches[name]} launches around the capture at "
            f"{per} per call")
        assert in_capture.get(name, 0) == per, (
            f"{name}: {in_capture.get(name, 0)} launches in the capture")
        assert rep.port_kernels[name] == per, (
            f"{name}: {rep.port_kernels[name]} nodes in the graph, "
            f"{per} launches per call")
    bit_equal = []
    for arg in args:
        with torch.inference_mode():
            got = [f.clone() for f in call(owner, arg)]
        bit_equal.append(_same(got, eager(arg)))
    assert all(bit_equal), f"replayed detections differ: {bit_equal}"
    if copies:   # a later call leaves an earlier result as it was
        first = call(owner, args[0])
        kept = [f.clone() for f in first]
        second = call(owner, args[-1])
        torch.cuda.synchronize()
        assert _same(first, kept)
        assert all(a.data_ptr() != b.data_ptr()
                   for a, b in zip(first, second))
    n = FRAMES if unit == "frame" else BATCHES
    for _ in range(3):
        call(owner, args[0])
    torch.cuda.synchronize()
    _zero(kernels)
    times = []
    for i in range(n):
        t = time.perf_counter()
        call(owner, args[i % len(args)])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    replay_launches = _read(kernels)
    assert not any(replay_launches.values()), (
        f"eager launches during replays: {replay_launches}")
    return owner, graph, {
        "unit": unit, "calls": n, "capture_s": capture_s,
        "capture_inner_s": graph.capture_s,
        "call_ms_median": float(np.median(times)),
        "call_ms_min": float(np.min(times)),
        "bit_equal_vs_eager": bit_equal, "report": vars(rep),
        "launches_around_capture": launches,
        "launches_in_capture": in_capture,
        "launches_in_replays": replay_launches}


def drive_server(kernels, per_call, scenes, eager_art, torch) -> dict:
    """The lifecycle server on the shipped artifact's graph: counters set
    to 0 before configure (which captures) and read after, and again
    around SERVER_FRAMES frames (cycling through the scenes), which must
    launch nothing eagerly; each scene's dict against the eager frame."""
    from unina_yolo_dla_torch.runtime import aot
    from unina_yolo_dla_torch.runtime.serving import (
        LifecycleState,
        PerceptionServer,
    )

    _zero(kernels)
    srv = PerceptionServer(ARTIFACT, log_fn=lambda _m: None)
    t = time.perf_counter()
    srv.configure()
    configure_s = time.perf_counter() - t
    srv.activate()
    assert srv.state == LifecycleState.ACTIVE
    launches = _read(kernels)
    for name, per in per_call.items():
        assert launches[name] == (aot.WARMUP + 1) * per, (name, launches)
    assert srv.process_frame(scenes[0][:320]) is None   # geometry guard
    _zero(kernels)
    outs = [srv.process_frame(scenes[i % len(scenes)])
            for i in range(SERVER_FRAMES)]
    frame_launches = _read(kernels)
    assert not any(frame_launches.values()), frame_launches
    for i, frame in enumerate(scenes):
        want = eager_art(frame)
        v = want.valid.cpu().numpy()
        got = outs[i]
        assert got["count"] == int(v.sum())
        assert np.array_equal(got["boxes"], want.boxes.cpu().numpy()[v])
        assert np.array_equal(got["scores"], want.scores.cpu().numpy()[v])
        assert np.array_equal(got["classes"], want.classes.cpu().numpy()[v])
    stats = srv.stats()
    assert stats["frames_processed"] == SERVER_FRAMES
    assert stats["frames_dropped"] == 1
    srv.shutdown()
    return {"configure_s": configure_s, "launches_in_configure": launches,
            "launches_in_frames": frame_launches,
            "counts": [o["count"] for o in outs[:len(scenes)]], **stats}


def drive_executor(kernels, per_call, scenes, torch) -> dict:
    """The native host's executor entry on the shipped artifact's graph:
    RGB and BGRA frames give the same records, which equal the server's
    packed result; a frame of the wrong geometry gets the sentinel."""
    import struct

    from unina_yolo_dla_torch.runtime import aot
    from unina_yolo_dla_torch.runtime.embed import make_executor

    _zero(kernels)
    execute = make_executor(str(ARTIFACT))
    launches = _read(kernels)
    for name, per in per_call.items():
        assert launches[name] == (aot.WARMUP + 1) * per, (name, launches)
    _zero(kernels)
    blobs, times = [], []
    for rgb in scenes:
        bgra = np.concatenate([rgb[..., ::-1], np.full(
            rgb.shape[:2] + (1,), 255, np.uint8)], axis=-1)
        t = time.perf_counter()
        blob = execute(memoryview(rgb.tobytes()), 640, 640, 3)
        times.append((time.perf_counter() - t) * 1e3)
        assert execute(memoryview(bgra.tobytes()), 640, 640, 4) == blob
        count, = struct.unpack_from("<I", blob, 0)
        assert len(blob) == 4 + 24 * count and count >= 1
        blobs.append(blob)
    wrong = execute(memoryview(scenes[0].tobytes()), 320, 640, 3)
    assert wrong == struct.pack("<I", 0xFFFFFFFF), wrong
    frame_launches = _read(kernels)
    assert not any(frame_launches.values()), frame_launches
    return {"bytes_per_frame": [len(b) for b in blobs],
            "frame_ms_median": float(np.median(times)),
            "launches_in_configure": launches,
            "launches_in_frames": frame_launches, "sentinel_ok": True,
            "blobs": blobs}


def drive_camera_executor(kernels, per_call, art_g, frames, torch) -> dict:
    """The executor entry on the camera artifact's graph: the ring's BGRA
    bytes as they are give the records of the artifact's packed result;
    another geometry or format gets the sentinel; frames launch nothing."""
    import struct

    from unina_yolo_dla_torch.runtime import aot
    from unina_yolo_dla_torch.runtime.embed import make_executor, pack_records

    _zero(kernels)
    execute = make_executor(str(ARTIFACT_CAM))
    launches = _read(kernels)
    for name, per in per_call.items():
        assert launches[name] == (aot.WARMUP + 1) * per, (name, launches)
    h, w = CAMERA_SHAPE
    wants = [pack_records(art_g.packed(f)) for f in frames]
    _zero(kernels)
    blobs, times = [], []
    for frame, want in zip(frames, wants):
        t = time.perf_counter()
        blob = execute(memoryview(frame.tobytes()), w, h, 4)
        times.append((time.perf_counter() - t) * 1e3)
        assert blob == want, "camera executor records differ from packed()"
        blobs.append(blob)
    sentinel = struct.pack("<I", 0xFFFFFFFF)
    for gw, gh, gc in ((w, h, 3), (w, h, 0), (640, 640, 3)):
        assert execute(memoryview(frames[0].tobytes()), gw, gh, gc) == \
            sentinel, (gw, gh, gc)
    frame_launches = _read(kernels)
    assert not any(frame_launches.values()), frame_launches
    return {"bytes_per_frame": [len(b) for b in blobs],
            "frame_ms_median": float(np.median(times)),
            "launches_in_configure": launches,
            "launches_in_frames": frame_launches, "sentinel_ok": True,
            "blobs": blobs}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, np.asarray(tree)


def trees_equal(a, b) -> bool:
    """The same paths in the same order, every leaf equal in dtype, shape
    and value."""
    la, lb = list(_leaves(a)), list(_leaves(b))
    return (len(la) == len(lb) > 0 and all(
        pa == pb and x.dtype == y.dtype and x.shape == y.shape
        and np.array_equal(x, y) for (pa, x), (pb, y) in zip(la, lb)))


def run_export(argv) -> float:
    """``python -m unina_yolo_dla_torch.export`` in this process, on the
    card, its log on stderr; -> wall seconds."""
    import contextlib

    from unina_yolo_dla_torch import export

    t = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        export.main([str(a) for a in argv])
    return time.perf_counter() - t


def drive_export(tmp: Path, scenes, art_g, torch) -> dict:
    """The port's export on the card from the committed checkpoint with
    each committed artifact's flags: variables equal to the committed ones
    (bytes for the shipped artifact, every leaf for all three), config.json
    equal on every key the reference writes but ``platforms``, a clean
    strict report of a captured graph; then the port-exported shipped
    artifact served from its directory, its Detections on the scenes equal
    to the committed artifact's bit for bit."""
    from unina_yolo_dla_torch.runtime.artifact import ServingArtifact
    from unina_yolo_dla_torch.utils.checkpoint import load_msgpack_raw

    out = {}
    for name, flags in EXPORT_FLAGS.items():
        d = tmp / name
        secs = run_export(["--weights", SOURCE, *flags, "--cp-calibration",
                           CP_CALIBRATION, "--output", d])
        ref = REPO / "artifacts" / name
        same_bytes = ((d / "variables.msgpack").read_bytes()
                      == (ref / "variables.msgpack").read_bytes())
        leaves = trees_equal(load_msgpack_raw(d / "variables.msgpack"),
                             load_msgpack_raw(ref / "variables.msgpack"))
        got, want = (json.loads((p / "config.json").read_text())
                     for p in (d, ref))
        differ = sorted(k for k in set(got) | set(want)
                        if k not in OWN_KEYS and got.get(k) != want.get(k))
        rep = json.loads((d / "fallback_report.json").read_text())
        assert leaves, f"{name}: exported variables differ"
        assert name != "serving_artifact" or same_bytes, (
            f"{name}: exported variables.msgpack differs in its bytes")
        assert not differ, f"{name}: config.json differs on {differ}"
        assert got["platforms"] == ["cuda"], got["platforms"]
        assert rep["captured"] and not rep["host_nodes"], rep
        out[name] = {"export_s": secs, "bytes_equal": same_bytes,
                     "leaves_equal": leaves, "config_keys_differ": differ,
                     "report": {k: rep[k] for k in (
                         "host_nodes", "kernel_nodes", "port_kernels",
                         "output_bytes", "captured")}}
    mine = ServingArtifact(tmp / "serving_artifact")
    equal = []
    for frame in scenes:
        with torch.inference_mode():
            got = [f.clone() for f in mine(frame)]
        equal.append(_same(got, art_g(frame)))
    assert all(equal), f"port-exported artifact differs: {equal}"
    out["served_bit_equal_vs_committed"] = equal
    del mine
    return out


def check_wide_kernels(model, serve, frame, unfused, torch) -> list[dict]:
    """Each fused module of the bf16 fc engine (seven C3k2s, three heads,
    at 64, 128 and 256 channels) on the activations and weights of one
    served frame: its kernel against its plain version on the card, |err|
    <= 1e-2 (1 + |ref|); its time by CUDA events and inside a replayed
    graph, the plain version's, its bound, its launch's grid as the
    library recorded it, and inside a replayed graph the same block of
    ``unfused`` (the bf16_s2dm_mh model: cuDNN convolutions) on the same
    activations."""
    from unina_yolo_dla_torch.ops.cuda import c3k2_kernel, head_kernel
    from unina_yolo_dla_torch.quant.qtensor import QTensor

    bf = torch.bfloat16
    mods = {path: model.get_submodule(path)
            for paths in FC_MODULES.values() for path in paths}
    caps = {}

    def keep(path):
        def hook(_module, args, kwargs):
            caps[path] = (args, kwargs)
        return hook

    hooks = [m.register_forward_pre_hook(keep(p), with_kwargs=True)
             for p, m in mods.items()]
    try:
        serve(frame)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()

    def dev(t):
        t = t.dequant(bf) if isinstance(t, QTensor) else t
        return t.to(bf).contiguous()

    def size(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    rows = []
    for kernel, paths in FC_MODULES.items():
        for path in paths:
            mod = mods[path]
            args, kwargs = caps[path]
            ws = [getattr(mod, n) for n in mod._FUSED]
            if kernel == "fused_head":
                x = dev(args[0])
                px = x.shape[1] * x.shape[2]
                npred = ws[4].shape[1] + ws[10].shape[1]
                nbytes = 2 * x.numel() + 4 * px * npred + size(ws)
                macs = px * sum(ws[i].numel() for i in (0, 2, 4, 6, 8, 10))
                shape = dict(x=list(x.shape), c=x.shape[-1])

                def fn(x=x, ws=ws, mod=mod):
                    return head_kernel.fused_head(x, *ws, w33=mod.w33)

                def plain(x=x, ws=ws):
                    return head_kernel.fused_head_plain(x, *ws)
            else:
                _, _, wb1, _, wb2, *_ = ws
                tail = (wb1[0].numel() * len(wb1) + wb2[0].numel() * len(wb2)
                        + ws[8].numel())
                if kernel == "fused_c3k2":
                    x = dev(args[0])
                    px = x.shape[1] * x.shape[2]
                    nbytes = 2 * x.numel() + 2 * px * ws[8].shape[1] + size(
                        ws)
                    macs = px * 2 * ws[0].numel() + px * tail
                    shape = dict(x=list(x.shape))

                    def fn(x=x, ws=ws, mod=mod):
                        return c3k2_kernel.fused_c3k2(
                            x, *ws, shortcut=mod.shortcut, wpk=mod.wpk)

                    def plain(x=x, ws=ws, mod=mod):
                        return c3k2_kernel.fused_c3k2_plain(
                            x, *ws, shortcut=mod.shortcut)
                else:
                    xa, xb = dev(args[0]), dev(kwargs["x2"])
                    up = kwargs.get("up_x", False)
                    pa = xa.shape[1] * xa.shape[2]
                    pb = xb.shape[1] * xb.shape[2]
                    nbytes = 2 * (xa.numel() + xb.numel()
                                  + pb * ws[8].shape[1]) + size(ws)
                    macs = (2 * ws[0].shape[1] * (pa * xa.shape[-1]
                                                  + pb * xb.shape[-1])
                            + pb * tail)
                    shape = dict(xa=list(xa.shape), xb=list(xb.shape),
                                 up_a=up)

                    def fn(xa=xa, xb=xb, ws=ws, mod=mod, up=up):
                        return c3k2_kernel.fused_c3k2_cat(
                            xa, xb, *ws, shortcut=mod.shortcut, up_a=up,
                            wpk=mod.wpk)

                    def plain(xa=xa, xb=xb, ws=ws, mod=mod, up=up):
                        return c3k2_kernel.fused_c3k2_cat_plain(
                            xa, xb, *ws, shortcut=mod.shortcut, up_a=up)
                shape.update(hidden=ws[0].shape[1], f=ws[8].shape[1],
                             n=len(wb1))
            outs = fn()
            # the shape the launch used, as the library recorded it
            launch = (head_kernel if kernel == "fused_head"
                      else c3k2_kernel).last_launch()
            wants = plain()
            torch.cuda.synchronize()
            outs = outs if isinstance(outs, tuple) else (outs,)
            wants = wants if isinstance(wants, tuple) else (wants,)
            err = rel = 0.0
            for g, w in zip(outs, wants):
                g, w = g.float(), w.float()
                err = max(err, float((g - w).abs().max()))
                rel = max(rel, float(((g - w).abs() / (1 + w.abs())).max()))
            assert rel <= 1e-2, (
                f"{path} ({kernel}): max |err|/(1+|ref|) {rel} > 1e-2")
            b_ms, b_by = bound(nbytes, 2 * macs, BF16_FLOPS)
            mh = unfused.get_submodule(path)
            assert not getattr(mh, "fused", False), f"{path}: mh is fused"

            def unfused_fn(mh=mh, args=args, kwargs=kwargs):
                return mh(*args, **kwargs)

            rows.append(dict(
                block=path, kernel=kernel, **shape,
                form="tiled wgmma" if mod_is_narrow(kernel, ws) else
                "wide wgmma", grid=launch,
                max_abs_err=err, max_rel_err=rel,
                ms=cuda_ms(fn, 50), graph_ms=graph_ms(fn, 10, 5),
                unfused_ms=graph_ms(unfused_fn, 10, 5),
                plain_ms=cuda_ms(plain, 5, 2), bound_ms=b_ms, bound_by=b_by,
                library_ms=None))
            log(json.dumps(rows[-1]))
    return rows


def mod_is_narrow(kernel: str, ws) -> bool:
    """Whether these weights go to the tiled (64-wide) kernel."""
    if kernel == "fused_head":
        return ws[0].shape[-1] == 64
    return ws[0].shape[1] == 32 and ws[8].shape[1] == 64


def drive_bf16(name: str, ckpt: Path, tmp: Path, rgb, labels, scenes,
               kernels, torch) -> dict:
    """One bf16 engine exported from the float checkpoint by the port's
    export on the card, then served from its directory: eager FRAMES
    frames against the port's CPU path (0.5 px, 1e-2), profiled; then as
    one captured graph (``drive_graph``: clean strict report, each kernel
    among the nodes as often as a frame launches it, replay bit for bit
    the eager frame on the scenes), profiled."""
    from unina_yolo_dla_torch.runtime.artifact import ServingArtifact

    d = tmp / name
    secs = run_export(["--weights", ckpt, *BF16_FLAGS[name],
                       "--cp-calibration", CP_CALIBRATION, "--output", d])
    conf = json.loads((d / "config.json").read_text())
    assert not conf["quantized"], conf
    eager = ServingArtifact(d, graph=False)
    cpu = ServingArtifact(d, device="cpu")(rgb)
    e2e = drive(eager, rgb, labels, kernels, PER_FRAME[name], cpu, torch)
    prof = profile_calls(eager, rgb, torch)

    def capture():
        owner = ServingArtifact(d)
        return owner, owner.graph

    owner, graph, g = drive_graph(capture, lambda a, f: a(f), eager, scenes,
                                  kernels, PER_FRAME[name], 25600, torch,
                                  copies=True)
    prof_g = profile_calls(owner, rgb, torch)
    return {"dir": d, "export_s": secs, "config": conf, "eager": eager,
            "e2e": e2e, "profile": prof, "graph": g, "profile_graph": prof_g,
            "graph_owner": owner}


def _bgra(rgb):
    return np.ascontiguousarray(np.concatenate(
        [rgb[..., ::-1], np.full(rgb.shape[:2] + (1,), 255, np.uint8)],
        axis=-1))


def native_records(kernels, per_call, artifact, frames, width, height,
                   channels, wants, wrong=None) -> dict:
    """The native CUDA executor (``runtime/native``, through its C ABI) on
    one artifact. Counters set to 0 before its configure and read after
    show each of the path's kernels captured into its graph (once per
    warm-up call and once in the capture); at depth 1 (``infer``) and at
    depth 2 (every frame submitted, then collected in order) its records
    equal ``wants`` byte for byte; ``wrong`` geometries get the sentinel;
    counters set to 0 before the frames and read after show no launch from
    Python. At ``channels`` 3 each frame's BGRA form is served too."""
    from unina_yolo_dla_torch.runtime import aot
    from unina_yolo_dla_torch.runtime.native import capi

    _zero(kernels)
    t = time.perf_counter()
    ex = capi.Executor("cuda", str(artifact))
    configure_s = time.perf_counter() - t
    launches = _read(kernels)
    for name, per in per_call.items():
        assert launches[name] == (aot.WARMUP + 1) * per, (name, launches)
    assert ex.depth == 2, ex.depth
    _zero(kernels)
    times = []
    for frame, want in zip(frames, wants):
        t = time.perf_counter()
        got = ex.infer(frame, width, height, channels)
        times.append((time.perf_counter() - t) * 1e3)
        assert got == want, f"{artifact.name}: depth-1 records differ"
        if channels == 3:   # the same scene as the ring's BGRA bytes
            assert ex.infer(_bgra(frame), width, height, 4) == want, (
                f"{artifact.name}: BGRA records differ")
    for frame in frames:
        assert ex.submit(frame, width, height, channels)
    depth2 = [ex.collect() for _ in frames]
    assert depth2 == wants, f"{artifact.name}: depth-2 records differ"
    # throughput at depth 2: a window of two frames in flight, as the host
    # keeps it, over the frames three times
    t, pending = time.perf_counter(), 0
    for _ in range(3):
        for frame in frames:
            assert ex.submit(frame, width, height, channels)
            pending += 1
            if pending == 2:
                ex.collect()
                pending -= 1
    ex.collect()
    depth2_ms = (time.perf_counter() - t) * 1e3 / (3 * len(frames))
    for frame, w, h, ch in wrong or ():
        assert ex.infer(frame, w, h, ch) == capi.SENTINEL, (w, h, ch)
    frame_launches = _read(kernels)
    assert not any(frame_launches.values()), frame_launches
    ex.close()
    return {"frames": len(frames), "configure_s": configure_s,
            "depth1_ms_median": float(np.median(times)),
            "depth2_ms_per_frame": depth2_ms, "depth1_equal": True, "depth2_equal": True,
            "sentinel_ok": bool(wrong), "launches_in_configure": launches,
            "launches_in_frames": frame_launches,
            "counts": [int.from_bytes(b[:4], "little") for b in wants]}


def run_host(native, kind: str, pipeline, tmp: Path, execute) -> dict:
    """``ring_tool produce`` (640x640 RGB, 4 slots, PRODUCER_FPS) feeding
    ``perception_host --executor kind [--pipeline N] --max-frames
    HOST_FRAMES``; the out block's records against ``execute`` (the
    card's ``make_executor``) on the regenerated frame of its
    ``result_seq``. The producer starts first (the host waits for its
    ring), and is stopped once the host has exited."""
    import struct

    from unina_yolo_dla_torch.runtime.native import build

    tag = f"{kind}{pipeline or ''}"
    ring, out = tmp / f"{tag}.ring", tmp / f"{tag}.out"
    env = build.host_env()
    env.pop("UNINA_FORCE_CPU", None)
    producer = subprocess.Popen(
        [str(native / build.RING_TOOL), "produce", "--ring", str(ring),
         "--width", "640", "--height", "640", "--frames",
         str(PRODUCER_FRAMES), "--fps", str(PRODUCER_FPS), "--slots", "4"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    cmd = [str(native / build.HOST), "--artifact", str(ARTIFACT), "--ring",
           str(ring), "--out", str(out), "--input", "640", "--classes", "4",
           "--executor", kind, "--max-frames", str(HOST_FRAMES)]
    if pipeline:
        cmd += ["--pipeline", str(pipeline)]
    t = time.perf_counter()
    try:
        host = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=300)
    finally:
        producer.terminate()
        producer.wait(timeout=30)
    wall_s = time.perf_counter() - t
    logdir = REPO / "chiprun_out"
    logdir.mkdir(exist_ok=True)
    (logdir / f"native_host_{tag}.log").write_text(host.stderr)
    assert host.returncode == 0, f"host {tag} failed:\n{host.stderr[-4000:]}"
    m = SHUTDOWN.search(host.stderr)
    assert m, host.stderr[-2000:]
    frames, dropped, torn, geom = (int(x) for x in m.groups()[:4])
    p50, p90, p99, fps = (float(x) for x in m.groups()[4:8])
    depth = int(m.group(9))
    assert frames == HOST_FRAMES and geom == 0, m.group(0)
    assert depth == (pipeline or (2 if kind == "cuda" else 1)), m.group(0)
    assert fps < PRODUCER_FPS, f"host {tag} outran the producer: {fps}"
    raw = out.read_bytes()
    _, seq, count = struct.unpack_from("<QQI", raw, 0)
    frame = np.full((640, 640, 3), (seq - 1) * 37 % 256, np.uint8)
    want = execute(memoryview(frame.tobytes()), 640, 640, 3)
    got = struct.pack("<I", count) + raw[32:32 + 24 * count]
    assert got == want, f"host {tag}: result of seq {seq} differs"
    return {"executor": kind, "pipeline": depth, "frames": frames,
            "dropped": dropped, "torn": torn, "p50_ms": p50, "p90_ms": p90,
            "p99_ms": p99, "fps": fps, "wall_s": wall_s,
            "result_seq": seq, "result_count": count,
            "result_equal_make_executor": True,
            "configured": "[perception_host] configured" in host.stderr}


def drive_native(kernels, scenes, ship_blobs, cam_frames, cam_blobs,
                 fc_dir: Path, tmp: Path, smi: str) -> dict:
    """Phase 16: build the native host, hold the CUDA executor's records
    against the Python entry points on the shipped, camera and bf16 fc
    artifacts, then serve the ring through the binary with each
    executor."""
    from unina_yolo_dla_torch.runtime.artifact import ServingArtifact
    from unina_yolo_dla_torch.runtime.embed import make_executor, pack_records
    from unina_yolo_dla_torch.runtime.native import build

    t = time.perf_counter()
    native = build.build()
    build_s = time.perf_counter() - t
    log(f"native host build: {build_s:.1f} s ({native})")
    h, w = CAMERA_SHAPE
    ship = native_records(
        kernels, PER_FRAME["shipped"], ARTIFACT, scenes, 640, 640, 3,
        ship_blobs, wrong=[(scenes[0], 640, 320, 3), (scenes[0], 640, 640, 2)])
    cam = native_records(
        kernels, PER_FRAME["camera"], ARTIFACT_CAM, cam_frames, w, h, 4,
        cam_blobs, wrong=[(cam_frames[0], w, h, 3), (cam_frames[0], w, h, 0),
                          (cam_frames[0], 640, 640, 4)])
    fc_art = ServingArtifact(fc_dir)
    fc_wants = [pack_records(fc_art.packed(s)) for s in scenes]
    del fc_art
    fc = native_records(kernels, PER_FRAME["bf16_s2dm_fc"], fc_dir, scenes,
                        640, 640, 3, fc_wants)
    execute = make_executor(str(ARTIFACT))
    runs = [run_host(native, kind, pipeline, tmp, execute)
            for kind, pipeline in HOST_RUNS]
    return {"card": smi, "build_s": build_s, "records": {
        "shipped": ship, "camera": cam, "bf16_s2dm_fc": fc},
        "producer": {"fps": PRODUCER_FPS, "frames": PRODUCER_FRAMES,
                     "geometry": "640x640 rgb", "slots": 4},
        "host_runs": runs}


def train_batch(seeds, size: int = 640) -> dict:
    """Synthetic scenes as a training batch (numpy): uint8 RGB images, the
    YOLO labels as xyxy pixels padded to TRAIN_MAX_BOXES with a mask. The
    dataset loader (``data/dataset.py`` ``YoloDataset``) is ROADMAP Queue A
    item 9; until then the batch is built here."""
    from unina_yolo_dla_torch.data.synthetic import SynthConfig, \
        generate_image

    n = len(seeds)
    images = np.empty((n, size, size, 3), np.uint8)
    boxes = np.zeros((n, TRAIN_MAX_BOXES, 4), np.float32)
    labels = np.zeros((n, TRAIN_MAX_BOXES), np.int32)
    mask = np.zeros((n, TRAIN_MAX_BOXES), bool)
    for i, seed in enumerate(seeds):
        bgr, lab = generate_image(np.random.default_rng(seed),
                                  SynthConfig(image_size=size, seed=seed))
        images[i] = bgr[..., ::-1]
        for j, (c, cx, cy, w, h) in enumerate(lab[:TRAIN_MAX_BOXES]):
            boxes[i, j] = np.array([cx - w / 2, cy - h / 2, cx + w / 2,
                                    cy + h / 2], np.float32) * size
            labels[i, j], mask[i, j] = c, True
    return {"images": images, "boxes": boxes, "labels": labels,
            "mask": mask}


def _to(batch: dict, device, torch) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _aux(aux) -> dict:
    return {k: float(v) for k, v in aux.items()}


def run_steps(step, state, batch, n: int, torch):
    """``n`` train steps, each timed on the host clock to its end
    (synchronised); -> (state, per-step aux, per-step ms)."""
    auxes, ms = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, aux = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        auxes.append(aux)
    return state, [_aux(a) for a in auxes], ms


def step_breakdown(model, cfg, tx, tc, state, batch, torch,
                   reps: int = 3) -> dict:
    """The FP32 train step's stages run one after another as
    ``make_train_step`` runs them, each segment timed by CUDA events on the
    stream (median of ``reps``): normalize, forward (train mode), loss
    (assigner included), backward, optimiser, EMA. A segment includes any
    time the card waits for the host to launch it."""
    from torch.func import functional_call

    from unina_yolo_dla_torch.ops.preprocess import ensure_normalized
    from unina_yolo_dla_torch.train.losses import detection_loss
    from unina_yolo_dla_torch.train.trainer import ema_update

    names = ("normalize", "forward", "loss", "backward", "optimizer", "ema")
    runs = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        torch.cuda.synchronize()
        model.train()
        params = {k: p.detach().requires_grad_()
                  for k, p in state.params.items()}
        stats = {k: v.clone() for k, v in state.batch_stats.items()}
        ev[0].record()
        x = ensure_normalized(batch["images"])
        ev[1].record()
        outs = functional_call(model, {**params, **stats}, (x,))
        ev[2].record()
        loss, _ = detection_loss(outs, batch["boxes"], batch["labels"],
                                 batch["mask"], cfg)
        ev[3].record()
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        ev[4].record()
        with torch.no_grad():
            upd, _ = tx.update(grads, state.opt_state, state.params)
            new = {k: state.params[k] + u for k, u in upd.items()}
            ev[5].record()
            ema_update(state.ema_params, new, state.step, tc.ema_decay)
        ev[6].record()
        torch.cuda.synchronize()
        runs.append([ev[i].elapsed_time(ev[i + 1]) for i in range(6)])
        del outs, loss, grads, upd, new
    med = np.median(np.array(runs), axis=0)
    return dict(zip(names, map(float, med)), total=float(med.sum()))


def _finite(auxes) -> bool:
    return all(np.isfinite(v) for a in auxes for v in a.values())


def drive_training(kernels, smi: str, rgb, art_g, tmp: Path, torch) -> dict:
    """Phase 17, the port's two-phase training at full width (base 32,
    640^2, bf16 compute) from ``artifacts/engine_source.msgpack``:

    a. FP32 phase: FP32_STEPS steps of a batch of 16 scenes (seeds 1-16),
       the trainer's recipe with the EMA (TrainConfig's 300 warmup steps
       need total_steps above 300, as optax does: warmup_steps=3, the
       train CLI's 3 epochs of one 16-image step); the launch counters set
       to 0 before and read after (one normalize launch a step);
    b. one float32 step (TF32 off) of 2 of the scenes on the card and on
       the port's CPU path from the same state;
    c. prepare_qat_variables (two passes, entropy) on 4 batches of 16,
       and the "max" method of the train CLI's default beside it;
    d. QAT_STEPS QAT steps from the committed quant collection (lr0 1e-3,
       warmup_steps 1, no EMA);
    e. the QAT state saved through CheckpointManager, reloaded with a
       template, exported as the shipped engine on the card and served on
       the seed-7 scene.

    Every gate asserts; the times stand beside ``smi``."""
    from unina_yolo_dla_torch.models.config import ModelConfig
    from unina_yolo_dla_torch.models.detector import (
        UninaYoloDla, from_jax_variables, variables_from_jax,
        to_jax_variables, variables_of)
    from unina_yolo_dla_torch.quant.calibrate import calibrate
    from unina_yolo_dla_torch.ops.cuda.preprocess_kernel import \
        normalize_plain
    from unina_yolo_dla_torch.ops.preprocess import ensure_normalized
    from unina_yolo_dla_torch.quant.qat import make_qat_model, \
        prepare_qat_variables
    from unina_yolo_dla_torch.runtime.artifact import ServingArtifact
    from unina_yolo_dla_torch.train.trainer import (
        TrainConfig, create_train_state, make_optimizer, make_train_step)
    from unina_yolo_dla_torch.utils.checkpoint import (
        CheckpointManager, load_msgpack_raw)

    dev = torch.device("cuda")
    src = load_msgpack_raw(SOURCE)
    fp = {k: src[k] for k in ("params", "batch_stats")}
    cfg = ModelConfig()
    t = time.perf_counter()
    batch_np = train_batch(range(1, TRAIN_BATCH + 1))
    batch = _to(batch_np, dev, torch)
    out = {"card": smi, "batch": list(batch_np["images"].shape),
           "batch_build_s": time.perf_counter() - t}

    # a. the FP32 phase
    model = from_jax_variables(fp, cfg)
    tc = TrainConfig(total_steps=FP32_STEPS, warmup_steps=3)
    tx = make_optimizer(tc)
    state = create_train_state(variables_of(model), tx, tc)
    step = make_train_step(model, cfg, tx, tc)
    stats0 = {k: v.clone() for k, v in state.batch_stats.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(kernels)
    state, auxes, ms = run_steps(step, state, batch, FP32_STEPS, torch)
    launches = _read(kernels)
    peak = torch.cuda.max_memory_allocated()
    assert launches["normalize"] == FP32_STEPS, launches
    assert not any(v for k, v in launches.items() if k != "normalize"), (
        launches)
    assert _finite(auxes), auxes
    assert all(torch.isfinite(p).all() for p in state.params.values())
    assert all(t.is_cuda for tree in (state.params, state.batch_stats,
                                      state.ema_params, batch)
               for t in tree.values()), "a training tensor left the card"
    moved = sum(not torch.equal(stats0[k], v)
                for k, v in state.batch_stats.items())
    assert moved == len(stats0), f"{moved} of {len(stats0)} stats moved"
    med = float(np.median(ms[2:]))
    out["fp32"] = {
        "steps": FP32_STEPS, "train_config": {
            "total_steps": tc.total_steps, "warmup_steps": tc.warmup_steps,
            "lr0": tc.lr0, "optimizer": tc.optimizer,
            "use_ema": tc.use_ema},
        "step_ms": ms, "step_ms_median_3_10": med,
        "images_per_s": TRAIN_BATCH / med * 1e3,
        "peak_allocated_bytes": peak, "launches": launches,
        "batch_stats_moved": moved, "per_step": auxes}
    # where the step's time goes: its stages by CUDA events, and three
    # steps under the profiler (device busy, idle share, top kernels)
    out["fp32"]["stages_ms"] = step_breakdown(model, cfg, tx, tc, state,
                                              batch, torch)
    out["fp32"]["profile"] = profile_calls(
        lambda b: step(state, b), batch, torch, calls=3, unit="train step")
    print(json.dumps({"train_fp32": out["fp32"], "card": smi}), flush=True)

    # the normalize kernel's float32 form on the training batch, against
    # its plain formula on the port's CPU path, bit for bit
    images = batch["images"]
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    got = ensure_normalized(images)
    want = normalize_plain(batch["images"].cpu(), mean, std)
    err = float((got.cpu() - want).abs().max())
    assert torch.equal(got.cpu(), want), f"normalize differs by {err}"
    from unina_yolo_dla_torch.ops.cuda.preprocess_kernel import normalize
    nbytes = images.numel() * (1 + 4)
    b_ms, b_by = bound(nbytes, 3 * images.numel(), F32_FLOPS)
    out["normalize"] = {
        "launches": launches["normalize"], "shape": list(images.shape),
        "out_dtype": "float32", "max_abs_err": err,
        "ms": cuda_ms(lambda: normalize(images, out_dtype=torch.float32),
                      20),
        "plain_ms": cuda_ms(lambda: normalize_plain(images, mean, std), 20),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    del got, want

    # b. the card against the port's CPU path: one float32 step, 2 scenes
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    tc32 = TrainConfig(total_steps=FP32_STEPS, warmup_steps=3)
    two = {k: v[:2] for k, v in batch_np.items()}
    pair = {}
    for where in ("cuda", "cpu"):
        m = from_jax_variables(fp, cfg32, where)
        tx32 = make_optimizer(tc32)
        st = create_train_state(variables_of(m), tx32, tc32)
        t = time.perf_counter()
        _, aux = make_train_step(m, cfg32, tx32, tc32)(
            st, _to(two, where, torch))
        pair[where] = dict(_aux(aux), s=time.perf_counter() - t)
        del m, st
    gap = {k: abs(pair["cuda"][k] - pair["cpu"][k]) / abs(pair["cpu"][k])
           for k in ("loss", "cls_loss", "box_loss", "grad_norm")}
    assert pair["cuda"]["num_fg"] == pair["cpu"]["num_fg"], pair
    assert gap["loss"] <= 1e-3 and gap["grad_norm"] <= 1e-2, gap
    out["card_vs_cpu"] = {"card": pair["cuda"], "cpu": pair["cpu"],
                          "relative_gap": gap}
    print(json.dumps({"train_card_vs_cpu": out["card_vs_cpu"]}), flush=True)

    # c. calibration of the FP32 phase's result (EMA params)
    calib = [_to(train_batch(range(1 + i * TRAIN_BATCH,
                                   1 + (i + 1) * TRAIN_BATCH)), dev, torch)
             for i in range(CALIB_BATCHES)]
    fp_vars = {"params": state.ema_params, "batch_stats": state.batch_stats}
    _zero(kernels)
    t = time.perf_counter()
    _, qvars = prepare_qat_variables(model, fp_vars, lambda: iter(calib),
                                     min_images=CALIB_BATCHES * TRAIN_BATCH)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t
    calib_launches = _read(kernels)
    new_q = to_jax_variables({"quant": qvars["quant"]})["quant"]
    ref_q = dict(_leaves(src["quant"]))
    got_q = dict(_leaves(new_q))
    assert sorted(got_q) == sorted(ref_q), "calibrated keys differ"
    assert all(float(v) > 0 for v in got_q.values())
    assert calib_launches["normalize"] == 2 * CALIB_BATCHES, calib_launches
    # the train CLI's default method, "max" (the committed collection's
    # amaxes are running maxima of bf16 activations): one pass
    t = time.perf_counter()
    max_q = dict(_leaves(calibrate(
        UninaYoloDla(None, cfg.with_quant("calib_max")).to(dev), fp_vars,
        lambda: iter(calib), method="max",
        min_images=CALIB_BATCHES * TRAIN_BATCH)))
    max_s = time.perf_counter() - t

    def ratios(q):
        r = [float(q[k]) / float(ref_q[k]) for k in ref_q]
        return {"median": float(np.median(r)), "min": min(r), "max": max(r)}

    out["calibration"] = {
        "images": CALIB_BATCHES * TRAIN_BATCH, "quantisers": len(got_q),
        "entropy_seconds": calib_s, "launches": calib_launches,
        "entropy_ratio_to_committed": ratios(got_q),
        "max_seconds": max_s, "max_ratio_to_committed": ratios(max_q)}
    print(json.dumps({"train_calibration": out["calibration"]}), flush=True)
    del calib, model, state, step, qvars

    # d. QAT from the committed quant collection
    qtrees = variables_from_jax(src, dev)
    quant = {"quant": qtrees["quant"]}
    qmodel = make_qat_model(cfg)
    qtc = TrainConfig(lr0=1e-3, warmup_steps=1, use_ema=False)
    qtx = make_optimizer(qtc)
    qstate = create_train_state(qtrees, qtx, qtc)
    qstep = make_train_step(qmodel, qmodel.config, qtx, qtc,
                            extra_variables=quant)
    _zero(kernels)
    qstate, qaux, qms = run_steps(qstep, qstate, batch, QAT_STEPS, torch)
    qlaunch = _read(kernels)
    assert _finite(qaux), qaux
    assert qlaunch["normalize"] == QAT_STEPS, qlaunch
    qmed = float(np.median(qms[1:]))
    out["qat"] = {"steps": QAT_STEPS, "step_ms": qms,
                  "step_ms_median_2_5": qmed,
                  "images_per_s": TRAIN_BATCH / qmed * 1e3,
                  "qat_over_fp32_step_time": qmed / med,
                  "launches": qlaunch, "per_step": qaux}
    print(json.dumps({"train_qat": out["qat"], "card": smi}), flush=True)

    # e. the hand-off: checkpoint, reload, export, serve
    tree = to_jax_variables({"params": qstate.params,
                             "batch_stats": qstate.batch_stats,
                             "quant": quant["quant"]})
    mgr = CheckpointManager(tmp / "qat_checkpoints")
    path = mgr.save(QAT_STEPS, tree)
    assert trees_equal(tree, mgr.load_last(tree)), "reloaded tree differs"
    art_dir = tmp / "qat_serving_artifact"
    export_s = run_export(["--weights", path,
                           *EXPORT_FLAGS["serving_artifact"],
                           "--cp-calibration", CP_CALIBRATION,
                           "--output", art_dir])
    rep = json.loads((art_dir / "fallback_report.json").read_text())
    assert rep["captured"] and not rep["host_nodes"], rep
    art = ServingArtifact(art_dir)
    count = int(art(rgb).count)
    shipped = int(art_g(rgb).count)
    out["handoff"] = {"checkpoint": path.name, "reload_bit_equal": True,
                      "export_s": export_s, "report": {k: rep[k] for k in (
                          "host_nodes", "kernel_nodes", "port_kernels",
                          "captured")},
                      "seed7_detections": count,
                      "shipped_seed7_detections": shipped}
    print(json.dumps({"train_handoff": out["handoff"]}), flush=True)
    del art, qmodel, qstate, qstep
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from unina_yolo_dla_torch.data.synthetic import SynthConfig, generate_image
    from unina_yolo_dla_torch.models.config import ModelConfig
    from unina_yolo_dla_torch.models.detector import from_jax_variables
    from unina_yolo_dla_torch.ops.cuda import (
        _lib, c3k2_kernel, camera_kernel, decode_kernel, head_kernel,
        nms_kernel, preprocess_kernel, stage1_kernel, stem_kernel)
    from unina_yolo_dla_torch.quant.fake_quant import PERF_EXCLUDE, QuantSpec
    from unina_yolo_dla_torch.runtime import aot
    from unina_yolo_dla_torch.runtime.artifact import ServingArtifact
    from unina_yolo_dla_torch.runtime.pipeline import build_serving_fn
    from unina_yolo_dla_torch.utils.checkpoint import (
        load_msgpack_raw,
        save_msgpack,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)

    # phase 1: build
    t0 = time.perf_counter()
    _lib.library()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.1f} s")
    for logf in sorted(_lib.BUILD_DIR.glob("*.log")):
        log(f"--- {logf.name}\n{logf.read_text().strip()}")

    kernels = {"normalize": preprocess_kernel.KERNEL,
               "fused_stem_stage1": stem_kernel.KERNEL,
               "decode_topk": decode_kernel.KERNEL,
               "nms": nms_kernel.KERNEL,
               "stage1_merged": stage1_kernel.KERNEL,
               "fused_c3k2": c3k2_kernel.KERNEL,
               "fused_c3k2_cat": c3k2_kernel.KERNEL_CAT,
               "fused_head": head_kernel.KERNEL,
               "camera": camera_kernel.KERNEL}
    # the shipped engine, and the fc engine from the same weights through
    # the entry points (both on cuda), eager: each launch counted
    art = ServingArtifact(ARTIFACT, graph=False)
    c = art.config
    serve_kw = dict(conf_threshold=c["conf_threshold"],
                    iou_threshold=c["iou_threshold"],
                    q_factor=c["q_factor"],
                    max_detections=c["max_detections"])
    fc_cfg = ModelConfig(
        quant=QuantSpec("int8_fused", exclude=PERF_EXCLUDE), deploy=True,
        stem_s2d=True, s2d_host=True, stage1_s2d=True, s2d_merged=True,
        fused_c3k2=True, fused_head=True)
    variables = load_msgpack_raw(ARTIFACT / "variables.msgpack")
    fc_model = from_jax_variables(variables, fc_cfg)
    fc_serve = build_serving_fn(fc_model, fc_cfg, **serve_kw)

    img, labels = generate_image(np.random.default_rng(7),
                                 SynthConfig(image_size=640, seed=7))
    rgb = np.ascontiguousarray(img[..., ::-1])
    scenes, scene_labels = [], []
    for seed in SCENE_SEEDS:
        im, lb = generate_image(np.random.default_rng(seed),
                                SynthConfig(image_size=640, seed=seed))
        scenes.append(np.ascontiguousarray(im[..., ::-1]))
        scene_labels.append(lb)
    scenes = np.stack(scenes)
    # the camera artifact's frames: synthetic 1080x1920 scenes as the ring
    # delivers them, BGRA (seed 7 against the CPU path, seeds 1-8 for
    # replay against eager)
    def camera_scene(seed):
        bgr, lb = generate_image(np.random.default_rng(seed), SynthConfig(
            image_size=CAMERA_SHAPE[0], image_width=CAMERA_SHAPE[1],
            seed=seed))
        return np.concatenate([bgr, np.full((*CAMERA_SHAPE, 1), 255,
                                            np.uint8)], axis=-1), lb

    cam7, cam_labels = camera_scene(7)
    cam_scenes = [camera_scene(seed)[0] for seed in SCENE_SEEDS]
    art_cam = ServingArtifact(ARTIFACT_CAM, graph=False)

    # phase 2: each kernel against its plain version on the card
    floor = launch_floor(torch)
    print(json.dumps({"launch_floor": floor}), flush=True)
    rows = [dict(r, path="shipped")
            for r in check_kernels(art, rgb, scenes, torch)]
    rows += [dict(r, path="int8_s2dm_fc") for r in check_fc_kernels(
        fc_model, fc_serve, art.stage(rgb), torch)]
    rows.append(dict(check_camera_kernel(art_cam, cam7, torch),
                     path="camera"))
    ragged = check_ragged(torch)
    log(json.dumps({"ragged_max_rel_err": ragged}))
    lib_path = _lib.build()
    for row in rows:
        if row["name"] in MMA_KERNELS:
            row["ragged_max_rel_err"] = ragged[row["name"]]
            row["mma"] = mma_route(lib_path, DEVICE_FUNCS[row["name"]][0],
                                   REPO / row["source"])
            assert row["mma"] == "wgmma", (
                f"{row['name']}: issues {row['mma']}, not wgmma")

    # phase 3: end to end, batch 1, the committed engine
    cpu_dets = ServingArtifact(ARTIFACT, device="cpu")(rgb)
    e2e = drive(art, rgb, labels, kernels, PER_FRAME["shipped"], cpu_dets,
                torch)
    print(json.dumps({"end_to_end": e2e}), flush=True)

    # phase 4: where the frame's time goes (profiler over a few frames)
    prof = profile_calls(art, rgb, torch)
    log(json.dumps({"profile": prof}, indent=1))

    # phase 5: end to end, batch 1, the fc engine
    cpu_fc = build_serving_fn(from_jax_variables(variables, fc_cfg, "cpu"),
                              fc_cfg, **serve_kw)
    cpu_dets = cpu_fc(art.stage(rgb).cpu())

    def serve_fc(frame):
        return fc_serve(art.stage(frame))

    e2e_fc = drive(serve_fc, rgb, labels, kernels, PER_FRAME["int8_s2dm_fc"],
                   cpu_dets, torch)
    print(json.dumps({"end_to_end_fc": e2e_fc}), flush=True)

    # phase 6: the fc engine's frame under the profiler
    prof_fc = profile_calls(serve_fc, rgb, torch)
    log(json.dumps({"profile_fc": prof_fc}, indent=1))

    # phase 7: the batch-8 artifact, 8 scenes in one call, against the
    # card's batch-1 path and the port's CPU batch path on the same frames
    art8 = ServingArtifact(ARTIFACT_B8, graph=False)
    b1_dets = [art(frame) for frame in scenes]
    cpu8 = ServingArtifact(ARTIFACT_B8, device="cpu")(scenes)
    e2e_b8 = drive_batch(art8, scenes, scene_labels, kernels,
                         PER_FRAME["b8"], b1_dets, cpu8, torch)

    # phase 8: the batch under the profiler
    prof_b8 = profile_calls(art8, scenes, torch, unit="batch of 8")
    log(json.dumps({"profile_b8": prof_b8}, indent=1))
    print(json.dumps({"batch8": {
        k: e2e_b8[k] for k in ("batch_ms_median", "batch_ms_min",
                               "frames_per_s", "valid",
                               "max_gap_vs_card_batch1",
                               "max_gap_vs_cpu_batch")} | {
        k: prof_b8[k] for k in ("wall_ms_per_call", "device_busy_ms_per_call",
                                "device_idle_share", "kernels_per_call")}}),
        flush=True)

    # phase 8b: the camera artifact, eager: the raw 1080x1920 BGRA frame
    # through the camera, stage1, decode and NMS kernels, against the port's
    # CPU path on the seed-7 scene; then under the profiler
    cpu_cam = ServingArtifact(ARTIFACT_CAM, device="cpu")(cam7)
    e2e_cam = drive(art_cam, cam7, cam_labels, kernels, PER_FRAME["camera"],
                    cpu_cam, torch, box_tol=1.5)
    print(json.dumps({"end_to_end_camera": e2e_cam}), flush=True)
    prof_cam = profile_calls(art_cam, cam7, torch)
    log(json.dumps({"profile_camera": prof_cam}, indent=1))

    # phases 9-11: the four paths again, each one captured CUDA graph
    # replayed per call; the result sizes are the reference artifacts' own
    out_bytes = {p.name: json.loads((p / "fallback_report.json").read_text(
    ))["output_bytes"] for p in (ARTIFACT, ARTIFACT_B8, ARTIFACT_CAM)}

    def artifact_graph(path):
        owner = ServingArtifact(path)
        return owner, owner.graph

    art_g, graph_ship, g_ship = drive_graph(
        lambda: artifact_graph(ARTIFACT), lambda a, f: a(f), art, scenes,
        kernels, PER_FRAME["shipped"], out_bytes[ARTIFACT.name], torch,
        copies=True)
    prof_g = profile_calls(art_g, rgb, torch)
    log(json.dumps({"graph_shipped": g_ship, "profile": prof_g}, indent=1))

    def fc_capture():
        cap = aot.capture_serving_fn(fc_serve, art.staged_shape, art.device)
        return cap, cap

    fc_g, graph_fc, g_fc = drive_graph(
        fc_capture, lambda g, f: g(art.stage(f)), serve_fc, scenes, kernels,
        PER_FRAME["int8_s2dm_fc"], out_bytes[ARTIFACT.name], torch,
        copies=False)
    prof_gfc = profile_calls(lambda f: fc_g(art.stage(f)), rgb, torch)
    log(json.dumps({"graph_fc": g_fc, "profile": prof_gfc}, indent=1))

    art8_g, graph_b8, g_b8 = drive_graph(
        lambda: artifact_graph(ARTIFACT_B8), lambda a, f: a(f), art8,
        [scenes], kernels, PER_FRAME["b8"], out_bytes[ARTIFACT_B8.name],
        torch, copies=True, unit="batch of 8")
    prof_gb8 = profile_calls(art8_g, scenes, torch, unit="batch of 8")
    log(json.dumps({"graph_b8": g_b8, "profile": prof_gb8}, indent=1))
    cam_g, graph_cam, g_cam = drive_graph(
        lambda: artifact_graph(ARTIFACT_CAM), lambda a, f: a(f), art_cam,
        cam_scenes, kernels, PER_FRAME["camera"],
        out_bytes[ARTIFACT_CAM.name], torch, copies=True)
    prof_gcam = profile_calls(cam_g, cam7, torch)
    log(json.dumps({"graph_camera": g_cam, "profile": prof_gcam}, indent=1))
    # host staging alone: into the pinned buffer (blocked and merged; the
    # camera's raw frame, one copy)
    staging = {}
    for engine, owner, frames in (("shipped", art_g, rgb),
                                  ("int8_s2dm_fc", art_g, rgb),
                                  ("b8", art8_g, scenes),
                                  ("camera", cam_g, cam7)):
        pinned, times = owner._pinned.numpy(), []
        for _ in range(FRAMES):
            t = time.perf_counter()
            owner._host_stage(frames, out=pinned)
            times.append((time.perf_counter() - t) * 1e3)
        staging[engine] = float(np.median(times))
    graphs = {"shipped": (g_ship, prof_g, graph_ship),
              "int8_s2dm_fc": (g_fc, prof_gfc, graph_fc),
              "b8": (g_b8, prof_gb8, graph_b8),
              "camera": (g_cam, prof_gcam, graph_cam)}
    eager = {"shipped": (e2e, prof), "int8_s2dm_fc": (e2e_fc, prof_fc),
             "b8": (e2e_b8, prof_b8), "camera": (e2e_cam, prof_cam)}
    summary = {}
    for engine, (g, pr, _) in graphs.items():
        run, pe = eager[engine]
        med = "frame_ms_median" if engine != "b8" else "batch_ms_median"
        summary[engine] = {
            "eager_ms_median": run[med],
            "eager_ms_min": run[med.replace("median", "min")],
            "graph_ms_median": g["call_ms_median"],
            "graph_ms_min": g["call_ms_min"], "capture_s": g["capture_s"],
            "host_staging_ms": staging[engine],
            "eager_device_busy_ms": pe["device_busy_ms_per_call"],
            "graph_device_busy_ms": pr["device_busy_ms_per_call"],
            "eager_idle_share": pe["device_idle_share"],
            "graph_idle_share": pr["device_idle_share"],
            "eager_kernels_per_call": pe["kernels_per_call"],
            "graph_kernels_per_call": pr["kernels_per_call"],
            "graph_kernel_nodes": g["report"]["kernel_nodes"],
            "graph_nodes": g["report"]["nodes"]}
    print(json.dumps({"eager_vs_graph": summary}), flush=True)
    print(json.dumps({"camera": dict(
        summary["camera"], card=smi,
        graph_memsets=g_cam["report"]["memsets"],
        eager_memsets_per_call=prof_cam["memsets_per_call"])}), flush=True)
    del fc_g, art8_g

    # phase 12: the lifecycle server, phase 13: the executor entry, both
    # on the shipped artifact's graph
    server = drive_server(kernels, PER_FRAME["shipped"], scenes, art, torch)
    print(json.dumps({"server": {k: server[k] for k in (
        "configure_s", "count", "p50_ms", "p90_ms", "p99_ms", "mean_ms",
        "max_ms")}}), flush=True)
    executor = drive_executor(kernels, PER_FRAME["shipped"], scenes, torch)
    print(json.dumps({"executor": {k: executor[k] for k in (
        "bytes_per_frame", "frame_ms_median", "sentinel_ok")}}), flush=True)
    executor_cam = drive_camera_executor(kernels, PER_FRAME["camera"], cam_g,
                                         cam_scenes[:4], torch)
    ship_blobs, cam_blobs = executor.pop("blobs"), executor_cam.pop("blobs")
    print(json.dumps({"executor_camera": {k: executor_cam[k] for k in (
        "bytes_per_frame", "frame_ms_median", "sentinel_ok")}}), flush=True)
    del cam_g

    # phase 14: the port's export on the card, from the committed
    # calibrated checkpoint, with the three committed artifacts' flags;
    # the exported shipped artifact served against the committed one
    # phase 15: the bf16 engines, exported from the float checkpoint (the
    # committed one without quant and calib_meta, written by the port's
    # save_msgpack), served eager and as graphs; the fc engine's ten fused
    # modules at every width against their plain versions
    with tempfile.TemporaryDirectory() as tmpname:
        tmp = Path(tmpname)
        exported = drive_export(tmp, scenes, art_g, torch)
        print(json.dumps({"export": exported}), flush=True)
        ckpt = tmp / "float_checkpoint.msgpack"
        src = load_msgpack_raw(SOURCE)
        save_msgpack({k: v for k, v in src.items()
                      if k not in ("quant", "calib_meta")}, ckpt)
        bf16 = {name: drive_bf16(name, ckpt, tmp, rgb, labels, scenes,
                                 kernels, torch) for name in BF16_FLAGS}
        fc16 = bf16["bf16_s2dm_fc"]["eager"]
        wide_rows = check_wide_kernels(
            fc16.model, fc16._serve, fc16.stage(rgb),
            bf16["bf16_s2dm_mh"]["eager"].model, torch)
        # phase 16: the native host (its C++ staging and CUDA-graph
        # executor against the Python entry points on the shipped, camera
        # and bf16 fc artifacts; then the binary over the frame ring)
        native = drive_native(kernels, scenes, ship_blobs, cam_scenes[:4],
                              cam_blobs, bf16["bf16_s2dm_fc"]["dir"], tmp,
                              smi)
        print(json.dumps({"native_host": native}), flush=True)
        # phase 17: the two-phase training step at full width from the
        # committed checkpoint (FP32 steps, card against CPU, calibration,
        # QAT steps, checkpoint hand-off to the export)
        training = drive_training(kernels, smi, rgb, art_g, tmp, torch)
        for name, rec in bf16.items():
            rec.pop("eager"), rec.pop("graph_owner")
            rec["dir"] = str(rec["dir"])
    bf16_summary = {}
    for name, rec in bf16.items():
        e, g, pe, pg = (rec["e2e"], rec["graph"], rec["profile"],
                        rec["profile_graph"])
        bf16_summary[name] = {
            "export_s": rec["export_s"],
            "eager_ms_median": e["frame_ms_median"],
            "eager_ms_min": e["frame_ms_min"],
            "graph_ms_median": g["call_ms_median"],
            "graph_ms_min": g["call_ms_min"], "capture_s": g["capture_s"],
            "eager_device_busy_ms": pe["device_busy_ms_per_call"],
            "graph_device_busy_ms": pg["device_busy_ms_per_call"],
            "eager_idle_share": pe["device_idle_share"],
            "graph_idle_share": pg["device_idle_share"],
            "eager_kernels_per_call": pe["kernels_per_call"],
            "graph_kernels_per_call": pg["kernels_per_call"],
            "graph_kernel_nodes": g["report"]["kernel_nodes"],
            "graph_port_kernels": g["report"]["port_kernels"],
            "report_clean": not g["report"]["host_nodes"],
            "bit_equal_vs_eager": g["bit_equal_vs_eager"],
            "vs_cpu_port": e["vs_cpu_port"], "valid": e["valid"],
            "launches": {k: v for k, v in e["launches"].items() if v}}
    print(json.dumps({"bf16_engines": bf16_summary, "card": smi}),
          flush=True)

    runs = {"shipped": (e2e, prof), "int8_s2dm_fc": (e2e_fc, prof_fc),
            "b8": (e2e_b8, prof_b8), "camera": (e2e_cam, prof_cam)}
    profiles = [(engine, pr) for engine, (_, pr) in runs.items()] + [
        (f"{engine} graph", pr) for engine, (_, pr, _) in graphs.items()]
    for name, rec in bf16.items():
        profiles += [(name, rec["profile"]),
                     (f"{name} graph", rec["profile_graph"])]
    for label, pr in profiles:
        engine = label.split()[0]
        assert not pr["sort_kernels"], f"{label}: {pr['sort_kernels']}"
        for name, per in PER_FRAME[engine].items():
            dev_ms = pr["port_kernels_device_ms_per_call"][name]
            assert (dev_ms > 0) == (per > 0), (
                f"{label}: {name} has {dev_ms} ms of profiled device time "
                f"at {per} launches per call")
            # one wrapper call is one kernel on the card (the profiler may
            # miss the first kernel launched inside its window)
            calls = pr["port_kernels_calls_per_call"][name]
            assert per - 1 / pr["calls"] <= calls <= per, (
                f"{label}: {name} ran {calls} kernels per call at {per} "
                f"launches per call")
    for row in rows:
        run, pr = runs[row["path"]]
        g, pg, _ = graphs[row["path"]]
        row["launches"] = run["launches"][row["name"]]
        row["device_ms_per_frame"] = pr[
            "port_kernels_device_ms_per_call"][row["name"]]
        row["graph_nodes_per_frame"] = g["report"]["port_kernels"][
            row["name"]]
        row["graph_capture_launches"] = g["launches_in_capture"].get(
            row["name"], 0)
        row["graph_replay_launches"] = g["launches_in_replays"][row["name"]]
        row["graph_device_ms_per_frame"] = pg[
            "port_kernels_device_ms_per_call"][row["name"]]
        if row["name"] in FC_MODULES:
            fc_rec = bf16["bf16_s2dm_fc"]
            row["widths"] = [dict(
                block="int8_s2dm_fc " + {"fused_c3k2": "backbone.stage1_block",
                                         "fused_c3k2_cat": "neck.fpn_c3k2_2",
                                         "fused_head": "head_p2"}[row["name"]],
                form="tiled wgmma", ms=row["ms"], plain_ms=row["plain_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                max_abs_err=row["max_abs_err"], library_ms=None)] + [
                dict(w, block="bf16_s2dm_fc " + w["block"])
                for w in wide_rows if w["kernel"] == row["name"]]
            row["bf16_fc_launches"] = fc_rec["e2e"]["launches"][row["name"]]
            row["bf16_fc_graph_nodes_per_frame"] = fc_rec["graph"][
                "report"]["port_kernels"][row["name"]]
            row["bf16_fc_device_ms_per_frame"] = fc_rec["profile"][
                "port_kernels_device_ms_per_call"][row["name"]]
            row["bf16_fc_graph_device_ms_per_frame"] = fc_rec[
                "profile_graph"]["port_kernels_device_ms_per_call"][
                row["name"]]
            row["mma_wide"] = mma_route(lib_path, DEVICE_FUNCS[row["name"]][1],
                                        REPO / row["source"])
            assert row["mma_wide"] == "wgmma", (
                f"{row['name']}: the wide form issues {row['mma_wide']}")
        if row["name"] == "normalize":
            # the training batch's float32 form (phase 17)
            row["train_path"] = training["normalize"]
        if PER_FRAME["b8"][row["name"]]:
            row["b8_launches"] = e2e_b8["launches"][row["name"]]
            row["b8_device_ms_per_batch"] = prof_b8[
                "port_kernels_device_ms_per_call"][row["name"]]
            row["b8_graph_nodes_per_batch"] = g_b8["report"][
                "port_kernels"][row["name"]]
        print(json.dumps(row), flush=True)
    line = {"kernels": rows}
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "build_s": build_s, "launch_floor": floor,
         "end_to_end": e2e,
         "profile": prof, "end_to_end_fc": e2e_fc, "profile_fc": prof_fc,
         "end_to_end_b8": e2e_b8, "profile_b8": prof_b8,
         "graph_shipped": g_ship, "profile_graph_shipped": prof_g,
         "graph_fc": g_fc, "profile_graph_fc": prof_gfc,
         "graph_b8": g_b8, "profile_graph_b8": prof_gb8,
         "end_to_end_camera": e2e_cam, "profile_camera": prof_cam,
         "graph_camera": g_cam, "profile_graph_camera": prof_gcam,
         "eager_vs_graph": summary, "server": server,
         "executor": executor, "executor_camera": executor_cam,
         "native_host": native, "training": training,
         "export": exported, "bf16_engines": bf16,
         "bf16_fc_fused_modules": wide_rows,
         "before_redesign_graph_ms_quoted": {
             "quoted": BEFORE_ORIGIN, "ms": BEFORE_GRAPH_MS}, **line},
        indent=2, default=str))
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
