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

The int8 conv kernel (``csrc/int8_conv.cu``, one launch for each int8
layer of the int8 engines, 46 a frame on the shipped, fc, b8 and camera
paths, 59 on the unfused int8 engine) is held bit for bit against its
plain version on each of the shipped frame's layers, on the activations
that layer receives from the seed-7 frame, and timed beside the plain
version and ``torch._int_mm`` on prebuilt patches (the product alone,
by events and inside a replayed graph), each layer with the plan it
launched on; one eager frame runs with ``torch._int_mm`` and the im2col
refused; a ``shipped_graph_profile`` line gives the shipped graph's
device time by kernel name, in which no library integer product may
appear.

The int8 chain's glue (``csrc/int8_sppf.cu``: SPPF's three int8
max-pools and their concat, one launch a frame; ``csrc/qconcat.cu``: each
int8 concat and each quantise of a float input, its parts copied,
requantised, quantised or dequantised and quantised, upsampled where the
neck upsamples, nine launches a frame, 52 on the unfused int8 engine) is
held bit for bit against its plain versions at the sites the shipped
eager frame launches it at (which must be ``SHIPPED_SITES`` and SPPF's
``SHIPPED_SHAPE``), on that frame's activations, and timed beside the
plain versions and a library yardstick (three ``F.max_pool2d``; a
``torch.cat`` of the parts' sizes); no float max-pool, eager round or
int8 ``torch.cat`` may appear in the shipped frame's profiles.

The six tensor-core kernels (stem+stage1, stage1, both C3k2 forms, head,
the int8 conv) are also run at ragged shapes that cut every tile edge, and
the built library's SASS is read for the tensor-core instruction each of
them issues (``mma`` in their rows; ``mma_wide`` for the C3k2 and head
kernels' wide form): every one must issue ``wgmma`` (HGMMA, IGMMA on
int8).

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

Then the train CLI's path (phase 18) at full width: the reference's
round-5 XHARD set regenerated by the port's ``generate_dataset`` (seed 42,
400 train and 200 val scenes, JPEG), the host loader's images/s with
augmentation off and with mosaic 0.5; the committed QAT model
(``engine_source.msgpack``) evaluated on the card over the 200 val images
(``evaluate_model``: one normalize, decode and NMS launch a batch of 16)
against ``artifacts/xhard_run_r5/engine_compare.json`` ``qat_sim`` within
0.01 on mAP50, mAP50-95 and small-object F1, and CP-calibrated
(``calibrate_conformal_prediction``) against its ``cp_calibration.json``
(q_hat within 0.01, the number of scores within 2%); 4 val images against
the port's CPU path (the FP32 model in float32 compute: same counts, 0.5
px, 1e-2; the QAT model's differences measured); the eval path's
normalize, decode (K = 300, conf 0.25 and 0.001) and NMS held bit for bit
against their plain versions on a val batch and the model's own logits
and timed (the ``eval_path`` of their rows); the train CLI
(``train.main``, in this process) from the float checkpoint on a 64 / 32
subset with ``--epochs 1 --qat-epochs 1 --batch 16 --calib-batches 2
--calib-min-images 0 --calibrate-cp --export``, its exported QAT
train-form artifact served as one captured CUDA graph (strict report
clean) on the seed-7 scene beside the shipped artifact's count; one DP
step under a one-rank NCCL group bit for bit the plain step's.

Then the last modules (phases 19-22). Phase 19: the two deploy modes the
export writes beside the fused int8 chain, exported on the card from the
committed checkpoint at 640^2, batch 1, with ``--s2d-merged
--fused-stem``: the unfused int8 engine (``--int8 --int8-unfused``) and
the folded QAT model (``--merged-head`` without ``--int8``); each with a
clean strict report, eager FRAMES frames (one normalize, stem, decode and
NMS launch a frame) against the port's CPU path on the seed-7 scene (same
count, 0.5 px, 1e-2), one captured graph equal to the eager frame on the
8 scenes. Phase 20: the stem and stage1 kernels at base 16 and 64 (C =
32 and 128) and the C3k2 and head kernels at base 64's ten blocks' shapes
(``WIDE64_SHAPES``) and the C3k2's and head's at ragged batches on their
persistent plans (``PERSIST_SHAPES``; the head's large plan): on
binary-grid inputs bit for bit their plain
versions; the stem and stage1 kernels' SHA-256 digests at every width and
the wide C3k2 and head kernels' unchanged (base 16's and 32's shapes, and
base 64's but where the redesign sums in another order: WIDE64_REORDERED;
PERSIST_DIGESTS); the C = 128 cluster kernels, the C3k2's persistent
plan and the head's large plan relaunched 100 times, each output the
first's;
random-initialised engines (the port's seeded ``init_model`` at each
base, BatchNorm scales at WIDTH_BN_GAIN so the activations keep their
scale through the depth) exported with ``--s2d-merged --fused-stem`` (row
2), ``--stage1-s2d --fused-c3k2 --fused-head`` (row 5 in its fc form) and,
at base 64, ``--s2d-merged --fused-c3k2 --fused-head``, at a confidence
threshold set in the widest gap of the seed-7 frame's top cell logits at
which the card and the CPU path pass the same cells, each served eager
(its kernels launched as often as a frame holds them: the fc engines'
C3k2 3, C3k2-cat 4 and head 3 a frame) against the port's CPU path (same
count, 0.5 px, 1e-2) and as one captured graph equal to the eager frame
on the 8 scenes; each width's stem or stage1 kernel on that frame's own
activations against its plain version and timed (one more entry of the
kernels line each), and the base-64 fc and base-16 stage1_fc engines'
ten fused blocks the same way beside the fused-stem engine's cuDNN blocks
of their base (rows in the ``widths`` of the C3k2, C3k2-cat and head
entries). Phase 5b: the shipped engine served
with ``use_greedy_nms=False`` (``ops/nms.py nms_fast``) against the port's
CPU path with the same switch. Phase 21: the batch-8 artifact's model
served as a fleet
(``parallel.make_sharded_batch_serving_fn``) over ``[cuda:0]`` and over
the card listed twice (two programs, two streams, two graphs), both bit
for bit the batch-8 graph's Detections, one fleet call under
``utils.trace`` with an ``annotate`` span (the written trace holds the
span and the stem kernel, and no collective). Phase 22: curation from the
float checkpoint on the card: ``curation.mine`` over phase 18's 200 val
images in both modes, read back by ``load_difficulty_weights``, a K-Center
coreset of 32, and ``AutoLabeler`` with a mock detector over 4 scenes at
1080x1920 (host work: seconds only).

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
                "fused_stem_stage1": ("fused_stem_stage1_kernel<64>",),
                "decode_topk": ("decode_topk_kernel",),
                "nms": ("nms_kernel",),
                "stage1_merged": ("stage1_mma_kernel<64>",),
                "fused_c3k2": ("c3k2_kernel<false>",
                               "c3k2_wide_kernel<false"),
                "fused_c3k2_cat": ("c3k2_kernel<true>",
                                   "c3k2_wide_kernel<true"),
                "fused_head": ("head_mma_kernel", "head_wide_kernel",
                               "head_large_kernel"),
                "camera": ("camera_preprocess_kernel",
                           "camera_pixel_kernel"),
                "int8_conv": ("int8_conv_kernel",),
                "int8_sppf": ("int8_sppf_kernel",),
                "qconcat": ("qconcat_kernel",)}
# the kernels that run on the tensor cores: checked at ragged shapes too,
# and their SASS read for the instruction they issue
MMA_KERNELS = ("fused_stem_stage1", "stage1_merged", "fused_c3k2",
               "fused_c3k2_cat", "fused_head", "int8_conv")
# template instantiations as cuobjdump lists them (mangled); C = 128 is
# each source's cluster kernel, a function of its own
SASS_NAMES = {**{f"{k}<{c}>": f"{k}ILi{c}EE"
                for k in ("fused_stem_stage1_kernel", "stage1_mma_kernel")
                for c in (32, 64)},
              **{f"{k}<128>": f"{k}_pair"
                 for k in ("fused_stem_stage1_kernel", "stage1_mma_kernel")},
              "c3k2_kernel<false>": "c3k2_kernelILb0EE",
              "c3k2_kernel<true>": "c3k2_kernelILb1EE",
              "c3k2_wide_kernel<false": "c3k2_wide_kernelILb0E",
              "c3k2_wide_kernel<true": "c3k2_wide_kernelILb1E"}
# the int8 layers of the int8 engines' chain: 46 in the shipped engine
# (35 ConvBlocks with ReLU + out_q, 7 bottleneck cv2s with the residual
# add_q too, 4 f32 preds), the same in int8_s2dm_fc, b8 and camera; 59 in
# the unfused int8 engine (the reference's default exclusions)
INT8_LAYERS = 46
INT8_LAYERS_UNFUSED = 59
# the int8 chain's glue: SPPF's pools and concat, one launch of
# ``int8_sppf``; its seven other int8 concats and two quantises (each a
# C3k2's float or mixed input, quantised once for cv1 and cv2), nine of
# ``qconcat``; the unfused int8 engine quantises each int8 conv's float
# input (its 59 in_q, the seven C3k2s' pairs once: 52)
INT8_GLUE = {"int8_sppf": 1, "qconcat": 9}
INT8_GLUE_UNFUSED = {"int8_sppf": 0, "qconcat": 52}
NO_GLUE = {"int8_sppf": 0, "qconcat": 0}
# launches per call of each path (a call is a frame, or a batch of 8)
PER_FRAME = {
    "shipped": {"normalize": 1, "fused_stem_stage1": 1, "decode_topk": 1,
                "nms": 1, "stage1_merged": 0, "fused_c3k2": 0,
                "fused_c3k2_cat": 0, "fused_head": 0, "camera": 0,
                "int8_conv": INT8_LAYERS, **INT8_GLUE},
    "int8_s2dm_fc": {"normalize": 1, "fused_stem_stage1": 0,
                     "decode_topk": 1, "nms": 1, "stage1_merged": 1,
                     "fused_c3k2": 1, "fused_c3k2_cat": 1, "fused_head": 1,
                     "camera": 0, "int8_conv": INT8_LAYERS, **INT8_GLUE},
    "b8": {"normalize": 1, "fused_stem_stage1": 1, "decode_topk": 1,
           "nms": 1, "stage1_merged": 0, "fused_c3k2": 0,
           "fused_c3k2_cat": 0, "fused_head": 0, "camera": 0,
           "int8_conv": INT8_LAYERS, **INT8_GLUE},
    "camera": {"normalize": 0, "fused_stem_stage1": 0, "decode_topk": 1,
               "nms": 1, "stage1_merged": 1, "fused_c3k2": 0,
               "fused_c3k2_cat": 0, "fused_head": 0, "camera": 1,
               "int8_conv": INT8_LAYERS, **INT8_GLUE},
    "bf16_s2dm_mh": {"normalize": 1, "fused_stem_stage1": 0,
                     "decode_topk": 1, "nms": 1, "stage1_merged": 1,
                     "fused_c3k2": 0, "fused_c3k2_cat": 0, "fused_head": 0,
                     "camera": 0, "int8_conv": 0, **NO_GLUE},
    # every C3k2 and head of the bf16 engine fuses, at 64, 128 and 256
    "bf16_s2dm_fc": {"normalize": 1, "fused_stem_stage1": 0,
                     "decode_topk": 1, "nms": 1, "stage1_merged": 1,
                     "fused_c3k2": 3, "fused_c3k2_cat": 4, "fused_head": 3,
                     "camera": 0, "int8_conv": 0, **NO_GLUE},
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
# replayed-graph ms of each block of base 64's s2dm_fc engine before the
# wide C3k2 and head kernels were redesigned for its shapes, quoted beside
# this run's (logged and in chip_smoke.json, never in the kernels line)
BEFORE64_ORIGIN = (
    "quoted from PERF.md, not measured in this run: the blocks before the "
    "persistent plan (stage1_block and fpn_c3k2_2 on the replicated plan, "
    "one block a tile), the engine's seed-7 activations, NVIDIA H100 80GB "
    "HBM3, 700.00 W")
BEFORE64_GRAPH_MS = {
    "backbone.stage1_block": 0.04465, "backbone.stage2_c3k2": 0.07515,
    "backbone.stage3_c3k2": 0.07194, "neck.fpn_c3k2_1": 0.05530,
    "neck.fpn_c3k2_2": 0.05139, "neck.pan_c3k2_1": 0.05158,
    "neck.pan_c3k2_2": 0.04751, "head_p2": 0.11247, "head_p3": 0.11928,
    "head_p4": 0.11252}
# NVIDIA H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 tensor-core
# FLOP/s, f32 CUDA-core FLOP/s
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
INT8_OPS = 1979e12          # int8 tensor-core operations/s

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
# phase 18: the train CLI's path at full width on the reference's round-5
# XHARD set (regenerated: seed 42, 400 train scenes drawn before the 200
# val ones, JPEG), against the reference run's own recorded results
R5 = REPO / "artifacts" / "xhard_run_r5"
R5_TRAIN, R5_VAL = 400, 200
EVAL_BATCH = 16
EVAL_MAX_BOXES = 60        # tools/compare_engines.py's --max-boxes
METRIC_GATE, Q_GATE, NUM_SCORES_GATE = 0.01, 0.01, 0.02
LOADER_BATCHES = 6
CLI_TRAIN, CLI_VAL = 64, 32
CLI_ARGS = ["--epochs", "1", "--qat-epochs", "1", "--batch", "16",
            "--calib-batches", "2", "--calib-min-images", "0",
            "--calibrate-cp", "--export"]
# phase 19: the two deploy modes beside the fused int8 chain, exported from
# the committed calibrated checkpoint
MODE_FLAGS = {
    "int8_unfused": ["--int8", "--int8-unfused", "--s2d-merged",
                     "--fused-stem"],
    "qat_deploy": ["--s2d-merged", "--fused-stem", "--merged-head"],
}
_MODE_KERNELS = {"normalize": 1, "fused_stem_stage1": 1, "decode_topk": 1,
                 "nms": 1, "stage1_merged": 0, "fused_c3k2": 0,
                 "fused_c3k2_cat": 0, "fused_head": 0, "camera": 0}
MODE_PER_FRAME = {
    "int8_unfused": dict(_MODE_KERNELS, int8_conv=INT8_LAYERS_UNFUSED,
                         **INT8_GLUE_UNFUSED),
    "qat_deploy": dict(_MODE_KERNELS, int8_conv=0, **NO_GLUE)}
# phase 20: the kernels at the other base widths, in random-initialised
# engines (seed = base) whose BatchNorm scales keep the activations' scale
# through the depth; the threshold is set in a gap of the seed-7 frame's
# top cell logits between these ranks (``gap_threshold``)
WIDTH_BN_GAIN = 1.3
WIDTH_GAP_RANKS = (1, 60)
# the engines: name -> (export flags, the kernels a frame launches beside
# normalize, decode and NMS, once each). Row 5 in its fc form, every C3k2
# and head fused (the C3k2 and head kernels at base 16's and base 64's
# widths: hidden 16-256, heads 32-512), and base 64's ``--s2d-merged`` fc
# engine, whose ten fused blocks ``check_wide_kernels`` checks and times
# against the same blocks of the fused-stem engine (cuDNN convolutions)
FC_PER_FRAME = {"stage1_merged": 1, "fused_c3k2": 3, "fused_c3k2_cat": 4,
                "fused_head": 3}
WIDTH_ENGINES = {
    "fused_stem_stage1": (["--s2d-merged", "--fused-stem"],
                          {"fused_stem_stage1": 1}),
    "stage1_fc": (["--stage1-s2d", "--fused-c3k2", "--fused-head"],
                  FC_PER_FRAME),
    "s2dm_fc": (["--s2d-merged", "--fused-c3k2", "--fused-head"],
                FC_PER_FRAME),
}
# the engines served at each base, in order
WIDTH_RUNS = {16: ("fused_stem_stage1", "stage1_fc"),
              64: ("fused_stem_stage1", "stage1_fc", "s2dm_fc")}
# the row of phase 20's kernels table each engine gives (``width_row``)
WIDTH_ROW = {"fused_stem_stage1": "fused_stem_stage1",
             "stage1_fc": "stage1_merged"}
# SHA-256 of the 64-wide stem and stage1 kernels' outputs on seeded normal
# inputs (``width_inputs``), as the kernels computed them before they took
# other widths (on an NVIDIA H100 80GB HBM3, 700 W). To record them again
# from the kernels of another commit, unpack that commit into a directory
# and call ``width_digests(torch, c)`` on the card with that directory first
# on ``sys.path`` (this file's helpers, that commit's package).
WIDTH64_DIGESTS = {
    "stem_1x320x160":
        "c402c8cc7209ea7de25a2ac2eb5e5bfb6a4ff335f53961af4ed93da09545d94f",
    "stage1_1x320x160":
        "0e5637cd6dc70b3249b8a7a49ca2ff3877fd45410b0f29cd5806048dca2a1367",
    "stem_2x10x37":
        "f0420fd53b7b81f04e6bbc330d3369b3093bd75a9e3d2796538494b5fe4b012c",
    "stage1_2x10x37":
        "cbe071e224f13573d70a2d6e027aa5d975cf40e29fad3415aec19e807f0a273c",
}
# The same at C = 128 and 32 (base 64 and 16; ``WIDTH_DIGEST_CASES``), as
# the kernels computed them before the C = 128 forms were redesigned for
# clusters of two blocks (on an NVIDIA H100 80GB HBM3, 700 W): the
# redesign sums the same products in the same order, so neither moves.
WIDTH128_DIGESTS = {
    "stem_1x320x160":
        "38c2782fc490706b624869b9d00af96630264ca9108fe1bd2a162ceb022df339",
    "stage1_1x320x160":
        "57711f950311555a71554b596ed0c58ec079fbca4aa30d472e007960f6f17c9e",
    "stem_2x10x37":
        "5bf14566919ff9d018bbeacfc474d32540d9a7ee95454c84a0580511d71af4b9",
    "stage1_2x10x37":
        "3307c4ac5de3924ad499f9cf419947281cdaff81b7f2130caa70a7f42132778f",
    "stem_3x34x61":
        "d58eb18a6089b3d8e313b3e6696827973399bd670320a46b2299dbc808e48c7f",
    "stage1_3x34x61":
        "214fd395a547501ea34dd031fa19d383f334e24065b00cb056d708c0af5440f2",
}
WIDTH32_DIGESTS = {
    "stem_1x320x160":
        "eb092d93590b2e2abe6660480271c8dbb5bc91ebb6c5acf735425844230230b0",
    "stage1_1x320x160":
        "73220cdddefbfb80f021ee84bdaea358951726f7e7e9a298ae424c0e1982d36c",
    "stem_2x10x37":
        "6a0ca758d6a2769de488433288e620668923cd48f5e18fa3a5b66ba31ee53493",
    "stage1_2x10x37":
        "daccae8922591f68f93b2349708fe6eaec82bc34eaec7f8f673ae30f0dd15160",
    "stem_3x34x61":
        "03c8ee3e2ce484439c2819479f43c8978e282184c8afa613c53f66b8cbae56e6",
    "stage1_3x34x61":
        "95eb7aa298cbb75dafecba8f5efba5c19f9a7a208866feda76bb2fd59ae767e7",
}
# the wide C3k2 and head kernels at every (hidden, n) and head width they
# took before hidden 256 and head 512 were added: the served shapes of the
# base-32 and base-16 engines and ragged batches of 2. C3k2: (batch, H, W,
# Ca (0: the single form), Cb, hidden, n, up_a, shortcut); head: (batch,
# H, W, C).
WIDE_SEED = 2026
WIDE_SHAPES = {
    "c3k2_h16_n1_160": (1, 160, 160, 0, 32, 16, 1, False, True),
    "c3k2_h64_n2_80": (1, 80, 80, 0, 128, 64, 2, False, True),
    "c3k2_h128_n2_40": (1, 40, 40, 0, 256, 128, 2, False, True),
    "c3k2_h64_n1_2x37x45": (2, 37, 45, 0, 128, 64, 1, False, True),
    "c3k2_h128_n1_2x5x3": (2, 5, 3, 0, 256, 128, 1, False, True),
    "c3k2_h16_n2_2x9x14": (2, 9, 14, 0, 40, 16, 2, False, True),
    "cat_h64_n1_up_80": (1, 80, 80, 128, 128, 64, 1, True, False),
    "cat_h64_n1_80": (1, 80, 80, 64, 128, 64, 1, False, False),
    "cat_h128_n1_40": (1, 40, 40, 128, 256, 128, 1, False, False),
    "cat_h16_n1_up_160": (1, 160, 160, 32, 32, 16, 1, True, False),
    "cat_h128_n2_up_2x14x22": (2, 14, 22, 128, 64, 128, 2, True, True),
    "cat_h64_n2_2x37x45": (2, 37, 45, 64, 128, 64, 2, False, True),
    "head_c32_160": (1, 160, 160, 32),
    "head_c128_80": (1, 80, 80, 128),
    "head_c256_40": (1, 40, 40, 256),
    "head_c256_2x13x6": (2, 13, 6, 256),
    "head_c128_2x37x45": (2, 37, 45, 128),
    "head_c32_1x9x17": (1, 9, 17, 32),
}
# SHA-256 of ``wide_outputs`` as the wide kernels computed them before
# they took hidden 256 and head 512 (the parent commit's kernels, on an
# NVIDIA H100 80GB HBM3). To record them again from another commit,
# unpack it into a directory and call ``wide_digests(torch)`` on the card
# with that directory first on ``sys.path``.
WIDE_DIGESTS = {
    "c3k2_h16_n1_160":
        "e59361a4ed416bac6a29278ef7861502a8c17bdd8149d1fc9fefb5449a79efe0",
    "c3k2_h64_n2_80":
        "40056322871410b3118789183df0c9f9b7ef85f4d66cbb21a2f9361760957287",
    "c3k2_h128_n2_40":
        "7696212f93d8cae2726f818af1669656be2ddf21815638dbdde20fb7f03ccfeb",
    "c3k2_h64_n1_2x37x45":
        "0c65d91d2f7291e2344ab63d6709d4454e7d6807782ee09e887f67828ffdae49",
    "c3k2_h128_n1_2x5x3":
        "dc594fe2b0a83b2bad3661844cbe40952044d91adf97b0cb646bc85f47284ac8",
    "c3k2_h16_n2_2x9x14":
        "7214c8b71a364846e8208c7a1cc52d21745123c5f36c4dba59c467d7dd918d75",
    "cat_h64_n1_up_80":
        "c4001157ec5cc7da798c99ce5c04a06776bdd0385a551afe52467a8154caa5f6",
    "cat_h64_n1_80":
        "f97b900c895748b80cf1ef12c333e7d27902a5fbd3243a776c02097fe259e2a4",
    "cat_h128_n1_40":
        "498577c4c5bcbb83499f6d4aa9de5dd3cebee4d1e9c2187bdc913f85f6bb6107",
    "cat_h16_n1_up_160":
        "724010f7f3b4a958c9c9ed168e88880a6ab47919dd62e3c135d50c11ba22ff90",
    "cat_h128_n2_up_2x14x22":
        "c5214f258282aee3ce16aadec5ce2ca3b86c6ca390b3bac585663f3412e3dff9",
    "cat_h64_n2_2x37x45":
        "7825f59d3508be3391832dea34f02721cc516c91c7fd338fab04e7358f504e20",
    "head_c32_160":
        "efaece67794cbc3a8e9b4845597ee5881558ebb2a25d49cad4f4011669427723",
    "head_c128_80":
        "51ebd30d4f68e51e9ed8ef31f2d1e866b77e6fb2463f9999838015a7e073b6b4",
    "head_c256_40":
        "6a4d6801eda2b12b46c1783ff792fde0d7db355d91e4c0b9e8bb8aa757e3a4d4",
    "head_c256_2x13x6":
        "ee12a8ccdc24a53f7afd90aa36dba54422f8c5437f208c4c2656b1063030ccdf",
    "head_c128_2x37x45":
        "089dc6b9f853ab5ec846de4afc05e7fa14e5598cb9c43d4973a1544f7d5cc97a",
    "head_c32_1x9x17":
        "dbb6856de1ad338eb731c62b43945817b1a116bff94b1c40d3c0369a3b06bdeb",
}
# base 64's ten fused blocks at their served shapes (640²) and as ragged
# batches of 2, in WIDE_SHAPES' form: the base-64 fc engine's C3k2s
# (stage1_block, stage2_c3k2, stage3_c3k2; neck fpn_c3k2_1, fpn_c3k2_2,
# pan_c3k2_1, pan_c3k2_2) and heads (P2, P3, P4)
WIDE64_SHAPES = {
    "stage1_block_1x160x160": (1, 160, 160, 0, 128, 64, 1, False, True),
    "stage2_c3k2_1x80x80": (1, 80, 80, 0, 256, 128, 2, False, True),
    "stage3_c3k2_1x40x40": (1, 40, 40, 0, 512, 256, 2, False, True),
    "fpn_c3k2_1_1x80x80": (1, 80, 80, 256, 256, 128, 1, True, False),
    "fpn_c3k2_2_1x160x160": (1, 160, 160, 128, 128, 64, 1, True, False),
    "pan_c3k2_1_1x80x80": (1, 80, 80, 128, 256, 128, 1, False, False),
    "pan_c3k2_2_1x40x40": (1, 40, 40, 256, 512, 256, 1, False, False),
    "head_p2_1x160x160": (1, 160, 160, 128),
    "head_p3_1x80x80": (1, 80, 80, 256),
    "head_p4_1x40x40": (1, 40, 40, 512),
    "stage1_block_2x19x23": (2, 19, 23, 0, 128, 64, 1, False, True),
    "stage2_c3k2_2x13x21": (2, 13, 21, 0, 256, 128, 2, False, True),
    "stage3_c3k2_2x11x13": (2, 11, 13, 0, 512, 256, 2, False, True),
    "fpn_c3k2_1_2x14x22": (2, 14, 22, 256, 256, 128, 1, True, False),
    "fpn_c3k2_2_2x18x26": (2, 18, 26, 128, 128, 64, 1, True, False),
    "pan_c3k2_1_2x13x21": (2, 13, 21, 128, 256, 128, 1, False, False),
    "pan_c3k2_2_2x11x13": (2, 11, 13, 256, 512, 256, 1, False, False),
    "head_p2_2x19x23": (2, 19, 23, 128),
    "head_p3_2x13x21": (2, 13, 21, 256),
    "head_p4_2x13x7": (2, 13, 7, 512),
}
# SHA-256 of ``wide_outputs`` at WIDE64_SHAPES as the wide kernels computed
# them before they were redesigned for base 64's shapes (the parent
# commit's kernels, on an NVIDIA H100 80GB HBM3, 700.00 W); recorded as
# WIDE_DIGESTS, with ``wide_digests(torch, WIDE64_SHAPES)``
WIDE64_DIGESTS = {
    "stage1_block_1x160x160":
        "c8fe27dbbc927132e527b629abba2cd3f40d6f3fbeb345b17ddf96ce10bee9ee",
    "stage2_c3k2_1x80x80":
        "88b89cd74c2b4e3cfd2f3f5075d71bb646e518018863924c7dd752165ee64017",
    "stage3_c3k2_1x40x40":
        "26a09e2f536a564e30c4983df28a469c288aa4317315f114cb312bad10401504",
    "fpn_c3k2_1_1x80x80":
        "f576f6b64930cde415b5bbf005b8015352c3f2db9068caca9dc2ca4dc034d5d9",
    "fpn_c3k2_2_1x160x160":
        "b13bc8ab1d869eae03bb94840a81329eee6c6febc390093c698c9e2c791fbd31",
    "pan_c3k2_1_1x80x80":
        "cf6f1e66dd009a42292f1c0b80652b0edafdd3ed9f66c1ab25f1cce416c2a816",
    "pan_c3k2_2_1x40x40":
        "000832678d3dc4d8c5550ee25555f5c1bf4a7ce2130481f54e3f839edae1694b",
    "head_p2_1x160x160":
        "b397ea56581f27d034dcdea972f1948164ed71709c002d5268a279b99cadf168",
    "head_p3_1x80x80":
        "bfb32fe428084a26e385b7382b21a04d06fb973781635b9d247da4b412919d0f",
    "head_p4_1x40x40":
        "ffa027d310f1df3aea07c448f4186256916d071d3385a9a3a82460ec980e0a05",
    "stage1_block_2x19x23":
        "1103a27e6c2948d1aa60366cf01382e73d105db42a8b0a04322a3b3b1ea9825c",
    "stage2_c3k2_2x13x21":
        "26cf0f67b6848c73c9cb0e5607bf7901510f0d6c9645c118d969a5e24100d2b3",
    "stage3_c3k2_2x11x13":
        "abed6976c46afaf17f2e1c740e2c647d9f0815c07f226de1c56d0aa00cd6400d",
    "fpn_c3k2_1_2x14x22":
        "daa82bb3f3aa9655b66325a996b8b3204871f45218c0b5c781bda538560be365",
    "fpn_c3k2_2_2x18x26":
        "18722582ef21b6e922196525e9f6bbcd2fcc01a3dde3f55c218b5e7dac1c4f96",
    "pan_c3k2_1_2x13x21":
        "0a92e846025a4ff882df4ab2e4c409eb4b508c7cf758f85f4fb9d298c4b11044",
    "pan_c3k2_2_2x11x13":
        "3b2a7742c8eb85361b8c91c5166c9ba1ceb53611991f535cabbb98564d448618",
    "head_p2_2x19x23":
        "897e226c2088591d3dba85ac70eb35b229e7866607478918a147347b480d9058",
    "head_p3_2x13x21":
        "0f6272a3dace21637e89fcd5d9a5210640038c4de449ab285fb3f44d1e83222d",
    "head_p4_2x13x7":
        "c5ef2f12e7006a20721c274e9abbe201c98c592c533095a5c5a2059565501e30",
}
# base 64's three blocks at 160 x 160 whose kernels walk their tiles on
# one block an SM (on grids of two rounds of the card or more): the two
# C3k2s of the persistent plan (hidden 64, one bottleneck) and head_p2 on
# the large plan (C = 128), as ragged batches of 2 large enough for them:
# 150 rows and 134 columns, a part tile at the end of each
PERSIST_SHAPES = {
    "stage1_block_2x150x134": (2, 150, 134, 0, 128, 64, 1, False, True),
    "fpn_c3k2_2_2x150x134": (2, 150, 134, 128, 128, 64, 1, True, False),
    "head_p2_2x150x134": (2, 150, 134, 128),
}
# SHA-256 of ``wide_outputs`` at PERSIST_SHAPES as the parent commits'
# kernels (the replicated plans) computed them (NVIDIA H100 80GB HBM3),
# with ``wide_digests(torch, PERSIST_SHAPES)``
PERSIST_DIGESTS = {
    "stage1_block_2x150x134":
        "4bf80a77f79335516da03a4dccddd15e2bc865fefb2d58d27c66d080087befc3",
    "fpn_c3k2_2_2x150x134":
        "fc09e79c3fda63a338ddb03f434fa7c476c0c1cc39da16c1e5e9cc9b96afd564",
    "head_p2_2x150x134":
        "1f2541a306ca268a5a524b456aff1bc68a261103cf177ffe551dd06bdfe2bbfe",
}
# the base-64 shapes whose redesigned kernel sums in another order than
# the parent's (the head's owned plan, at 512 and at 256 on 80 x 80: both
# convs plane by plane, the preds split over the cluster), so whose
# digests moved
WIDE64_REORDERED = ("head_p4_1x40x40", "head_p4_2x13x7", "head_p3_1x80x80")
# phase 22: curation
CORESET = 32
LABEL_SCENES = 4

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
    lead = torch.zeros(1, device=dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # a window can still drop its first kernel: let that be another
        lead.add_(1)
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
    (HGMMA in the built library's SASS, IGMMA on int8) or ``mma.sync``
    (HMMA, or IMMA on int8, only), read
    by ``cuobjdump``; where that tool is absent, what the source states."""
    from unina_yolo_dla_torch.ops.cuda import _lib

    tool = Path(_lib._nvcc()).with_name("cuobjdump")
    if tool.exists():
        sass = subprocess.run([str(tool), "-sass", str(lib_path)],
                              capture_output=True, text=True,
                              check=True).stdout
        # one SASS function, or one a compiled body (the wide kernels)
        body = [part for part in sass.split("Function : ")[1:]
                if SASS_NAMES.get(func, func) in part.splitlines()[0]]
        assert body, f"{func}: no SASS function"
        kinds = {"wgmma" if "HGMMA" in b or "IGMMA" in b else
                 "mma.sync" if "HMMA" in b or "IMMA" in b else None
                 for b in body}
        found = kinds.pop() if len(kinds) == 1 else None
        log(f"{func}: {len(body)} SASS functions, "
            f"{sum(b.count('HGMMA') for b in body)} HGMMA, "
            f"{sum(b.count('IGMMA') for b in body)} IGMMA, "
            f"{sum(b.count('HMMA') for b in body)} HMMA, "
            f"{sum(b.count('IMMA') for b in body)} IMMA")
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
    37 x 45 (and 38 x 46 with the upsample on); the int8 conv at batch 2,
    37 x 45 (3x3 with the residual, and stride 2), exact."""
    from unina_yolo_dla_torch.ops.cuda import (
        c3k2_kernel, head_kernel, int8_conv_kernel, mma_pack, stage1_kernel,
        stem_kernel)

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

    # the int8 conv: random int8 on tiles cut by both image edges, bits
    worst["int8_conv"] = 0.0
    for k, st, mode in ((3, 1, "qres"), (3, 2, "q")):
        xq = torch.from_numpy(rng.integers(-128, 128, (2, 37, 45, 64),
                                           dtype=np.int8)).to(dev)
        wq = torch.from_numpy(rng.integers(-127, 128, (72, k * k * 64),
                                           dtype=np.int8)).to(dev)
        comb = torch.full((72,), 2.0 ** -16, device=dev)
        bias = torch.from_numpy(rng.normal(0, .1, 72).astype(
            np.float32)).to(dev)
        ho, wo = int8_conv_kernel.out_size(37, 45, k, st)
        kw = {"out_amax": np.float32(2.5)}
        if mode == "qres":
            kw.update(res=torch.from_numpy(rng.integers(
                -127, 128, (2, ho, wo, 72), dtype=np.int8)).to(dev),
                res_amax=np.float32(3.1), add_amax=np.float32(4.2))
        args = (xq, wq, comb, bias, k, k, st, k // 2, 72)
        got = int8_conv_kernel.int8_conv(*args, **kw)
        torch.cuda.synchronize()
        want = int8_conv_kernel.int8_conv_plain(*args, **kw)
        assert torch.equal(got, want), f"int8_conv ragged {k}x{k} s{st}"
        worst["int8_conv"] = max(worst["int8_conv"], rel(got, want))
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


def int8_layer_work(bsz: int, h: int, w: int, c: int, n: int, cout: int,
                    k: int, stride: int, mode: int) -> tuple[int, int]:
    """(bytes, operations) an int8 layer must move and do: each input read
    once (x, the (n, k*k*c) weights, comb and bias, the residual), the
    output written once (f32, or int8); 2 operations a multiply-add of the
    ``cout`` channels out."""
    from unina_yolo_dla_torch.ops.cuda.int8_conv_kernel import F32, QRES, \
        out_size

    ho, wo = out_size(h, w, k, stride)
    px = bsz * ho * wo
    nbytes = (bsz * h * w * c + n * k * k * c + 8 * n
              + px * cout * (4 if mode == F32 else 1)
              + (px * cout if mode == QRES else 0))
    return nbytes, 2 * px * cout * k * k * c


def check_int8_layers(art, rgb, torch) -> tuple[dict, list[dict]]:
    """The int8 conv kernel on each of the shipped frame's int8 layers, on
    the activations the eager frame hands each layer (forward pre-hooks,
    as ``capture_inputs``): bit for bit its plain version (im2col,
    ``torch._int_mm``, the float64-emulated FMA, the requants), timed
    (events, a replayed graph), beside the plain version and the library's
    integer product alone on prebuilt patches (``torch._int_mm``: the
    yardstick, which the port never calls on the card; events and a
    replayed graph), with each layer's bound and the plan it launched on.
    The kernel's graph ms is a chain of programmatic dependent launches,
    each starting under the one before (``tools/torch_int8_plans.py
    --no-pdl`` times the chain without). Also one eager frame with
    ``torch._int_mm`` and the im2col refused: the card's path runs
    neither. -> (the kernels line's row:
    sums over the frame's layers and by geometry; the layers)."""
    from unina_yolo_dla_torch.ops.cuda import int8_conv_kernel as k8
    from unina_yolo_dla_torch.quant import fake_quant
    from unina_yolo_dla_torch.quant.fake_quant import QuantConv, im2col_nhwc
    from unina_yolo_dla_torch.quant.qtensor import QTensor

    mods = {n: m for n, m in art.model.named_modules()
            if isinstance(m, QuantConv) and m.int8}
    caps = {}
    hooks = [m.register_forward_pre_hook(
        lambda _m, a, kw, n=n: caps.__setitem__(n, a), with_kwargs=True)
        for n, m in mods.items()]
    try:
        with torch.inference_mode():
            art(rgb)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    assert len(caps) == INT8_LAYERS, f"{len(caps)} int8 layers in a frame"

    # the card's frame never reaches the plain int8 product
    refused = []

    def refuse(name):
        def fn(*a, **k):
            refused.append(name)
            raise AssertionError(f"{name} ran on the card")
        return fn

    saved = torch._int_mm, fake_quant.im2col_nhwc
    torch._int_mm = refuse("torch._int_mm")
    fake_quant.im2col_nhwc = refuse("im2col_nhwc")
    try:
        with torch.inference_mode():
            art(rgb)
        torch.cuda.synchronize()
    finally:
        torch._int_mm, fake_quant.im2col_nhwc = saved
    assert not refused, refused

    layers = []
    for name, args in caps.items():
        conv = mods[name]
        x, res, add_amax = (tuple(args) + (None, None))[:3]
        qt = x if isinstance(x, QTensor) else conv.in_q(x)
        xq = qt.q.contiguous()
        call = (xq, conv.weight, conv._comb(qt.scale), conv.bias, conv.kh,
                conv.kw, conv.stride, conv.padding, conv.cout)
        kw = {}
        if conv.out_amax is not None:
            kw["out_amax"] = conv.out_amax
        if res is not None:
            kw.update(res=res.q.contiguous(), res_amax=res.amax,
                      add_amax=add_amax)
        mode = k8.QRES if res is not None else (
            k8.Q if conv.out_amax is not None else k8.F32)

        def fn(call=call, kw=kw):
            return k8.int8_conv(*call, **kw)

        def plain(call=call, kw=kw):
            return k8.int8_conv_plain(*call, **kw)

        got, want = fn(), plain()
        torch.cuda.synchronize()
        launch_plan = k8.last_plan()
        err = float((got.float() - want.float()).abs().max())
        assert got.dtype == want.dtype and torch.equal(got, want), (
            f"int8_conv {name}: {int((got != want).sum())} elements "
            f"differ, max |err| {err}")
        patches = im2col_nhwc(xq, conv.kh, conv.kw, conv.stride,
                              conv.padding)
        wt = conv.weight.t()

        def lib(patches=patches, wt=wt):
            return torch._int_mm(patches, wt)

        b, h, w, c = xq.shape
        nbytes, ops = int8_layer_work(b, h, w, c, conv.weight.shape[0],
                                      conv.cout, conv.kh, conv.stride, mode)
        b_ms, b_by = bound(nbytes, ops, INT8_OPS)
        layers.append(dict(
            layer=name, shape=[b, h, w, c], n=conv.weight.shape[0],
            cout=conv.cout, k=conv.kh, stride=conv.stride,
            epilogue=("f32", "q", "qres")[mode], bytes=nbytes, ops=ops,
            max_abs_err=err, ms=cuda_ms(fn, 200), graph_ms=graph_ms(fn),
            plain_ms=cuda_ms(plain, 10, 2), library_ms=cuda_ms(lib, 100),
            library_graph_ms=graph_ms(lib), bound_ms=b_ms, bound_by=b_by,
            plan={k: launch_plan[k] for k in ("bn", "kc", "stages", "grid",
                                               "smem_bytes")}))
        log(f"int8_conv {name}: plan {json.dumps(layers[-1]['plan'])}, "
            f"graph ms {layers[-1]['graph_ms']:.5f}")

    def total(rows):
        out = {k: sum(r[k] for r in rows) for k in (
            "ms", "graph_ms", "plain_ms", "library_ms", "library_graph_ms",
            "bytes", "ops")}
        t_bytes = out["bytes"] / HBM_BPS * 1e3
        t_ops = out["ops"] / INT8_OPS * 1e3
        out["bound_ms"] = max(t_bytes, t_ops)
        out["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        out["layers"] = len(rows)
        return out

    geoms = {}
    for r in layers:
        geoms.setdefault(f"{r['k']}x{r['k']}_s{r['stride']}", []).append(r)
    sums = total(layers)
    row = dict(
        name="int8_conv", route="cuda",
        source="unina_yolo_dla_torch/csrc/int8_conv.cu",
        replaces="unina_yolo_dla_tpu/quant/fake_quant.py:235",
        tolerance="exact: every layer's output bit for bit its plain "
                  "version's",
        per=f"the shipped frame's {len(layers)} int8 layers on their "
            "seed-7 activations, summed (one launch a layer)",
        max_abs_err=max(r["max_abs_err"] for r in layers),
        **{k: sums[k] for k in ("ms", "graph_ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms", "library_graph_ms",
                                "bytes", "ops")},
        graph="graph_ms: 20 launches of a layer in a replayed graph, "
              "each a programmatic dependent launch that starts under the "
              "one before",
        library="torch._int_mm on prebuilt patches: the integer product "
                "alone, no gather, no epilogue (library_ms by events, "
                "library_graph_ms in a replayed graph)",
        geometries={g: total(rows) for g, rows in geoms.items()})
    log(json.dumps({"int8_conv_layers": layers}))
    return row, layers


def check_int8_glue(art, rgb, torch) -> tuple[list[dict], list[dict]]:
    """Kernels 11 and 12 (``csrc/int8_sppf.cu``, ``csrc/qconcat.cu``) on
    the inputs the shipped eager frame hands them (the wrappers' launches
    recorded over one frame): the sites must be ``SHIPPED_SITES`` and
    SPPF's ``SHIPPED_SHAPE``; each launch bit for bit its plain version
    (``qmaxpool`` three times and ``qconcat``; ``upsample_nearest_2x_q``,
    ``requantize``, ``dequant``, ``torch.cat``, ``quantize``), timed by
    events and inside a replayed graph beside the plain version and a
    library yardstick, with its bound (each input read once, the output
    written once, at 3.35 TB/s; one operation an output byte at the f32
    rate). -> (the two rows of the kernels line, summed over a frame's
    sites; the sites)."""
    import torch.nn.functional as F

    from unina_yolo_dla_torch.models import blocks
    from unina_yolo_dla_torch.ops.cuda import qconcat_kernel as k12
    from unina_yolo_dla_torch.ops.cuda import sppf_kernel as k11
    from unina_yolo_dla_torch.quant.qtensor import QTensor

    concats, pools = [], []
    launch, sppf = k12._launch, blocks.int8_sppf

    def keep_launch(xs, modes, up, amax):
        concats.append((list(xs), list(modes), tuple(up), amax))
        return launch(xs, modes, up, amax)

    def keep_sppf(x, window=k11.WINDOW):
        pools.append(x)
        return sppf(x, window)

    k12._launch, blocks.int8_sppf = keep_launch, keep_sppf
    try:
        with torch.inference_mode():
            art(rgb)
        torch.cuda.synchronize()
    finally:
        k12._launch, blocks.int8_sppf = launch, sppf
    assert [tuple(x.q.shape) for x in pools] == [k11.SHIPPED_SHAPE], pools
    kinds = {k12.COPY: "s8", k12.REQ: "s8", k12.DEQ_Q: "deq", k12.Q: "bf16"}

    def signature(xs, modes, up, amax):
        parts = tuple((x.shape[-1], kinds[m], np.float32(x.amax)
                       if isinstance(x, QTensor) else None, u)
                      for x, m, u in zip(xs, modes, up))
        scale = 2 if up[-1] else 1   # the output's size from the last part
        return (xs[-1].shape[1] * scale, xs[-1].shape[2] * scale,
                np.float32(amax), parts)

    got_sites = sorted(repr(signature(*c)) for c in concats)
    want_sites = sorted(repr(site[1:]) for site in k12.SHIPPED_SITES)
    assert got_sites == want_sites, (got_sites, want_sites)

    def timed(fn, plain, lib, rec):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        err = float((got.q.float() - want.q.float()).abs().max())
        assert torch.equal(got.q, want.q) and got.amax == want.amax, (
            rec, int((got.q != want.q).sum()))
        b_ms, b_by = bound(rec["bytes"], rec["ops"], F32_FLOPS)
        return dict(rec, max_abs_err=err, ms=cuda_ms(fn, 200),
                    graph_ms=graph_ms(fn), plain_ms=cuda_ms(plain, 20, 3),
                    library_ms=cuda_ms(lib, 200),
                    library_graph_ms=graph_ms(lib), bound_ms=b_ms,
                    bound_by=b_by)

    sites = []
    for xs, modes, up, amax in concats:
        kept = all(m in (k12.COPY, k12.REQ) for m in modes)
        ts = [x.q if isinstance(x, QTensor) else x for x in xs]

        def fn(xs=xs, modes=modes, up=up, amax=amax):
            return k12._launch(xs, modes, up, amax)

        def plain(xs=xs, up=up, amax=amax, kept=kept):
            return (k12.int8_concat_plain(xs, up) if kept else
                    k12.quantize_concat_plain(xs, amax, up))

        b, h, w = fn().q.shape[:3]
        # the yardstick: torch.cat of prebuilt int8 tensors of the parts'
        # output shapes (the concat's copy alone: no rescale, no quantise,
        # no upsample)
        stand = [torch.zeros((b, h, w, t.shape[-1]), dtype=torch.int8,
                             device=t.device) for t in ts]
        out_bytes = b * h * w * sum(t.shape[-1] for t in ts)
        sites.append(timed(fn, plain, lambda stand=stand: torch.cat(
            stand, dim=-1), dict(
                kernel="qconcat", shape=[b, h, w, out_bytes // (b * h * w)],
                amax=float(amax), parts=[
                    [t.shape[-1], ("copy", "req", "q", "deq_q")[m],
                     str(t.dtype).replace("torch.", ""), u]
                    for t, m, u in zip(ts, modes, up)],
                bytes=sum(t.numel() * t.element_size() for t in ts)
                + out_bytes, ops=out_bytes)))
    x = pools[0]
    b, h, w, c = x.q.shape
    xf = x.q.float().permute(0, 3, 1, 2)

    def pools3(xf=xf):   # the yardstick: as the port pooled before
        y1 = F.max_pool2d(xf, 5, 1, 2)
        y2 = F.max_pool2d(y1, 5, 1, 2)
        return F.max_pool2d(y2, 5, 1, 2)

    # each pooled element: 8 maxima a 5 x 5 pool (rows, then columns)
    sites.append(timed(lambda: k11.int8_sppf(x),
                       lambda: k11.int8_sppf_plain(x), pools3, dict(
                           kernel="int8_sppf", shape=[b, h, w, c],
                           amax=float(x.amax), bytes=5 * b * h * w * c,
                           ops=3 * 8 * b * h * w * c)))
    for r in sites:
        log(f"{r['kernel']} {r['shape']}: graph ms {r['graph_ms']:.5f}, "
            f"library graph ms {r['library_graph_ms']:.5f}")

    rows = []
    for name, source, replaces, per, lib in (
            ("int8_sppf", "int8_sppf.cu", "quant/qtensor.py:115",
             "SPPF's input in the shipped frame, on its seed-7 activations "
             "(one launch a frame)",
             "F.max_pool2d three times on the float NCHW view of the int8 "
             "input, as the port pooled before (library_ms by events, "
             "library_graph_ms in a replayed graph)"),
            ("qconcat", "qconcat.cu", "quant/qtensor.py:86",
             "the shipped frame's nine sites (SHIPPED_SITES: seven int8 "
             "concats, two quantises of a C3k2's input) on their seed-7 "
             "activations, summed (one launch a site)",
             "torch.cat of prebuilt int8 tensors of the parts' output "
             "shapes: the concat's copy alone, no rescale, no quantise, "
             "no upsample (library_ms by events, library_graph_ms in a "
             "replayed graph)")):
        mine = [r for r in sites if r["kernel"] == name]
        sums = {k: sum(r[k] for r in mine) for k in (
            "ms", "graph_ms", "plain_ms", "library_ms", "library_graph_ms",
            "bytes", "ops")}
        b_ms, b_by = bound(sums["bytes"], sums["ops"], F32_FLOPS)
        rows.append(dict(
            name=name, route="cuda",
            source=f"unina_yolo_dla_torch/csrc/{source}",
            replaces=f"unina_yolo_dla_tpu/{replaces}",
            tolerance="exact: every site's output bit for bit its plain "
                      "version's",
            per=per, max_abs_err=max(r["max_abs_err"] for r in mine),
            bound_ms=b_ms, bound_by=b_by, library=lib,
            graph="graph_ms: 20 launches of a site in a replayed graph",
            sites=len(mine), **sums))
    log(json.dumps({"int8_glue_sites": sites}))
    return rows, sites


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
            re.search(rf"(^|\W){f}([,<][^(]*>)?\(", n)
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
            "by_kernel": {n[:200]: {"ms_per_call": v[0],
                                    "calls_per_call": v[1] / calls}
                          for n, v in top},
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


def check_wide_kernels(model, serve, frame, unfused, torch,
                       before=None, gate=True) -> list[dict]:
    """Each fused module of a bf16 fc engine (seven C3k2s, three heads:
    at 64, 128 and 256 channels at base 32, 128 to 512 at base 64) on the
    activations and weights of one served frame: its kernel against its
    plain version on the card, |err| <= 1e-2 (1 + |ref|); its time by CUDA
    events and inside a replayed graph, the plain version's, its bound,
    its launch's grid as the library recorded it, and inside a replayed
    graph the same block of ``unfused`` (an engine of the same weights
    whose blocks are cuDNN convolutions: bf16_s2dm_mh at base 32, the
    fused-stem engine at base 64) on the same activations. ``before``:
    block -> an earlier graph ms, quoted in the log beside each row.
    ``gate`` False (base 16's blocks, timed here only): the error is
    recorded, not held to 1e-2, since a hidden-16 chain of two bf16
    bottlenecks on real activations can grow one flip past it; their bits
    are held on grid inputs and by WIDE_DIGESTS."""
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
            assert rel <= 1e-2 or not gate, (
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
            if before:
                r = rows[-1]
                log(f"{path}: graph {r['graph_ms']:.5f} ms, before "
                    f"{before[path]:.5f} ms (quoted), cuDNN form "
                    f"{r['unfused_ms']:.5f} ms, bound {r['bound_ms']:.5f}")
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
    """Synthetic scenes as a training batch built in memory (numpy, no
    JPEG round trip): uint8 RGB images, the YOLO labels as xyxy pixels
    padded to TRAIN_MAX_BOXES with a mask. Phase 18 runs the loader
    (``data/dataset.py``) over written files."""
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


def _matched(got, want, box_tol: float, score_tol: float,
             gate: bool = True) -> dict:
    """Two images' prediction rows (N, 6) [x1, y1, x2, y2, score, cls]
    matched one to one by class and nearest box; -> counts, how many
    matched within the tolerances, the worst errors (asserted within them
    with ``gate``)."""
    free = np.ones(len(got), bool)
    worst_box = worst_score = 0.0
    within = 0
    for w in want:
        d = np.where(free & (got[:, 5] == w[5]),
                     np.abs(got[:, :4] - w[:4]).max(1), np.inf)
        j = int(np.argmin(d)) if len(d) else -1
        if j < 0 or not np.isfinite(d[j]):
            continue
        free[j] = False
        err = float(abs(got[j, 4] - w[4]))
        within += int(d[j] <= box_tol and err <= score_tol)
        worst_box, worst_score = max(worst_box, float(d[j])), max(
            worst_score, err)
    rec = {"count": len(got), "cpu_count": len(want), "within_tol": within,
           "max_box_err_px": worst_box, "max_score_err": worst_score}
    if gate:
        assert len(got) == len(want) == within, rec
    return rec


def loader_rate(ds, **kw) -> float:
    """Images/s of the host loader (``batch_iterator``, one thread) over
    LOADER_BATCHES batches of EVAL_BATCH."""
    from unina_yolo_dla_torch.data.dataset import batch_iterator

    t, n = time.perf_counter(), 0
    for b in batch_iterator(ds, EVAL_BATCH, np.random.default_rng(0),
                            steps=LOADER_BATCHES, **kw):
        n += len(b["images"])
    return n / (time.perf_counter() - t)


def eval_path_kernels(model, variables, images, launches, n_batches,
                      torch) -> dict:
    """The eval path's three kernels on one batch of val images and the
    full-width model's own logits: normalize (float32 form), decode (K =
    300, q = 0) at the evaluation's conf 0.25 and CP's 0.001, NMS on both
    candidate sets; each bit for bit against its plain version, timed
    (CUDA events, and inside a replayed graph), beside its bound and the
    library's time where one call computes the same function."""
    from torch.func import functional_call

    from unina_yolo_dla_torch.models.detector import model_inputs
    from unina_yolo_dla_torch.ops.cuda import decode_kernel, nms_kernel
    from unina_yolo_dla_torch.ops.cuda.preprocess_kernel import (
        normalize, normalize_plain)

    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    cfg = model.config
    per_batch = {k: v / n_batches for k, v in launches.items()}
    got = normalize(images, out_dtype=torch.float32)
    want = normalize_plain(images, mean, std)
    assert torch.equal(got, want), "normalize (eval batch) differs"
    b_ms, b_by = bound(images.numel() * (1 + 4), 3 * images.numel(),
                       F32_FLOPS)
    out = {"normalize": {
        "shape": list(images.shape), "out_dtype": "float32",
        "max_abs_err": 0.0, "launches_per_batch": per_batch["normalize"],
        "ms": cuda_ms(lambda: normalize(images, out_dtype=torch.float32),
                      20),
        "graph_ms": graph_ms(lambda: normalize(images,
                                               out_dtype=torch.float32)),
        "plain_ms": cuda_ms(lambda: normalize_plain(images, mean, std), 20),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}}
    with torch.no_grad():
        outs = functional_call(model, model_inputs(model, variables),
                               (normalize(images, out_dtype=torch.float32),))
    assert all(c.dtype == torch.float32 and r.dtype == torch.float32
               for c, r in outs), "the head must hand decode float32"
    dec, nms = {}, {}
    for conf in (0.25, 0.001):
        args = (outs, cfg.strides, conf, 0.0, 300)
        got = decode_kernel.decode_topk(*args)
        want = decode_kernel.decode_topk_plain(*args)
        torch.cuda.synchronize()
        for name, g_, w_ in zip(("boxes", "scores", "classes", "valid"),
                                got, want):
            assert torch.equal(g_, w_), f"decode (conf {conf}): {name}"
        b = images.shape[0]
        cells = sum(c.shape[1] * c.shape[2] for c, _ in outs)
        rows = torch.cat([decode_kernel.decode_level_plain(c, r, st, conf,
                                                           0.0)
                          for (c, r), st in zip(outs, cfg.strides)], dim=1)
        masked = torch.where(rows[..., 6] > 0.5, rows[..., 4],
                             torch.full_like(rows[..., 4], -1.0))

        def lib(rows=rows, masked=masked):
            order = torch.sort(masked, dim=1, descending=True, stable=True)[1]
            return rows.gather(1, order[:, :300, None].expand(-1, -1, 7))

        nc = outs[0][0].shape[-1]
        b_ms, b_by = bound(b * (cells * nc * 4 + 300 * (16 + 25)),
                           b * cells * 40, F32_FLOPS)
        valid = int((rows[..., 6] > 0.5).sum())
        dec[f"conf_{conf}"] = dict(
            batch=b, cells=cells, k=300, valid_cells=valid,
            valid_share=valid / (b * cells),
            slots_valid=got[3].sum(dim=1).tolist(), max_abs_err=0.0,
            ms=cuda_ms(lambda: decode_kernel.decode_topk(*args), 50),
            graph_ms=graph_ms(lambda: decode_kernel.decode_topk(*args)),
            plain_ms=cuda_ms(lambda: decode_kernel.decode_topk_plain(*args),
                             5, 1),
            bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib, 20))
        boxes, _, classes, valid_m = got
        nargs = (boxes, classes, valid_m, 0.45)
        keep = nms_kernel.nms_keep(*nargs)
        keep_plain = nms_kernel.nms_keep_plain(*nargs)
        torch.cuda.synchronize()
        assert torch.equal(keep, keep_plain), f"nms (conf {conf}) differs"
        same = ((classes[:, :, None] == classes[:, None, :])
                & valid_m[:, :, None] & valid_m[:, None, :]).triu(1)
        b_ms, b_by = bound(valid_m.numel() * (16 + 4 + 1 + 1),
                           int(same.sum()) * 15, F32_FLOPS)
        nms[f"conf_{conf}"] = dict(
            shape=list(valid_m.shape), valid=valid_m.sum(dim=1).tolist(),
            kept=keep.sum(dim=1).tolist(), max_abs_err=0.0,
            ms=cuda_ms(lambda: nms_kernel.nms_keep(*nargs), 100),
            graph_ms=graph_ms(lambda: nms_kernel.nms_keep(*nargs)),
            plain_ms=cuda_ms(lambda: nms_kernel.nms_keep_plain(*nargs), 2,
                             1),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
    out["decode_topk"] = dict(launches_per_batch=per_batch["decode_topk"],
                              tolerance="exact (all four fields)", **dec)
    out["nms"] = dict(launches_per_batch=per_batch["nms"],
                      tolerance="keep mask exact", **nms)
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def drive_train_cli(kernels, smi: str, rgb, art_g, tmp: Path, ckpt: Path,
                    torch) -> dict:
    """Phase 18, the train CLI's path at full width (``ModelConfig()``,
    640², bf16, batch 16):

    a. the reference's round-5 XHARD set regenerated by the port's
       ``generate_dataset`` (seed 42, 400 train / 200 val, JPEG through
       cv2); the host loader's images/s, augmentation off and on (mosaic
       0.5);
    b. the committed QAT model (``engine_source.msgpack``) evaluated on the
       card over the 200 val images against ``engine_compare.json``
       ``qat_sim`` (|delta| <= METRIC_GATE on map50, map50_95 and
       small-object F1), one decode and one NMS launch a batch; 4 val
       images against the port's CPU path: the FP32 model in float32
       compute gated (same counts, 0.5 px, 1e-2), the QAT model measured
       in float32 and bf16; the eval path's kernels on a val batch
       (``eval_path``);
    c. CP calibration over the same images against ``cp_calibration.json``
       (|delta q_hat| <= Q_GATE, num_scores within NUM_SCORES_GATE);
    d. the CLI (``train.main``, in this process, on the card) from the
       float checkpoint on a 64 / 32 subset of the set, then its exported
       QAT train-form artifact served as one captured CUDA graph;
    e. one DP step under a one-rank NCCL group, bit-equal to the plain
       step on the same batch (cuDNN deterministic; the plain step run
       twice shows it is).

    Every gate asserts; the times stand beside ``smi``."""
    import dataclasses as dc
    import shutil

    import torch.distributed as dist

    from unina_yolo_dla_torch.data.dataset import (
        YoloDataset, batch_iterator, load_dataset_yaml)
    from unina_yolo_dla_torch.data.synthetic import (
        CLASS_NAMES, XHARD, generate_dataset)
    from unina_yolo_dla_torch.evaluate import evaluate_model, predict_batches
    from unina_yolo_dla_torch.models.config import ModelConfig
    from unina_yolo_dla_torch.models.detector import (
        create_model, from_jax_variables, variables_from_jax, variables_of)
    from unina_yolo_dla_torch.parallel import (
        create_mesh, make_parallel_train_step)
    from unina_yolo_dla_torch.quant.qat import make_qat_model
    from unina_yolo_dla_torch.runtime import aot
    from unina_yolo_dla_torch.runtime.artifact import ServingArtifact
    from unina_yolo_dla_torch.train import train as train_cli
    from unina_yolo_dla_torch.train.conformal import \
        calibrate_conformal_prediction
    from unina_yolo_dla_torch.train.trainer import (
        TrainConfig, create_train_state, make_optimizer, make_train_step)
    from unina_yolo_dla_torch.utils.checkpoint import load_msgpack_raw

    dev = torch.device("cuda")
    out = {"card": smi}

    # a. the round-5 set
    t = time.perf_counter()
    yaml = generate_dataset(tmp / "xhard_r5", R5_TRAIN, R5_VAL,
                            dc.replace(XHARD, image_size=640, seed=42))
    out["dataset"] = {"train": R5_TRAIN, "val": R5_VAL, "jpeg": True,
                      "generate_s": time.perf_counter() - t}
    spec = load_dataset_yaml(yaml)
    train_ds = YoloDataset(spec["train"], 640, 100)
    val_ds = YoloDataset(spec["val"], 640, EVAL_MAX_BOXES)
    assert (len(train_ds), len(val_ds)) == (R5_TRAIN, R5_VAL)
    out["loader_images_per_s"] = {
        "augment_off": loader_rate(val_ds),
        "augment_mosaic_0.5": loader_rate(train_ds, augment=True,
                                          mosaic_p=0.5)}
    print(json.dumps({"train_cli_loader": out["loader_images_per_s"],
                      "card": smi}), flush=True)

    # b. the committed QAT model over the 200 val images
    src = load_msgpack_raw(SOURCE)
    qtree = {k: src[k] for k in ("params", "batch_stats", "quant")}
    qvars = variables_from_jax(qtree, dev)
    qmodel = make_qat_model(ModelConfig())

    def val_batches():
        return batch_iterator(val_ds, EVAL_BATCH, np.random.default_rng(0),
                              shuffle=False, augment=False)

    n_batches = -(-R5_VAL // EVAL_BATCH)
    evaluate_model(qmodel, qvars, lambda: iter([next(val_batches())]))
    torch.cuda.synchronize()
    _zero(kernels)
    t = time.perf_counter()
    metrics = evaluate_model(qmodel, qvars, val_batches)
    eval_s = time.perf_counter() - t
    launches = _read(kernels)
    for name in ("normalize", "decode_topk", "nms"):
        assert launches[name] == n_batches, launches
    assert not any(v for k, v in launches.items()
                   if k not in ("normalize", "decode_topk", "nms")), launches
    ref = json.loads((R5 / "engine_compare.json").read_text())["qat_sim"]
    delta = {k: metrics[k] - ref[k] for k in (
        "map50", "map50_95", "small_object_precision",
        "small_object_recall", "small_object_f1")}
    first = next(val_batches())
    images = torch.from_numpy(first["images"]).to(dev)
    # one batch as predict_batches runs it: upload, forward, decode, NMS,
    # one read-back
    prof = profile_calls(lambda b: list(predict_batches(qmodel, qvars, [b])),
                         first, torch, calls=3, unit="eval batch of 16")
    out["evaluate"] = {
        "images": R5_VAL, "batch": EVAL_BATCH, "batches": n_batches,
        "metrics": {k: v for k, v in metrics.items()
                    if not isinstance(v, list)},
        "reference_qat_sim": ref, "delta": delta, "eval_s": eval_s,
        "images_per_s": R5_VAL / eval_s, "launches": launches,
        "device_ms_per_batch": prof["device_busy_ms_per_call"],
        "wall_ms_per_batch": prof["wall_ms_per_call"],
        "idle_share": prof["device_idle_share"], "top": prof["top"][:8]}
    print(json.dumps({"train_cli_evaluate": {
        k: out["evaluate"][k] for k in ("metrics", "delta", "eval_s",
                                        "images_per_s",
                                        "device_ms_per_batch",
                                        "idle_share")}, "card": smi}),
        flush=True)
    for k in ("map50", "map50_95", "small_object_f1"):
        assert abs(delta[k]) <= METRIC_GATE, (
            f"{k}: {metrics[k]} against qat_sim {ref[k]}")
    # 4 val images, the card against the port's CPU path: gated on the
    # FP32 model (float32 compute); the QAT model's measured in bf16 and
    # float32: its fake-quantisers turn the backends' different rounding
    # of a convolution into whole int8 steps where a value sits near a
    # rounding boundary, and near-equal overlapping candidates then swap
    four = {k: v[:4] for k, v in first.items()}
    out["card_vs_cpu"] = {}
    fp_tree = {k: qtree[k] for k in ("params", "batch_stats")}
    for name, make, tree, dtype in (
            ("fp32_float32", create_model, fp_tree, torch.float32),
            ("qat_float32", make_qat_model, qtree, torch.float32),
            ("qat_bfloat16", make_qat_model, qtree, torch.bfloat16)):
        cfg = ModelConfig(compute_dtype=dtype)
        card = list(predict_batches(make(cfg), variables_from_jax(tree, dev),
                                    [four]))
        cpu = list(predict_batches(make(cfg, device="cpu"),
                                   variables_from_jax(tree, "cpu"), [four]))
        out["card_vs_cpu"][name] = [
            _matched(g[0], w[0], 0.5, 1e-2, gate=name.startswith("fp32"))
            for g, w in zip(card, cpu)]
    print(json.dumps({"train_cli_card_vs_cpu": out["card_vs_cpu"]}),
          flush=True)
    out["eval_path"] = eval_path_kernels(qmodel, qvars, images, launches,
                                         n_batches, torch)

    # c. CP calibration over the same images
    cp_ref = json.loads((R5 / "cp_calibration.json").read_text())
    t = time.perf_counter()
    cp = calibrate_conformal_prediction(qmodel, qvars, val_batches())
    out["cp"] = {"q_hat": cp["q_hat"], "num_scores": cp["num_scores"],
                 "num_images": cp["num_images"], "seconds":
                 time.perf_counter() - t,
                 "reference_q_hat": cp_ref["q_hat"],
                 "reference_num_scores": cp_ref["num_scores"]}
    print(json.dumps({"train_cli_cp": out["cp"], "card": smi}), flush=True)
    assert abs(cp["q_hat"] - cp_ref["q_hat"]) <= Q_GATE, out["cp"]
    assert abs(cp["num_scores"] - cp_ref["num_scores"]) <= \
        NUM_SCORES_GATE * cp_ref["num_scores"], out["cp"]
    del qmodel, qvars

    # d. the CLI on a 64 / 32 subset, from the float checkpoint
    sub = tmp / "xhard_r5_subset"
    for split, n in (("train", CLI_TRAIN), ("val", CLI_VAL)):
        for kind, ext in (("images", ".jpg"), ("labels", ".txt")):
            (sub / kind / split).mkdir(parents=True, exist_ok=True)
            for i in range(n):
                shutil.copy(Path(spec["root"]) / kind / split /
                            f"synth_{i:04d}{ext}", sub / kind / split)
    names = "\n".join(f"  {i}: {n}" for i, n in enumerate(CLASS_NAMES))
    (sub / "data.yaml").write_text(
        f"path: {sub}\ntrain: images/train\nval: images/val\n"
        f"names:\n{names}\nnc: 4\n")
    timings = {}

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            timings[name] = time.perf_counter() - t0
            return r
        return run

    patched = {(train_cli, "prepare_qat_variables"): "calibration_s",
               (train_cli, "calibrate_conformal_prediction"): "cp_s",
               (aot, "export_serving_artifact"): "export_s"}
    saved = {key: getattr(*key) for key in patched}
    for (mod, attr), name in patched.items():
        setattr(mod, attr, timed(name, saved[(mod, attr)]))
    cli_dir = tmp / "cli_run"
    _zero(kernels)
    t = time.perf_counter()
    try:
        import contextlib

        with contextlib.redirect_stdout(sys.stderr):
            results = train_cli.main(
                ["--data", str(sub / "data.yaml"), "--weights", str(ckpt),
                 "--output-dir", str(cli_dir), *CLI_ARGS])
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)
    cli_s = time.perf_counter() - t
    cli_launches = _read(kernels)
    assert "cp" in results and (cli_dir / "cp_calibration.json").exists()
    for name in ("normalize", "decode_topk", "nms"):
        assert cli_launches[name] > 0, cli_launches
    phases = {}
    for phase in ("fp32", "qat"):
        m = results[phase]
        phases[phase] = {
            "epoch_s": m["time_s"], "train_s": m["train_s"],
            "train_images_per_s": CLI_TRAIN // EVAL_BATCH * EVAL_BATCH
            / m["train_s"], "eval_s": m["eval_s"], "loss": m["loss"],
            "map50": m["map50"], "small_object_f1": m["small_object_f1"]}
    art_dir = cli_dir / "serving_artifact"
    conf = json.loads((art_dir / "config.json").read_text())
    rep = json.loads((art_dir / "fallback_report.json").read_text())
    assert conf["quant_mode"] == "quantize" and rep["captured"], conf
    assert not rep["host_nodes"] and not rep["dynamic_shapes"], rep
    art = ServingArtifact(art_dir)
    assert art.graph is not None and art.graph.report.clean
    assert not art.model_config.deploy
    count = int(art(rgb).count)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        art.graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(20):
        art.graph.replay()
    end.record()
    torch.cuda.synchronize()
    out["cli"] = {
        "subset": [CLI_TRAIN, CLI_VAL], "args": CLI_ARGS, "cli_s": cli_s,
        "phases": phases, **timings, "launches": cli_launches,
        "q_hat": results["cp"]["q_hat"],
        "num_scores": results["cp"]["num_scores"],
        "artifact": {"quant_mode": conf["quant_mode"],
                     "report": {k: rep[k] for k in (
                         "host_nodes", "kernel_nodes", "port_kernels",
                         "captured")},
                     "graph_kernel_nodes": art.graph.report.kernel_nodes,
                     "graph_ms": start.elapsed_time(end) / 20,
                     "seed7_detections": count,
                     "shipped_seed7_detections": int(art_g(rgb).count)}}
    print(json.dumps({"train_cli": out["cli"], "card": smi}), flush=True)
    del art

    # e. one DP step under a one-rank NCCL group
    fp = {k: src[k] for k in ("params", "batch_stats")}
    model = from_jax_variables(fp, ModelConfig())
    tc = TrainConfig(total_steps=10, warmup_steps=3)
    tx = make_optimizer(tc)
    state = create_train_state(variables_of(model), tx, tc)
    step = make_train_step(model, model.config, tx, tc)
    sub_ds = YoloDataset(sub / "images" / "train", 640, 100)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(batch_iterator(
        sub_ds, EVAL_BATCH, np.random.default_rng(0), steps=1)).items()
        if k not in ("sample_valid", "indices")}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        runs = [step(state, batch), step(state, batch),
                make_parallel_train_step(step, create_mesh())(state, batch)]
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic = deterministic

    def equal(a, b) -> bool:
        (sa, xa), (sb, xb) = a, b
        return (all(torch.equal(xa[k], xb[k]) for k in xa)
                and all(torch.equal(getattr(sa, f)[k], getattr(sb, f)[k])
                        for f in ("params", "batch_stats", "ema_params")
                        for k in getattr(sa, f)))

    out["dp"] = {"backend": "nccl", "world_size": 1,
                 "plain_repeat_bit_equal": equal(runs[0], runs[1]),
                 "dp_bit_equal": equal(runs[0], runs[2]),
                 "loss": float(runs[2][1]["loss"]),
                 "grad_norm": float(runs[2][1]["grad_norm"])}
    print(json.dumps({"train_cli_dp": out["dp"]}), flush=True)
    assert out["dp"]["dp_bit_equal"], out["dp"]
    del model, state, runs
    torch.cuda.empty_cache()
    return out


def drive_mode(name: str, tmp: Path, rgb, labels, scenes, kernels,
               torch) -> dict:
    """Phase 19, one deploy mode: exported by the port on the card from the
    committed checkpoint (a clean strict report), served eager FRAMES
    frames against the port's CPU path on the seed-7 scene (``drive``:
    same count, 0.5 px, 1e-2; one normalize, stem, decode and NMS launch a
    frame), then as one captured graph equal to the eager frame on the 8
    scenes (``drive_graph``)."""
    from unina_yolo_dla_torch.runtime.artifact import ServingArtifact

    d = tmp / name
    secs = run_export(["--weights", SOURCE, *MODE_FLAGS[name],
                       "--cp-calibration", CP_CALIBRATION, "--output", d])
    conf = json.loads((d / "config.json").read_text())
    rep = json.loads((d / "fallback_report.json").read_text())
    mode = "int8" if name == "int8_unfused" else "quantize"
    assert conf["quant_mode"] == mode and conf["quantized"], conf
    assert rep["captured"] and not rep["host_nodes"], rep
    eager = ServingArtifact(d, graph=False)
    assert eager.model_config.quant.mode == mode
    cpu = ServingArtifact(d, device="cpu")(rgb)
    e2e = drive(eager, rgb, labels, kernels, MODE_PER_FRAME[name], cpu,
                torch)

    def capture():
        owner = ServingArtifact(d)
        return owner, owner.graph

    _owner, _graph, g = drive_graph(capture, lambda a, f: a(f), eager,
                                    scenes, kernels, MODE_PER_FRAME[name],
                                    25600,
                                    torch, copies=True)
    return {"export_s": secs, "quant_mode": mode,
            "report": {k: rep[k] for k in ("host_nodes", "kernel_nodes",
                                           "port_kernels", "captured")},
            "e2e": {k: e2e[k] for k in ("valid", "gt_cones",
                                        "frame_ms_median", "frame_ms_min",
                                        "vs_cpu_port")},
            "launches": {k: v for k, v in e2e["launches"].items() if v},
            "graph": {k: g[k] for k in ("call_ms_median", "call_ms_min",
                                        "capture_s", "bit_equal_vs_eager")},
            "graph_kernel_nodes": g["report"]["kernel_nodes"]}


def width_inputs(rng, c, shape, grid, dev, torch):
    """Frame (B, H, W2, 24), merged stem output (B, H, W2, C), stem and
    stage1 kernels and biases: seeded normal (activations ReLU'd), or on
    binary grids (activations k/2, sparse weights k/4, biases k/8: every
    f32 sum exact in any order)."""
    bf = torch.bfloat16

    def act(sh, relu):
        if grid:
            a = rng.integers(0 if relu else -4, 5, sh) * 0.5
        else:
            a = rng.normal(0, 1, sh)
            a = np.maximum(a, 0) if relu else a
        return torch.from_numpy(a.astype(np.float32)).to(dev, bf)

    def kb(sh):
        fan = int(np.prod(sh[:-1]))
        if grid:
            k = np.where(rng.random(sh) < min(1.0, 8 / fan),
                         rng.choice([-.5, -.25, .25, .5], sh), 0.0)
            b = rng.integers(-2, 3, sh[-1]) / 8
        else:
            k = rng.normal(0, np.sqrt(2 / fan), sh)
            b = rng.normal(0, .1, sh[-1])
        return (torch.from_numpy(k.astype(np.float32)).to(dev, bf),
                torch.from_numpy(b.astype(np.float32)).to(dev))

    frame = act((*shape, 24), relu=False)
    xm = act((*shape, c), relu=True)
    ks, bs = kb((2, 2, 24, c))
    k1, b1 = kb((2, 2, 2 * c, c))
    return frame, xm, ks, bs, k1, b1


def width_outputs(c, shape, grid, seed, torch):
    """The stem and stage1 kernels and their plain versions at width
    ``c`` on ``width_inputs``: name -> (kernel's, plain's)."""
    from unina_yolo_dla_torch.ops.cuda import mma_pack, stage1_kernel, \
        stem_kernel

    dev = torch.device("cuda")
    frame, xm, ks, bs, k1, b1 = width_inputs(np.random.default_rng(seed), c,
                                             shape, grid, dev, torch)
    ksp, k1p = mma_pack.pack_stem_mma(ks), mma_pack.pack_stage1_mma(k1)
    out = {"stem": (stem_kernel.fused_stem_stage1(frame, ksp, bs, k1p, b1),
                    stem_kernel.fused_stem_stage1_plain(frame, ks, bs, k1,
                                                        b1)),
           "stage1": (stage1_kernel.fused_downsample_merged(xm, k1p, b1),
                      stage1_kernel.fused_downsample_merged_plain(xm, k1,
                                                                  b1))}
    torch.cuda.synchronize()
    return out


def check_widths_grid(torch) -> dict:
    """Every compiled width of the stem and stage1 kernels on binary-grid
    inputs at the served shape, ragged batches of 2 and 3 and a single
    output pixel, and the C3k2 and head kernels at base 64's new widths
    (``wide_grid_checks``): bit for bit their plain versions; the stem and
    stage1 kernels' outputs at every width and the wide C3k2 and head
    kernels' at their earlier widths on seeded normal inputs: the digests
    they had before (WIDTH32/64/128_DIGESTS, WIDE_DIGESTS); the C = 128
    cluster kernels relaunched 100 times (``relaunch_check``)."""
    from unina_yolo_dla_torch.ops.cuda import mma_pack

    exact = {}
    for c in mma_pack.STEM_STAGE1_WIDTHS:
        for shape in ((1, 320, 160), (2, 10, 37), (3, 34, 61), (3, 2, 1)):
            for name, (got, want) in width_outputs(c, shape, True, 100 + c,
                                                   torch).items():
                # a single output pixel a row may be small, never all 0
                assert float(want.float().abs().max()) > (
                    1.0 if shape[1] > 2 else 0.0), "degenerate grid inputs"
                key = f"{name}_c{c}_{'x'.join(map(str, shape))}"
                exact[key] = bool(torch.equal(got, want))
                assert exact[key], f"{key}: kernel differs from plain"
    for c, want in ((64, WIDTH64_DIGESTS), (128, WIDTH128_DIGESTS),
                    (32, WIDTH32_DIGESTS)):
        digests = width_digests(torch, c)
        moved = sorted(k for k in want if digests[k] != want[k])
        assert not moved, f"{c}-wide digests moved: {moved}"
    relaunch = relaunch_check(torch)
    relaunch.update(persist_relaunch_check(torch))
    exact.update(wide_grid_checks(torch))
    exact.update(wide_grid_checks(torch, PERSIST_SHAPES))
    digests = wide_digests(torch)
    moved = {k for k, v in digests.items() if WIDE_DIGESTS[k] != v}
    assert not moved, f"wide kernels' digests moved: {sorted(moved)}"
    digests64 = wide_digests(torch, WIDE64_SHAPES)
    moved64 = {k for k, v in digests64.items() if WIDE64_DIGESTS[k] != v}
    assert moved64 <= set(WIDE64_REORDERED), (
        f"base-64 digests moved: {sorted(moved64 - set(WIDE64_REORDERED))}")
    persist = wide_digests(torch, PERSIST_SHAPES)
    moved_p = sorted(k for k, v in persist.items() if PERSIST_DIGESTS[k] != v)
    assert not moved_p, f"persistent-plan digests moved: {moved_p}"
    return {"grid_bit_equal": exact, "digests_64_unchanged": True,
            "digests_128_32_unchanged": True, "relaunch_bit_equal": relaunch,
            "wide_digests_unchanged": len(digests),
            "wide64_digests_unchanged": len(digests64) - len(moved64),
            "wide64_reordered": {k: digests64[k] for k in sorted(moved64)},
            "persist_digests_unchanged": len(persist)}


RELAUNCHES = 100


def relaunch_check(torch) -> dict:
    """The C = 128 stem and stage1 kernels, whose blocks hand each other
    windows through distributed shared memory and multicast copies,
    launched RELAUNCHES times back to back at the served shape and at a
    ragged batch of 3 on seeded normal inputs: every output bit for bit
    the first (a race in the hand-off would show as a flipped bit in some
    launch). Returns the launches compared per case."""
    from unina_yolo_dla_torch.ops.cuda import mma_pack, stage1_kernel, \
        stem_kernel

    dev = torch.device("cuda")
    done = {}
    for shape, seed in (((1, 320, 160), 11), ((3, 34, 61), 13)):
        frame, xm, ks, bs, k1, b1 = width_inputs(
            np.random.default_rng(seed), 128, shape, False, dev, torch)
        ksp, k1p = mma_pack.pack_stem_mma(ks), mma_pack.pack_stage1_mma(k1)
        calls = {"stem": lambda: stem_kernel.fused_stem_stage1(
                     frame, ksp, bs, k1p, b1),
                 "stage1": lambda: stage1_kernel.fused_downsample_merged(
                     xm, k1p, b1)}
        for name, call in calls.items():
            outs = [call() for _ in range(RELAUNCHES)]
            torch.cuda.synchronize()
            key = f"{name}_c128_{'x'.join(map(str, shape))}"
            same = sum(bool(torch.equal(o, outs[0])) for o in outs)
            assert same == RELAUNCHES, f"{key}: {RELAUNCHES - same} of " \
                f"{RELAUNCHES} launches differ from the first"
            done[key] = same
    return done


def persist_relaunch_check(torch) -> dict:
    """The wide C3k2 kernel on the persistent plan and the wide head on
    the large plan, whose blocks reuse their ring's slots and windows from
    tile to tile (the next tile's chunks and input copied while this tile
    multiplies), launched RELAUNCHES times back to back at base 64's three
    served shapes they take and at ragged batches of 2 (PERSIST_SHAPES) on
    seeded normal inputs:
    every output bit for bit the first. The ragged batches of
    WIDE64_SHAPES run the replicated plan and are held to their digests
    elsewhere. Returns the launches compared per case."""
    shapes = {k: v for k, v in WIDE64_SHAPES.items()
              if k in ("stage1_block_1x160x160", "fpn_c3k2_2_1x160x160",
                       "head_p2_1x160x160")}
    done = {}
    for name, call in wide_calls(torch, {**shapes, **PERSIST_SHAPES}).items():
        outs = [call() for _ in range(RELAUNCHES)]
        torch.cuda.synchronize()
        same = sum(all(bool(torch.equal(a, b)) for a, b in zip(o, outs[0]))
                   for o in outs)
        assert same == RELAUNCHES, f"{name}: {RELAUNCHES - same} of " \
            f"{RELAUNCHES} launches differ from the first"
        done[name] = same
    return done


def wide_grid_checks(torch, shapes=None) -> dict:
    """The C3k2 and head kernels at base 64's ten blocks' shapes
    (WIDE64_SHAPES by default: 640² and ragged batches of 2) on
    binary-grid inputs (activations k/2, sparse weights k/4, biases k/8:
    every f32 sum exact in any order): bit for bit their plain versions."""
    from unina_yolo_dla_torch.ops.cuda import c3k2_kernel, head_kernel, \
        mma_pack

    dev, bf = torch.device("cuda"), torch.bfloat16
    rng = np.random.default_rng(16)

    def act(shape):
        a = rng.integers(0, 5, shape) * 0.5
        return torch.from_numpy(a.astype(np.float32)).to(dev, bf)

    def kb(shape):
        fan = int(np.prod(shape[:-1]))
        k = np.where(rng.random(shape) < min(1.0, 8 / fan),
                     rng.choice([-.5, -.25, .25, .5], shape), 0.0)
        return (k.astype(np.float32),
                (rng.integers(-2, 3, shape[-1]) / 8).astype(np.float32))

    exact = {}
    for name, case in (WIDE64_SHAPES if shapes is None else shapes).items():
        if name.startswith("head"):
            b, h, w, c = case
            x = act((b, h, w, c))
            ws = [t.to(dev) for t in head_kernel.pack_head_weights(
                [kb((3, 3, c, c)), kb((3, 3, c, c))], kb((1, 1, c, 4)),
                [kb((3, 3, c, c)), kb((3, 3, c, c))], kb((1, 1, c, 4)), bf)]
            got = head_kernel.fused_head(x, *ws, w33=mma_pack.pack_head_mma(
                ws[0], ws[6], ws[2], ws[8], ws[4], ws[10]))
            want = head_kernel.fused_head_plain(x, *ws)
        else:
            b, h, w, ca, cb, hd, n, up, shortcut = case
            xb = act((b, h, w, cb))
            xa = act((b, h // 2, w // 2, ca) if up else (b, h, w, ca))
            ws = [t.to(dev) for t in c3k2_kernel.pack_c3k2_weights(
                kb((1, 1, ca + cb, hd)), kb((1, 1, ca + cb, hd)),
                kb((1, 1, 2 * hd, 2 * hd)),
                [(kb((1, 1, hd, hd)), kb((3, 3, hd, hd))) for _ in range(n)],
                bf)]
            wpk = mma_pack.pack_c3k2_mma(ws[0], ws[6], ws[2], ws[4], ws[8],
                                         ca)
            if ca:
                got = (c3k2_kernel.fused_c3k2_cat(
                    xa, xb, *ws, shortcut=shortcut, up_a=up, wpk=wpk),)
                want = (c3k2_kernel.fused_c3k2_cat_plain(
                    xa, xb, *ws, shortcut=shortcut, up_a=up),)
            else:
                got = (c3k2_kernel.fused_c3k2(xb, *ws, shortcut=shortcut,
                                              wpk=wpk),)
                want = (c3k2_kernel.fused_c3k2_plain(xb, *ws,
                                                     shortcut=shortcut),)
        torch.cuda.synchronize()
        assert float(want[0].float().abs().max()) > 1.0, \
            f"{name}: degenerate grid inputs"
        exact[name] = all(bool(torch.equal(g, w_))
                          for g, w_ in zip(got, want))
        assert exact[name], f"{name}: kernel differs from plain"
    return exact


# the seeded normal inputs each width's digests are taken on: (shape,
# seed); C = 64's two are those WIDTH64_DIGESTS were recorded on
WIDTH_DIGEST_CASES = {
    64: (((1, 320, 160), 11), ((2, 10, 37), 12)),
    32: (((1, 320, 160), 11), ((2, 10, 37), 12), ((3, 34, 61), 13)),
    128: (((1, 320, 160), 11), ((2, 10, 37), 12), ((3, 34, 61), 13)),
}


def width_digests(torch, c: int = 64) -> dict:
    """SHA-256 of the stem and stage1 kernels' outputs at width ``c`` on
    seeded normal inputs (``WIDTH_DIGEST_CASES``: the served shape and
    ragged batches; WIDTH32/64/128_DIGESTS)."""
    import hashlib

    digests = {}
    for shape, seed in WIDTH_DIGEST_CASES[c]:
        for name, (got, _) in width_outputs(c, shape, False, seed,
                                            torch).items():
            key = f"{name}_{'x'.join(map(str, shape))}"
            digests[key] = hashlib.sha256(
                got.contiguous().view(torch.int16).cpu().numpy().tobytes()
            ).hexdigest()
    return digests


def wide_calls(torch, shapes=None) -> dict:
    """The wide C3k2 and head kernels at every shape of ``shapes``
    (WIDE_SHAPES by default) on seeded normal inputs (activations ReLU'd;
    weights N(0, 2/fan), biases N(0, 0.1)): name -> a call of the kernel
    on them, returning its output tensors."""
    from unina_yolo_dla_torch.ops.cuda import c3k2_kernel, head_kernel, \
        mma_pack

    dev, bf = torch.device("cuda"), torch.bfloat16
    calls = {}
    for name, case in (WIDE_SHAPES if shapes is None else shapes).items():
        rng = np.random.default_rng(WIDE_SEED)

        def act(shape):
            a = np.maximum(rng.normal(0, 1, shape), 0).astype(np.float32)
            return torch.from_numpy(a).to(dev, bf)

        def kb(shape):
            fan = int(np.prod(shape[:-1]))
            return (rng.normal(0, np.sqrt(2 / fan), shape).astype(np.float32),
                    rng.normal(0, .1, shape[-1]).astype(np.float32))

        if name.startswith("head"):
            b, h, w, c = case
            x = act((b, h, w, c))
            ws = [t.to(dev) for t in head_kernel.pack_head_weights(
                [kb((3, 3, c, c)), kb((3, 3, c, c))], kb((1, 1, c, 4)),
                [kb((3, 3, c, c)), kb((3, 3, c, c))], kb((1, 1, c, 4)), bf)]
            w33 = mma_pack.pack_head_mma(ws[0], ws[6], ws[2], ws[8], ws[4],
                                         ws[10])

            def call(x=x, ws=ws, w33=w33):
                return head_kernel.fused_head(x, *ws, w33=w33)
        else:
            b, h, w, ca, cb, hd, n, up, shortcut = case
            xb = act((b, h, w, cb))
            xa = act((b, h // 2, w // 2, ca) if up else (b, h, w, ca)) \
                if ca else None
            ws = [t.to(dev) for t in c3k2_kernel.pack_c3k2_weights(
                kb((1, 1, ca + cb, hd)), kb((1, 1, ca + cb, hd)),
                kb((1, 1, 2 * hd, 2 * hd)),
                [(kb((1, 1, hd, hd)), kb((3, 3, hd, hd))) for _ in range(n)],
                bf)]
            wpk = mma_pack.pack_c3k2_mma(ws[0], ws[6], ws[2], ws[4], ws[8],
                                         ca)

            def call(xa=xa, xb=xb, ws=ws, wpk=wpk, sc=shortcut, up=up):
                return (c3k2_kernel.fused_c3k2(
                    xb, *ws, shortcut=sc, wpk=wpk) if xa is None else
                    c3k2_kernel.fused_c3k2_cat(xa, xb, *ws, shortcut=sc,
                                               up_a=up, wpk=wpk),)
        calls[name] = call
    return calls


def wide_outputs(torch, shapes=None) -> dict:
    """``wide_calls``' kernels called once: name -> the output tensors."""
    out = {name: call() for name, call in wide_calls(torch, shapes).items()}
    torch.cuda.synchronize()
    return out


def wide_digests(torch, shapes=None) -> dict:
    """SHA-256 of ``wide_outputs``' tensors, name by name (WIDE_DIGESTS;
    WIDE64_DIGESTS at WIDE64_SHAPES)."""
    import hashlib

    digests = {}
    for name, tensors in wide_outputs(torch, shapes).items():
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        digests[name] = h.hexdigest()
    return digests


def width_checkpoint(base: int, tmp: Path, torch) -> Path:
    """A random-initialised checkpoint at ``base``: the port's seeded
    ``init_model`` (seed = base), its BatchNorm scales at WIDTH_BN_GAIN,
    written as the reference's variable tree."""
    from unina_yolo_dla_torch.models.blocks import BatchNorm
    from unina_yolo_dla_torch.models.config import ModelConfig
    from unina_yolo_dla_torch.models.detector import init_model, \
        to_jax_variables
    from unina_yolo_dla_torch.utils.checkpoint import save_msgpack

    model, _ = init_model(ModelConfig(base_channels=base),
                          generator=torch.Generator().manual_seed(base),
                          device="cpu")
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.scale.fill_(WIDTH_BN_GAIN)
    path = tmp / f"init_base{base}.msgpack"
    save_msgpack(to_jax_variables(model), path)
    return path


def _top_logits(art, rgb, torch):
    """The served frame's per-cell max class logits (every level), as
    ``art``'s model computes them on its device."""
    from unina_yolo_dla_torch.ops.cuda.preprocess_kernel import (
        channel_constants, normalize)

    staged = art.stage(rgb)
    mean, std = channel_constants(staged.shape[-1])
    with torch.inference_mode():
        outs = art.model(normalize(staged[None], mean, std,
                                   out_dtype=torch.bfloat16))
    return torch.cat([c.float().amax(-1).reshape(-1) for c, _ in outs]).cpu()


def gap_threshold(card, cpu, rgb, torch) -> tuple[float, dict]:
    """The confidence threshold of a random-initialised engine, whose cell
    scores crowd together: the midpoint of the widest gap between
    consecutive top cell logits of the served frame (the card's ranking,
    ranks WIDTH_GAP_RANKS) at which the card and the CPU path pass the
    same cells (a bf16 step of difference between the two must not decide
    the comparison); raises where no gap does."""
    a, b = _top_logits(card, rgb, torch), _top_logits(cpu, rgb, torch)
    lo, hi = WIDTH_GAP_RANKS
    top = a.sort(descending=True).values[:hi + 1]
    gaps = top[lo - 1:hi] - top[lo:hi + 1]
    for i in gaps.argsort(descending=True).tolist():
        mid = float((top[lo - 1 + i] + top[lo + i]) / 2)
        if gaps[i] > 0 and torch.equal(a > mid, b > mid):
            break
    else:
        raise AssertionError("no threshold at which the card and the CPU "
                             "path pass the same cells")
    conf = float(1 / (1 + np.exp(-mid)))
    return conf, {"rank": lo + i, "gap_logit": float(gaps[i]),
                  "widest_gap_logit": float(gaps.max()),
                  "card_cpu_max_logit_diff": float((a - b).abs().max()),
                  "threshold_logit": mid, "conf": conf,
                  "top_logit": float(top[0])}


def _width_module(kernel: str, model):
    return (model.backbone if kernel == "fused_stem_stage1"
            else model.backbone.stage1_conv)


def width_row(kernel: str, base: int, eager, rgb, torch) -> dict:
    """The width's kernel on the served frame's own activations and the
    engine's weights against its plain version (|err| <= 1e-2 (1 +
    |ref|)), timed; the stage1 row beside one cuDNN conv computing the
    same function."""
    from functools import partial

    import torch.nn.functional as F

    from unina_yolo_dla_torch.ops.cuda import stage1_kernel, stem_kernel

    bf = torch.bfloat16
    mod = _width_module(kernel, eager.model)
    caps = {}
    hook = mod.register_forward_pre_hook(
        lambda _m, args: caps.setdefault("x", args[0]))
    try:
        eager(rgb)
        torch.cuda.synchronize()
    finally:
        hook.remove()
    xm = caps["x"].to(bf).contiguous()
    library_ms = None
    if kernel == "fused_stem_stage1":
        args = (xm, mod.stem_kernel_mma, mod.stem_bias, mod.stage1_kernel_mma,
                mod.stage1_bias)
        plain_args = (xm, mod.stem_kernel, mod.stem_bias, mod.stage1_kernel,
                      mod.stage1_bias)
        fn = partial(stem_kernel.fused_stem_stage1, *args)
        plain = partial(stem_kernel.fused_stem_stage1_plain, *plain_args)
        h, w2, cm = xm.shape[1:]
        o2, c2 = mod.stem_kernel.shape[-1], mod.stage1_kernel.shape[-1]
        flops = 2 * (h * w2 * o2 * 4 * cm + (h // 2) * w2 * c2 * 8 * o2)
        nbytes = (xm.numel() * 2 + (h // 2) * w2 * c2 * 2
                  + (mod.stem_kernel.numel() + mod.stage1_kernel.numel()) * 2
                  + (o2 + c2) * 4)
        replaces = "stem_kernel.py:192"
    else:
        wb, bias, wb_mma = mod.kernel, mod.bias, mod.kernel_mma
        fn = partial(stage1_kernel.fused_downsample_merged, xm, wb_mma, bias)
        plain = partial(stage1_kernel.fused_downsample_merged_plain, xm, wb,
                        bias)
        _, h, w2, cm = xm.shape
        c = cm // 2
        xs = xm.reshape(1, h, 2 * w2, c).permute(0, 3, 1, 2)
        k4 = wb.reshape(2, 2, 2, 2, c, -1).permute(5, 4, 0, 2, 1, 3).reshape(
            -1, c, 4, 4).contiguous()

        def lib():
            return F.conv2d(xs, k4, bias.to(bf), stride=2,
                            padding=2)[..., :h // 2, :w2]

        ref = torch.relu(lib()).permute(0, 2, 3, 1).float()
        lib_rel = float(((fn().float() - ref).abs() / (1 + ref.abs())).max())
        assert lib_rel <= 1e-2, f"stage1 yardstick disagrees: {lib_rel}"
        library_ms = cuda_ms(lib, 50)
        out_numel = (h // 2) * w2 * wb.shape[-1]
        nbytes = (xm.numel() * 2 + out_numel * 2 + wb.numel() * 2
                  + bias.numel() * 4)
        flops = 2 * out_numel * wb.shape[0] * wb.shape[1] * wb.shape[2]
        replaces = "stage1_kernel.py:127"
    got, want = fn(), plain()
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    rel = float(((g - w).abs() / (1.0 + w.abs())).max())
    assert rel <= 1e-2, f"{kernel} base {base}: |err|/(1+|ref|) {rel}"
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
    source = "stem.cu" if kernel == "fused_stem_stage1" else "stage1.cu"
    return dict(
        name=f"{kernel}_b{base}", route="cuda",
        source=f"unina_yolo_dla_torch/csrc/{source}",
        replaces=f"unina_yolo_dla_tpu/ops/pallas/{replaces}",
        width=2 * base, max_abs_err=err,
        tolerance="|err| <= 1e-2 * (1 + |ref|); bit for bit on grid inputs",
        ms=cuda_ms(fn, 100), graph_ms=graph_ms(fn),
        plain_ms=cuda_ms(plain, 10), bound_ms=b_ms, bound_by=b_by,
        library_ms=library_ms)


def drive_width(engine: str, base: int, ckpt: Path, tmp: Path, rgb,
                scenes, torch) -> tuple[dict, dict | None, object]:
    """Phase 20, one engine of WIDTH_ENGINES at ``base``: exported on the
    card, its threshold set in a gap (``gap_threshold``), re-exported with
    it; eager FRAMES frames with every launch count at 0 before and read
    after (normalize, decode and NMS once a frame, the engine's kernels as
    often as WIDTH_ENGINES says) against the port's CPU path on the seed-7
    scene (same count > 0, 0.5 px, 1e-2); one captured graph (clean strict
    report, each of the engine's kernels captured as often as a frame
    launches it, no launch in replays) equal to the eager frame on the 8
    scenes. -> (the engine's record, its kernel's row (``width_row``;
    None for ``s2dm_fc``), the eager ServingArtifact)."""
    from unina_yolo_dla_torch.ops.cuda import (
        _lib, c3k2_kernel, decode_kernel, head_kernel, nms_kernel,
        preprocess_kernel, stage1_kernel, stem_kernel)
    from unina_yolo_dla_torch.runtime import aot
    from unina_yolo_dla_torch.runtime.artifact import ServingArtifact

    c = 2 * base
    flags_, per = WIDTH_ENGINES[engine]
    kern = {"fused_stem_stage1": stem_kernel.KERNELS[c],
            "stage1_merged": stage1_kernel.KERNELS[c],
            "fused_c3k2": c3k2_kernel.KERNEL,
            "fused_c3k2_cat": c3k2_kernel.KERNEL_CAT,
            "fused_head": head_kernel.KERNEL}
    counted = {"normalize": (preprocess_kernel.KERNEL, 1),
               "decode_topk": (decode_kernel.KERNEL, 1),
               "nms": (nms_kernel.KERNEL, 1),
               **{name: (kern[name], n) for name, n in per.items()}}
    flags = ["--weights", ckpt, "--base-channels", base, *flags_,
             "--cp-calibration", CP_CALIBRATION]
    first = tmp / f"{engine}_b{base}_first"
    run_export([*flags, "--output", first])
    probe = ServingArtifact(first, graph=False)
    conf, gap = gap_threshold(probe, ServingArtifact(first, device="cpu"),
                              rgb, torch)
    log(f"base {base} {engine}: threshold {json.dumps(gap)}")
    del probe
    d = tmp / f"{engine}_b{base}"
    secs = run_export([*flags, "--conf", conf, "--output", d])
    rep = json.loads((d / "fallback_report.json").read_text())
    assert rep["captured"] and not rep["host_nodes"], rep
    eager = ServingArtifact(d, graph=False)
    model = eager.model
    if engine == "fused_stem_stage1":
        assert model.backbone.fused_stem, engine
    else:
        assert type(model.backbone.stage1_conv).__name__ == \
            "MergedDownsample", engine
        for paths in FC_MODULES.values():
            for path in paths:
                mod = model.get_submodule(path)
                assert mod.fused and getattr(
                    mod, "w33" if path.startswith("head") else "wpk"
                ) is not None, f"base {base} {engine}: {path} not packed"
    cpu = ServingArtifact(d, device="cpu")(rgb)
    for _ in range(3):
        eager(rgb)
    torch.cuda.synchronize()
    for k in _lib.KERNELS:
        k.launches = 0
    times = []
    for _ in range(FRAMES):
        t = time.perf_counter()
        dets = eager(rgb)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    launches = {k.symbol: k.launches for k in _lib.KERNELS if k.launches}
    for name, (k, n) in counted.items():
        assert k.launches == n * FRAMES, (
            f"base {base} {engine}: {name} launched {k.launches} times in "
            f"{FRAMES} frames, expected {n * FRAMES}")
    assert bool(torch.isfinite(dets.boxes).all())
    match = match_detections(dets, cpu, box_tol=0.5, score_tol=1e-2)
    assert match["count"] > 0, "no detection to compare"
    t = time.perf_counter()
    owner = ServingArtifact(d)
    capture_s = time.perf_counter() - t
    g = owner.graph
    aot.print_fallback_report(g.report, strict=True, log_fn=log)
    for name, (k, n) in counted.items():
        assert g.capture_launches.get(k.symbol) == n, (
            name, g.capture_launches)
        assert g.report.port_kernels[name] == n, (name,
                                                   g.report.port_kernels)
    wants = [eager(frame) for frame in scenes]
    for k in _lib.KERNELS:
        k.launches = 0
    bit_equal, gtimes = [], []
    for frame, want in zip(scenes, wants):
        t = time.perf_counter()
        got = owner(frame)
        torch.cuda.synchronize()
        gtimes.append((time.perf_counter() - t) * 1e3)
        bit_equal.append(_same(got, want))
    replays = {k.symbol: k.launches for k in _lib.KERNELS if k.launches}
    assert not replays, f"eager launches during replays: {replays}"
    assert all(bit_equal), f"base {base} {engine}: replay differs"
    row = None
    if engine in WIDTH_ROW:
        kernel = WIDTH_ROW[engine]
        row = width_row(kernel, base, eager, rgb, torch)
        row["launches"] = launches[kern[kernel].symbol]
    rec = {"base": base, "engine": engine, "flags": flags_,
           "export_s": secs, "threshold": gap, "frames": FRAMES,
           "frame_ms_median": float(np.median(times)),
           "valid": dets.count, "vs_cpu_port": match, "launches": launches,
           "graph_capture_s": capture_s,
           "graph_call_ms_median": float(np.median(gtimes)),
           "graph_kernel_nodes": g.report.kernel_nodes,
           "graph_port_kernels": g.report.port_kernels,
           "bit_equal_vs_eager": bit_equal}
    del owner
    return rec, row, eager


def check_nms_fast(art, rgb, serve_kw, torch) -> dict:
    """The one-pass NMS switch on the card: the shipped engine's model
    served with ``use_greedy_nms=False`` on the seed-7 frame (decode once,
    the NMS kernel not at all: ``nms_fast`` is plain PyTorch) against the
    port's CPU path with the same switch (same count > 0, 0.5 px, 1e-2);
    and the count the greedy path gives beside it."""
    from unina_yolo_dla_torch.ops.cuda import decode_kernel, nms_kernel
    from unina_yolo_dla_torch.runtime.artifact import ServingArtifact
    from unina_yolo_dla_torch.runtime.pipeline import build_serving_fn

    cfg = art.model_config
    fast = build_serving_fn(art.model, cfg, use_greedy_nms=False, **serve_kw)
    cpu_art = ServingArtifact(ARTIFACT, device="cpu")
    cpu = build_serving_fn(cpu_art.model, cfg, use_greedy_nms=False,
                           **serve_kw)(cpu_art.stage(rgb).cpu())
    staged = art.stage(rgb)
    fast(staged)
    torch.cuda.synchronize()
    before = (decode_kernel.KERNEL.launches, nms_kernel.KERNEL.launches)
    dets = fast(staged)
    torch.cuda.synchronize()
    after = (decode_kernel.KERNEL.launches, nms_kernel.KERNEL.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (1, 0), after
    match = match_detections(dets, cpu, box_tol=0.5, score_tol=1e-2)
    assert match["count"] > 0, "no detection to compare"
    return {"valid": dets.count, "greedy_valid": art(rgb).count,
            "vs_cpu_port": match, "decode_launches": 1, "nms_launches": 0}


def drive_fleet(art8_model, cfg, conf: dict, scenes, b8_dets, tmp: Path,
                torch) -> dict:
    """Phase 21: the batch-8 artifact's model as a fleet over [cuda:0] and
    over the card listed twice (two programs with their own weights,
    streams and graphs), each call bit for bit the batch-8 graph's
    Detections; counts at 0 before the timed calls and read after (graph
    replays: none); one call of the two-program fleet under
    ``utils.trace`` with an ``annotate`` span: the written Chrome trace
    holds the span and the stem kernel, and no collective."""
    import torch.distributed as dist

    from unina_yolo_dla_torch.ops.cuda import _lib
    from unina_yolo_dla_torch.ops.preprocess import merged_frame_np
    from unina_yolo_dla_torch.parallel import (
        make_sharded_batch_serving_fn, shard_streams)
    from unina_yolo_dla_torch.utils import annotate, trace

    staged = merged_frame_np(scenes)
    kw = dict(conf_threshold=conf["conf_threshold"],
              iou_threshold=conf["iou_threshold"], q_factor=conf["q_factor"],
              max_detections=conf["max_detections"])
    out = {}
    for label, devices in (("one_program", ["cuda:0"]),
                           ("two_programs", ["cuda:0", "cuda:0"])):
        t = time.perf_counter()
        fleet = make_sharded_batch_serving_fn(art8_model, cfg, devices,
                                              **kw)
        fleet(shard_streams(staged, devices))   # captures each program
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        assert all(p.graph.report.clean for p in fleet.programs)
        assert len({id(p.graph.stream) for p in fleet.programs}) == \
            len(devices)
        for k in _lib.KERNELS:
            k.launches = 0
        times, equal = [], []
        for _ in range(BATCHES):
            t = time.perf_counter()
            shards = shard_streams(staged, devices)
            got = fleet(shards)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            equal.append(_same(got, b8_dets))
        assert all(equal), f"fleet {label} differs from the batch-8 graph"
        replay_launches = {k.symbol: k.launches for k in _lib.KERNELS
                           if k.launches}
        assert not replay_launches, replay_launches
        out[label] = {"devices": devices, "build_and_capture_s": build_s,
                      "batch_ms_median": float(np.median(times)),
                      "batch_ms_min": float(np.min(times)),
                      "frames_per_s": len(scenes) * 1e3
                      / float(np.median(times)),
                      "bit_equal_vs_b8_graph": all(equal),
                      "graph_kernel_nodes": [p.graph.report.kernel_nodes
                                             for p in fleet.programs]}
    assert not dist.is_initialized()
    with trace(tmp / "fleet_trace") as tr:
        with annotate("fleet_call"):
            fleet(shard_streams(staged, ["cuda:0", "cuda:0"]))
            torch.cuda.synchronize()
    text = tr.path.read_text()
    names = [e.name for e in tr.profile.events()]
    assert "fleet_call" in text, "the annotate span is not in the trace"
    assert "fused_stem_stage1_kernel" in text, "no stem kernel in the trace"
    assert not any(w in n.lower() for n in names
                   for w in ("nccl", "all_reduce", "allreduce", "c10d")), \
        "a collective in the fleet's trace"
    out["trace"] = {"path": tr.path.name, "bytes": len(text),
                    "events": len(names),
                    "stem_kernel_events": sum(
                        "fused_stem_stage1_kernel" in n for n in names)}
    return out


def drive_curation(ckpt: Path, tmp: Path, cam_scenes, torch) -> dict:
    """Phase 22: from the float checkpoint (the train form on the card),
    ``curation.mine`` over phase 18's 200 val images in both modes, each
    map read back by ``load_difficulty_weights``; a K-Center coreset of
    CORESET from the same images; ``AutoLabeler`` with a mock detector over
    LABEL_SCENES scenes at 1080x1920 (host work)."""
    import contextlib

    from unina_yolo_dla_torch.curation import ActiveLearner, AutoLabeler
    from unina_yolo_dla_torch.curation import mine
    from unina_yolo_dla_torch.data.dataset import (
        YoloDataset, load_dataset_yaml, load_difficulty_weights)
    from unina_yolo_dla_torch.models.config import ModelConfig
    from unina_yolo_dla_torch.models.detector import from_jax_variables
    from unina_yolo_dla_torch.utils import Timer
    from unina_yolo_dla_torch.utils.checkpoint import load_msgpack_raw

    spec = load_dataset_yaml(next((tmp / "xhard_r5").glob("*.yaml")))
    val = Path(spec["val"])
    ds = YoloDataset(val, 640)
    timer = Timer()
    out = {"images": len(ds)}
    for mode in ("entropy", "loc_var"):
        path = tmp / f"difficulty_{mode}.json"
        with timer(f"mine_{mode}"), contextlib.redirect_stdout(sys.stderr):
            mine.main(["--weights", str(ckpt), "--images", str(val),
                       "--output", str(path), "--mode", mode,
                       "--batch", "16"])
        dm = json.loads(path.read_text())
        assert len(dm) == len(ds) and all(np.isfinite(list(dm.values())))
        w = load_difficulty_weights(ds, path)
        want = np.maximum([dm[p.stem] for p in ds.image_paths], 0.1)
        assert np.array_equal(w, want), "weights differ from the map"
        out[mode] = {"min": float(min(dm.values())),
                     "max": float(max(dm.values())),
                     "weights_mean": float(w.mean())}
    model = from_jax_variables(load_msgpack_raw(ckpt), ModelConfig())
    learner = ActiveLearner(model)
    with timer("coreset"):
        picked = learner.coreset_selection(
            lambda: mine.unlabeled_batches(val, 640, 16), CORESET)
    assert len(set(picked)) == CORESET
    out["coreset"] = {"size": CORESET, "method": "kcenter",
                      "embedding_dim": int(
                          learner._cached_embeddings.shape[1])}

    def detector(tile, prompts):
        # a stand-in for the open-vocabulary model: the tile's brightest
        # 32-pixel block as one cone of class 1
        g = tile.mean(axis=2)[:tile.shape[0] // 32 * 32,
                              :tile.shape[1] // 32 * 32]
        blocks = g.reshape(g.shape[0] // 32, 32, -1, 32).mean(axis=(1, 3))
        y, x = np.unravel_index(int(blocks.argmax()), blocks.shape)
        return (np.asarray([[32 * x, 32 * y, 32 * x + 32, 32 * y + 32]],
                           np.float32), np.asarray([0.9]), np.asarray([1]))

    labeler = AutoLabeler(detector)
    labels = []
    with timer("auto_label"):
        for frame in cam_scenes[:LABEL_SCENES]:
            labels.append(labeler.label_image(
                np.ascontiguousarray(frame[..., 2::-1])))
    assert all(lb.shape[1] == 5 and len(lb) > 0 for lb in labels)
    out["auto_label"] = {"scenes": LABEL_SCENES, "size": list(CAMERA_SHAPE),
                         "labels": [len(lb) for lb in labels]}
    out["seconds"] = {k: v["total_s"] for k, v in timer.summary().items()}
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
        int8_conv_kernel, nms_kernel, preprocess_kernel, qconcat_kernel,
        sppf_kernel, stage1_kernel, stem_kernel)
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
               "camera": camera_kernel.KERNEL,
               "int8_conv": int8_conv_kernel.KERNEL,
               "int8_sppf": sppf_kernel.KERNEL,
               "qconcat": qconcat_kernel.KERNEL}
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
    int8_row, int8_layers = check_int8_layers(art, rgb, torch)
    rows.append(dict(int8_row, path="shipped"))
    glue_rows, glue_sites = check_int8_glue(art, rgb, torch)
    rows += [dict(r, path="shipped") for r in glue_rows]
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

    # phase 5b: the shipped engine served with the one-pass NMS
    fast_nms = check_nms_fast(art, rgb, serve_kw, torch)
    print(json.dumps({"nms_fast": fast_nms}), flush=True)

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
    # the shipped graph's device time by kernel name: no library integer
    # product is left in the frame (the int8 conv kernel computes each
    # int8 layer)
    for label, pr in (("eager", prof), ("graph", prof_g)):
        gemms = [n for n in pr["by_kernel"]
                 if re.search(r"gemm_?s8|s8_?gemm|i8i8|int8.*gemm|"
                              r"gemm.*int8|int_mm|imma", n, re.I)]
        assert not gemms, f"shipped {label}: integer GEMM kernels {gemms}"
        # the int8 glue runs as kernels 11 and 12: no float max-pool, no
        # eager round, no int8 cat is left in the frame
        glue = [n for n in pr["by_kernel"]
                if re.search(r"max_pool_forward_nhwc|round_kernel_cuda|"
                             r"CatArrayBatchedCopy.*OpaqueType<1u?>", n)]
        assert not glue, f"shipped {label}: eager int8 glue {glue}"
    print(json.dumps({"shipped_graph_profile": {
        "card": smi, "kernel_nodes": g_ship["report"]["kernel_nodes"],
        "device_busy_ms_per_frame": prof_g["device_busy_ms_per_call"],
        "device_idle_share": prof_g["device_idle_share"],
        "kernels_per_frame": prof_g["kernels_per_call"],
        "by_kernel": prof_g["by_kernel"]}}), flush=True)

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
    b8_graph_dets = art8_g(scenes)   # the fleet's reference (phase 21)
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
        # phase 18: the train CLI's path (the round-5 set, evaluation and
        # CP of the committed QAT model against the reference run's
        # results, the CLI from the float checkpoint, its artifact served,
        # one DP step)
        cli = drive_train_cli(kernels, smi, rgb, art_g, tmp, ckpt, torch)
        # phase 19: the unfused int8 engine and the folded QAT model
        phase_s = {}
        t = time.perf_counter()
        modes = {name: drive_mode(name, tmp, rgb, labels, scenes, kernels,
                                  torch) for name in MODE_FLAGS}
        phase_s["deploy_modes"] = time.perf_counter() - t
        print(json.dumps({"deploy_modes": modes, "card": smi}), flush=True)
        # phase 20: the kernels at base 16 and 64: the stem and stage1,
        # the C3k2 and head kernels of the fc engines
        t = time.perf_counter()
        widths = {"grid": check_widths_grid(torch), "engines": []}
        width_rows, eagers = [], {}
        for base, engines in WIDTH_RUNS.items():
            wckpt = width_checkpoint(base, tmp, torch)
            for engine in engines:
                rec, wrow, eagers[base, engine] = drive_width(
                    engine, base, wckpt, tmp, rgb, scenes, torch)
                widths["engines"].append(rec)
                if wrow is not None:
                    width_rows.append(wrow)
        fc64 = eagers[64, "s2dm_fc"]
        wide64_rows = check_wide_kernels(
            fc64.model, fc64._serve, fc64.stage(rgb),
            eagers[64, "fused_stem_stage1"].model, torch, BEFORE64_GRAPH_MS)
        fc64_launches = next(
            r["launches"] for r in widths["engines"]
            if (r["base"], r["engine"]) == (64, "s2dm_fc"))
        # base 16's: the stage1_fc engine's ten fused blocks against the
        # fused-stem engine's cuDNN blocks, on its seed-7 activations
        fc16 = eagers[16, "stage1_fc"]
        wide16_rows = check_wide_kernels(
            fc16.model, fc16._serve, fc16.stage(rgb),
            eagers[16, "fused_stem_stage1"].model, torch, gate=False)
        fc16_launches = next(
            r["launches"] for r in widths["engines"]
            if (r["base"], r["engine"]) == (16, "stage1_fc"))
        del fc16
        del eagers, fc64
        phase_s["widths"] = time.perf_counter() - t
        print(json.dumps({"widths": widths, "card": smi}), flush=True)
        # phase 21: the batch-8 model as a fleet, one program and two
        t = time.perf_counter()
        fleet = drive_fleet(art8.model, art8.model_config, art8.config,
                            scenes, b8_graph_dets, tmp, torch)
        phase_s["fleet"] = time.perf_counter() - t
        print(json.dumps({"fleet": fleet, "card": smi}), flush=True)
        # phase 22: curation from the float checkpoint
        t = time.perf_counter()
        curation = drive_curation(ckpt, tmp, cam_scenes, torch)
        phase_s["curation"] = time.perf_counter() - t
        print(json.dumps({"curation": curation, "card": smi}), flush=True)
        print(json.dumps({"phases_19_22_s": phase_s}), flush=True)
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
                for w in wide_rows if w["kernel"] == row["name"]] + [
                dict(w, block="b64_s2dm_fc " + w["block"],
                     launches=fc64_launches[kernels[row["name"]].symbol])
                for w in wide64_rows if w["kernel"] == row["name"]] + [
                dict(w, block="b16_stage1_fc " + w["block"],
                     launches=fc16_launches[kernels[row["name"]].symbol])
                for w in wide16_rows if w["kernel"] == row["name"]]
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
            if row["name"] == "fused_head":  # the large plan's kernel
                row["mma_large"] = mma_route(
                    lib_path, DEVICE_FUNCS["fused_head"][2],
                    REPO / row["source"])
                assert row["mma_large"] == "wgmma", (
                    f"the large plan issues {row['mma_large']}")
        if row["name"] == "normalize":
            # the training batch's float32 form (phase 17)
            row["train_path"] = training["normalize"]
        if row["name"] in cli["eval_path"]:
            # the eval and CP batches of the train CLI's path (phase 18)
            row["eval_path"] = cli["eval_path"][row["name"]]
        if PER_FRAME["b8"][row["name"]]:
            row["b8_launches"] = e2e_b8["launches"][row["name"]]
            row["b8_device_ms_per_batch"] = prof_b8[
                "port_kernels_device_ms_per_call"][row["name"]]
            row["b8_graph_nodes_per_batch"] = g_b8["report"][
                "port_kernels"][row["name"]]
        print(json.dumps(row), flush=True)
    for row in width_rows:
        kernel, base = row["name"].rsplit("_b", 1)
        func = DEVICE_FUNCS[kernel][0].replace("<64>", f"<{2 * int(base)}>")
        row["mma"] = mma_route(lib_path, func, REPO / row["source"])
        assert row["mma"] == "wgmma", f"{row['name']}: issues {row['mma']}"
        print(json.dumps(row), flush=True)
    rows += width_rows
    line = {"kernels": rows}
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "build_s": build_s, "launch_floor": floor,
         "int8_conv_layers": int8_layers, "int8_glue_sites": glue_sites,
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
         "native_host": native, "training": training, "train_cli": cli,
         "export": exported, "bf16_engines": bf16,
         "bf16_fc_fused_modules": wide_rows,
         "b64_s2dm_fc_fused_modules": wide64_rows,
         "b16_stage1_fc_fused_modules": wide16_rows, "nms_fast": fast_nms,
         "deploy_modes": modes, "widths": widths, "fleet": fleet,
         "curation": curation, "phases_19_22_s": phase_s,
         "before_redesign_graph_ms_quoted": {
             "quoted": BEFORE_ORIGIN, "ms": BEFORE_GRAPH_MS},
         "b64_before_redesign_graph_ms_quoted": {
             "quoted": BEFORE64_ORIGIN, "ms": BEFORE64_GRAPH_MS}, **line},
        indent=2, default=str))
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
