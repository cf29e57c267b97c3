"""Two trees of the PyTorch/CUDA port on one NVIDIA GPU, the six engines
served the same way: their graph times and whether their outputs are
the same bits (imports no JAX).

    python3 tools/torch_parent_ab.py [--root DIR] [--tag TAG]

``--root DIR`` imports ``unina_yolo_dla_torch`` from another tree (an
unpacked parent commit: ``git archive <commit> unina_yolo_dla_torch | tar
-x -C build/parent``); the artifacts, scenes and method are this tree's.
For each int8 path that ``chip_smoke.py`` serves (the shipped artifact,
the ``int8_s2dm_fc`` engine from the same weights, the batch-8 artifact
and the camera artifact), captured as one CUDA graph:

- ``call_ms_median``/``call_ms_min``: host clock around ``FRAMES`` calls
  (staging, copy, replay, synchronise), as ``chip_smoke.py`` times them;
- ``replay_ms``: CUDA events around ``FRAMES`` back-to-back replays of the
  graph alone;
- ``digest``: SHA-256 of every Detections field of every scene (seeds 1-8;
  one batch of them for b8; the camera's 1080x1920 BGRA scenes).

The same for the unfused int8 engine (``int8_unfused``: every int8 conv
quantises its float input), exported by the tree's own export from
``artifacts/engine_source.msgpack`` with ``chip_smoke.py``'s flags.

For each int8 path also ``int8_layers``: the SHA-256 of each int8 layer's
output through the eager frame (forward hooks, keyed by layer; the
seed-7 scene, the batch of seeds 1-8 for b8, the seed-7 camera frame):
the requantised int8 of each ConvBlock (the compute-dtype output in the
unfused engine), the sum requantised at ``add_q`` for each bottleneck
``cv2`` with a residual (the Bottleneck's output), the f32 of each pred;
the glue's outputs are these layers' inputs. And ``shipped_profile``:
the shipped graph's kernel nodes and, under the profiler over 10
replayed frames, its device busy ms a frame, idle share and device ms by
kernel name.

The same for the two bf16 engines (``bf16_s2dm_mh``, ``bf16_s2dm_fc``),
each exported by the tree's own export from the float checkpoint
(``artifacts/engine_source.msgpack`` without ``quant``) with
``chip_smoke.py``'s flags and served from its directory.

And ``int8_shapes``: the int8 conv kernel at each of the shipped frame's
18 int8 layer shapes (``int8_conv_kernel.SHIPPED_LAYERS`` of this tree,
batch 1) on seeded random inputs, the SHA-256 of its output and three
replayed-graph times.

And the int8 fc engine's three fused kernels at 64 channels (stage1_block,
fpn_c3k2_2, head_p2) on the seed-7 frame's own activations, and the bf16
fc engine's ten fused blocks (``blocks``: the wide C3k2 and head kernels
at 128 and 256 channels among them) on its seed-7 frame's activations:
the SHA-256 of each output and its time inside a replayed graph; the same
for base 64's ten fused blocks at their served shapes on
``chip_smoke.py``'s seeded inputs (``blocks64``, ``WIDE64_SHAPES``), and
the digests of the two 160 x 160 C3k2 blocks at ``PERSIST_SHAPES``'
ragged batches and of head_p2 at its ragged batch (``persist``); the head
at 128 at each base's served shape (``heads128``: base 64's head_p2, base
32's head_p3, base 16's head_p4), digest and three replayed-graph times;
and the stem and stage1 kernels at C = 32, 64 and
128 (base 16, 32, 64) at the served shape (1, 320, 160) on
``chip_smoke.width_inputs``' seeded normal inputs (``widths``: each
output's SHA-256 and three replayed-graph times). Run parent, change,
change, parent in one call and compare digests (equal:
the same bits) and times (within the spread of the two runs of one
tree). Prints one JSON object and writes it to
``chiprun_out/torch_parent_ab_<tag>.json``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FRAMES = 30
# the head at 128 where each base serves it: base 64's head_p2 (the large
# plan), base 32's head_p3 and base 16's head_p4 (the replicated plan)
HEADS128 = {"head_p2_1x160x160": (1, 160, 160, 128),
            "head_p3_1x80x80": (1, 80, 80, 128),
            "head_p4_1x20x20": (1, 20, 20, 128)}


def digest(tensors) -> str:
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def timed_calls(call, args, torch) -> dict:
    for _ in range(3):
        call(args[0])
    torch.cuda.synchronize()
    times = []
    for i in range(FRAMES):
        t = time.perf_counter()
        call(args[i % len(args)])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return {"call_ms_median": float(np.median(times)),
            "call_ms_min": float(np.min(times))}


def replay_ms(graph, torch) -> float:
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(FRAMES):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / FRAMES


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--tag", default="tree")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    sys.path.insert(1, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from unina_yolo_dla_torch.data.synthetic import SynthConfig, \
        generate_image
    from unina_yolo_dla_torch.models.config import ModelConfig
    from unina_yolo_dla_torch.models.detector import from_jax_variables
    from unina_yolo_dla_torch.ops.cuda import _lib, c3k2_kernel, head_kernel
    from unina_yolo_dla_torch.quant.fake_quant import PERF_EXCLUDE, \
        QuantSpec
    from unina_yolo_dla_torch.runtime import aot
    from unina_yolo_dla_torch.runtime.artifact import ServingArtifact
    from unina_yolo_dla_torch.runtime.pipeline import build_serving_fn
    from unina_yolo_dla_torch.utils.checkpoint import (load_msgpack_raw,
                                                       save_msgpack)

    import unina_yolo_dla_torch
    pkg = Path(unina_yolo_dla_torch.__file__).resolve().parent
    assert pkg.parent == Path(args.root).resolve(), pkg
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _lib.library()
    build_s = time.perf_counter() - t0

    scenes = [np.ascontiguousarray(generate_image(
        np.random.default_rng(s), SynthConfig(image_size=640, seed=s))[0][
            ..., ::-1]) for s in range(1, 9)]
    cams = []
    for s in range(1, 9):
        bgr = generate_image(np.random.default_rng(s), SynthConfig(
            image_size=1080, image_width=1920, seed=s))[0]
        cams.append(np.concatenate(
            [bgr, np.full((1080, 1920, 1), 255, np.uint8)], axis=-1))

    out = {"card": smi, "root": args.root, "tag": args.tag,
           "build_s": build_s, "paths": {}}
    ship = ServingArtifact(cs.ARTIFACT)
    cfg = ModelConfig(quant=QuantSpec("int8_fused", exclude=PERF_EXCLUDE),
                      deploy=True, stem_s2d=True, s2d_host=True,
                      stage1_s2d=True, s2d_merged=True, fused_c3k2=True,
                      fused_head=True)
    c = ship.config
    model = from_jax_variables(
        load_msgpack_raw(cs.ARTIFACT / "variables.msgpack"), cfg)
    serve = build_serving_fn(model, cfg, c["conf_threshold"],
                             c["iou_threshold"], c["q_factor"],
                             c["max_detections"])
    fc = aot.capture_serving_fn(serve, ship.staged_shape, ship.device)
    b8 = ServingArtifact(cs.ARTIFACT_B8)
    cam = ServingArtifact(cs.ARTIFACT_CAM)
    tmp = Path(tempfile.mkdtemp())
    ckpt = tmp / "float_checkpoint.msgpack"
    save_msgpack({k: v for k, v in load_msgpack_raw(cs.SOURCE).items()
                  if k not in ("quant", "calib_meta")}, ckpt)
    bf16 = {}
    for name, flags in cs.BF16_FLAGS.items():
        cs.run_export(["--weights", ckpt, *flags, "--cp-calibration",
                       cs.CP_CALIBRATION, "--output", tmp / name])
        bf16[name] = ServingArtifact(tmp / name)
    cs.run_export(["--weights", cs.SOURCE, *cs.MODE_FLAGS["int8_unfused"],
                   "--cp-calibration", cs.CP_CALIBRATION, "--output",
                   tmp / "int8_unfused"])
    unfused = ServingArtifact(tmp / "int8_unfused")
    paths = {
        "shipped": (lambda f: ship(f), ship.graph.graph, scenes),
        "int8_s2dm_fc": (lambda f: fc(ship.stage(f)), fc.graph, scenes),
        "b8": (lambda f: b8(f), b8.graph.graph, [np.stack(scenes)]),
        "camera": (lambda f: cam(f), cam.graph.graph, cams),
    }
    for name, art in bf16.items():
        paths[name] = (art, art.graph.graph, scenes)
    paths["int8_unfused"] = (unfused, unfused.graph.graph, scenes)
    for name, (call, graph, inputs) in paths.items():
        dets = []
        for frame in inputs:
            with torch.inference_mode():
                dets += [f.clone() for f in call(frame)]
        rec = timed_calls(call, inputs, torch)
        rec["replay_ms"] = replay_ms(graph, torch)
        rec["digest"] = digest(dets)
        out["paths"][name] = rec

    # the fc engine's 64-wide kernels on the seed-7 frame's activations
    caps = cs.capture_inputs(model, serve, ship.stage(scenes[6]), torch)
    kernels = {}
    for name in ("fused_c3k2", "fused_c3k2_cat", "fused_head"):
        mod, a, kw = caps[name]
        ws = [getattr(mod, n) for n in mod._FUSED]
        bf = torch.bfloat16

        def dev(t):
            t = t.dequant(bf) if hasattr(t, "dequant") else t
            return t.to(bf).contiguous()

        if name == "fused_head":
            x = dev(a[0])

            def fn(x=x, ws=ws, mod=mod):
                return head_kernel.fused_head(x, *ws, w33=mod.w33)
        elif name == "fused_c3k2":
            x = dev(a[0])

            def fn(x=x, ws=ws, mod=mod):
                return c3k2_kernel.fused_c3k2(x, *ws, shortcut=mod.shortcut,
                                              wpk=mod.wpk)
        else:
            xa, xb = dev(a[0]), dev(kw["x2"])

            def fn(xa=xa, xb=xb, ws=ws, mod=mod, up=kw["up_x"]):
                return c3k2_kernel.fused_c3k2_cat(
                    xa, xb, *ws, shortcut=mod.shortcut, up_a=up,
                    wpk=mod.wpk)
        res = fn()
        torch.cuda.synchronize()
        res = res if isinstance(res, tuple) else (res,)
        kernels[name] = {"digest": digest(res),
                         "graph_ms": cs.graph_ms(fn)}
    out["kernels_64"] = kernels
    fc_eager = from_jax_variables(
        load_msgpack_raw(cs.ARTIFACT / "variables.msgpack"), cfg)
    fc_serve = build_serving_fn(fc_eager, cfg, c["conf_threshold"],
                                c["iou_threshold"], c["q_factor"],
                                c["max_detections"])
    eager = {name: ServingArtifact(d, graph=False) for name, d in (
        ("shipped", cs.ARTIFACT), ("b8", cs.ARTIFACT_B8),
        ("camera", cs.ARTIFACT_CAM), ("int8_unfused", tmp / "int8_unfused"))}
    out["int8_layers"] = {
        "shipped": int8_layer_digests(eager["shipped"].model,
                                      eager["shipped"], scenes[6], torch),
        "int8_s2dm_fc": int8_layer_digests(
            fc_eager, lambda f: fc_serve(ship.stage(f)), scenes[6], torch),
        "b8": int8_layer_digests(eager["b8"].model, eager["b8"],
                                 np.stack(scenes), torch),
        "camera": int8_layer_digests(eager["camera"].model, eager["camera"],
                                     cams[6], torch),
        "int8_unfused": int8_layer_digests(
            eager["int8_unfused"].model, eager["int8_unfused"], scenes[6],
            torch, cs.INT8_LAYERS_UNFUSED)}
    del eager, fc_eager
    prof = cs.profile_calls(ship, scenes[6], torch)
    out["shipped_profile"] = {
        "kernel_nodes": ship.graph.report.kernel_nodes,
        **{k: prof[k] for k in ("wall_ms_per_call", "device_busy_ms_per_call",
                                "device_idle_share", "kernels_per_call",
                                "by_kernel")}}
    out["blocks"] = fc_blocks(bf16["bf16_s2dm_fc"], scenes[6], cs, torch)
    # base 64's ten fused blocks at their served shapes, on chip_smoke's
    # seeded inputs (WIDE64_SHAPES): digest and replayed-graph time
    calls = cs.wide_calls(torch, {k: v for k, v in cs.WIDE64_SHAPES.items()
                                  if "_1x" in k})
    out["blocks64"] = {}
    for name, call in calls.items():
        res = call()
        torch.cuda.synchronize()
        out["blocks64"][name] = {"digest": digest(res),
                                 "graph_ms": cs.graph_ms(call, 10, 5)}
    # base 64's 160 x 160 C3k2 blocks at ragged batches of 2 on the
    # persistent plan's grids (PERSIST_SHAPES): digests only
    out["persist"] = {name: digest(call()) for name, call in
                      cs.wide_calls(torch, cs.PERSIST_SHAPES).items()}
    # the head at 128 at the three bases' shapes it serves (base 64's
    # head_p2, base 32's head_p3, base 16's head_p4) on chip_smoke's
    # seeded inputs: digest and replayed-graph time, three times
    out["heads128"] = {}
    for name, call in cs.wide_calls(torch, HEADS128).items():
        res = call()
        torch.cuda.synchronize()
        out["heads128"][name] = {
            "digest": digest(res),
            "graph_ms": [cs.graph_ms(call, 10, 5) for _ in range(3)]}
    out["widths"] = width_kernels(cs, torch)
    out["int8_shapes"] = int8_shapes(torch)
    text = json.dumps(out)
    shutil.rmtree(tmp)
    dst = REPO / "chiprun_out"
    dst.mkdir(exist_ok=True)
    (dst / f"torch_parent_ab_{args.tag}.json").write_text(text)
    print(text)
    return 0


def int8_shapes(torch) -> dict:
    """The int8 conv kernel at each of the shipped frame's 18 int8 layer
    shapes (this tree's ``SHIPPED_LAYERS``, batch 1, the tree's own plan)
    on ``torch_int8_plans.layer_inputs``' seeded inputs: the SHA-256 of its
    output and three replayed-graph times, keyed by shape."""
    import chip_smoke as cs
    from torch_int8_plans import layer_inputs, shipped_shapes
    from unina_yolo_dla_torch.ops.cuda import int8_conv_kernel as k8

    out = {}
    for i, shape in enumerate(shipped_shapes()):
        call, kw = layer_inputs(shape, 1, i, torch)

        def fn(call=call, kw=kw):
            return k8.int8_conv(*call, **kw)

        res = fn()
        torch.cuda.synchronize()
        out["x".join(map(str, shape))] = {
            "digest": digest((res,)),
            "graph_ms": [cs.graph_ms(fn) for _ in range(3)]}
    return out


def int8_layer_digests(model, call, frame, torch, layers=None) -> dict:
    """SHA-256 of each int8 layer's output of ``model``'s eager frame
    (``call(frame)``), keyed by layer, the same in any tree: a ConvBlock
    whose conv is int8 (its int8 output, or its compute-dtype output in
    the unfused engine), a pred whose conv is int8 (f32), and for a
    bottleneck that adds its residual on the int8 chain, its requantised
    sum under its ``cv2``'s name. ``layers``: how many there must be
    (the int8 chain's 46 by default)."""
    import chip_smoke as cs
    from unina_yolo_dla_torch.models.blocks import Bottleneck, ConvBlock
    from unina_yolo_dla_torch.quant.fake_quant import QuantConv

    out, hooks = {}, []

    def keep(name):
        def hook(_m, _a, y):
            out[name] = digest([getattr(y, "q", y)])
        return hook

    mods = dict(model.named_modules())
    residual = {f"{n}.cv2" for n, m in mods.items()
                if isinstance(m, Bottleneck) and m.add_q is not None}
    for n, m in mods.items():
        if isinstance(m, ConvBlock) and m.conv.int8 and n not in residual:
            hooks.append(m.register_forward_hook(keep(n)))
        elif isinstance(m, Bottleneck) and f"{n}.cv2" in residual:
            hooks.append(m.register_forward_hook(keep(f"{n}.cv2")))
        elif (isinstance(m, QuantConv) and m.int8
              and not isinstance(mods[n.rsplit(".", 1)[0]], ConvBlock)):
            hooks.append(m.register_forward_hook(keep(n)))
    try:
        with torch.inference_mode():
            call(frame)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    want = cs.INT8_LAYERS if layers is None else layers
    assert len(out) == want, f"{len(out)} int8 layers, not {want}"
    return dict(sorted(out.items()))


def width_kernels(cs, torch) -> dict:
    """The stem and stage1 kernels at every compiled width, served shape,
    seeded normal inputs (seed 11): each output's SHA-256 and its time
    inside a replayed graph, three times."""
    from unina_yolo_dla_torch.ops.cuda import mma_pack, stage1_kernel, \
        stem_kernel

    dev = torch.device("cuda")
    out = {}
    for c in (32, 64, 128):
        frame, xm, ks, bs, k1, b1 = cs.width_inputs(
            np.random.default_rng(11), c, (1, 320, 160), False, dev, torch)
        ksp, k1p = mma_pack.pack_stem_mma(ks), mma_pack.pack_stage1_mma(k1)
        calls = {"stem": lambda: stem_kernel.fused_stem_stage1(
                     frame, ksp, bs, k1p, b1),
                 "stage1": lambda: stage1_kernel.fused_downsample_merged(
                     xm, k1p, b1)}
        for name, call in calls.items():
            res = call()
            torch.cuda.synchronize()
            out[f"{name}_c{c}"] = {
                "digest": digest((res,)),
                "graph_ms": [cs.graph_ms(call) for _ in range(3)]}
    return out


def fc_blocks(art, scene, cs, torch) -> dict:
    """The bf16 fc engine's ten fused blocks on the activations its eager
    frame gives them for ``scene``: each output's SHA-256 and its time
    inside a replayed graph."""
    from unina_yolo_dla_torch.ops.cuda import c3k2_kernel, head_kernel

    mods = {p: art.model.get_submodule(p)
            for ps in cs.FC_MODULES.values() for p in ps}
    caps = {}
    hooks = [m.register_forward_pre_hook(
        lambda _m, a, kw, p=p: caps.__setitem__(p, (a, kw)),
        with_kwargs=True) for p, m in mods.items()]
    try:
        with torch.inference_mode():
            art._serve(art.stage(scene))
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    out = {}
    for kernel, ps in cs.FC_MODULES.items():
        for p in ps:
            mod, (a, kw) = mods[p], caps[p]
            ws = [getattr(mod, n) for n in mod._FUSED]
            if kernel == "fused_head":
                def fn(x=a[0], ws=ws, mod=mod):
                    return head_kernel.fused_head(x, *ws, w33=mod.w33)
            elif kernel == "fused_c3k2":
                def fn(x=a[0], ws=ws, mod=mod):
                    return c3k2_kernel.fused_c3k2(
                        x, *ws, shortcut=mod.shortcut, wpk=mod.wpk)
            else:
                def fn(xa=a[0], xb=kw["x2"], ws=ws, mod=mod,
                       up=kw.get("up_x", False)):
                    return c3k2_kernel.fused_c3k2_cat(
                        xa, xb, *ws, shortcut=mod.shortcut, up_a=up,
                        wpk=mod.wpk)
            res = fn()
            torch.cuda.synchronize()
            res = res if isinstance(res, tuple) else (res,)
            out[p] = {"digest": digest(res), "graph_ms": cs.graph_ms(fn,
                                                                     10, 5)}
    return out


if __name__ == "__main__":
    sys.exit(main())
