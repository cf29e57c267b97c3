"""Device time of the port's small kernels around the model (normalize,
decode with its top-K compaction, NMS, the camera preprocessing) on one
NVIDIA GPU, under the host's launch cost (PyTorch/CUDA port; imports no
JAX).

    python3 tools/torch_prepost_probe.py [--root DIR] [--define NAME]
                                         [--ablation] [--camera-only]
                                         [--tag TAG]

Twenty launches are captured into one CUDA graph and the graph is
replayed, so the number is what the card spends per launch, not what the
host needs to enqueue it. Timed:

- ``normalize`` on the merged (320, 160, 24) frame, float32 out and (where
  the wrapper has ``out_dtype``) bfloat16 out, on one buffer pair (found in
  the L2 cache) and rotating over sixteen pairs (more than the L2 holds);
- ``nms_keep`` at K = 1024 on random boxes for several numbers of valid
  slots, each checked against the plain version first;
- the library's empty kernel, where it has one: the floor of any launch;
- what the serving path runs after the model, on the shipped artifact's
  head outputs for the seed-7 scene (B = 1) and for 8 scenes (seeds 1-8,
  B = 8), and on random levels where ~94% of the cells are valid
  (``all_valid``, N(0, 3) logits): ``decode`` is decode plus compaction,
  ``post`` adds NMS. A tree whose ``ops/decode.py`` has no
  ``decode_batch`` runs the batch image by image, as its serving path
  would have to. Beside the graph time, kernels and device ms per call by
  ``chip_smoke.py``'s profiler (20 calls), and the whole served frame at
  B = 1 (10 frames);
- the camera kernel (``CameraPreprocess``, bf16 out) at each geometry of
  ``CAMERA_SWEEP`` (random frames; checked against the plain version
  first: bit for bit in the lookup form, elsewhere within one bf16 step
  of it run on the CPU, as ``chip_smoke.py`` holds it; the pad bit for
  bit), and at the served geometry (1080x1920
  BGRA letterboxed to 640), bf16 and f32 out, on ``chip_smoke.py``'s three
  clocks: CUDA events over back-to-back calls (host cost included), a
  replayed graph, the profiler; beside it ``F.interpolate`` (bilinear, the
  float RGB frame: the resize alone) and a PyTorch fill of the same bf16
  canvas on the same clocks. ``--camera-only`` times nothing else.

``--root DIR`` imports ``unina_yolo_dla_torch`` from another tree (an
unpacked parent commit: ``git archive <commit> unina_yolo_dla_torch | tar
-x -C build/parent``) so two versions are timed by the same method on one
card; the artifacts are this tree's. ``--define NAME`` adds ``-DNAME`` to the kernels' build
(``UNINA_NORMALIZE_DIVIDE``: normalize with two divisions per element
instead of its table). ``--ablation`` builds
``tools/torch_normalize_ablation.cu`` (the port's first normalize kernel
with each of its three costs switchable) and times its variants.
Prints one JSON object and writes it to
``chiprun_out/torch_prepost_probe_<tag>.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ARTIFACT = HERE.parent / "artifacts" / "serving_artifact"
LAUNCHES = 20
ROTATE = 16
NMS_VALID = (0, 4, 32, 64, 128, 256, 257, 512, 1024)
# (height, width, format, size, letterbox): the served geometry first
CAMERA_SWEEP = ((1080, 1920, "bgra", 640, True),
                (1080, 1920, "rgb", 640, True),
                (640, 640, "bgra", 640, True),     # every row a window row
                (3, 1920, "bgra", 640, True),      # nearly every row pad
                (2160, 3840, "bgra", 1280, True),  # two staged steps a row
                (1080, 1920, "bgra", 640, False),  # fractional rows
                (720, 1280, "rgb", 640, True),     # weights 1/2
                (1080, 1920, "nv12", 640, True),
                (480, 640, "nv12", 640, False))
ABLATION = ("as it was", "32-bit index", "constants in shared memory",
            "no IEEE division", "32-bit index + shared constants",
            "all three")


def graph_us(fns) -> float:
    """Mean device microseconds per call of ``fns`` (a list run round
    robin, ``LAUNCHES`` calls a graph) inside a replayed CUDA graph."""
    # warmed up on the stream it is captured on (the decode kernel's
    # scratch is the stream's own)
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for fn in fns[:3]:
            fn()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph, stream=stream):
        for i in range(LAUNCHES):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / (10 * LAUNCHES)


def nms_sets(rng, dev, k=1024):
    """Score-ordered random boxes, 4 classes, the first n slots valid."""
    centers = rng.uniform(50, 590, (k, 2))
    wh = rng.uniform(5, 60, (k, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1)
    bt = torch.tensor(boxes, dtype=torch.float32, device=dev)
    ct = torch.tensor(rng.integers(0, 4, k), dtype=torch.int32, device=dev)
    for n in NMS_VALID:
        yield n, bt, ct, torch.arange(k, device=dev) < n


def ablation(frame, mean, std, want) -> list[dict]:
    from unina_yolo_dla_torch.ops.cuda import _lib

    out_dir = _lib.BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libnormalize_ablation.so"
    subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared",
                    str(HERE / "torch_normalize_ablation.cu"), "-o",
                    str(lib_path)], check=True)
    fn = ctypes.CDLL(str(lib_path)).ablate_normalize
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, p, p, ctypes.c_longlong, i, i, p, p, p, p]
    fn.restype = i
    c = frame.shape[-1]
    fa, ia = ctypes.c_float * c, ctypes.c_int * c
    m, s, src = fa(*mean), fa(*std), ia(*range(c))
    out = torch.empty(frame.shape, dtype=torch.float32, device=frame.device)
    rows = []
    for variant, what in enumerate(ABLATION):
        def run():
            err = fn(variant, frame.data_ptr(), out.data_ptr(),
                     frame.numel() // c, c, c, m, s, src,
                     torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
        run()
        torch.cuda.synchronize()
        rows.append(dict(variant=variant, what=what, device_us=graph_us([run]),
                         max_abs_err=float((out - want).abs().max())))
    return rows


def post_model(dev) -> dict:
    """Decode (+ compaction) and NMS after the shipped artifact's model,
    graph-replayed and profiled; then the whole frame, profiled."""
    from chip_smoke import profile_calls
    from unina_yolo_dla_torch.data.synthetic import SynthConfig, generate_image
    from unina_yolo_dla_torch.ops import decode as dmod
    from unina_yolo_dla_torch.ops.cuda import preprocess_kernel
    from unina_yolo_dla_torch.ops.nms import nms
    from unina_yolo_dla_torch.ops.preprocess import merged_frame_np
    from unina_yolo_dla_torch.runtime.artifact import ServingArtifact

    art = ServingArtifact(ARTIFACT)
    c = art.config
    kw = dict(strides=art.model_config.strides,
              conf_threshold=c["conf_threshold"], q_factor=c["q_factor"],
              max_detections=c["max_detections"])
    iou = c["iou_threshold"]

    def scene(seed):
        img, _ = generate_image(np.random.default_rng(seed),
                                SynthConfig(image_size=640, seed=seed))
        return np.ascontiguousarray(img[..., ::-1])

    rgb = scene(7)
    mean, std = preprocess_kernel.channel_constants(24)
    with torch.inference_mode():
        outs1 = art.model(preprocess_kernel.normalize(
            art.stage(rgb), mean, std, out_dtype=torch.bfloat16)[None])
        outs8 = art.model(preprocess_kernel.normalize(
            torch.from_numpy(merged_frame_np(np.stack(
                [scene(s) for s in range(1, 9)]))).to(dev), mean, std,
            out_dtype=torch.bfloat16))
    rng = np.random.default_rng(0)
    rand8 = [tuple(torch.from_numpy(a).to(dev) for a in (
        rng.normal(0, 3, (8, g, g, 4)).astype(np.float32),
        rng.uniform(0.1, 3.0, (8, g, g, 4)).astype(np.float32)))
        for g in art.model_config.grid_sizes]
    rand1 = [(cl[:1], rg[:1]) for cl, rg in rand8]

    def decode1(outs=outs1):
        return dmod.decode_outputs(outs, **kw)

    def decode8(outs=outs8):
        if hasattr(dmod, "decode_batch"):
            return [dmod.decode_batch(outs, **kw)]
        return [dmod.decode_outputs([(cl[i:i + 1], rg[i:i + 1])
                                     for cl, rg in outs], **kw)
                for i in range(8)]

    fns = {"decode_b1": decode1,
           "post_b1": lambda: nms(decode1(), iou),
           "decode_b8": decode8,
           "post_b8": lambda: [nms(d, iou) for d in decode8()],
           "decode_all_valid_b1": lambda: decode1(rand1),
           "decode_all_valid_b8": lambda: decode8(rand8)}
    out = {"batch_path": hasattr(dmod, "decode_batch")}
    with torch.inference_mode():
        for name, fn in fns.items():
            prof = profile_calls(lambda _, fn=fn: fn(), None, torch, 20,
                                 unit="call")
            out[name] = {"graph_ms": graph_us([fn]) / 1e3,
                         **{k: prof[k] for k in (
                             "kernels_per_call", "device_busy_ms_per_call",
                             "top")}}
        frame = profile_calls(art, rgb, torch)
    out["frame_b1"] = {k: frame[k] for k in ("kernels_per_call",
                                             "device_busy_ms_per_call")}
    return out


def camera(dev) -> dict:
    """The camera kernel: checked and timed at each geometry of
    CAMERA_SWEEP, then on three clocks at the served one, with its
    yardsticks."""
    import torch.nn.functional as F

    from chip_smoke import (bf16_steps, cuda_ms, graph_ms, pad_equal,
                            profiled_ms)
    from unina_yolo_dla_torch.ops.cuda import camera_kernel as ck

    rng = np.random.default_rng(7)
    bf = torch.bfloat16
    out = {"sweep": []}
    for h, w, fmt, size, lb in CAMERA_SWEEP:
        g = ck.CameraGeometry(h, w, fmt, size, lb)
        f = torch.from_numpy(rng.integers(0, 256, g.frame_shape,
                                          dtype=np.uint8)).to(dev)
        pre = ck.CameraPreprocess(g, bf).to(dev)
        got = pre(f)
        table = getattr(pre, "table", None)   # a tree of one form: None
        want = ck.camera_preprocess_plain(f if table else f.cpu(), g,
                                          out_dtype=bf).to(dev)
        steps = bf16_steps(got, want)
        out["sweep"].append(dict(
            geometry=f"{fmt} {h}x{w} to {size} "
                     f"{'letterbox' if lb else 'stretch'}",
            table=table, bf16_max_steps=steps,
            pad_exact=pad_equal(g, got, want),
            ok=pad_equal(g, got, want) and (
                steps == 0.0 if table else steps <= 1.0),
            graph_ms=graph_ms(lambda: pre(f))))
    g = ck.CameraGeometry(*CAMERA_SWEEP[0])
    served = torch.from_numpy(rng.integers(0, 256, g.frame_shape,
                                           dtype=np.uint8)).to(dev)
    for dt in (bf, torch.float32):
        pre = ck.CameraPreprocess(g, dt).to(dev)
        out[str(dt).split(".")[-1]] = dict(
            ms=cuda_ms(lambda: pre(served), 500),
            graph_ms=graph_ms(lambda: pre(served)),
            device_ms=profiled_ms(lambda: pre(served), torch))
    _, new_h, new_w, _, _ = g.window
    rgb = served[..., [2, 1, 0]].float().permute(2, 0, 1)[None].contiguous()
    canvas = torch.empty((g.size, g.size, 3), dtype=bf, device=dev)
    for name, fn in (
            ("interpolate", lambda: F.interpolate(
                rgb, size=(new_h, new_w), mode="bilinear",
                align_corners=False)),
            ("fill", lambda: canvas.fill_(0.5))):
        out[name] = dict(ms=cuda_ms(fn, 500), graph_ms=graph_ms(fn),
                         device_ms=profiled_ms(fn, torch))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE.parent))
    ap.add_argument("--define", action="append", default=[])
    ap.add_argument("--ablation", action="store_true")
    ap.add_argument("--camera-only", action="store_true")
    ap.add_argument("--tag", default="this")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_prepost_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE.parent))   # chip_smoke's profiler
    sys.path.insert(0, str(Path(args.root).resolve()))
    from unina_yolo_dla_torch.ops.cuda import (
        _lib, nms_kernel, preprocess_kernel)

    _lib.NVCC_FLAGS = (*_lib.NVCC_FLAGS, *(f"-D{d}" for d in args.define))
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {"card": smi, "root": args.root, "defines": args.define,
           "launches_per_graph": LAUNCHES}
    out["camera"] = camera(dev)
    ok = all(r["ok"] for r in out["camera"]["sweep"])
    if args.camera_only:
        return finish(out, args.tag, ok)

    frames = [torch.from_numpy(rng.integers(
        0, 256, (320, 160, 24), dtype=np.uint8)).to(dev)
        for _ in range(ROTATE)]
    mean, std = preprocess_kernel.channel_constants(24)
    want = preprocess_kernel.normalize_plain(frames[0], mean, std)
    forms = {"float32": {}}
    if "out_dtype" in inspect.signature(
            preprocess_kernel.normalize).parameters:
        forms["bfloat16"] = {"out_dtype": torch.bfloat16}
    rows = []
    for form, kw in forms.items():
        got = preprocess_kernel.normalize(frames[0], mean, std, **kw)
        torch.cuda.synchronize()
        ref = want.to(got.dtype)
        n = frames[0].numel()
        nbytes = n * (1 + got.element_size())
        one = graph_us([lambda: preprocess_kernel.normalize(
            frames[0], mean, std, **kw)])
        many = graph_us([
            (lambda f: lambda: preprocess_kernel.normalize(
                f, mean, std, **kw))(f) for f in frames])
        rows.append(dict(
            out=form, exact=bool(torch.equal(got, ref)),
            max_abs_err=float((got.float() - ref.float()).abs().max()),
            device_us_l2=one, device_us_rotating=many, mbytes=nbytes / 1e6,
            tbytes_per_s_l2=nbytes / one / 1e6,
            tbytes_per_s_rotating=nbytes / many / 1e6))
    out["normalize"] = rows
    if args.ablation:
        out["normalize_ablation"] = ablation(frames[0], mean, std, want)

    rows = []
    for n, bt, ct, vt in nms_sets(np.random.default_rng(3), dev):
        keep = nms_kernel.nms_keep(bt, ct, vt, 0.45)
        plain = nms_kernel.nms_keep_plain(bt, ct, vt, 0.45)
        torch.cuda.synchronize()
        rows.append(dict(
            k=1024, valid=n, kept=int(keep.sum()),
            exact=bool(torch.equal(keep, plain)),
            device_us=graph_us([lambda: nms_kernel.nms_keep(
                bt, ct, vt, 0.45)])))
    out["nms"] = rows

    lib = _lib.library()
    if hasattr(lib, "unina_empty_launch"):
        empty = _lib.Kernel("unina_empty_launch", [_lib.P])
        out["empty_launch_device_us"] = graph_us(
            [lambda: empty.launch(_lib.stream_ptr(dev))])
    out["post_model"] = post_model(dev)
    return finish(out, args.tag, ok and all(
        r["exact"] for r in out["normalize"] + out["nms"]))


def finish(out: dict, tag: str, ok: bool) -> int:
    print(json.dumps(out, indent=1))
    dest = HERE.parent / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / f"torch_prepost_probe_{tag}.json").write_text(
        json.dumps(out, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
