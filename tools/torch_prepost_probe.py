"""Device time of the port's small kernels around the model (normalize,
NMS) on one NVIDIA GPU, under the host's launch cost (PyTorch/CUDA port;
imports no JAX).

    python3 tools/torch_prepost_probe.py [--root DIR] [--define NAME]
                                         [--ablation] [--tag TAG]

Twenty launches are captured into one CUDA graph and the graph is
replayed, so the number is what the card spends per launch, not what the
host needs to enqueue it. Timed:

- ``normalize`` on the merged (320, 160, 24) frame, float32 out and (where
  the wrapper has ``out_dtype``) bfloat16 out, on one buffer pair (found in
  the L2 cache) and rotating over sixteen pairs (more than the L2 holds);
- ``nms_keep`` at K = 1024 on random boxes for several numbers of valid
  slots, each checked against the plain version first;
- the library's empty kernel, where it has one: the floor of any launch.

``--root DIR`` imports ``unina_yolo_dla_torch`` from another tree (an
unpacked parent commit) so two versions are timed by the same method on
one card. ``--define NAME`` adds ``-DNAME`` to the kernels' build
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
LAUNCHES = 20
ROTATE = 16
NMS_VALID = (0, 4, 32, 64, 128, 256, 257, 512, 1024)
ABLATION = ("as it was", "32-bit index", "constants in shared memory",
            "no IEEE division", "32-bit index + shared constants",
            "all three")


def graph_us(fns) -> float:
    """Mean device microseconds per call of ``fns`` (a list run round
    robin, ``LAUNCHES`` calls a graph) inside a replayed CUDA graph."""
    for fn in fns[:3]:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE.parent))
    ap.add_argument("--define", action="append", default=[])
    ap.add_argument("--ablation", action="store_true")
    ap.add_argument("--tag", default="this")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_prepost_probe: no CUDA device", file=sys.stderr)
        return 2
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
    print(json.dumps(out, indent=1))
    dest = HERE.parent / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / f"torch_prepost_probe_{args.tag}.json").write_text(
        json.dumps(out, indent=1))
    ok = all(r["exact"] for r in out["normalize"] + out["nms"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
