"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``unina_yolo_dla_torch/csrc``, holds
each kernel against its plain PyTorch version on the card at the shapes of
the serving path, serves the committed int8 engine
(``artifacts/serving_artifact``) on a synthetic scene, checks through the
launch counters that the frame went through every kernel, and checks the
card's detections against the port's own CPU path on the same frame.

Prints one JSON line per kernel, a ``{"kernels": [...]}`` line, and as the
last line ``{"ok": true, "device": {...}}``. Exits non-zero (and prints no
result) without a CUDA device or when any phase fails. A copy of the
measurements is written to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
ARTIFACT = REPO / "artifacts" / "serving_artifact"

# NVIDIA H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 tensor-core
# FLOP/s, f32 CUDA-core FLOP/s
# the port's kernels by wrapper, as their device functions are named
DEVICE_FUNCS = {"normalize": ("normalize_kernel",),
                "fused_stem_stage1": ("fused_stem_stage1_kernel",),
                "decode_level": ("decode_kernel",),
                "nms": ("suppress_kernel", "scan_kernel")}
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

FRAMES = 30


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


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / peak_flops * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def check_kernels(art, torch) -> list[dict]:
    """Each kernel vs its plain version on the card, at serving shapes."""
    from unina_yolo_dla_torch.ops.cuda import (
        decode_kernel, nms_kernel, preprocess_kernel, stem_kernel)
    from unina_yolo_dla_torch.ops.decode import decode_outputs

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    s = art.model_config.input_size
    rows = []

    # 1. normalize: merged uint8 frame (S/2, S/4, 24) -> f32
    frame = torch.from_numpy(
        rng.integers(0, 256, (s // 2, s // 4, 24), dtype=np.uint8)).to(dev)
    mean, std = preprocess_kernel.channel_constants(24)
    got = preprocess_kernel.normalize(frame, mean, std)
    want = preprocess_kernel.normalize_plain(frame, mean, std)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err <= 1e-6, f"normalize: max |err| {err} > 1e-6"
    n = frame.numel()
    b_ms, b_by = bound(n * 1 + n * 4, 2 * n, F32_FLOPS)
    rows.append(dict(
        name="normalize", route="cuda",
        source="unina_yolo_dla_torch/csrc/normalize.cu",
        replaces="unina_yolo_dla_tpu/ops/pallas/preprocess_kernel.py:66",
        max_abs_err=err, tolerance="abs 1e-6",
        ms=cuda_ms(lambda: preprocess_kernel.normalize(frame, mean, std),
                   500),
        plain_ms=cuda_ms(
            lambda: preprocess_kernel.normalize_plain(frame, mean, std), 200),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))

    # 2. fused stem + stage1 on the normalised frame, real weights
    bb = art.model.backbone
    xm = want.to(torch.bfloat16)[None].contiguous()
    args = (xm, bb.stem_kernel, bb.stem_bias, bb.stage1_kernel,
            bb.stage1_bias)
    got = stem_kernel.fused_stem_stage1(*args)
    want_s = stem_kernel.fused_stem_stage1_plain(*args)
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
    rows.append(dict(
        name="fused_stem_stage1", route="cuda",
        source="unina_yolo_dla_torch/csrc/stem.cu",
        replaces="unina_yolo_dla_tpu/ops/pallas/stem_kernel.py:192",
        max_abs_err=err, tolerance="|err| <= 1e-2 * (1 + |ref|)",
        ms=cuda_ms(lambda: stem_kernel.fused_stem_stage1(*args), 100),
        plain_ms=cuda_ms(lambda: stem_kernel.fused_stem_stage1_plain(*args),
                         20),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))

    # 3. decode: the three levels of one frame (160^2, 80^2, 40^2 cells)
    levels = []
    for g_, st in zip(art.model_config.grid_sizes,
                      art.model_config.strides):
        cls = torch.from_numpy(rng.normal(0, 3, (g_, g_, 4)).astype(
            np.float32)).to(dev)
        reg = torch.from_numpy(rng.uniform(0.1, 3.0, (g_, g_, 4)).astype(
            np.float32)).to(dev)
        levels.append((cls, reg, st))
    conf, q = art.config["conf_threshold"], art.config["q_factor"]
    err = 0.0
    for cls, reg, st in levels:
        a = decode_kernel.decode_level_packed(cls, reg, st, conf, q)
        b = decode_kernel.decode_level_plain(cls, reg, st, conf, q)
        torch.cuda.synchronize()
        assert torch.equal(a[:, 5:], b[:, 5:]), "decode: class/valid differ"
        err = max(err, float((a - b).abs().max()))
        rel = float(((a - b).abs() / (1.0 + b.abs())).max())
        assert rel <= 1e-6, f"decode: max |err|/(1+|ref|) {rel} > 1e-6"
    cells = sum(c.shape[0] * c.shape[1] for c, _, _ in levels)
    b_ms, b_by = bound(cells * (16 + 16 + 28), cells * 40, F32_FLOPS)
    rows.append(dict(
        name="decode_level", route="cuda",
        source="unina_yolo_dla_torch/csrc/decode.cu",
        replaces="unina_yolo_dla_tpu/ops/pallas/decode_kernel.py:94",
        max_abs_err=err, tolerance="class/valid exact, boxes/scores "
        "within 1e-6 relative", per="frame (3 levels)",
        ms=cuda_ms(lambda: [decode_kernel.decode_level_packed(
            c, r, st, conf, q) for c, r, st in levels], 200),
        plain_ms=cuda_ms(lambda: [decode_kernel.decode_level_plain(
            c, r, st, conf, q) for c, r, st in levels], 50),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))

    # 4. NMS: the sorted K = 1024 set of that random head output (every
    # slot valid: the heaviest set the path can hand it)
    outs = [(c[None], r[None]) for c, r, _ in levels]
    dets = decode_outputs(outs, art.model_config.strides, conf, q, 1024)
    thr = art.config["iou_threshold"]
    nargs = (dets.boxes, dets.classes, dets.valid, thr)
    keep = nms_kernel.nms_keep(*nargs)
    keep_plain = nms_kernel.nms_keep_plain(*nargs)
    torch.cuda.synchronize()
    assert torch.equal(keep, keep_plain), "nms: keep masks differ"
    k = dets.boxes.shape[0]
    # IoU tests the kernel makes: later, same-class, both-valid pairs
    same = ((dets.classes[:, None] == dets.classes[None, :])
            & dets.valid[:, None] & dets.valid[None, :]).triu(1)
    pairs = int(same.sum())
    b_ms, b_by = bound(k * (16 + 4 + 1) + k, pairs * 15, F32_FLOPS)
    rows.append(dict(
        name="nms", route="cuda", source="unina_yolo_dla_torch/csrc/nms.cu",
        replaces="unina_yolo_dla_tpu/ops/pallas/nms_kernel.py:111",
        max_abs_err=float((keep.int() - keep_plain.int()).abs().max()),
        tolerance="keep mask exact", kept=int(keep.sum()),
        valid=int(dets.valid.sum()),
        ms=cuda_ms(lambda: nms_kernel.nms_keep(*nargs), 200),
        plain_ms=cuda_ms(lambda: nms_kernel.nms_keep_plain(*nargs), 3, 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    return rows


def profile_frames(art, rgb, torch, frames: int = 10) -> dict:
    """Device time per frame by kernel (torch.profiler, CUDA activity),
    against the host wall clock of the same frames."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    art(rgb)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(frames):
            art(rgb)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / frames
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            row = by_name.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e3 / frames
            row[1] += 1
    busy = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    port = {w: sum(v[0] for n, v in by_name.items()
                   if any(re.search(rf"(^|\W){f}\(", n) for f in funcs))
            for w, funcs in DEVICE_FUNCS.items()}
    return {"frames": frames, "wall_ms_per_frame": wall,
            "device_busy_ms_per_frame": busy,
            "device_idle_share": 1.0 - busy / wall,
            "port_kernels_device_ms_per_frame": port,
            "kernels_per_frame": sum(v[1] for v in by_name.values())
            / frames,
            "top": [{"name": n[:90], "ms_per_frame": v[0],
                     "calls_per_frame": v[1] / frames}
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from unina_yolo_dla_torch.data.synthetic import SynthConfig, generate_image
    from unina_yolo_dla_torch.ops.cuda import (
        _lib, decode_kernel, nms_kernel, preprocess_kernel, stem_kernel)
    from unina_yolo_dla_torch.runtime.artifact import ServingArtifact

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

    art = ServingArtifact(ARTIFACT)                 # on cuda
    kernels = {"normalize": preprocess_kernel.KERNEL,
               "fused_stem_stage1": stem_kernel.KERNEL,
               "decode_level": decode_kernel.KERNEL,
               "nms": nms_kernel.KERNEL}
    expected_per_frame = {"normalize": 1, "fused_stem_stage1": 1,
                          "decode_level": 3, "nms": 1}

    # phase 2: each kernel against its plain version on the card
    rows = check_kernels(art, torch)

    # phase 3: end to end, batch 1, the committed engine
    img, labels = generate_image(np.random.default_rng(7),
                                 SynthConfig(image_size=640, seed=7))
    rgb = np.ascontiguousarray(img[..., ::-1])
    for _ in range(5):
        art(rgb)
    torch.cuda.synchronize()
    for kern in kernels.values():
        kern.launches = 0
    times = []
    for _ in range(FRAMES):
        t = time.perf_counter()
        dets = art(rgb)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    launches = {name: kern.launches for name, kern in kernels.items()}
    for name, per in expected_per_frame.items():
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
    cpu_dets = ServingArtifact(ARTIFACT, device="cpu")(rgb)
    match = match_detections(dets, cpu_dets, box_tol=0.5, score_tol=1e-2)
    e2e = {"frames": FRAMES, "valid": n_valid, "gt_cones": len(labels),
           "frame_ms_median": float(np.median(times)),
           "frame_ms_min": float(np.min(times)), "vs_cpu_port": match,
           "launches": launches}
    print(json.dumps({"end_to_end": e2e}), flush=True)

    # phase 4: where the frame's time goes (profiler over a few frames)
    prof = profile_frames(art, rgb, torch)
    log(json.dumps({"profile": prof}, indent=1))

    for row in rows:
        row["launches"] = launches[row["name"]]
        row["device_ms_per_frame"] = prof[
            "port_kernels_device_ms_per_frame"][row["name"]]
        print(json.dumps(row), flush=True)
    line = {"kernels": rows}
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "build_s": build_s, "end_to_end": e2e,
         "profile": prof, **line},
        indent=2))
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
