"""The wide head's large plan at C = 128 on one NVIDIA GPU: held to its
bits over many launches, and timed where the replicated plan runs
(imports no JAX).

    python3 tools/torch_large_plan.py [--launches 1000] [--rounds 5]

Copies the package into ``build/large_plan/forced/`` with csrc/head.cu's
``large::plan`` (and its mirror ``head_kernel.large_plan``) true at every
C = 128 grid, builds both trees' kernels at once, and runs each part in
its own process:

- ``stress`` (this tree): the large plan at base 64's 160 x 160, at
  batches of 2 and 4 and at two ragged sizes, each on SEEDS seeded normal
  inputs, launched ``--launches`` times back to back in bursts of
  BURST, every output compared bit for bit with the first launch's; the
  same shapes on binary-grid inputs (every f32 sum exact in any order),
  every launch of a burst equal to ``fused_head_plain``; then
  ``chip_smoke.check_widths_grid`` (``chip_smoke.py`` phase 20's grid
  checks, digests and relaunches) ``--rounds`` times. Every failure is
  recorded with its message; none stops the others.
- ``check`` (both trees): the SHA-256 of the head at 128 at each base's
  served shape and at ragged batches (HEADS128), the launch each made,
  and on the forced tree each of those shapes on grid inputs bit for bit
  ``fused_head_plain``.
- ``time``: this, forced, forced, this: the replayed-graph ms of HEADS128'
  served shapes, three times each.

Prints one JSON object and writes ``chiprun_out/torch_large_plan.json``;
exits 1 if any stress case or check failed.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
TREES = REPO / "build" / "large_plan"
# the head at 128: each base's served shape, then ragged batches
HEADS128 = {"head_p2_b64_1x160x160": (1, 160, 160, 128),
            "head_p3_b32_1x80x80": (1, 80, 80, 128),
            "head_p4_b16_1x20x20": (1, 20, 20, 128),
            "head_p2_b64_2x150x134": (2, 150, 134, 128),
            "head_p2_b64_2x19x23": (2, 19, 23, 128),
            "head_p3_b32_2x41x37": (2, 41, 37, 128),
            "head_p4_b16_3x13x7": (3, 13, 7, 128)}
TIMED = ("head_p2_b64_1x160x160", "head_p3_b32_1x80x80",
         "head_p4_b16_1x20x20")
# the stress shapes, all on the large plan
STRESS = {"1x160x160": (1, 160, 160), "2x160x160": (2, 160, 160),
          "4x160x160": (4, 160, 160), "2x150x134": (2, 150, 134),
          "3x97x211": (3, 97, 211)}
SEEDS = (1, 2, 3, 4, 5)
BURST = 100
PLAN = ("  return c == C &&\n"
        "         ((h + 7) / 8) * ((w + 15) / 16) * 2 >= "
        "wide::WALK_MIN_BLOCKS;")
PLAN_PY = ("    return c == 128 and -(-h // 8) * -(-w // 16) * 2 >= "
           "WIDE_WALK_MIN_BLOCKS")


def _sub(path: Path, old: str, new: str) -> None:
    text = path.read_text()
    assert text.count(old) == 1, (path, old)
    path.write_text(text.replace(old, new))


def make_forced() -> Path:
    """A copy of the package whose wide head takes the large plan at every
    C = 128 grid."""
    root = TREES / "forced"
    shutil.rmtree(root, ignore_errors=True)
    pkg = root / "unina_yolo_dla_torch"
    shutil.copytree(REPO / "unina_yolo_dla_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    _sub(pkg / "csrc" / "head.cu", PLAN, "  return c == C;")
    _sub(pkg / "ops" / "cuda" / "head_kernel.py", PLAN_PY,
         "    return c == 128")
    return root


def head_inputs(shape, seed: int, grid: bool, torch):
    """x and the packed weights of a C = 128 head on the card: seeded
    normal inputs (``chip_smoke.wide_calls``' distributions) or binary-grid
    ones (``chip_smoke.wide_grid_checks``')."""
    from unina_yolo_dla_torch.ops.cuda import head_kernel, mma_pack

    dev, bf = torch.device("cuda"), torch.bfloat16
    rng = np.random.default_rng(seed)
    b, h, w, c = shape

    def act(s):
        a = (rng.integers(0, 5, s) * 0.5 if grid
             else np.maximum(rng.normal(0, 1, s), 0))
        return torch.from_numpy(a.astype(np.float32)).to(dev, bf)

    def kb(s):
        fan = int(np.prod(s[:-1]))
        if grid:
            k = np.where(rng.random(s) < min(1.0, 8 / fan),
                         rng.choice([-.5, -.25, .25, .5], s), 0.0)
            return (k.astype(np.float32),
                    (rng.integers(-2, 3, s[-1]) / 8).astype(np.float32))
        return (rng.normal(0, np.sqrt(2 / fan), s).astype(np.float32),
                rng.normal(0, .1, s[-1]).astype(np.float32))

    x = act((b, h, w, c))
    ws = [t.to(dev) for t in head_kernel.pack_head_weights(
        [kb((3, 3, c, c)), kb((3, 3, c, c))], kb((1, 1, c, 4)),
        [kb((3, 3, c, c)), kb((3, 3, c, c))], kb((1, 1, c, 4)), bf)]
    w33 = mma_pack.pack_head_mma(ws[0], ws[6], ws[2], ws[8], ws[4], ws[10])
    return x, ws, w33


def digest(tensors, torch) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def stress(launches: int, rounds: int, torch) -> dict:
    """The large plan relaunched on seeded and grid inputs, and phase 20's
    grid checks ``rounds`` times: every case's launches and the ones that
    differ; every failure's message."""
    import chip_smoke as cs
    from unina_yolo_dla_torch.ops.cuda import head_kernel

    out = {"cases": {}, "failures": [], "widths_grid": []}
    for name, (b, h, w) in STRESS.items():
        assert head_kernel.large_plan(128, h, w), name
        for seed in SEEDS:
            for grid in (False, True):
                key = f"{name}_seed{seed}_{'grid' if grid else 'normal'}"
                x, ws, w33 = head_inputs((b, h, w, 128), seed, grid, torch)
                n = launches if not grid else max(BURST, launches // 10)
                first = head_kernel.fused_head(x, *ws, w33=w33)
                ref = head_kernel.fused_head_plain(x, *ws) if grid else first
                torch.cuda.synchronize()
                assert head_kernel.last_launch()["threads"] == 384, name
                differ = int(not all(bool(torch.equal(a, r))
                                     for a, r in zip(first, ref)))
                done = 1
                while done < n:
                    outs = [head_kernel.fused_head(x, *ws, w33=w33)
                            for _ in range(min(BURST, n - done))]
                    torch.cuda.synchronize()
                    differ += sum(not all(bool(torch.equal(a, r))
                                          for a, r in zip(o, ref))
                                  for o in outs)
                    done += len(outs)
                out["cases"][key] = {"launches": done, "differ": differ}
                if differ:
                    out["failures"].append(
                        f"{key}: {differ} of {done} launches differ from "
                        f"{'the plain version' if grid else 'the first'}")
                del x, ws, w33, ref, first
    for r in range(rounds):
        t = time.perf_counter()
        try:
            cs.check_widths_grid(torch)
            res = "passed"
        except Exception as e:  # record, and go on with the next round
            res = f"{type(e).__name__}: {e}"
            out["failures"].append(f"check_widths_grid round {r}: {res}")
        out["widths_grid"].append({"round": r, "result": res,
                                   "s": time.perf_counter() - t})
    return out


def check(torch, forced: bool) -> dict:
    """HEADS128' digests on seeded inputs and the launch each made; on the
    forced tree, the same shapes on grid inputs against the plain
    version."""
    import chip_smoke as cs
    from unina_yolo_dla_torch.ops.cuda import head_kernel

    out = {"digest": {}, "launch": {}, "grid_bit_equal": {}}
    for name, call in cs.wide_calls(torch, HEADS128).items():
        res = call()
        torch.cuda.synchronize()
        out["launch"][name] = head_kernel.last_launch()
        out["digest"][name] = digest(res, torch)
        if forced:
            x, ws, w33 = head_inputs(HEADS128[name], 16, True, torch)
            got = head_kernel.fused_head(x, *ws, w33=w33)
            want = head_kernel.fused_head_plain(x, *ws)
            torch.cuda.synchronize()
            out["grid_bit_equal"][name] = all(
                bool(torch.equal(g, w_)) for g, w_ in zip(got, want))
    return out


def timing(torch) -> dict:
    import chip_smoke as cs

    shapes = {k: HEADS128[k] for k in TIMED}
    return {name: [cs.graph_ms(call, 10, 5) for _ in range(3)]
            for name, call in cs.wide_calls(torch, shapes).items()}


def one_tree(root: str, mode: str, launches: int, rounds: int) -> dict:
    """In this process: build ``root``'s kernels, then run ``mode``."""
    sys.path.insert(0, root)
    sys.path.insert(1, str(REPO))
    import torch

    import unina_yolo_dla_torch
    assert Path(unina_yolo_dla_torch.__file__).resolve().parents[1] == \
        Path(root).resolve()
    from unina_yolo_dla_torch.ops.cuda import _lib

    t = time.perf_counter()
    _lib.library()
    out = {"build_s": time.perf_counter() - t}
    if mode == "stress":
        out.update(stress(launches, rounds, torch))
    elif mode in ("check", "check_forced"):
        out.update(check(torch, mode == "check_forced"))
    elif mode == "time":
        out["graph_ms"] = timing(torch)
    return out


def run_tree(root: Path, mode: str, args) -> dict:
    p = subprocess.run([sys.executable, __file__, "--tree", str(root),
                        "--mode", mode, "--launches", str(args.launches),
                        "--rounds", str(args.rounds)],
                       capture_output=True, text=True, timeout=1800)
    try:
        return json.loads(p.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        return {"rc": p.returncode, "stderr": p.stderr[-3000:]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--launches", type=int, default=1000)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--tree")
    ap.add_argument("--mode")
    args = ap.parse_args()
    if args.tree:
        print(json.dumps(one_tree(args.tree, args.mode, args.launches,
                                  args.rounds)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    trees = {"this": REPO, "forced": make_forced()}
    builds = {k: subprocess.Popen(
        [sys.executable, __file__, "--tree", str(r), "--mode", "build"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k, r in trees.items()}
    for k, p in builds.items():
        _, err = p.communicate(timeout=900)
        assert p.returncode == 0, (k, err[-2000:])
    out = {"card": card, "launches": args.launches, "rounds": args.rounds}
    out["stress"] = run_tree(REPO, "stress", args)
    out["check"] = {"this": run_tree(REPO, "check", args),
                    "forced": run_tree(trees["forced"], "check_forced",
                                       args)}
    out["runs"] = [{"tree": k, **run_tree(trees[k], "time", args)}
                   for k in ("this", "forced", "forced", "this")]
    ok = "failures" in out["stress"] and not out["stress"]["failures"]
    this, forced = out["check"]["this"], out["check"]["forced"]
    ok = ok and "digest" in this and "digest" in forced
    if ok:
        out["forced_digests_differ"] = sorted(
            k for k, v in this["digest"].items() if forced["digest"][k] != v)
        ok = all(forced["grid_bit_equal"].values())
    out["ok"] = ok
    text = json.dumps(out)
    dst = REPO / "chiprun_out"
    dst.mkdir(exist_ok=True)
    (dst / "torch_large_plan.json").write_text(text)
    print(text)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
