"""The int8 conv kernel's plans on one NVIDIA GPU: for each layer shape of
the shipped frame (``int8_conv_kernel.SHIPPED_LAYERS``), the kernel on
seeded random inputs under ``int8_conv_kernel.plan``'s choice and under
the other plans the kernel takes (tile width, ring depth), each checked
bit for bit against ``int8_conv_plain`` and timed inside a replayed CUDA
graph (imports no JAX).

    python3 tools/torch_int8_plans.py [--batch 1] [--quick] [--epilogues]
                                      [--no-pdl] [--tag TAG]

``--quick`` times the chosen plan and the plans that differ from it in
one choice. ``--epilogues`` times instead each shape's chosen plan in the
three epilogues (f32 out, ReLU + requant, and that + the residual
requant), to show what the epilogue costs. ``--no-pdl`` compares instead
this tree with a copy of the package (``build/int8_plans/no_pdl/``) whose
int8 conv is launched without programmatic dependent launch, so that each
launch waits for the one before, as the library's launches and the
parent's do. Both trees' kernels are built at once; then, in turns (this,
copy, copy, this), each in its own process: each shape's chosen plan in a
replayed graph of 20 launches (three times; the output's SHA-256), the
library's product on the same input's patches (``torch._int_mm``), and
the shipped and batch-8 artifacts' captured graphs (30 back-to-back
replays, CUDA events; the SHA-256 of their Detections on scenes of seeds
1-8). Prints one JSON object (the card, and per shape the chosen plan and
every timed plan's graph ms) and writes it to
``chiprun_out/torch_int8_plans_<tag>.json``.
"""
from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
NO_PDL = REPO / "build" / "int8_plans" / "no_pdl"
# the launch attribute of csrc/int8_conv.cu that ``--no-pdl`` takes out
PDL_ATTR = "  cfg.numAttrs = 1;\n"


def layer_inputs(shape, batch: int, seed: int, torch):
    """Seeded random int8 over the full range, scales and biases of the
    engine's size: (args, kwargs) of ``int8_conv``."""
    from unina_yolo_dla_torch.ops.cuda import int8_conv_kernel as k8

    k, s, h, w, c, n, cout, mode = shape
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (batch, h, w, c), dtype=np.int8)
    wq = rng.integers(-127, 128, (n, k * k * c), dtype=np.int8)
    comb = (rng.uniform(0.5, 1.5, n) * 2.5 / 127 * np.sqrt(2 / (k * k * c))
            / 73).astype(np.float32)
    bias = rng.normal(0, 0.1, n).astype(np.float32)
    ho, wo = k8.out_size(h, w, k, s)
    res = rng.integers(-127, 128, (batch, ho, wo, cout), dtype=np.int8)
    dev = torch.device("cuda")
    t = [torch.from_numpy(a).to(dev) for a in (x, wq, comb, bias, res)]
    kw = {}
    if mode != "f32":
        kw["out_amax"] = np.float32(2.5)
    if mode == "qres":
        kw.update(res=t[4], res_amax=np.float32(3.1),
                  add_amax=np.float32(4.2))
    return (*t[:4], k, k, s, k // 2, cout), kw


def shipped_shapes() -> list[tuple]:
    """The shapes of ``int8_conv_kernel.SHIPPED_LAYERS`` as this tree's
    source defines them, read without importing the package (a caller
    such as ``tools/torch_parent_ab.py --root`` may import another
    tree's)."""
    import ast

    src = REPO / "unina_yolo_dla_torch" / "ops" / "cuda" / \
        "int8_conv_kernel.py"
    for node in ast.parse(src.read_text()).body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == "SHIPPED_LAYERS"):
            return list(ast.literal_eval(node.value))
    raise LookupError(f"no SHIPPED_LAYERS in {src}")


def candidates(shape, batch: int, quick: bool) -> list[dict]:
    """The chosen plan first, then the others the kernel takes."""
    from unina_yolo_dla_torch.ops.cuda import int8_conv_kernel as k8

    k, s, h, w, c, n = shape[:6]
    chosen = k8.plan(batch, h, w, c, n, k, s)
    out = [chosen]
    bns = [b for b in k8.TILE_WIDTHS if min(n, 32) <= b <= max(n, 8)]
    for bn, stages in itertools.product(bns, (4, 6, 8)):
        p = dict(chosen, bn=bn, stages=stages)
        try:
            k8.check_plan(p, c, n, k)
        except ValueError:
            continue
        differs = sum(p[key] != chosen[key] for key in ("bn", "stages"))
        if differs and (not quick or differs == 1):
            out.append(p)
    return out


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--epilogues", action="store_true")
    ap.add_argument("--no-pdl", action="store_true")
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    ap.add_argument("--mode", choices=("build", "time"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--tag", default="tree")
    args = ap.parse_args()
    if args.tree:
        print(json.dumps(one_tree(args.tree, args.mode)))
        return 0
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    out = {"card": card(), "batch": args.batch, "shapes": {}}
    if args.no_pdl:
        out["no_pdl"] = no_pdl()
        return write(out, args.tag)
    import chip_smoke as cs
    from unina_yolo_dla_torch.ops.cuda import int8_conv_kernel as k8

    if args.epilogues:
        out["epilogues"] = {}
        for i, shape in enumerate(k8.SHIPPED_LAYERS):
            row = {}
            for mode in ("f32", "q", "qres"):
                call, kw = layer_inputs((*shape[:7], mode), args.batch, i,
                                        torch)
                want = k8.int8_conv_plain(*call, **kw)

                def fn(call=call, kw=kw):
                    return k8.int8_conv(*call, **kw)

                assert torch.equal(fn(), want), (shape, mode)
                row[mode] = cs.graph_ms(fn)
            out["epilogues"]["x".join(map(str, shape))] = row
            print(shape, json.dumps(row), file=sys.stderr, flush=True)
        return write(out, args.tag)
    for i, shape in enumerate(k8.SHIPPED_LAYERS):
        call, kw = layer_inputs(shape, args.batch, i, torch)
        want = k8.int8_conv_plain(*call, **kw)
        rows = []
        for p in candidates(shape, args.batch, args.quick):
            def fn(p=p):
                return k8.int8_conv(*call, **kw, launch_plan=p)

            got = fn()
            torch.cuda.synchronize()
            assert torch.equal(got, want), (shape, p)
            rows.append(dict(bn=p["bn"], stages=p["stages"], kc=p["kc"],
                             graph_ms=cs.graph_ms(fn)))
        key = "x".join(map(str, shape))
        out["shapes"][key] = {"chosen": rows[0], "plans": rows[1:],
                              "best": min(rows, key=lambda r: r["graph_ms"])}
        print(key, json.dumps(out["shapes"][key]["chosen"]),
              json.dumps(out["shapes"][key]["best"]), file=sys.stderr,
              flush=True)
    return write(out, args.tag)


def make_no_pdl() -> Path:
    """A copy of the package whose int8 conv launches without
    programmatic dependent launch (its griddepcontrol instructions then
    return at once)."""
    shutil.rmtree(NO_PDL, ignore_errors=True)
    pkg = NO_PDL / "unina_yolo_dla_torch"
    shutil.copytree(REPO / "unina_yolo_dla_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = pkg / "csrc" / "int8_conv.cu"
    text = cu.read_text()
    assert text.count(PDL_ATTR) == 1, cu
    cu.write_text(text.replace(PDL_ATTR, "  cfg.numAttrs = 0;\n"))
    return NO_PDL


def no_pdl() -> dict:
    """This tree and the copy without programmatic dependent launch, in
    turns (this, copy, copy, this), each in its own process."""
    trees = {"this": REPO, "no_pdl": make_no_pdl()}
    builds = {k: subprocess.Popen(
        [sys.executable, __file__, "--tree", str(r), "--mode", "build"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k, r in trees.items()}
    for k, p in builds.items():
        _, err = p.communicate(timeout=900)
        assert p.returncode == 0, (k, err[-2000:])
    runs = []
    for k in ("this", "no_pdl", "no_pdl", "this"):
        p = subprocess.run([sys.executable, __file__, "--tree",
                            str(trees[k]), "--mode", "time"],
                           capture_output=True, text=True, timeout=900)
        assert p.returncode == 0, (k, p.stderr[-3000:])
        runs.append({"tree": k, **json.loads(p.stdout.splitlines()[-1])})
        print(k, "done", file=sys.stderr, flush=True)
    return {"runs": runs}


def one_tree(root: str, mode: str) -> dict:
    """In this process: build ``root``'s kernels; in ``time`` mode, then
    time its shapes, the library's product and the served graphs."""
    sys.path.insert(0, root)
    sys.path.insert(1, str(REPO))
    import torch

    import unina_yolo_dla_torch
    assert Path(unina_yolo_dla_torch.__file__).resolve().parents[1] == \
        Path(root).resolve()
    from unina_yolo_dla_torch.ops.cuda import _lib

    _lib.library()
    if mode == "build":
        return {}
    import chip_smoke as cs
    from unina_yolo_dla_torch.ops.cuda import int8_conv_kernel as k8
    from unina_yolo_dla_torch.quant.fake_quant import im2col_nhwc

    shapes = {}
    for i, shape in enumerate(shipped_shapes()):
        call, kw = layer_inputs(shape, 1, i, torch)

        def fn(call=call, kw=kw):
            return k8.int8_conv(*call, **kw)

        got = fn()
        assert torch.equal(got, k8.int8_conv_plain(*call, **kw)), shape
        patches = im2col_nhwc(call[0], *call[4:8])
        wt = call[1].t()

        def lib(patches=patches, wt=wt):
            return torch._int_mm(patches, wt)

        shapes["x".join(map(str, shape))] = {
            "digest": _digest([got], torch),
            "graph_ms": [cs.graph_ms(fn) for _ in range(3)],
            "library_graph_ms": cs.graph_ms(lib)}
    return {"shapes": shapes, "served": served(cs, torch)}


def _digest(tensors, torch) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def served(cs, torch) -> dict:
    """The shipped and batch-8 artifacts' captured graphs: replay ms a
    call (30 back-to-back replays, CUDA events) and a digest of the
    Detections of scenes of seeds 1-8."""
    from unina_yolo_dla_torch.data.synthetic import SynthConfig, \
        generate_image
    from unina_yolo_dla_torch.runtime.artifact import ServingArtifact

    scenes = [np.ascontiguousarray(generate_image(
        np.random.default_rng(s), SynthConfig(image_size=640, seed=s))[0][
            ..., ::-1]) for s in range(1, 9)]
    out = {}
    for name, path, inputs in (("shipped", cs.ARTIFACT, scenes),
                               ("b8", cs.ARTIFACT_B8, [np.stack(scenes)])):
        art = ServingArtifact(path)
        dets = [t for frame in inputs for t in art(frame)]
        graph = art.graph.graph
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(30):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        out[name] = {"replay_ms": start.elapsed_time(end) / 30,
                     "digest": _digest(dets, torch)}
    return out


def write(out: dict, tag: str) -> int:
    text = json.dumps(out)
    dst = REPO / "chiprun_out"
    dst.mkdir(exist_ok=True)
    (dst / f"torch_int8_plans_{tag}.json").write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
