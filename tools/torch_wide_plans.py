"""The wide C3k2 and head kernels' two plans on one NVIDIA GPU, and two
variants of their weight feeder (imports no JAX).

    python3 tools/torch_wide_plans.py [--feeder]

Copies the package into ``build/wide_plans/<variant>/`` with one change
each, builds every tree's kernels at once, and runs each tree in its own
process:

- ``owned`` and ``replicated``: ``OWNED_MIN_BLOCKS`` 0 or 2**30 in
  csrc/c3k2.cu, csrc/head.cu and their Python mirrors, so hidden 128 and
  head 256 run the owned plan, or the replicated one, on every grid;
- with ``--feeder``, ``table`` and ``divide``: csrc/wide_mma.cuh's
  ``Feeder`` reads the stream's table at every chunk and computes the
  walked chunk index by ``%`` and ``/``, only on walked stages
  (``table``) or on every stage, dividing by 0 where a stage is not
  walked (``divide``: undefined in C++).

For every tree, the SHA-256 of the wide kernels' outputs at
``chip_smoke.py``'s WIDE_SHAPES and WIDE64_SHAPES; the names whose digest
differs from this tree's are listed. For this tree, ``owned`` and
``replicated`` (this, owned, replicated, replicated, owned, this), the
replayed-graph ms of base 32's hidden-128 C3k2s
and head 256 at 40 x 40 (batch 1 and 8) and of base 64's stage2_c3k2 at
80 x 80, on seeded inputs, with the launch each made. Prints one JSON
object and writes ``chiprun_out/torch_wide_plans.json``.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
TREES = REPO / "build" / "wide_plans"
TIMED = {
    "c3k2_h128_n2_1x40x40": (1, 40, 40, 0, 256, 128, 2, False, True),
    "cat_h128_n1_1x40x40": (1, 40, 40, 128, 256, 128, 1, False, False),
    "c3k2_h128_n2_8x40x40": (8, 40, 40, 0, 256, 128, 2, False, True),
    "cat_h128_n1_8x40x40": (8, 40, 40, 128, 256, 128, 1, False, False),
    "head_c256_1x40x40": (1, 40, 40, 256),
    "head_c256_8x40x40": (8, 40, 40, 256),
    "c3k2_h128_n2_1x80x80": (1, 80, 80, 0, 256, 128, 2, False, True),
}
FEEDER = '''template <class G, bool WALK = false>
struct Feeder {
  static constexpr int RING = G::RING, SLOT = G::SLOT;
  const Stream* st;
  int s, g;
  uint32_t ring, bars;
  bool lead;
  int wg;
  __device__ Feeder(const Stream& stream, uint32_t ring0, uint32_t bars0,
                    const Lane& L)
      : st(&stream), s(0), g(0), ring(ring0 + L.wg * RING * SLOT),
        bars(bars0 + L.wg * RING * 8), lead((L.tid & 127) == 0), wg(L.wg) {}
  __device__ void issue() {
    if (s < st->nst) {
      const int j = g - st->first[s], in = st->inner[s];
      const int part = st->bytes[s] / st->halves[s];
      long long idx;
      INDEX
      if (lead) {
        const uint32_t bar = bars + (g % RING) * 8;
        mbar_expect(bar, part);
        bulk_copy(ring + (g % RING) * SLOT,
                  st->src + st->off[s] + st->skew[s] +
                      (st->halves[s] == 2 ? wg * part : 0) +
                      idx * st->stride[s],
                  part, bar);
      }
      if (g + 1 == st->first[s + 1]) ++s;
    }
    ++g;
  }
  __device__ uint32_t slot(int chunk_index) const {
    return ring + (chunk_index % RING) * SLOT;
  }
  __device__ void wait(int chunk_index) const {
    mbar_wait(bars + (chunk_index % RING) * 8, (chunk_index / RING) & 1);
  }
};

'''
# the plan variants' OWNED_MIN_BLOCKS
PLANS = {"owned": 0, "replicated": 1 << 30}
INDEX = {
    "table": "idx = in ? (long long)(j % in) * st->jump[s] + j / in : j;",
    "divide": ("const long long t = (long long)(j % in) * st->jump[s] + "
               "j / in;\n      idx = in ? t : j;"),
}


def _sub(path: Path, old: str, new: str) -> None:
    text = path.read_text()
    assert text.count(old) == 1, (path, old)
    path.write_text(text.replace(old, new))


def make_tree(name: str) -> Path:
    """A copy of the package under TREES / name with the variant's
    change."""
    root = TREES / name
    shutil.rmtree(root, ignore_errors=True)
    pkg = root / "unina_yolo_dla_torch"
    shutil.copytree(REPO / "unina_yolo_dla_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    if name in PLANS:
        for src in ("csrc/c3k2.cu", "csrc/head.cu"):
            _sub(pkg / src, "constexpr int OWNED_MIN_BLOCKS = 128;",
                 f"constexpr int OWNED_MIN_BLOCKS = {PLANS[name]};")
        for src in ("ops/cuda/c3k2_kernel.py", "ops/cuda/head_kernel.py"):
            _sub(pkg / src, "\nOWNED_MIN_BLOCKS = 128\n",
                 f"\nOWNED_MIN_BLOCKS = {PLANS[name]}\n")
    else:
        head = pkg / "csrc" / "wide_mma.cuh"
        text = head.read_text()
        a = text.index("template <class G, bool WALK = false>\nstruct Feeder")
        b = text.index("static_assert(sizeof(Stream) <= BARS")
        head.write_text(text[:a] + FEEDER.replace("INDEX", INDEX[name])
                        + text[b:])
    return root


def one_tree(root: str, mode: str) -> dict:
    """In this process: build ``root``'s kernels (mode ``build``), or
    digest (``digests``) or time (``time``) its wide kernels."""
    sys.path.insert(0, root)
    sys.path.insert(1, str(REPO))
    import torch

    import unina_yolo_dla_torch
    assert Path(unina_yolo_dla_torch.__file__).resolve().parents[1] == \
        Path(root).resolve()
    from unina_yolo_dla_torch.ops.cuda import _lib, c3k2_kernel, head_kernel

    t = time.perf_counter()
    _lib.library()
    out = {"build_s": time.perf_counter() - t}
    if mode == "build":
        return out
    import chip_smoke as cs

    if mode == "digests":
        for key, shapes in (("wide", cs.WIDE_SHAPES),
                            ("wide64", cs.WIDE64_SHAPES)):
            out[key] = cs.wide_digests(torch, shapes)
        return out
    out["graph_ms"], out["launch"] = {}, {}
    for name, call in cs.wide_calls(torch, TIMED).items():
        call()
        torch.cuda.synchronize()
        mod = head_kernel if name.startswith("head") else c3k2_kernel
        out["launch"][name] = mod.last_launch()
        out["graph_ms"][name] = cs.graph_ms(call, 10, 20)
    return out


def run_tree(root: Path, mode: str) -> dict:
    p = subprocess.run([sys.executable, __file__, "--tree", str(root),
                        "--mode", mode], capture_output=True, text=True,
                       timeout=900)
    try:
        return json.loads(p.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        return {"rc": p.returncode, "stderr": p.stderr[-2000:]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--feeder", action="store_true")
    ap.add_argument("--tree")
    ap.add_argument("--mode")
    args = ap.parse_args()
    if args.tree:
        print(json.dumps(one_tree(args.tree, args.mode)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    trees = {"this": REPO}
    for name in tuple(PLANS) + (tuple(INDEX) if args.feeder else ()):
        trees[name] = make_tree(name)
    builds = {k: subprocess.Popen(
        [sys.executable, __file__, "--tree", str(r), "--mode", "build"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k, r in trees.items()}
    for k, p in builds.items():
        _, err = p.communicate(timeout=900)
        assert p.returncode == 0, (k, err[-2000:])
    out = {"card": card, "differs_from_this": {}, "runs": []}
    digests = {k: run_tree(r, "digests") for k, r in trees.items()}
    for k, d in digests.items():
        if k != "this":
            out["differs_from_this"][k] = d if "rc" in d else {
                key: sorted(n for n, v in digests["this"][key].items()
                            if d[key][n] != v) for key in ("wide", "wide64")}
    for k in ("this", "owned", "replicated", "replicated", "owned", "this"):
        out["runs"].append({"tree": k, **run_tree(trees[k], "time")})
    text = json.dumps(out)
    dst = REPO / "chiprun_out"
    dst.mkdir(exist_ok=True)
    (dst / "torch_wide_plans.json").write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
