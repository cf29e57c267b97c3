"""How far can the tensor-core C3k2 kernel drift from its plain version on
random weights, and does it agree bit for bit where sums are exact? One
NVIDIA GPU (PyTorch/CUDA port; imports no JAX).

    python3 tools/torch_c3k2_flip_probe.py

``wgmma`` sums in f32 in another order, and a little more coarsely, than
the f32 GEMM of the plain version, so a pre-rounding value next to a bf16
boundary can round the other way (a "flip", one bf16 step). A C3k2 with two
bottlenecks chains up to seven rounded products with residual adds, which
can grow one flip of a large ``p1`` past ``1e-2 (1 + |ref|)`` at a small
output. Over ten seeds and three ragged shapes (both forms, n = 2) this
prints, per shape:

- ``normal``: max |err| / (1 + |ref|) of kernel vs plain with normal
  (He) weights, at the 3x3's full gain and at a quarter of it, and of the
  plain version vs itself with every product summed in float64;
- ``grid``: the same with inputs on binary grids (activations k/2, sparse
  weights k/4, biases k/8), on which every f32 sum is exact in any order:
  kernel and plain must agree bit for bit there.

Prints one JSON object, and writes it to ``chiprun_out/``.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from unina_yolo_dla_torch.ops.cuda import c3k2_kernel  # noqa: E402
from unina_yolo_dla_torch.ops.cuda.mma_pack import pack_c3k2_mma  # noqa: E402

SEEDS = range(1, 11)
# (H, W, upsample xa, xa's channels; 0 = the single form), all n = 2
SHAPES = ((38, 46, True, 64), (37, 45, False, 64), (37, 45, False, 0))


def rel(got, want) -> float:
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (1.0 + want.abs())).max())


def run(seed: int, shape, grid: bool, gain3: float = 2.0) -> dict:
    hb, wb_, up, ca = shape
    dev, bf = torch.device("cuda"), torch.bfloat16
    rng = np.random.default_rng(seed)

    def act(s):
        a = (rng.integers(0, 5, s) * 0.5 if grid
             else np.maximum(rng.normal(0, 1, s), 0))
        return torch.from_numpy(a.astype(np.float32)).to(dev, bf)

    def kb(s, gain=2.0):
        fan = int(np.prod(s[:-1]))
        if grid:
            k = np.where(rng.random(s) < min(1.0, 8 / fan),
                         rng.choice([-.5, -.25, .25, .5], s), 0.0)
            b = rng.integers(-2, 3, s[-1]) / 8
        else:
            k = rng.normal(0, np.sqrt(gain / fan), s)
            b = rng.normal(0, .1, s[-1])
        return k.astype(np.float32), b.astype(np.float32)

    ws = [w.to(dev) for w in c3k2_kernel.pack_c3k2_weights(
        kb((1, 1, ca + 64, 32)), kb((1, 1, ca + 64, 32)),
        kb((1, 1, 64, 64)),
        [(kb((1, 1, 32, 32)), kb((3, 3, 32, 32), gain3)) for _ in range(2)],
        bf)]
    wpk = pack_c3k2_mma(ws[0], ws[6], ws[2], ws[4], ws[8], ca)
    xb = act((2, hb, wb_, 64))
    if ca:
        xa = act((2, hb // 2, wb_ // 2, ca) if up else (2, hb, wb_, ca))

        def plain():
            return c3k2_kernel.fused_c3k2_cat_plain(xa, xb, *ws, up_a=up)

        got = c3k2_kernel.fused_c3k2_cat(xa, xb, *ws, up_a=up, wpk=wpk)
    else:
        def plain():
            return c3k2_kernel.fused_c3k2_plain(xb, *ws)

        got = c3k2_kernel.fused_c3k2(xb, *ws, wpk=wpk)
    want = plain()
    # the plain version with every product summed in float64 and rounded
    # to f32 once (same rounding points)
    f32_dot = c3k2_kernel._dot
    c3k2_kernel._dot = lambda t, w: (t.double() @ w.double()).float()
    try:
        exact = plain()
    finally:
        c3k2_kernel._dot = f32_dot
    torch.cuda.synchronize()
    return {"kernel_vs_plain": rel(got, want),
            "plain_vs_f64_sums": rel(want, exact),
            "bit_equal": bool(torch.equal(got, want)),
            "ref_max": float(want.float().abs().max())}


def summary(runs: list[dict]) -> dict:
    errs = [r["kernel_vs_plain"] for r in runs]
    return {"kernel_vs_plain": errs, "max": max(errs),
            "seeds_above_1e-2": sum(e > 1e-2 for e in errs),
            "plain_vs_f64_sums_max": max(r["plain_vs_f64_sums"]
                                         for r in runs),
            "bit_equal_runs": sum(r["bit_equal"] for r in runs),
            "ref_max": max(r["ref_max"] for r in runs)}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_c3k2_flip_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for shape in SHAPES:
        rows.append({
            "shape": list(shape), "n": 2, "seeds": len(SEEDS),
            "normal": summary([run(s, shape, False) for s in SEEDS]),
            "normal_quarter_3x3_gain": summary(
                [run(s, shape, False, 0.5) for s in SEEDS]),
            "grid": summary([run(s, shape, True) for s in SEEDS])})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {"card": smi, "rows": rows}
    print(json.dumps(out, indent=1))
    dest = Path(__file__).resolve().parents[1] / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "torch_c3k2_flip_probe.json").write_text(json.dumps(out,
                                                                indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
