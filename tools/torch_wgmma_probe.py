"""Rates of the tensor cores in the forms a redesign of the wide head's
products could take, and whether a shared-memory matrix descriptor reads
a window's pixel rows from any pixel (imports no JAX).

    python3 tools/torch_wgmma_probe.py

Builds ``tools/torch_wgmma_probe.cu`` with nvcc for sm_90a into
``build/wgmma_probe/`` and runs on the card:

- ``phase``: one m64n64 K chunk whose A operand a descriptor reads from a
  swizzled window of 160 pixels (the wide kernels' ``pix_chunk`` layout)
  starting at pixel ``start``, its 8-row groups ``sbo_px`` pixels apart,
  the descriptor's base-offset field 0 (``base0``) or the start's row
  phase (``phase``); against the same product in float32 on the host
  (inputs small integers: exact). ``max_abs_err`` 0 means the descriptor
  addressed those rows.
- ``rates``: one block an SM (132), each of its warpgroups holding MINE
  m64 x N accumulator tiles and multiplying 64-deep K chunks back to back
  with A by ldmatrix (mode 0: after waiting out its products, as the wide
  kernels do; mode 1: one k16 step ahead into a second register set) or
  from shared memory (mode 2); TFLOP/s over CUDA events and the share of
  the bf16 dense peak (989 TFLOP/s).

Prints one JSON object (with the card's name and power limit) and writes
it to ``chiprun_out/torch_wgmma_probe.json``.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
SRC = REPO / "tools" / "torch_wgmma_probe.cu"
OUT = REPO / "build" / "wgmma_probe"
PEAK = 989e12
BLOCKS = 132
CHUNKS = 4000
# variant -> (N, MINE, warpgroups, mode), as probe_rate's switch
VARIANTS = {
    0: (64, 3, 2, 0), 1: (64, 3, 2, 1), 2: (128, 2, 2, 1),
    3: (128, 2, 3, 1), 4: (128, 1, 3, 1), 5: (128, 2, 1, 1),
    6: (128, 2, 2, 2), 7: (128, 2, 3, 2), 8: (256, 1, 2, 2),
    9: (64, 3, 2, 2), 10: (128, 2, 1, 2),
}


def build() -> ctypes.CDLL:
    hdr = REPO / "unina_yolo_dla_torch" / "csrc" / "mma_sm90.cuh"
    tag = hashlib.sha256(SRC.read_bytes() + hdr.read_bytes()).hexdigest()[:12]
    lib = OUT / f"libwgmma_probe_{tag}.so"
    if not lib.exists():
        OUT.mkdir(parents=True, exist_ok=True)
        r = subprocess.run(
            ["/usr/local/cuda/bin/nvcc", "-gencode",
             "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
             "-shared", str(SRC), "-o", str(lib)],
            capture_output=True, text=True)
        (OUT / "build.log").write_text(r.stdout + r.stderr)
        if r.returncode:
            raise RuntimeError(r.stdout + r.stderr)
    dll = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    dll.probe_rate.argtypes = [I, I, I, P, P]
    dll.probe_phase.argtypes = [P, I, P, P, I, I, I, P]
    return dll


def phase_test() -> int:
    import numpy as np
    import torch

    from unina_yolo_dla_torch.ops.cuda.mma_pack import _swizzle, \
        pack_b_tiles

    dll = build()
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(0)
    npix = 160
    x = torch.from_numpy(rng.integers(-3, 4, (npix, 64)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-3, 4, (64, 64)).astype(np.float32))
    win = _swizzle(x.to(torch.bfloat16)).contiguous().to(dev)
    tile = pack_b_tiles(w.to(torch.bfloat16)).contiguous().to(dev)
    phase = []
    for sbo in (8, 18):
        for start in (0, 1, 2, 3, 4, 5, 6, 7, 18, 36, 21):
            rows = [start + (i // 8) * sbo + i % 8 for i in range(64)]
            if max(rows) >= npix:
                continue
            want = x[rows] @ w
            for mode in (0, 1):
                out = torch.zeros(64, 64, device=dev)
                err = dll.probe_phase(win.data_ptr(), npix * 8,
                                      tile.data_ptr(), out.data_ptr(), start,
                                      sbo, mode, stream)
                torch.cuda.synchronize()
                if err:
                    raise RuntimeError(f"probe_phase: CUDA error {err}")
                phase.append({"sbo_px": sbo, "start": start,
                              "base": ["base0", "phase"][mode],
                              "max_abs_err": float(
                                  (out.cpu() - want).abs().max())})
    print(json.dumps(phase))
    return 0


def rate(v: int) -> int:
    """Variant ``v``'s rate (one JSON line)."""
    import torch

    dll = build()
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    n, mine, nwg, mode = VARIANTS[v]
    sink = torch.zeros(1024, device=dev)

    def run(chunks):
        err = dll.probe_rate(v, BLOCKS, chunks, sink.data_ptr(), stream)
        if err:
            raise RuntimeError(f"probe_rate {v}: CUDA error {err}")
    run(64)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times = []
    for _ in range(3):
        start.record()
        run(CHUNKS)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    ms = min(times)
    flop = 2.0 * BLOCKS * nwg * mine * CHUNKS * 64 * 64 * n
    print(json.dumps({"variant": v, "n": n, "mine": mine,
                      "warpgroups": nwg, "mode": mode, "ms": ms,
                      "tflops": flop / ms / 1e9,
                      "share_of_peak": flop / ms / 1e-3 / PEAK}))
    return 0


def child(*args) -> dict | list:
    r = subprocess.run([sys.executable, __file__, *args],
                       capture_output=True, text=True, timeout=300)
    if r.returncode:
        return {"args": list(args), "error": r.stderr[-600:]}
    return json.loads(r.stdout.strip().splitlines()[-1])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build()
    phase = child("--phase")
    rates = [child("--rate", str(v)) for v in VARIANTS]
    res = {"card": smi, "phase": phase, "rates": rates,
           "ptxas": (OUT / "build.log").read_text()[-4000:]
           if (OUT / "build.log").exists() else ""}
    text = json.dumps(res)
    dst = REPO / "chiprun_out"
    dst.mkdir(exist_ok=True)
    (dst / "torch_wgmma_probe.json").write_text(text)
    print(json.dumps({k: v for k, v in res.items() if k != "ptxas"}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase"]:
        sys.exit(phase_test())
    if sys.argv[1:2] == ["--rate"]:
        sys.exit(rate(int(sys.argv[2])))
    sys.exit(main())
