"""SPPF's layout variants (``tools/torch_sppf_variants.cu``) on one NVIDIA
GPU, each with and without the programmatic dependent launch attribute,
against the port's ``int8_sppf`` (imports no JAX).

    python3 tools/torch_sppf_variants.py

Builds the variants with ``nvcc`` into ``build/sppf_variants/``. At the
shipped SPPF input (the seed-7 eager frame's, batch 1) and at a seeded
random batch of 8 (1, 40, 40, 128 -> 8, 40, 40, 128), for each variant:
``ok``, whether its output is the plain version's bits (None for the
variants that only load and store); ``graph``, three replayed-graph
times of 20 launches (``chip_smoke.graph_ms``, ms a launch); and at
batch 1 ``chained``, two times of what it adds under the int8 conv
launch before SPPF in the frame (``chip_smoke.chained_ms``). The same
for ``int8_sppf`` itself (``package``). Writes
``chiprun_out/sppf_variants.json``; the SASS of the variants' library is
``cuobjdump -sass build/sppf_variants/libvariants.so``.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from unina_yolo_dla_torch.data.synthetic import (  # noqa: E402
    SynthConfig, generate_image)
from unina_yolo_dla_torch.ops.cuda import _lib  # noqa: E402
from unina_yolo_dla_torch.ops.cuda import sppf_kernel as k11  # noqa: E402
from unina_yolo_dla_torch.quant.qtensor import QTensor  # noqa: E402
from unina_yolo_dla_torch.runtime.artifact import (  # noqa: E402
    ServingArtifact)

VARIANTS = range(15)
COPY_ONLY = (7, 8)      # loads and stores only: not SPPF's function


def build() -> ctypes.CDLL:
    out = REPO / "build" / "sppf_variants"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libvariants.so"
    r = subprocess.run(
        [_lib._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v", "-o", str(so),
         str(REPO / "tools" / "torch_sppf_variants.cu")],
        capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stderr)
    print("\n".join(s for s in r.stderr.splitlines() if "Used" in s))
    lib = ctypes.CDLL(str(so))
    lib.sppf_var.argtypes = ([ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_void_p] + [ctypes.c_int] * 5
                             + [ctypes.c_void_p])
    return lib


def main() -> None:
    fn = build().sppf_var
    img, _ = generate_image(np.random.default_rng(7),
                            SynthConfig(image_size=640, seed=7))
    rgb = np.ascontiguousarray(img[..., ::-1])
    art = ServingArtifact(cs.ARTIFACT, graph=False)
    _, pools = cs.glue_launches(art, rgb, torch)
    x, conv = pools[0]
    gen = torch.Generator(device="cuda").manual_seed(8)
    xb = QTensor(torch.randint(-127, 128, (8,) + tuple(x.q.shape[1:]),
                               dtype=torch.int8, device="cuda",
                               generator=gen), x.amax)
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()}

    def call(v, pdl, xx):
        q = xx.q
        b, h, w, c = q.shape
        o = torch.empty((b, h, w, 4 * c), dtype=torch.int8, device=q.device)
        err = fn(v, q.data_ptr(), o.data_ptr(), b, h, w, c, pdl,
                 _lib.stream_ptr(q.device))
        assert err == 0, err
        return o

    for xx, tag in ((x, "b1"), (xb, "b8")):
        want = k11.int8_sppf_plain(xx).q
        res = {"package": [cs.graph_ms(lambda: k11.int8_sppf(xx))
                           for _ in range(3)]}
        if tag == "b1":
            res["package_chained"] = [
                cs.chained_ms(conv, lambda: k11.int8_sppf(xx), torch)
                for _ in range(2)]
        for v in VARIANTS:
            for pdl in (1, 0):
                got = call(v, pdl, xx)
                torch.cuda.synchronize()
                ok = None if v in COPY_ONLY else bool(torch.equal(got, want))

                def f(v=v, pdl=pdl):
                    return call(v, pdl, xx)

                rec = {"ok": ok, "graph": [cs.graph_ms(f) for _ in range(3)]}
                if tag == "b1":
                    rec["chained"] = [cs.chained_ms(conv, f, torch)
                                      for _ in range(2)]
                res[f"v{v}_pdl{pdl}"] = rec
                print(tag, v, pdl, json.dumps(rec), flush=True)
        out[tag] = res
    dst = REPO / "chiprun_out"
    dst.mkdir(exist_ok=True)
    (dst / "sppf_variants.json").write_text(json.dumps(out))
    print(json.dumps({"card": out["card"], "ok": all(
        r["ok"] is not False for t in ("b1", "b8")
        for k, r in out[t].items() if k.startswith("v"))}))


if __name__ == "__main__":
    main()
