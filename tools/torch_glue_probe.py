"""The int8 glue kernels of one tree of the port, site by site, on one
NVIDIA GPU (imports no JAX).

    python3 tools/torch_glue_probe.py [--root DIR] [--tag TAG]

``--root DIR`` imports ``unina_yolo_dla_torch`` from another tree (an
unpacked parent commit, as for ``tools/torch_parent_ab.py``). On the
glue launches of the shipped artifact's eager seed-7 frame
(``chip_smoke.glue_launches``), for each concat site (kernel 12,
``qconcat_kernel._launch``): ``graph_ms``, three replayed-graph times of
20 launches (``chip_smoke.graph_ms``); ``chained_ms``, two times of what
it adds under the int8 conv launch before it in the frame
(``chip_smoke.chained_ms``); ``cat_ms``, a bare ``torch.cat`` of int8
tensors of the parts' sizes; and, for a site of more than one part,
``parts_alone``: each float (Q) or dequantising (DEQ_Q) part launched
alone (None for an int8 COPY or REQ part). For SPPF (kernel 11):
``graph_ms``, ``chained_ms``, ``ms`` (CUDA events over 200 back-to-back
launches) and ``b8_graph_ms`` at a seeded random batch of 8. Writes
``chiprun_out/glue_probe_<tag>.json``.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--tag", default="tree")
    args = ap.parse_args()
    sys.path[:0] = [str(Path(args.root).resolve()), str(REPO)]
    import torch

    import chip_smoke as cs
    import unina_yolo_dla_torch
    from unina_yolo_dla_torch.data.synthetic import (SynthConfig,
                                                     generate_image)
    from unina_yolo_dla_torch.ops.cuda import _lib
    from unina_yolo_dla_torch.ops.cuda import qconcat_kernel as k12
    from unina_yolo_dla_torch.ops.cuda import sppf_kernel as k11
    from unina_yolo_dla_torch.quant.qtensor import QTensor
    from unina_yolo_dla_torch.runtime.artifact import ServingArtifact

    root = Path(unina_yolo_dla_torch.__file__).resolve().parent.parent
    assert root == Path(args.root).resolve(), root
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    t0 = time.perf_counter()
    _lib.library()
    build_s = time.perf_counter() - t0
    img, _ = generate_image(np.random.default_rng(7),
                            SynthConfig(image_size=640, seed=7))
    rgb = np.ascontiguousarray(img[..., ::-1])
    art = ServingArtifact(cs.ARTIFACT, graph=False)
    concats, pools = cs.glue_launches(art, rgb, torch)
    out = {"card": smi, "tag": args.tag, "build_s": build_s, "sites": []}
    for i, (xs, modes, up, amax, conv) in enumerate(concats):
        def fn(xs=xs, modes=modes, up=up, amax=amax):
            return k12._launch(xs, modes, up, amax)

        shape = list(fn().q.shape)
        rec = {"modes": list(modes), "up": list(up), "shape": shape,
               "graph_ms": [cs.graph_ms(fn) for _ in range(3)],
               "chained_ms": [cs.chained_ms(conv, fn, torch)
                              for _ in range(2)]}
        parts = [torch.zeros(shape[:3] + [(x.q if isinstance(x, QTensor)
                                           else x).shape[-1]],
                             dtype=torch.int8, device="cuda") for x in xs]
        rec["cat_ms"] = cs.graph_ms(lambda p=parts: torch.cat(p, dim=-1))
        if len(xs) > 1:
            rec["parts_alone"] = [
                None if m in (k12.COPY, k12.REQ) else cs.graph_ms(
                    lambda x=x, m=m, u=u, amax=amax:
                    k12._launch([x], [m], (u,), amax))
                for x, m, u in zip(xs, modes, up)]
        out["sites"].append(rec)
        print(i, json.dumps(rec), flush=True)
    x, conv = pools[0]

    def sppf():
        return k11.int8_sppf(x)

    gen = torch.Generator(device="cuda").manual_seed(8)
    xb = QTensor(torch.randint(-127, 128, (8,) + tuple(x.q.shape[1:]),
                               dtype=torch.int8, device="cuda",
                               generator=gen), x.amax)
    out["sppf"] = {"graph_ms": [cs.graph_ms(sppf) for _ in range(3)],
                   "chained_ms": [cs.chained_ms(conv, sppf, torch)
                                  for _ in range(2)],
                   "ms": cs.cuda_ms(sppf, 200),
                   "b8_graph_ms": cs.graph_ms(lambda: k11.int8_sppf(xb))}
    print(json.dumps(out["sppf"]))
    dst = REPO / "chiprun_out"
    dst.mkdir(exist_ok=True)
    (dst / f"glue_probe_{args.tag}.json").write_text(json.dumps(out))
    print("OK", args.tag)


if __name__ == "__main__":
    main()
