"""Device time of the port's tensor-core kernels against the number of
tiles, on one NVIDIA GPU (PyTorch/CUDA port; imports no JAX).

    python3 tools/torch_mma_probe.py

``csrc/stage1.cu``, ``csrc/stem.cu``, ``csrc/c3k2.cu`` (both forms) and
``csrc/head.cu`` run persistent blocks over fixed-size output tiles, so
their time is a step function of tiles / tile slots (SMs x warpgroups or
blocks in flight per SM) plus a fixed part (launch, weight staging, the
first window). This times each kernel at one tile, at shapes that fill one,
two and three rounds of 132 tiles and more, and at the serving shape.
Twenty launches are captured into
one CUDA graph and the graph is replayed, so the host's launch cost (larger
than these kernels) stays out of the number. Prints one JSON object.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from unina_yolo_dla_torch.ops.cuda import (  # noqa: E402
    c3k2_kernel, head_kernel, stage1_kernel, stem_kernel)
from unina_yolo_dla_torch.ops.cuda.mma_pack import (  # noqa: E402
    pack_c3k2_mma, pack_head_mma, pack_stage1_mma, pack_stem_mma)

LAUNCHES = 20
BF16_FLOPS = 989e12


def graph_us(fn) -> float:
    """Mean device microseconds of ``fn`` inside a replayed CUDA graph."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(LAUNCHES):
            fn()
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


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_mma_probe: no CUDA device", file=sys.stderr)
        return 2
    dev, bf = torch.device("cuda"), torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(0)

    def act(shape, relu=True):
        a = rng.normal(0, 1, shape)
        a = np.maximum(a, 0) if relu else a
        return torch.from_numpy(a.astype(np.float32)).to(dev, bf)

    def kb(shape):
        fan = int(np.prod(shape[:-1]))
        return (rng.normal(0, np.sqrt(2 / fan), shape).astype(np.float32),
                rng.normal(0, .1, shape[-1]).astype(np.float32))

    wb, b = kb((2, 2, 128, 64))
    wb, b = torch.from_numpy(wb).to(dev, bf), torch.from_numpy(b).to(dev)
    wpk = pack_stage1_mma(wb)
    ws = [w.to(dev) for w in head_kernel.pack_head_weights(
        [kb((3, 3, 64, 64)), kb((3, 3, 64, 64))], kb((1, 1, 64, 4)),
        [kb((3, 3, 64, 64)), kb((3, 3, 64, 64))], kb((1, 1, 64, 4)), bf)]
    w33 = pack_head_mma(ws[0], ws[6], ws[2], ws[8], ws[4], ws[10])

    rows = []
    # stage1: 4 x 16 output tiles, two warpgroups (tiles in flight) per SM
    for h2, w2 in ((4, 16), (44, 192), (88, 192), (176, 192), (264, 192),
                   (160, 160)):
        xm = act((1, 2 * h2, w2, 64))
        tiles = -(-h2 // 4) * -(-w2 // 16)
        us = graph_us(lambda: stage1_kernel.fused_downsample_merged(
            xm, wpk, b))
        flops = 2 * h2 * w2 * 64 * 512
        rows.append(dict(kernel="stage1_merged", out=[h2, w2], tiles=tiles,
                         tiles_per_sm=tiles / sms, device_us=us,
                         tflops=flops / us / 1e6,
                         mbytes=(xm.numel() + h2 * w2 * 64) * 2 / 1e6))
    # stem + stage1: the same 4 x 16 tiles and two warpgroups per SM
    ks, bs = kb((2, 2, 24, 64))
    ks, bs = torch.from_numpy(ks).to(dev, bf), torch.from_numpy(bs).to(dev)
    kspk = pack_stem_mma(ks)
    for h2, w2 in ((4, 16), (44, 192), (88, 192), (176, 192), (264, 192),
                   (160, 160)):
        frame = act((1, 2 * h2, w2, 24), relu=False)
        tiles = -(-h2 // 4) * -(-w2 // 16)
        us = graph_us(lambda: stem_kernel.fused_stem_stage1(
            frame, kspk, bs, wpk, b))
        flops = 2 * (2 * h2 * w2 * 64 * 96 + h2 * w2 * 64 * 512)
        rows.append(dict(kernel="fused_stem_stage1", out=[h2, w2],
                         tiles=tiles, tiles_per_sm=tiles / sms, device_us=us,
                         tflops=flops / us / 1e6,
                         mbytes=(frame.numel() + h2 * w2 * 64) * 2 / 1e6))
    # C3k2 and its pair form (xa at half resolution): 8 x 16 output tiles,
    # one warpgroup a block, as many blocks per SM as shared memory allows
    cws = [w.to(dev) for w in c3k2_kernel.pack_c3k2_weights(
        kb((1, 1, 64, 32)), kb((1, 1, 64, 32)), kb((1, 1, 64, 64)),
        [(kb((1, 1, 32, 32)), kb((3, 3, 32, 32)))], bf)]
    cpk = pack_c3k2_mma(cws[0], cws[6], cws[2], cws[4], cws[8])
    pws = [w.to(dev) for w in c3k2_kernel.pack_c3k2_weights(
        kb((1, 1, 128, 32)), kb((1, 1, 128, 32)), kb((1, 1, 64, 64)),
        [(kb((1, 1, 32, 32)), kb((3, 3, 32, 32)))], bf)]
    ppk = pack_c3k2_mma(pws[0], pws[6], pws[2], pws[4], pws[8], 64)
    for h, w in ((8, 16), (88, 192), (176, 192), (264, 192), (352, 192),
                 (160, 160)):
        x = act((1, h, w, 64))
        xa = act((1, h // 2, w // 2, 64))
        tiles = -(-h // 8) * -(-w // 16)
        macs = h * w * (32 * 32 + 9 * 32 * 32 + 64 * 64)
        for name, fn, first, nbytes in (
                ("fused_c3k2",
                 lambda: c3k2_kernel.fused_c3k2(x, *cws, wpk=cpk),
                 h * w * 64 * 64, 2 * x.numel() * 2),
                ("fused_c3k2_cat",
                 lambda: c3k2_kernel.fused_c3k2_cat(xa, x, *pws, up_a=True,
                                                    wpk=ppk),
                 h * w * 64 * 64 + (h // 2) * (w // 2) * 64 * 64,
                 (2 * x.numel() + xa.numel()) * 2)):
            us = graph_us(fn)
            rows.append(dict(kernel=name, out=[h, w], tiles=tiles,
                             tiles_per_sm=tiles / sms, device_us=us,
                             tflops=2 * (macs + first) / us / 1e6,
                             mbytes=nbytes / 1e6))
    # head: 8 x 16 output tiles, one tile in flight per SM
    for h, w in ((8, 16), (88, 96), (88, 192), (176, 192), (264, 192),
                 (160, 160)):
        x = act((1, h, w, 64))
        tiles = -(-h // 8) * -(-w // 16)
        us = graph_us(lambda: head_kernel.fused_head(x, *ws, w33=w33))
        flops = 2 * h * w * (4 * 9 * 64 * 64 + 2 * 64 * 4)
        rows.append(dict(kernel="fused_head", out=[h, w], tiles=tiles,
                         tiles_per_sm=tiles / sms, device_us=us,
                         tflops=flops / us / 1e6))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {"card": smi, "sms": sms, "bf16_peak_tflops": BF16_FLOPS / 1e12,
           "launches_per_graph": LAUNCHES, "rows": rows}
    print(json.dumps(out, indent=1))
    dest = Path(__file__).resolve().parents[1] / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "torch_mma_probe.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
