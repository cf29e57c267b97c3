"""Does float64 accumulation of the stem and stage1 products close the
fc engine's score gap against the jitted JAX model? (CPU; not a test.)

    JAX_PLATFORMS=cpu python tools/jax_vs_torch_fc_f64_probe.py

``int8_s2dm_fc`` at full width on the CPU, port against ``jax.jit`` of the
JAX model, on the synthetic scenes of seeds 1, 2, 3 and 7: once with the
port as it is (f32 products in ``ShiftDot2x2`` and
``fused_downsample_merged_plain``) and once with both products accumulated
in float64 and rounded to f32 once. Prints per seed the matched detection
count, the worst box error in pixels and the worst score error of each.
Takes a few minutes and a few GiB.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from unina_yolo_dla_torch.data.synthetic import SynthConfig, generate_image  # noqa: E402
from unina_yolo_dla_torch.models import blocks, config as tconfig  # noqa: E402
from unina_yolo_dla_torch.models.detector import from_jax_variables  # noqa: E402
from unina_yolo_dla_torch.ops.cuda import stage1_kernel  # noqa: E402
from unina_yolo_dla_torch.ops.preprocess import merged_frame_np  # noqa: E402
from unina_yolo_dla_torch.quant.fake_quant import (  # noqa: E402
    PERF_EXCLUDE as T_PERF,
    QuantSpec as TSpec,
)
from unina_yolo_dla_torch.runtime.pipeline import build_serving_fn  # noqa: E402
from unina_yolo_dla_torch.utils.checkpoint import load_msgpack_raw  # noqa: E402
from unina_yolo_dla_tpu.models import ModelConfig  # noqa: E402
from unina_yolo_dla_tpu.models.detector import UninaYoloDla  # noqa: E402
from unina_yolo_dla_tpu.quant.fake_quant import PERF_EXCLUDE, QuantSpec  # noqa: E402
from unina_yolo_dla_tpu.runtime.pipeline import (  # noqa: E402
    build_serving_fn as jax_build_serving_fn,
)

ART = REPO / "artifacts" / "serving_artifact"
FC = dict(deploy=True, stem_s2d=True, s2d_host=True, stage1_s2d=True,
          s2d_merged=True, fused_c3k2=True, fused_head=True)
SERVE = dict(conf_threshold=0.5, iou_threshold=0.45, q_factor=0.2116)


def errors(want, got):
    """(matched count, worst box error px, worst score error)."""
    jv, tv = np.asarray(want.valid), got.valid.numpy()
    if tv.sum() != jv.sum():
        return ("count", int(jv.sum()), int(tv.sum()))
    jb, jsc, jc = (np.asarray(a)[jv]
                   for a in (want.boxes, want.scores, want.classes))
    tb, tsc, tc = (a.numpy()[tv]
                   for a in (got.boxes, got.scores, got.classes))
    used, box, score = set(), 0.0, 0.0
    for i in range(len(jb)):
        cand = [j for j in range(len(tb)) if j not in used and tc[j] == jc[i]]
        if not cand:
            return ("unmatched", i)
        j = min(cand, key=lambda j: np.abs(tb[j] - jb[i]).max())
        used.add(j)
        box = max(box, float(np.abs(tb[j] - jb[i]).max()))
        score = max(score, float(abs(tsc[j] - jsc[i])))
    return (len(jb), box, score)


def shift_dot_f64(self, x):
    """``ShiftDot2x2.forward`` with the product summed in float64."""
    *lead, h, w, c = x.shape
    o = self.kernel.shape[-1]
    xp = F.pad(x.to(self.kernel.dtype), (0, 0, 1, 0, 1, 0))
    patches = torch.cat([xp[..., kh:kh + h, kw:kw + w, :]
                         for kh in range(2) for kw in range(2)], dim=-1)
    y = (patches.reshape(-1, 4 * c).double()
         @ self.kernel.double().reshape(4 * c, o)).float()
    return (y + self.bias).reshape(*lead, h, w, o).to(self.kernel.dtype)


def stage1_plain_f64(xm, wb, bias):
    """``fused_downsample_merged_plain`` with the sums in float64."""
    dt = xm.dtype
    *lead, h, w2, cm = xm.shape
    wp = stage1_kernel.pack_stage1_weights(wb.to(dt)).double()
    co, h2 = wp.shape[-1] // 2, h // 2
    x = xm.reshape(-1, h, w2, cm).double()
    xp = F.pad(x, (0, 0, 1, 0, 2, 0))
    x4 = xp.reshape(x.shape[0], h2 + 1, 2, w2 + 1, cm)
    acc = torch.zeros(x.shape[0], h2, w2, co, dtype=torch.float64)
    for kh in range(2):
        for di in range(2):
            z = x4[:, kh:kh + h2, di] @ wp[kh, di]
            acc = acc + z[:, :, 0:w2, 0:co] + z[:, :, 1:w2 + 1, co:2 * co]
    out = torch.relu(acc.float() + bias.float())
    return out.to(dt).reshape(*lead, h2, w2, co)


def main() -> int:
    jcfg = ModelConfig(quant=QuantSpec("int8_fused", exclude=PERF_EXCLUDE),
                       **FC)
    tcfg = tconfig.ModelConfig(quant=TSpec("int8_fused", exclude=T_PERF),
                               **FC)
    variables = load_msgpack_raw(ART / "variables.msgpack")
    port = from_jax_variables(variables, tcfg, device="cpu")
    jserve = jax.jit(jax_build_serving_fn(UninaYoloDla(jcfg), jcfg, **SERVE))
    tserve = build_serving_fn(port, tcfg, **SERVE)
    as_is = (blocks.ShiftDot2x2.forward,
             stage1_kernel.fused_downsample_merged_plain)
    for seed in (1, 2, 3, 7):
        img, _ = generate_image(np.random.default_rng(seed),
                                SynthConfig(image_size=640, seed=seed))
        frame = merged_frame_np(np.ascontiguousarray(img[..., ::-1]))
        want = jserve(variables, jnp.asarray(frame))
        out = {}
        for name, (fwd, plain) in (("f32", as_is),
                                   ("f64", (shift_dot_f64,
                                            stage1_plain_f64))):
            blocks.ShiftDot2x2.forward = fwd
            stage1_kernel.fused_downsample_merged_plain = plain
            out[name] = errors(want, tserve(torch.from_numpy(frame)))
        print("seed", seed, "f32:", out["f32"], "f64:", out["f64"],
              flush=True)
    blocks.ShiftDot2x2.forward, \
        stage1_kernel.fused_downsample_merged_plain = as_is
    return 0


if __name__ == "__main__":
    sys.exit(main())
