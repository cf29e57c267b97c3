"""The int8 engines served with an amax's scale in either f32 form, on one
NVIDIA GPU: whether the served outputs move (imports no JAX).

    python3 tools/torch_scale_form.py

The reference writes a scale ``max(amax, 1e-9) / 127``; its jitted
program computes it as ``max(amax, 1e-9) * f32(1 / 127)``, one f32 step
from the IEEE quotient at some amaxes (ROADMAP Queue C, "Scale of an
amax"). The port computes it as the jitted reference does
(``quant/qtensor.scale_of``), which repaired the port's earlier IEEE
quotient. For each form (``port``: ``scale_of``; ``ieee``: the IEEE
quotient in its place wherever the port calls it, the port's form
before the repair), in a process of its own, since every
scale is taken as the engines are built and captured: the shipped
artifact and the unfused int8 engine (exported from
``artifacts/engine_source.msgpack`` with ``chip_smoke.py``'s flags), each
served as a CUDA graph on the seed 1-8 scenes, give the SHA-256 of their
Detections and their valid Detections; their eager frames on the seed-7
scene give each int8 layer's output digest
(``torch_parent_ab.int8_layer_digests``). Prints one JSON object, and
writes it to ``chiprun_out/torch_scale_form.json``: the card, the
amaxes of the shipped artifact whose scales differ, each form's digests,
and, for each engine, whether the Detections are the same bits, the
valid detections of each scene in each form, matched (``compare``), and
the int8 layers whose digests differ.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORMS = ("port", "ieee")


def ieee_scale_of(amax) -> np.float32:
    """``max(amax, 1e-9) / 127`` as the IEEE quotient in f32: the port's
    scale before it took the jitted reference's form."""
    return np.float32(max(np.float32(amax), np.float32(1e-9))) / \
        np.float32(127)


def differing_amaxes(tree, path="") -> dict:
    """path -> amax of every leaf of an int8 engine's ``quant`` tree whose
    two scale forms differ."""
    from unina_yolo_dla_torch.quant.qtensor import scale_of

    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in differing_amaxes(sub, f"{path}/{key}").items()}
    a = np.float32(np.asarray(tree).reshape(-1)[0])
    return {path: float(a)} if scale_of(a) != ieee_scale_of(a) else {}


def serve_form(form: str) -> dict:
    """Digests and valid Detections of both engines with ``form``'s
    scale."""
    import torch

    import chip_smoke as cs
    from torch_parent_ab import digest, int8_layer_digests
    from unina_yolo_dla_torch.data.synthetic import SynthConfig, \
        generate_image
    from unina_yolo_dla_torch.ops.cuda import int8_conv_kernel, \
        qconcat_kernel
    from unina_yolo_dla_torch.quant import qtensor
    from unina_yolo_dla_torch.runtime.artifact import ServingArtifact

    if form == "ieee":
        for mod in (qtensor, int8_conv_kernel, qconcat_kernel):
            mod.scale_of = ieee_scale_of
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scenes = [np.ascontiguousarray(generate_image(
        np.random.default_rng(s), SynthConfig(image_size=640, seed=s))[0][
            ..., ::-1]) for s in range(1, 9)]
    tmp = Path(tempfile.mkdtemp())
    cs.run_export(["--weights", cs.SOURCE, *cs.MODE_FLAGS["int8_unfused"],
                   "--cp-calibration", cs.CP_CALIBRATION, "--output",
                   tmp / "int8_unfused"])
    out = {}
    for name, d, layers in (("shipped", cs.ARTIFACT, cs.INT8_LAYERS),
                            ("int8_unfused", tmp / "int8_unfused",
                             cs.INT8_LAYERS_UNFUSED)):
        art = ServingArtifact(d)
        dets, valid = [], []
        for frame in scenes:
            with torch.inference_mode():
                det = art(frame)
            dets += [f.clone() for f in det]
            valid.append({f: v.cpu().numpy().tolist()
                          for f, v in det._asdict().items()})
        eager = ServingArtifact(d, graph=False)
        out[name] = {
            "digest": digest(dets),
            "detections": valid,
            "int8_layers": int8_layer_digests(eager.model, eager, scenes[6],
                                              torch, layers)}
        del art, eager
    return out


def _valid(det: dict):
    v = np.asarray(det["valid"], bool)
    return (np.asarray(det["boxes"])[v], np.asarray(det["scores"])[v],
            np.asarray(det["classes"])[v])


def compare(a: dict, b: dict) -> dict:
    """The two forms' outputs of one engine side by side: for each scene,
    the valid detections of each form, matched one to one by class and
    nearest box (as ``tests/test_torch_slice.py`` matches the port's to
    the reference's); the largest box and score difference of the matched
    ones, and the (class, score) of each left unmatched."""
    box = score = 0.0
    counts, unmatched = [], []
    for da, db in zip(a["detections"], b["detections"]):
        (ba, sa, ca), (bb, sb, cb) = _valid(da), _valid(db)
        counts.append([len(ba), len(bb)])
        used = set()
        for i in range(len(ba)):
            cand = [j for j in range(len(bb)) if j not in used
                    and cb[j] == ca[i]]
            if not cand:
                unmatched.append({"form": "port", "class": int(ca[i]),
                                  "score": float(sa[i])})
                continue
            j = min(cand, key=lambda j: np.abs(bb[j] - ba[i]).max())
            used.add(j)
            box = max(box, float(np.abs(bb[j] - ba[i]).max()))
            score = max(score, float(abs(sb[j] - sa[i])))
        unmatched += [{"form": "ieee", "class": int(cb[j]),
                       "score": float(sb[j])}
                      for j in range(len(bb)) if j not in used]
    layers = [k for k in a["int8_layers"]
              if a["int8_layers"][k] != b["int8_layers"][k]]
    return {"same_bits": a["digest"] == b["digest"],
            "valid_per_scene": counts, "unmatched": unmatched,
            "max_box_diff_px": box, "max_score_diff": score,
            "int8_layers": len(a["int8_layers"]),
            "int8_layers_differing": layers}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--form", choices=FORMS,
                    help="serve in this form alone and print its outputs")
    args = ap.parse_args()
    sys.path[:0] = [str(REPO), str(HERE)]
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if args.form:
        print(json.dumps(serve_form(args.form)))
        return 0
    import chip_smoke as cs
    from unina_yolo_dla_torch.utils.checkpoint import load_msgpack_raw

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    forms = {}
    for form in FORMS:
        run = subprocess.run([sys.executable, __file__, "--form", form],
                             stdout=subprocess.PIPE, text=True, check=True)
        forms[form] = json.loads(run.stdout.strip().splitlines()[-1])
    out = {"card": smi,
           "differing_amaxes": differing_amaxes(load_msgpack_raw(
               cs.ARTIFACT / "variables.msgpack")["quant"]),
           "engines": {name: compare(forms["port"][name], forms["ieee"][name])
                       for name in forms["port"]},
           "digests": {form: {name: {"detections": rec["digest"],
                                     "int8_layers": rec["int8_layers"]}
                              for name, rec in recs.items()}
                       for form, recs in forms.items()}}
    dest = REPO / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "torch_scale_form.json").write_text(json.dumps(out, indent=1))
    print(json.dumps({k: out[k] for k in ("card", "differing_amaxes",
                                          "engines")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
