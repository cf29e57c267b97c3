"""Export CLI: checkpoint -> serving artifact, the port's counterpart of
the reference's ``export`` (the same flags and checks).

    python -m unina_yolo_dla_torch.export --weights ckpt.msgpack \
        --int8 --s2d-merged --fused-stem --merged-head \
        --cp-calibration cp_calibration.json --output serving_artifact

Loads the variables, applies the deploy transforms the flags ask for
(``quant/deploy.py``; ``--s2d-merged`` implies ``--stem-s2d-host``, which
implies ``--stage1-s2d``, and every deploy flag implies ``--fold-bn``),
bakes the serving thresholds and the conformal ``q`` and writes the
artifact (``runtime/aot.py export_serving_artifact``): on the card after
capturing the frame as one CUDA graph and checking its fallback report
(strict unless ``--no-strict``), on the CPU with ``--device cpu``.

Refused, each with the ROADMAP.md item it waits for: a quantised
checkpoint without ``--int8`` (the reference exports its QAT fake-quant
model: item 8d), ``--int8-unfused`` (quant mode ``int8``: item 8d), an
unfolded float export (serving the BatchNorm model: item 8d) and
``--platforms``
(the reference's lowering targets: the port's native host replays the
artifact's captured graph, ``runtime/native``, and needs no compiled
program).
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from .models.config import ModelConfig
from .models.detector import from_jax_variables
from .quant.deploy import (
    fold_batchnorm,
    fold_downsample_space_to_depth,
    fold_stem_space_to_depth,
    merge_stem_columns,
    quantize_weights_int8,
)
from .quant.fake_quant import PERF_EXCLUDE, QuantSpec
from .runtime.aot import export_serving_artifact
from .train.conformal import load_cp_q
from .utils.checkpoint import load_msgpack_raw
from .utils.device import resolve_device


def _has_out_q(tree) -> bool:
    """Whether any path of the ``quant`` collection names an ``out_q``."""
    if isinstance(tree, dict):
        return any(k == "out_q" or _has_out_q(v) for k, v in tree.items())
    return False


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Export a serving artifact with the PyTorch port")
    p.add_argument("--weights", required=True, help=".msgpack variables")
    p.add_argument("--output", default="serving_artifact")
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--base-channels", type=int, default=32)
    p.add_argument("--num-classes", type=int, default=4)
    p.add_argument("--lite-p2", action="store_true")
    p.add_argument("--conf", type=float, default=0.5)
    p.add_argument("--iou", type=float, default=0.45)
    p.add_argument("--cp-calibration", default=None,
                   help="cp_calibration.json (bakes q_hat)")
    p.add_argument("--q", type=float, default=0.1,
                   help="conformal dilation factor if no calibration file")
    p.add_argument("--max-detections", type=int, default=1024)
    p.add_argument("--no-strict", action="store_true",
                   help="warn instead of fail on fallback-report findings")
    p.add_argument("--platforms", default=None,
                   help="the reference's lowering targets; refused here")
    p.add_argument("--device", default=None,
                   help="where the frame is checked: cuda (default) or cpu")
    p.add_argument("--stem-s2d", action="store_true",
                   help="space-to-depth stem, the shuffle on the device; "
                        "implies --fold-bn")
    p.add_argument("--stem-s2d-host", action="store_true",
                   help="space-to-depth stem, the shuffle on the host: the "
                        "artifact takes (S/2, S/2, 12) blocked frames "
                        "(ServingArtifact blocks RGB frames itself); "
                        "implies --fold-bn and --stage1-s2d; not with "
                        "--camera")
    p.add_argument("--s2d-merged", action="store_true",
                   help="column-merged engine: the blocked frame viewed "
                        "(S/2, S/4, 24), the stem emitting merged columns, "
                        "stage1 as one kernel; implies --stem-s2d-host")
    p.add_argument("--fused-stem", action="store_true",
                   help="with --s2d-merged: stem and stage1 as one kernel "
                        "over the merged frame")
    p.add_argument("--stage1-s2d", action="store_true",
                   help="blocked stage1 downsample (the stage1 kernel); "
                        "implied by --stem-s2d-host")
    p.add_argument("--fused-c3k2", action="store_true",
                   help="each float-path C3k2 as one kernel; implies "
                        "--fold-bn")
    p.add_argument("--fused-head", action="store_true",
                   help="each float-path decoupled head as one kernel; "
                        "implies --fold-bn")
    p.add_argument("--merged-head", action="store_true",
                   help="each float-path head's cls/reg branches merged "
                        "into channel-concat/block-diagonal convs; implies "
                        "--fold-bn")
    p.add_argument("--fold-bn", action="store_true",
                   help="fold BatchNorm into the conv weights (drops "
                        "batch_stats from the artifact)")
    p.add_argument("--int8", action="store_true",
                   help="the int8 engine (fused int8 chain, the measured "
                        "exclusion list); needs a calibrated checkpoint; "
                        "implies --fold-bn")
    p.add_argument("--calib-min-images", type=int, default=50,
                   help="with --int8: refuse checkpoints calibrated on "
                        "fewer images; 0 disables")
    p.add_argument("--int8-unfused", action="store_true",
                   help="the reference's dequantise-between-layers "
                        "engine; refused here")
    p.add_argument("--camera", default=None, metavar="HxW",
                   help="the camera artifact: raw frames at this "
                        "resolution, preprocessed on the card")
    p.add_argument("--format", default="bgra",
                   choices=("bgra", "rgb", "nv12"),
                   help="camera pixel format (with --camera)")
    p.add_argument("--letterbox", action="store_true", default=True,
                   help="with --camera: aspect-preserving resize and gray "
                        "pad (the default)")
    p.add_argument("--stretch", dest="letterbox", action="store_false",
                   help="with --camera: stretch to the square input")
    p.add_argument("--box-space", default="camera",
                   choices=("model", "camera"),
                   help="with --camera: coordinate space of returned boxes")
    p.add_argument("--batch", type=int, default=None,
                   help="the multi-stream artifact taking (N, S, S, 3) RGB "
                        "frames")
    return p


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    if args.platforms:
        raise SystemExit(
            "--platforms names the reference's lowering targets; the "
            "port's artifact is its weights and configuration, served by "
            "the port on the card or the CPU; its native host replays the "
            "graph captured at load and needs no compiled program)")
    if args.int8_unfused:
        raise SystemExit(
            "--int8-unfused (quant mode 'int8', dequantised between "
            "layers) is not ported; the port serves the fused int8 chain "
            "(--int8). It waits for ROADMAP.md Queue A item 8d")
    device = resolve_device(args.device)

    variables = load_msgpack_raw(args.weights)
    # calibration provenance stamped by the train CLI, popped before any
    # transform sees the tree
    calib_meta = variables.pop("calib_meta", None)
    quantized = "quant" in variables
    cfg = ModelConfig(num_classes=args.num_classes,
                      base_channels=args.base_channels,
                      lite_p2=args.lite_p2, input_size=args.imgsz)
    if args.int8 and not quantized:
        raise SystemExit("--int8 requires a calibrated checkpoint "
                         "(quant collection with activation amax; run "
                         "phase-2 QAT or prepare_qat_variables first)")
    if args.int8 and calib_meta is not None:
        n_calib = int(np.asarray(calib_meta["images"]))
        if n_calib < args.calib_min_images:
            raise SystemExit(
                f"--int8 refused: checkpoint was calibrated on only "
                f"{n_calib} images (>= {args.calib_min_images} required; "
                "short calibration data exports a confidently-wrong "
                "engine). Re-calibrate with more data or pass "
                "--calib-min-images 0 for a deliberate smoke export.")
    if args.s2d_merged:
        args.stem_s2d_host = True
    if args.fused_stem and not args.s2d_merged:
        raise SystemExit("--fused-stem requires --s2d-merged (the "
                         "kernel consumes the column-merged frame)")
    fold = (args.fold_bn or args.int8 or args.stem_s2d
            or args.stem_s2d_host or args.stage1_s2d or args.fused_c3k2
            or args.fused_head or args.merged_head)
    if quantized and not args.int8:
        raise SystemExit(
            "a quantised checkpoint without --int8 exports the QAT "
            "fake-quant model, which the port does not serve yet (ROADMAP.md "
            "Queue A item 8d); pass --int8 for the int8 engine")
    if not fold:
        raise SystemExit(
            "an unfolded float export serves the BatchNorm model, which "
            "the port does not serve yet (ROADMAP.md Queue A item 8d); "
            "pass --fold-bn or a deploy flag")

    variables = fold_batchnorm(variables)
    cfg = dataclasses.replace(cfg, deploy=True)
    print(">>> BatchNorm folded into conv weights")
    if args.stem_s2d or args.stem_s2d_host:
        variables = fold_stem_space_to_depth(variables)
        cfg = dataclasses.replace(cfg, stem_s2d=True,
                                  s2d_host=args.stem_s2d_host)
        where = "host" if args.stem_s2d_host else "device"
        print(f">>> stem space-to-depth folded (2x2 s1 over 12ch, "
              f"shuffle on the {where})")
    if args.stage1_s2d or args.stem_s2d_host:
        variables = fold_downsample_space_to_depth(variables)
        cfg = dataclasses.replace(cfg, stage1_s2d=True)
        print(">>> stage1 downsample blocked (2x2 s1, contraction 4C)")
    if args.s2d_merged:
        variables = merge_stem_columns(variables)
        cfg = dataclasses.replace(cfg, s2d_merged=True)
        print(">>> stem columns merged: input (S/2,S/4,24), stage1 is "
              "its own kernel")
    if args.fused_stem:
        cfg = dataclasses.replace(cfg, fused_stem=True)
        print(">>> stem+stage1 fused: one kernel from the merged frame "
              "to the stage1 output")
    if args.fused_c3k2:
        cfg = dataclasses.replace(cfg, fused_c3k2=True)
        print(">>> C3k2 blocks fused: one kernel per float-path block")
    if args.fused_head:
        cfg = dataclasses.replace(cfg, fused_head=True)
        print(">>> decoupled heads fused: one kernel per float-path level")
    if args.merged_head:
        cfg = dataclasses.replace(cfg, merged_head=True)
        print(">>> decoupled heads merged: cls/reg branches as channel-"
              "concat/block-diagonal convs (float-path levels)")
    if args.int8:
        if not _has_out_q(variables.get("quant", {})):
            raise SystemExit(
                "--int8 (fused engine) needs out_q/add_q activation "
                "amaxes, which this checkpoint's calibration predates — "
                "re-run phase-2 calibration (train CLI)")
        spec = QuantSpec(mode="int8_fused", exclude=PERF_EXCLUDE)
        variables = quantize_weights_int8(variables, spec)
        cfg = dataclasses.replace(cfg, quant=spec)
        print(f">>> int8 engine ({spec.mode}): weights quantised, "
              "integer conv path on")

    q = (load_cp_q(args.cp_calibration, args.q)
         if args.cp_calibration else args.q)
    camera = None
    if args.camera:
        h, w = (int(v) for v in args.camera.lower().split("x"))
        camera = (h, w, args.format)
    model = from_jax_variables(variables, cfg, device)
    out = export_serving_artifact(
        model, variables, args.output,
        conf_threshold=args.conf, iou_threshold=args.iou, q_factor=q,
        max_detections=args.max_detections, strict=not args.no_strict,
        camera=camera, batch=args.batch, camera_letterbox=args.letterbox,
        box_space=args.box_space)
    print(f">>> artifact written to {out} (q={q})")


if __name__ == "__main__":
    main()
