"""Two-phase training CLI: FP32, then calibration and int8 QAT, then
conformal calibration and the export, the port's counterpart of the
reference's ``train/train.py`` (the same flags and phases, in its order):

  phase 1    FP32 training (EMA, warmup 3 epochs, mosaic/mixup/copy-paste)
  phase 1.5  optional FP32 fine-tune with the QAT recipe, no quantisation
  phase 2    calibration (``prepare_qat_variables``, ``calibration.cache``,
             ``qat_init_calibrated.msgpack``), then the QAT fine-tune
             (lr0 1e-3, no warmup, EMA off, augmentation off)
  CP         conformal calibration on rank 0, non-fatal
  export     the serving artifact of the model as it stands (the unfolded
             QAT fake-quant model after phase 2)

    python -m unina_yolo_dla_torch.train.train --data fsd_synth.yaml \
        --epochs 100 --qat-epochs 10 --calibrate-cp --export

Runs on the card unless ``--device cpu``. Several processes (one per
card): ``--coordinator host:port --num-processes N --process-id R``, or
``--coordinator auto`` under ``torchrun``; ``--batch`` is the global batch.
Every file is written by rank 0.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..data.dataset import YoloDataset, batch_iterator, load_dataset_yaml
from ..evaluate import load_checkpoint
from ..models.config import ModelConfig
from ..models.detector import (
    create_model,
    load_variables,
    to_jax_variables,
    variables_of,
)
from ..quant.calibrate import save_calibration_cache
from ..quant.qat import prepare_qat_variables
from ..utils.checkpoint import save_msgpack
from .conformal import calibrate_conformal_prediction
from .loop import fit
from .trainer import TrainConfig


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="UNINA-YOLO-DLA two-phase training (PyTorch port)")
    p.add_argument("--data", required=True, help="dataset YAML")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--fp32-ft-epochs", type=int, default=0,
                   help="optional phase 1.5: FP32 fine-tune with the "
                        "EXACT phase-2 recipe (lr 1e-3, no warmup, EMA "
                        "off, augment off) but no quantisation: the "
                        "epoch-matched FP32 baseline for the int8-vs-FP32 "
                        "delta")
    p.add_argument("--qat-epochs", type=int, default=10)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--base-channels", type=int, default=32)
    p.add_argument("--lite-p2", action="store_true")
    p.add_argument("--lr0", type=float, default=0.01)
    p.add_argument("--optimizer", choices=("sgd", "adamw"), default="sgd")
    p.add_argument("--devices", type=int, default=None,
                   help="data-parallel device count: the port drives one "
                        "device a process, so this must be the number of "
                        "processes (default: that number)")
    p.add_argument("--coordinator", default=None,
                   help="multi-process training: rank 0's host:port, or "
                        "'auto' for a launcher's environment (torchrun)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-process training: total process count")
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-process training: this process's rank")
    p.add_argument("--output-dir", default="runs/unina_dla")
    p.add_argument("--weights", default=None,
                   help="start from a .msgpack checkpoint")
    p.add_argument("--skip-fp32", action="store_true")
    p.add_argument("--skip-qat", action="store_true")
    p.add_argument("--export", action="store_true",
                   help="write the serving artifact after training")
    p.add_argument("--difficulty-map", default=None,
                   help="difficulty_map.json for weighted sampling")
    p.add_argument("--mosaic", type=float, default=0.5,
                   help="phase-1 mosaic probability (the QAT phase "
                        "forces 0)")
    p.add_argument("--mixup", type=float, default=0.0,
                   help="phase-1 mixup probability (the QAT phase "
                        "forces 0)")
    p.add_argument("--resume", action="store_true",
                   help="resume the interrupted phase from its full train "
                        "state (params, optimiser, EMA, step, data RNG)")
    p.add_argument("--copy-paste-assets", default=None,
                   help="directory of RGBA/.npy cone assets for copy-paste "
                        "augmentation (phase 1 only)")
    p.add_argument("--qat-corruption-aug", type=float, default=0.0,
                   help="phase-2 robustness: probability of corrupting "
                        "each calibration AND QAT training image with a "
                        "random corruption at severity 1-2 "
                        "(data/corruptions.py); 0 = clean QAT")
    p.add_argument("--calibrate-cp", action="store_true")
    p.add_argument("--cp-alpha", type=float, default=0.10)
    p.add_argument("--calib-batches", type=int, default=30)
    p.add_argument("--calib-method", default="max",
                   choices=("entropy", "max", "percentile"))
    p.add_argument("--calib-min-images", type=int, default=50,
                   help="hard floor on total calibration images; 0 only "
                        "for deliberate smoke runs")
    p.add_argument("--max-boxes", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (the plain versions of the "
                        "kernels)")
    return p


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)

    from ..parallel.distributed import initialize_distributed, \
        is_main_process
    from ..parallel.mesh import local_device
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    # before any collective; a no-op without --coordinator /
    # UNINA_COORDINATOR. --batch stays the GLOBAL batch.
    initialize_distributed(args.coordinator, args.num_processes,
                           args.process_id, device=dev)
    dev = local_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    main_proc = is_main_process()

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    spec = load_dataset_yaml(args.data)
    train_ds = YoloDataset(spec["train"], img_size=args.imgsz,
                           max_boxes=args.max_boxes)
    val_ds = (YoloDataset(spec["val"], img_size=args.imgsz,
                          max_boxes=args.max_boxes)
              if Path(spec["val"]).exists() else None)

    cfg = ModelConfig(num_classes=spec["nc"],
                      base_channels=args.base_channels,
                      lite_p2=args.lite_p2, input_size=args.imgsz)
    model = create_model(
        cfg, generator=torch.Generator().manual_seed(args.seed), device=dev)
    if args.weights:
        load_variables(model, load_checkpoint(model, args.weights))
    variables = variables_of(model)

    results: dict = {}

    # ---------- Phase 1: FP32 ----------
    if not args.skip_fp32:
        print(f">>> Phase 1: FP32 training ({args.epochs} epochs)")
        tc = TrainConfig(lr0=args.lr0, batch_size=args.batch,
                         optimizer=args.optimizer, use_ema=True,
                         warmup_steps=3 * max(len(train_ds) // args.batch, 1))
        copy_paste = None
        if args.copy_paste_assets:
            from ..curation.copy_paste import CopyPasteAugmentor

            copy_paste = CopyPasteAugmentor(args.copy_paste_assets,
                                            seed=args.seed)
        res = fit(model, variables, train_ds, val_ds, tc,
                  epochs=args.epochs, output_dir=out_dir / "fp32",
                  difficulty_map=args.difficulty_map,
                  mosaic_p=args.mosaic, mixup_p=args.mixup,
                  copy_paste=copy_paste,
                  n_devices=args.devices, seed=args.seed,
                  resume=args.resume)
        variables = res.best_variables
        if main_proc:
            save_msgpack(to_jax_variables(variables),
                         out_dir / "fp32" / "best.msgpack")
            print(f">>> Phase 1 complete: {res.metrics}")
        results["fp32"] = res.metrics

    # ---------- Phase 1.5: epoch-matched FP32 fine-tune ----------
    if args.fp32_ft_epochs:
        print(f">>> Phase 1.5: FP32 fine-tune ({args.fp32_ft_epochs} "
              "epochs, QAT recipe minus quantisation)")
        tc_ft = TrainConfig(lr0=1e-3, warmup_steps=1,
                            batch_size=args.batch,
                            optimizer=args.optimizer, use_ema=False)
        res = fit(model, variables, train_ds, val_ds, tc_ft,
                  epochs=args.fp32_ft_epochs,
                  output_dir=out_dir / "fp32_ft", augment=False,
                  n_devices=args.devices, seed=args.seed,
                  resume=args.resume)
        variables = res.best_variables
        if main_proc:
            save_msgpack(to_jax_variables(variables),
                         out_dir / "fp32_ft" / "best.msgpack")
            print(f">>> Phase 1.5 complete: {res.metrics}")
        results["fp32_ft"] = res.metrics

    # ---------- Phase 2: QAT ----------
    if not args.skip_qat:
        print(">>> Phase 2: int8 QAT "
              f"({args.calib_method} calibration, {args.qat_epochs} epochs)")

        def calib_batches():
            for b in batch_iterator(
                    train_ds, args.batch, np.random.default_rng(0),
                    steps=args.calib_batches, augment=False,
                    corruption_p=args.qat_corruption_aug):
                yield {"images": torch.from_numpy(b["images"]).to(dev)}

        qat_model, qat_vars = prepare_qat_variables(
            model, variables, calib_batches,
            method=args.calib_method, max_batches=args.calib_batches,
            min_images=args.calib_min_images)
        # stamped into every quantised checkpoint so the export can check
        # calibration sufficiency offline
        calib_meta = {"images": int(args.calib_batches * args.batch)}
        if main_proc:
            save_calibration_cache(
                to_jax_variables({"quant": qat_vars["quant"]})["quant"],
                out_dir / "calibration.cache")
            # the full calibrated variables
            save_msgpack(dict(to_jax_variables(qat_vars),
                              calib_meta=calib_meta),
                         out_dir / "qat_init_calibrated.msgpack")

        # QAT recipe: lr0=1e-3, no warmup, EMA off, augment off
        tc_qat = TrainConfig(lr0=1e-3, warmup_steps=1,
                             batch_size=args.batch,
                             optimizer=args.optimizer, use_ema=False)
        res = fit(qat_model, qat_vars, train_ds, val_ds, tc_qat,
                  epochs=args.qat_epochs, output_dir=out_dir / "qat",
                  augment=False, n_devices=args.devices,
                  corruption_p=args.qat_corruption_aug,
                  extra_variables={"quant": qat_vars["quant"]},
                  seed=args.seed, resume=args.resume)
        qat_best = dict(res.best_variables)
        qat_best["quant"] = qat_vars["quant"]
        if main_proc:
            save_msgpack(dict(to_jax_variables(qat_best),
                              calib_meta=calib_meta),
                         out_dir / "qat" / "best.msgpack")
            print(f">>> Phase 2 complete: {res.metrics}")
        results["qat"] = res.metrics
        model, variables = qat_model, qat_best

    # ---------- Conformal calibration (rank 0) ----------
    if args.calibrate_cp and val_ds is not None and main_proc:
        print(">>> Conformal-prediction calibration")

        def cp_batches():
            return batch_iterator(val_ds, min(args.batch, len(val_ds)),
                                  np.random.default_rng(0), shuffle=False,
                                  augment=False)
        try:
            payload = calibrate_conformal_prediction(
                model, variables, cp_batches(), alpha=args.cp_alpha,
                output_path=out_dir / "cp_calibration.json")
            results["cp"] = payload
            print(f">>> q_hat = {payload['q_hat']:.4f}")
        except RuntimeError as e:
            # zero matches: reported, not fatal (the reference's rule)
            print(f"WARNING: CP calibration failed: {e}")

    # ---------- Export (rank 0) ----------
    if args.export and main_proc:
        from ..runtime.aot import export_serving_artifact

        print(">>> Exporting the serving artifact")
        load_variables(model, variables)
        artifact = export_serving_artifact(
            model, to_jax_variables(variables), out_dir / "serving_artifact")
        results["export"] = str(artifact)

    if main_proc:
        (out_dir / "results.json").write_text(
            json.dumps(results, indent=2, default=str))
    return results


if __name__ == "__main__":
    main()
