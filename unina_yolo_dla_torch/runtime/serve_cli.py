"""Serve CLI — the launch-file equivalent (reference
launch/perception.launch.py + config/params.yaml): reads the serving YAML,
configures + activates a PerceptionServer, and either processes a
directory of images (batch mode) or execs the native host against the shm
ring (daemon mode, ``--native``: the port's ``perception_host`` with the
CUDA executor, built at first use).

    python -m unina_yolo_dla_torch.runtime.serve_cli \\
        --config configs/serving.yaml --artifact artifacts/serving_artifact \\
        --images DIR [--device cpu]
    python -m unina_yolo_dla_torch.runtime.serve_cli \\
        --artifact artifacts/serving_artifact --native [--max-frames N]
"""
from __future__ import annotations

import argparse
import json
import signal
import subprocess
import sys
from pathlib import Path


def load_config(path: str | Path) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def native_command(cfg: dict, artifact: str | Path, host: str | Path,
                   max_frames: int = 0) -> list[str]:
    """The host's command line for a serving config: the CUDA executor."""
    cmd = [str(host),
           "--artifact", str(artifact),
           "--ring", cfg.get("frame_ring", "/dev/shm/unina_frames"),
           "--out", cfg.get("detections_out", "/dev/shm/unina_dets"),
           "--input", str(int(cfg.get("input_size", 640))),
           "--classes", str(int(cfg.get("num_classes", 4))),
           "--executor", "cuda"]
    if max_frames:
        cmd += ["--max-frames", str(max_frames)]
    return cmd


def main(argv=None) -> None:
    # die quietly when stdout is piped into `head` etc.
    try:
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    except (AttributeError, ValueError):
        pass
    p = argparse.ArgumentParser(description="UNINA-YOLO-DLA serving "
                                            "(PyTorch/CUDA)")
    p.add_argument("--config", default="configs/serving.yaml")
    p.add_argument("--artifact", default=None,
                   help="override artifact_dir from the config")
    p.add_argument("--images", default=None,
                   help="batch mode: run over a directory of images")
    p.add_argument("--native", action="store_true",
                   help="daemon mode: exec the C++ perception_host")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="batch mode: 'cpu' serves the plain path "
                        "(default: the card)")
    args = p.parse_args(argv)

    cfg = load_config(args.config)
    artifact = args.artifact or cfg["artifact_dir"]
    input_size = int(cfg.get("input_size", 640))
    num_classes = int(cfg.get("num_classes", 4))

    if args.native:
        from .native import build

        cmd = native_command(cfg, artifact, build.host_binary(),
                             args.max_frames)
        raise SystemExit(subprocess.run(cmd, env=build.host_env()).returncode)

    from .serving import PerceptionServer

    srv = PerceptionServer(artifact, expected_input=input_size,
                           expected_classes=num_classes, device=args.device,
                           log_fn=lambda m: print(m, file=sys.stderr))
    srv.configure()
    srv.activate()

    if args.images:
        import cv2
        import numpy as np

        from ..data.dataset import letterbox_image

        names = cfg.get("class_names", {})
        for img_path in sorted(Path(args.images).iterdir()):
            if img_path.suffix.lower() not in (".jpg", ".jpeg", ".png"):
                continue
            img = cv2.imread(str(img_path))
            if img is None:
                continue
            # letterbox, not plain resize: the training/eval geometry
            # (Ultralytics LetterBox semantics) — a squashing resize
            # silently degrades accuracy here
            rgb = np.ascontiguousarray(img[..., ::-1])
            canvas, scale, pad_x, pad_y = letterbox_image(rgb, input_size)
            result = srv.process_frame(canvas)
            if result is None:
                continue
            # back-map boxes from canvas px to original-image px
            pad = np.array([pad_x, pad_y, pad_x, pad_y], np.float32)
            boxes = (np.asarray(result["boxes"], np.float32) - pad) / scale
            h0, w0 = img.shape[:2]
            if len(boxes):
                boxes[:, 0::2] = boxes[:, 0::2].clip(0, w0)
                boxes[:, 1::2] = boxes[:, 1::2].clip(0, h0)
            dets = [
                {"class": names.get(int(c), int(c)),
                 "score": round(float(s), 3),
                 "box": [round(float(v), 1) for v in b]}
                for b, s, c in zip(boxes, result["scores"],
                                   result["classes"])
            ]
            print(json.dumps({"image": img_path.name, "detections": dets}))
        print(json.dumps({"stats": srv.stats()}), file=sys.stderr)
    else:
        print(json.dumps(srv.stats()))
    srv.shutdown()


if __name__ == "__main__":
    main()
