"""Streaming inference server with lifecycle states.

The port's counterpart of the reference ``PerceptionServer``, with the
same transitions, guards and statistics:

- lifecycle:  UNCONFIGURED -> configure() -> INACTIVE -> activate()
              -> ACTIVE -> deactivate()/cleanup()/shutdown()
- configure loads the serving artifact, validates its dimensions against
  the requested ones, and warms the frame; on the card the artifact
  captures its frame as one CUDA graph at load, so activation is
  capture-free.
- process_frame: frames that arrive while the server is not active, or
  with the wrong geometry, are dropped, not raised on; a good frame is
  served and its packed result (``aot.pack_detections``) read back in one
  device-to-host copy into pinned memory.
- per-frame latency histogram with p50/p90/p99.
"""
from __future__ import annotations

import enum
import time
from pathlib import Path
from typing import Callable

import numpy as np

from .aot import validate_artifact_shapes
from .artifact import ServingArtifact


class LifecycleState(enum.Enum):
    UNCONFIGURED = "unconfigured"
    INACTIVE = "inactive"
    ACTIVE = "active"
    FINALIZED = "finalized"


class LatencyHistogram:
    """Fixed-size ring of per-frame latencies with percentile queries."""

    def __init__(self, capacity: int = 4096) -> None:
        self._buf = np.zeros(capacity, np.float64)
        self._n = 0
        self._cap = capacity

    def record(self, latency_ms: float) -> None:
        self._buf[self._n % self._cap] = latency_ms
        self._n += 1

    def summary(self) -> dict[str, float]:
        if self._n == 0:
            return {"count": 0}
        data = self._buf[: min(self._n, self._cap)]
        return {
            "count": self._n,
            "p50_ms": float(np.percentile(data, 50)),
            "p90_ms": float(np.percentile(data, 90)),
            "p99_ms": float(np.percentile(data, 99)),
            "mean_ms": float(data.mean()),
            "max_ms": float(data.max()),
        }


def unpack(packed: np.ndarray) -> dict:
    """(K, 7) packed detections -> the valid ones as the server's dict."""
    keep = packed[:, 6] > 0.5
    return {
        "boxes": packed[keep, :4],
        "scores": packed[keep, 4],
        "classes": packed[keep, 5].astype(np.int32),
        "count": int(keep.sum()),
    }


class PerceptionServer:
    """Lifecycle-managed frame -> detections server over an artifact;
    ``device`` None is the card, ``"cpu"`` the plain path; ``build`` goes
    to ``ServingArtifact`` (how the engine was built, where its
    ``config.json`` does not say)."""

    def __init__(
        self,
        artifact_dir: str | Path,
        expected_input: int = 640,
        expected_classes: int = 4,
        log_fn: Callable[[str], None] = print,
        warn_throttle_s: float = 5.0,
        device=None,
        **build,
    ) -> None:
        self.artifact_dir = Path(artifact_dir)
        self.build = build
        self.expected_input = expected_input
        self.expected_classes = expected_classes
        self.device = device
        self.state = LifecycleState.UNCONFIGURED
        self.artifact: ServingArtifact | None = None
        self.latency = LatencyHistogram()
        self.frames_processed = 0
        self.frames_dropped = 0
        self._log = log_fn
        self._warn_throttle_s = warn_throttle_s
        self._last_warn = 0.0

    # ---- lifecycle transitions ----

    def configure(self) -> None:
        if self.state != LifecycleState.UNCONFIGURED:
            raise RuntimeError(f"configure() in state {self.state}")
        artifact = ServingArtifact(self.artifact_dir, device=self.device,
                                   **self.build)
        validate_artifact_shapes(artifact, self.expected_input,
                                 self.expected_classes)
        dummy = np.zeros((self.expected_input, self.expected_input, 3),
                         np.uint8)
        artifact.packed(dummy)   # warm: staging and read-back buffers
        self.artifact = artifact
        self.state = LifecycleState.INACTIVE
        self._log(f"configured: {self.artifact.config}")

    def activate(self) -> None:
        if self.state != LifecycleState.INACTIVE:
            raise RuntimeError(f"activate() in state {self.state}")
        self.state = LifecycleState.ACTIVE
        self._log("activated")

    def deactivate(self) -> None:
        if self.state == LifecycleState.ACTIVE:
            self.state = LifecycleState.INACTIVE
            self._log("deactivated")

    def cleanup(self) -> None:
        self.artifact = None
        self.state = LifecycleState.UNCONFIGURED

    def shutdown(self) -> None:
        self.artifact = None
        self.state = LifecycleState.FINALIZED
        self._log(f"shutdown; latency {self.latency.summary()}")

    # ---- frame path ----

    def _warn(self, msg: str) -> None:
        now = time.monotonic()
        if now - self._last_warn > self._warn_throttle_s:
            self._log(f"WARNING: {msg}")
            self._last_warn = now

    def process_frame(self, frame: np.ndarray):
        """(S, S, 3) RGB uint8 -> dict with boxes/scores/classes/count, or
        None (frame dropped) when inactive or the frame fails validation;
        the per-frame guards never raise."""
        if self.state != LifecycleState.ACTIVE:
            self._warn(f"frame while {self.state.value}; dropping")
            self.frames_dropped += 1
            return None
        s = self.expected_input
        if frame is None or frame.shape != (s, s, 3) or \
                frame.dtype != np.uint8:
            self._warn(f"bad frame geometry "
                       f"{None if frame is None else frame.shape}; dropping")
            self.frames_dropped += 1
            return None

        t0 = time.perf_counter()
        packed = self.artifact.packed(frame)
        self.latency.record((time.perf_counter() - t0) * 1e3)
        self.frames_processed += 1
        return unpack(packed)

    def stats(self) -> dict:
        return {
            "state": self.state.value,
            "frames_processed": self.frames_processed,
            "frames_dropped": self.frames_dropped,
            **self.latency.summary(),
        }
