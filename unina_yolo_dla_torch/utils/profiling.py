"""Tracing and profiling utilities, the port's counterparts of the
reference's:

- ``trace(logdir)``: a ``torch.profiler`` trace of the enclosed block over
  the host and, where there is a card, its CUDA activity, written into
  ``logdir`` as a Chrome trace (``chrome://tracing``, Perfetto) on exit.
- ``annotate(name)``: a named span (``torch.profiler.record_function``)
  that shows up inside traces.
- ``Timer``: wall-clock span accumulator with summary stats for host-side
  phases (data loading, eval, ...).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from pathlib import Path

import torch


@dataclasses.dataclass
class Trace:
    """One ``trace()``: the directory, the Chrome trace file it writes
    there on exit, and the profiler (``profile.key_averages()``)."""

    logdir: Path
    path: Path
    profile: torch.profiler.profile


@contextlib.contextmanager
def trace(logdir: str | Path = "runs/trace"):
    """Profile the enclosed block; on exit write ``logdir/trace-<n>.json``
    (the first free ``n``). Yields the ``Trace``."""
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    n = 0
    while (logdir / f"trace-{n}.json").exists():
        n += 1
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    t = Trace(logdir, logdir / f"trace-{n}.json", prof)
    prof.__enter__()
    try:
        yield t
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(str(t.path))


def annotate(name: str):
    """Named span that shows up inside profiler traces."""
    return torch.profiler.record_function(name)


class Timer:
    """Accumulating wall-clock timer: ``with timer("phase"): ...``."""

    def __init__(self) -> None:
        self._acc: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name].append(time.perf_counter() - t0)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, vals in self._acc.items():
            out[name] = {
                "count": len(vals),
                "total_s": sum(vals),
                "mean_ms": sum(vals) / len(vals) * 1e3,
                "max_ms": max(vals) * 1e3,
            }
        return out
