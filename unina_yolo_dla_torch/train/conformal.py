"""Conformal calibration, serving side: the dilation factor ``q_hat``
that an export bakes into its artifact.

Only the reader is ported so far; the calibration that writes
``cp_calibration.json`` comes with training.
"""
from __future__ import annotations

import json
from pathlib import Path


def load_cp_q(path: str | Path, default: float = 0.1) -> float:
    """Read q_hat from a cp_calibration.json; ``default`` where the file
    or its key is missing."""
    p = Path(path)
    if not p.exists():
        return default
    return float(json.loads(p.read_text()).get("q_hat", default))
