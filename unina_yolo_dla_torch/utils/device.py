"""Device selection: the port runs on the card unless told otherwise."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None -> ``cuda`` (raises when no card is present); anything else is
    taken as given (``"cpu"`` runs the plain versions of the kernels)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain "
                "PyTorch versions of the kernels")
        return torch.device("cuda")
    return torch.device(device)
