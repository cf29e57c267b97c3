"""QAT orchestration: FP32 -> calibrated int8 QAT hand-off (the
reference's ``quant/qat.py``). The FP32 and QAT models share one
parameter tree, so the hand-off attaches the calibrated ``quant``
collection to the FP32 variables."""
from __future__ import annotations

from typing import Any, Callable, Iterable

from ..models.detector import create_model, variables_from_jax
from .calibrate import calibrate
from .fake_quant import DEFAULT_EXCLUDE


def make_qat_model(cfg, exclude: tuple[str, ...] = DEFAULT_EXCLUDE,
                   num_bits: int = 8, device=None):
    """The QAT twin of ``cfg``: the same tree, the quantisers on, the
    exclusions applied (the stem, stage1_conv and the P2 head in float by
    default), on ``device`` (``cuda`` by default)."""
    return create_model(cfg.with_quant("quantize", exclude=exclude,
                                       num_bits=num_bits), device=device)


def prepare_qat_variables(fp32_model, fp32_variables: dict[str, Any],
                          batches_fn: Callable[[], Iterable[Any]],
                          method: str = "entropy", max_batches: int = 30,
                          exclude: tuple[str, ...] = DEFAULT_EXCLUDE,
                          num_bits: int = 8, min_images: int = 50):
    """FP32 (model, port variables) -> (qat_model, qat_variables): the
    two-pass calibration on eval-mode forwards, its ``quant`` collection
    (port variables, on the params' device) attached; params and batch
    statistics passed through as they are."""
    cfg = fp32_model.config
    dev = next(iter(fp32_variables["params"].values())).device
    calib_model = type(fp32_model)(None, cfg.with_quant(
        "calib_max", exclude=exclude, num_bits=num_bits)).to(dev)
    quant_tree = calibrate(calib_model, fp32_variables, batches_fn,
                           method=method, max_batches=max_batches,
                           min_images=min_images)
    qat_model = make_qat_model(cfg, exclude=exclude, num_bits=num_bits,
                               device=dev)
    qat_variables = dict(fp32_variables)
    qat_variables["quant"] = variables_from_jax(
        {"quant": quant_tree}, dev)["quant"]
    return qat_model, qat_variables
