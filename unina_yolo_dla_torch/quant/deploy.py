"""Deploy-time weight transforms: BatchNorm folding, the space-to-depth
stem and stage1 blockings, the merged stem columns, int8 weights.

The port's own copy of the reference's ``quant/deploy.py`` (numpy only,
the same arithmetic, messages and idempotence): each function maps a
variable tree (nested dicts of numpy arrays) onto the tree a deploy
``ModelConfig`` loads.

  fold_batchnorm                  {'params', 'batch_stats', ['quant']}
                                  -> {'params', ['quant']}, every
                                  ConvBlock {'conv': {'kernel', 'bias'}}:
      W'[..., o] = W[..., o] * gamma[o] / sqrt(var[o] + eps)
      b'[o]      = beta[o] - gamma[o] * mean[o] / sqrt(var[o] + eps)
  fold_stem_space_to_depth        stem (3,3,3,O) -> (2,2,12,O)
  fold_downsample_space_to_depth  stage1_conv (3,3,C,O) -> (2,2,4C,O)
  merge_stem_columns              s2d stem (2,2,C,O) -> (2,2,2C,2O)
  quantize_weights_int8           non-excluded kernels -> int8 + w_scale

``folded_equivalence_report`` holds the train-form (BatchNorm) model in
eval mode against the deploy model built from its folded weights.
"""
from __future__ import annotations

from typing import Any

import numpy as np


def _is_convblock(params_node: dict, stats_node: dict | None) -> bool:
    return (isinstance(params_node, dict) and "conv" in params_node
            and "bn" in params_node and stats_node is not None
            and "bn" in stats_node)


def fold_batchnorm(
    variables: dict[str, Any],
    eps: float = 1e-5,
) -> dict[str, Any]:
    """Training variables {'params', 'batch_stats', ['quant']} ->
    deploy variables {'params', ['quant']} with BN folded into convs.

    The returned params tree matches a ``ModelConfig(deploy=True)`` tree:
    every ConvBlock is {'conv': {'kernel', 'bias'}} with no 'bn'.
    """
    params = variables["params"]
    stats = variables.get("batch_stats", {})

    def fold(p_node: Any, s_node: Any) -> Any:
        if not isinstance(p_node, dict):
            return p_node
        if _is_convblock(p_node, s_node):
            kernel = np.asarray(p_node["conv"]["kernel"], np.float32)
            gamma = np.asarray(p_node["bn"]["scale"], np.float32)
            beta = np.asarray(p_node["bn"]["bias"], np.float32)
            mean = np.asarray(s_node["bn"]["mean"], np.float32)
            var = np.asarray(s_node["bn"]["var"], np.float32)
            inv = gamma / np.sqrt(var + eps)
            out = {"conv": {
                "kernel": kernel * inv,            # broadcast over out dim
                "bias": beta - mean * inv,
            }}
            # preserve any other submodules living beside conv/bn
            for k, v in p_node.items():
                if k not in ("conv", "bn"):
                    out[k] = fold(v, (s_node or {}).get(k))
            return out
        return {k: fold(v, (s_node or {}).get(k) if isinstance(s_node, dict)
                        else None)
                for k, v in p_node.items()}

    out = {"params": fold(params, stats)}
    if "quant" in variables:
        out["quant"] = variables["quant"]
    return out


def fold_stem_space_to_depth(deploy_variables: dict[str, Any]
                             ) -> dict[str, Any]:
    """BN-folded deploy variables -> variables for the space-to-depth stem
    (``ModelConfig(deploy=True, stem_s2d=True)``).

    Kernel math (1D, then separable in both spatial axes): the stride-2
    3-tap conv with pad 1, ``out[o] = sum_k W3[k] x[2o-1+k]``, equals a
    stride-1 2-tap conv over 2x-blocked input with a zero-padded 4-tap
    kernel ``W4 = [0, W3]``:

        out[o] = sum_{kb in {0,1}} sum_{d in {0,1}} W4[2kb+d] xb[o-1+kb, d]

    so the blocked kernel is (2, 2, 4*C, O) with the (di, dj, c) offsets
    flattened row-major (``ops.preprocess.space_to_depth``'s layout) and
    the blocked conv uses padding ((1,0),(1,0)). The same multiplies and
    adds as the standard stem; only the data layout changes. Bias and
    every other layer pass through.
    """
    return _fold_layer_space_to_depth(deploy_variables, "stem",
                                      expect_cin=3)


def fold_downsample_space_to_depth(deploy_variables: dict[str, Any],
                                   layer: str = "stage1_conv"
                                   ) -> dict[str, Any]:
    """The same (3,3,C,O) -> (2,2,4C,O) blocking for a deeper stride-2
    downsample conv (``ModelConfig(stage1_s2d=True)`` consumes it).
    """
    return _fold_layer_space_to_depth(deploy_variables, layer,
                                      expect_cin=None)


def _fold_layer_space_to_depth(deploy_variables: dict[str, Any],
                               layer: str,
                               expect_cin: int | None) -> dict[str, Any]:
    params = deploy_variables["params"]
    conv = params.get("backbone", {}).get(layer, {}).get("conv")
    if conv is None or "kernel" not in conv:
        raise ValueError(f"no backbone/{layer}/conv kernel in deploy "
                         "variables")
    k = np.asarray(conv["kernel"], np.float32)
    if k.ndim != 4 or k.shape[:2] != (3, 3) or (
            expect_cin is not None and k.shape[2] != expect_cin):
        raise ValueError(f"{layer} kernel is {k.shape}, expected "
                         "(3,3,C,O) — already transformed?")
    C, O = k.shape[2], k.shape[3]
    k4 = np.zeros((4, 4, C, O), np.float32)
    k4[1:, 1:] = k
    # (4,4,C,O) -> (kbi, di, kbj, dj, C, O) -> (kbi, kbj, di, dj, C, O)
    k4 = k4.reshape(2, 2, 2, 2, C, O).transpose(0, 2, 1, 3, 4, 5)
    k2 = k4.reshape(2, 2, 4 * C, O)

    out = {kk: vv for kk, vv in deploy_variables.items()}
    new_params = dict(params)
    new_backbone = dict(params["backbone"])
    new_conv = dict(conv)
    new_conv["kernel"] = k2
    new_backbone[layer] = {"conv": new_conv}
    new_params["backbone"] = new_backbone
    out["params"] = new_params
    return out


def merge_stem_columns(deploy_variables: dict[str, Any]) -> dict[str, Any]:
    """s2d-stem deploy variables -> column-MERGED stem variables
    (``ModelConfig(s2d_merged=True)``).

    The merged engine's stem consumes the same host bytes as the s2d_host
    stem, viewed as (S/2, S/4, 24) (adjacent column pairs merged into
    channels, a byte-identical reshape), and emits its output in that
    merged layout, ``ym[h, w2] = [y[h,2w2]; y[h,2w2+1]]``. With
    ``xbm[i,j] = [xb[i,2j]; xb[i,2j+1]]`` the two interleaved outputs are
    2x2 stride-1 convs over ``xbm`` whose taps read xb columns {2w2-1,
    2w2} (left output) and {2w2, 2w2+1} (right), so the merged kernel
    (2,2,2C,2O) places the original (2,2,C,O) taps as

        Wm[kh, 0, C:2C, :O]  = W[kh, 0]     Wm[kh, 1, 0:C, :O]  = W[kh, 1]
        Wm[kh, 1, 0:C, O:]   = W[kh, 0]     Wm[kh, 1, C:2C, O:] = W[kh, 1]

    (rest zero), with the same ((1,0),(1,0)) padding. Bias tiles 2x.
    """
    params = deploy_variables["params"]
    conv = params.get("backbone", {}).get("stem", {}).get("conv")
    if conv is None or "kernel" not in conv or "bias" not in conv:
        raise ValueError("no backbone/stem/conv kernel+bias in deploy "
                         "variables — run fold_stem_space_to_depth first")
    k = np.asarray(conv["kernel"], np.float32)
    if k.ndim != 4 or k.shape[:2] != (2, 2):
        raise ValueError(f"stem kernel is {k.shape}, expected (2,2,C,O) "
                         "s2d-folded — run fold_stem_space_to_depth first")
    C, O = k.shape[2], k.shape[3]
    km = np.zeros((2, 2, 2 * C, 2 * O), np.float32)
    km[:, 0, C:2 * C, :O] = k[:, 0]
    km[:, 1, 0:C, :O] = k[:, 1]
    km[:, 1, 0:C, O:] = k[:, 0]
    km[:, 1, C:2 * C, O:] = k[:, 1]
    bias = np.asarray(conv["bias"], np.float32)

    out = {kk: vv for kk, vv in deploy_variables.items()}
    new_params = dict(params)
    new_backbone = dict(params["backbone"])
    new_conv = dict(conv)
    new_conv["kernel"] = km
    new_conv["bias"] = np.concatenate([bias, bias])
    new_backbone["stem"] = {"conv": new_conv}
    new_params["backbone"] = new_backbone
    out["params"] = new_params
    return out


def quantize_weights_int8(
    deploy_variables: dict[str, Any],
    spec,
    qmax: float = 127.0,
) -> dict[str, Any]:
    """BN-folded deploy variables -> int8-engine variables.

    Every conv kernel on a path ``spec`` does not exclude becomes {kernel:
    int8, w_scale: f32 per output channel (or one for the tensor when
    ``spec.per_channel_weights`` is false)}; excluded layers keep float
    kernels, and an int8 kernel passes through (idempotent). ``spec``: the
    QuantSpec of the calibration (its exclusion list must match the
    activation amaxes in ``deploy_variables['quant']``).
    """

    def walk(node: Any, path: str) -> Any:
        if not isinstance(node, dict):
            return node
        if "kernel" in node and not spec.excluded(path):
            if np.asarray(node["kernel"]).dtype == np.int8:
                return node  # already quantised: idempotent
            kernel = np.asarray(node["kernel"], np.float32)  # HWIO
            if getattr(spec, "per_channel_weights", True):
                amax = np.abs(kernel).max(axis=(0, 1, 2))    # (O,)
            else:
                amax = np.full(kernel.shape[-1], np.abs(kernel).max())
            w_scale = np.maximum(amax, 1e-9) / qmax          # (O,)
            out = {
                "kernel": np.clip(np.round(kernel / w_scale), -qmax, qmax
                                  ).astype(np.int8),
                "w_scale": w_scale.astype(np.float32),
            }
            for k, v in node.items():
                if k != "kernel":
                    out[k] = v
            return out
        return {k: walk(v, f"{path}/{k}" if path else k)
                for k, v in node.items()}

    out = dict(deploy_variables)
    out["params"] = walk(deploy_variables["params"], "")
    return out


def folded_equivalence_report(model_train, model_deploy, x) -> float:
    """Max |train-form eval output - deploy output| over every level's cls
    and reg maps, each model carrying its own weights (the train form's
    unfolded, the deploy form's from ``fold_batchnorm`` of them)."""
    import torch

    was_training = model_train.training
    model_train.eval()
    try:
        with torch.no_grad():
            train_out = model_train(x)
            dep_out = model_deploy(x)
    finally:
        model_train.train(was_training)
    return max(float((a - b).abs().max())
               for pa, pb in zip(train_out, dep_out)
               for a, b in zip(pa, pb))
