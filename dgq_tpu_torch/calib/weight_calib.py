"""Weight quantization for deployment: per-out-channel scale init and
load-time folding (port of the deploy half of `dgq_tpu/calib/weight_calib.py`;
AdaRound and the int8 packing wait for later slices).

Weights are input-independent, so they are fake-quantized once at load and
inference runs on the folded float weights. Torch layouts put the out
channel first (OIHW / (O, I)), so the (O,1,1,1) / (O,1) qparams broadcast
directly. conv_in / conv_out keep float weights but still get qparams.
"""
from __future__ import annotations

from typing import Dict

import torch

from dgq_tpu_torch.models.qconfig import QConfig
from dgq_tpu_torch.quant.affine import QParams, fake_quant
from dgq_tpu_torch.quant.scalers import Scaler, init_scale_channelwise

EXCLUDED_LAYERS = ("conv_in", "conv_out")


def init_layer_wqp(w: torch.Tensor, kind: str, bits: int, scaler: Scaler) -> QParams:
    """Per-out-channel scale init for one conv/linear weight (out channel
    first, so `kind` does not change the layout)."""
    del kind
    return init_scale_channelwise(w, bits, scaler)


def init_weight_qparams(params: dict, spec, bits: int,
                        scaler: Scaler = Scaler.MINMAX) -> Dict[str, QParams]:
    """Scale init for every quantizable (conv/linear) layer."""
    return {name: init_layer_wqp(params[name]["w"], kind, bits, scaler)
            for name, kind, _ in spec if kind in ("conv", "linear")}


def fold_weight_quant(params: dict, wqp: Dict[str, QParams], spec, cfg: QConfig) -> dict:
    """Params with each quantized layer's weight replaced by its
    quantize-dequantized value (nearest rounding)."""
    out = dict(params)
    for name, kind, _ in spec:
        if kind not in ("conv", "linear") or name not in wqp:
            continue
        if cfg.disable_out_quant and name in EXCLUDED_LAYERS:
            continue
        p = dict(params[name])
        p["w"] = fake_quant(p["w"], wqp[name], cfg.w_bits)
        out[name] = p
    return out


@torch.no_grad()
def quantize_model_weights(params: dict, spec, cfg: QConfig,
                           scaler: Scaler = Scaler.MINMAX) -> tuple[dict, Dict[str, QParams]]:
    """One-call weight-only PTQ: init scales, then fold."""
    wqp = init_weight_qparams(params, spec, cfg.w_bits, scaler)
    return fold_weight_quant(params, wqp, spec, cfg), wqp
