"""Weight quantization: per-out-channel scale init with any scaler of
`quant.scalers` (minmax, or the MSE search of `cli.quantize_weight --cali`),
load-time folding (nearest rounding, or AdaRound's learned rounding where a
checkpoint carries its offsets), and the attention head packing (port of
`dgq_tpu/calib/weight_calib.py`; the AdaRound reconstruction that learns the
offsets waits for a later slice).

Weights are input-independent, so they are fake-quantized once at load and
inference runs on the folded float weights. Torch layouts put the out
channel first (OIHW / (O, I)), so the (O,1,1,1) / (O,1) qparams broadcast
directly. conv_in / conv_out keep float weights but still get qparams. The
scale init and the folds work on each out channel alone, so on weights cut
over channels (`parallel.mesh.shard_params_tp`) a rank's scales and folded
rows are the matching rows of the whole's, and a fold keeps the layer's
mark; `attach_int8_packed` refuses a cut layer.
`attach_int8_packed` adds the packed int8 codes of the int8 deploy path
(`ops.int8_matmul`) beside the folded weights.
`pack_attention_heads` repacks the attention projections into the head-slot
layout of the packed attention path.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from dgq_tpu_torch.models.qconfig import QConfig
from dgq_tpu_torch.ops.int8_matmul import pack_weight_int8
from dgq_tpu_torch.parallel.tp import refuse_sharded
from dgq_tpu_torch.quant.adaround import adaround_quant
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


def fold_weight_quant(params: dict, wqp: Dict[str, QParams], spec, cfg: QConfig,
                      alphas: Optional[Dict[str, torch.Tensor]] = None,
                      soft: bool = False) -> dict:
    """Params with each quantized layer's weight replaced by its
    quantize-dequantized value: nearest rounding, or for a layer named in
    `alphas` AdaRound's learned rounding with those offsets (in the weight's
    layout; soft during a reconstruction, hard for deployment)."""
    out = dict(params)
    for name, kind, _ in spec:
        if kind not in ("conv", "linear") or name not in wqp:
            continue
        if cfg.disable_out_quant and name in EXCLUDED_LAYERS:
            continue
        p = dict(params[name])
        if alphas is not None and name in alphas:
            p["w"] = adaround_quant(p["w"], wqp[name], alphas[name], cfg.w_bits, soft=soft)
        else:
            p["w"] = fake_quant(p["w"], wqp[name], cfg.w_bits)
        out[name] = p
    return out


@torch.no_grad()
def quantize_model_weights(params: dict, spec, cfg: QConfig,
                           scaler: Scaler = Scaler.MINMAX) -> tuple[dict, Dict[str, QParams]]:
    """One-call weight-only PTQ: init scales, then fold (and pack the int8
    codes when the policy runs the int8 deploy path)."""
    wqp = init_weight_qparams(params, spec, cfg.w_bits, scaler)
    params_q = fold_weight_quant(params, wqp, spec, cfg)
    if cfg.use_int8_matmul or cfg.use_int8_conv:
        params_q = attach_int8_packed(params_q, wqp, spec, cfg)
    return params_q, wqp


@torch.no_grad()
def attach_int8_packed(params_q: dict, wqp: Dict[str, QParams], spec, cfg: QConfig) -> dict:
    """Attach packed int8 weight codes for the int8 deploy path.

    Works on FOLDED params: folded weights sit exactly on the quantization
    grid, so round(w_folded/delta)+zp recovers the integer codes. Under
    cfg.use_int8_matmul, linear layers and 1x1 convs (which route through the
    matmul kernel) get 'w_q8' ((N, K) int8 recentered codes, K contiguous);
    under cfg.use_int8_conv, k x k convs get 'w_q8c' (OIHW int8 codes) for the
    s8 conv (`models.layers._int8_conv`). Both get 'w_d', 'w_z' (recentered)
    and 'w_ksum' (the codes' per-out-channel sums, f32), all made on the
    weights' device. Group conv layers and conv_in / conv_out get none: they
    never reach the int8 paths."""
    out = dict(params_q)
    for name, kind, meta in spec:
        if name not in wqp or (cfg.disable_out_quant and name in EXCLUDED_LAYERS):
            continue
        if kind not in ("conv", "linear") or name in cfg.group_conv_layers:
            continue
        matmul = kind == "linear" or (meta[2] == 1 and tuple(params_q[name]["w"].shape[2:])
                                      == (1, 1))
        if not (cfg.use_int8_matmul if matmul else cfg.use_int8_conv):
            continue
        p = dict(params_q[name])
        refuse_sharded(p, "attach_int8_packed")
        w2 = p["w"].float().reshape(p["w"].shape[0], -1)
        qp = wqp[name]
        codes, d, zr = pack_weight_int8(w2, qp.delta.float(), qp.zero_point.float(), cfg.w_bits)
        if matmul:
            p["w_q8"] = codes.contiguous()
        else:
            p["w_q8c"] = codes.reshape(p["w"].shape).contiguous()
        p["w_d"], p["w_z"] = d, zr
        p["w_ksum"] = codes.sum(dim=1, dtype=torch.int32).float()
        out[name] = p
    return out


def _head_slot_width(d: int, h: int, slot: int) -> int:
    """Per-head packed slot width. slot=64 takes 64 whenever the head fits
    and the head count is even (the JAX package's pair layout); otherwise,
    and always at slot=128, heads pad to a multiple of 128."""
    if slot == 64 and d <= 64 and h % 2 == 0:
        return 64
    return -(-d // 128) * 128


@torch.no_grad()
def pack_attention_heads(params: dict, spec, num_heads=8, slot: int = 64) -> dict:
    """Repack attention projection weights into the head-slot layout.

    Deploy-time transform, run after `quantize_model_weights`: every
    `to_q/to_k/to_v` weight (O, I) is viewed as (H, head_dim, I) and gets zero
    rows up to (H, dp, I), dp = `_head_slot_width` (its bias zeros likewise),
    so each head occupies a dp-wide slot of the projection's output and the
    attention kernels read it there by stride, with no transposed copy. The
    matching `to_out.0` weight (O, H*head_dim) gets zero columns so that it
    consumes the padded layout. Zero rows give exact-zero activations, which
    the per-tensor quantizers map to zero, so the packed forward computes the
    unpacked one's sums.

    slot=64: SD's 40-wide heads pad to 64 (80 to 128, 160 to 256); SDXL's
    64-wide heads need no padding. slot=128: every head pads to a multiple of
    128. num_heads: an int (SD v1.4: 8 everywhere) or a callable of the
    projection width (SDXL: `lambda o: o // 64`). Returns a new flat dict that
    shares every leaf it does not touch. Only 'w' and 'b' are packed: the
    int8 codes of `attach_int8_packed` are not, and the two paths are not
    run together."""
    heads_of = num_heads if callable(num_heads) else (lambda o: num_heads)
    new = dict(params)
    for name, kind, meta in spec:
        if kind != "linear":
            continue
        is_qkv = name.endswith((".to_q", ".to_k", ".to_v"))
        if not is_qkv and not name.endswith(".to_out.0"):
            continue
        width = meta[1] if is_qkv else meta[0]  # the axis that holds the heads
        h = heads_of(width)
        d = width // h
        pad = _head_slot_width(d, h, slot) - d
        if pad == 0:
            continue
        p = dict(params[name])
        w = p["w"]
        if is_qkv:
            p["w"] = F.pad(w.reshape(h, d, w.shape[1]), (0, 0, 0, pad)).reshape(-1, w.shape[1])
            if p.get("b") is not None:
                p["b"] = F.pad(p["b"].reshape(h, d), (0, pad)).reshape(-1)
        else:
            p["w"] = F.pad(w.reshape(w.shape[0], h, d), (0, pad)).reshape(w.shape[0], -1)
        new[name] = p
    return new
