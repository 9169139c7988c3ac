"""Quantization configuration and runtime quantizer state (port of
`dgq_tpu/models/qconfig.py`; the calibration taps `_tap` / `collect_act_taps`
are left out until calibration is ported).

  * QConfig: the static policy, with the JAX package's field names so one
    dict builds both. The one field the port does not serve yet
    (`use_int8_conv`) raises NotImplementedError at construction.
  * QState: a plain dict {'a': {layer_name: QParams | GroupQParams},
    'sm': {attn_name: delta}}; time-aware states carry a leading [T] slot
    axis on every leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from dgq_tpu_torch.quant.affine import QParams, fake_quant
from dgq_tpu_torch.quant.log2 import log2_fake_quant, log2_real_time_quant

QState = Dict[str, Any]

# field -> the ROADMAP item that ports it
_NOT_PORTED = {
    "use_int8_conv": "queue 1 (the int8 implicit-GEMM conv on K6's tile code)",
}


GROUP_CONV_IMPLS = ("taps", "fused", "im2col", "unfold")
INT8_IMPLS = ("pallas", "xla")


@dataclasses.dataclass(frozen=True)
class QConfig:
    """Static quantization policy (see the JAX QConfig for each field)."""

    w_bits: int = 4
    a_bits: int = 8
    softmax_bits: int = 8
    use_wq: bool = False
    use_aq: bool = False
    t2i_log_quant: bool = False
    t2i_real_time: bool = False
    t2i_start_peak: bool = False
    log_max_1: bool = False
    disable_out_quant: bool = True
    # names of the k x k convs whose activation is group-quantized on the
    # unfolded (C*kh*kw, L) layout, and how they execute: 'taps' (per-tap
    # codes + kh*kw accumulated matmuls), 'fused' (the CUDA kernel
    # ops.group_conv where eligible, else taps), 'im2col' (one quantized
    # concat + one matmul), 'unfold' (the reference's materialized form)
    group_conv_layers: tuple = ()
    group_conv_impl: str = "taps"
    # True: attention runs fused_attention (the CUDA kernels on the GPU);
    # False: the materialized-softmax path
    use_pallas_attention: bool = False
    # linears and 1x1 convs with packed weights and a per-tensor activation
    # scale run in real int8. int8_impl keeps the JAX package's two values:
    # 'pallas' is the hand-written kernel (ops.int8_matmul; the CUDA kernel
    # on the GPU), 'xla' the library route (torch._int_mm) behind the shape
    # gate of models.layers._int8_xla_eligible
    use_int8_matmul: bool = False
    use_int8_conv: bool = False
    int8_impl: str = "pallas"
    # per-tensor activation quantizers emit shifted integer codes and the
    # dequantize multiply moves to the consumer's f32 epilogue
    fold_act_dequant: bool = False
    # attention projections emit the packed head-slot layout (B, T, H*dp)
    # (weights from calib.weight_calib.pack_attention_heads, or heads that are
    # 64 wide already) and the attention kernels read each head by stride:
    # no transposed copy of q, k, v or the output
    packed_attention: bool = False

    def __post_init__(self):
        for name, item in _NOT_PORTED.items():
            if getattr(self, name):
                raise NotImplementedError(
                    f"QConfig.{name} is not ported to dgq_tpu_torch yet: ROADMAP {item}")
        # Stricter on input than the JAX package, identical on every legal
        # value: there an unknown string silently takes the unfold branch.
        if self.group_conv_impl not in GROUP_CONV_IMPLS:
            raise ValueError(f"group_conv_impl {self.group_conv_impl!r} is none of "
                             f"{', '.join(map(repr, GROUP_CONV_IMPLS))}")
        if self.int8_impl not in INT8_IMPLS:
            raise ValueError(f"int8_impl {self.int8_impl!r} is none of "
                             f"{', '.join(map(repr, INT8_IMPLS))}")

    def replace(self, **kw) -> "QConfig":
        return dataclasses.replace(self, **kw)


class GroupQParams:
    """Group-quant params in canonical two-axis form over an unfolded
    (..., mid, last) activation: delta = delta_mid * delta_last,
    zp = zp_mid + zp_last, the unused axis's vector being ones/zeros."""

    def __init__(self, delta_mid, zp_mid, delta_last, zp_last):
        self.delta_mid = delta_mid
        self.zp_mid = zp_mid
        self.delta_last = delta_last
        self.zp_last = zp_last


def aq_apply(qstate: Optional[QState], cfg: QConfig, name: str,
             x: torch.Tensor) -> torch.Tensor:
    """Apply the activation quantizer registered for `name`, if any."""
    if not cfg.use_aq or qstate is None:
        return x
    qp = qstate.get("a", {}).get(name)
    if qp is None:
        return x
    if isinstance(qp, GroupQParams):
        mid = (1,) * (x.dim() - 2) + (-1, 1)
        last = (1,) * (x.dim() - 1) + (-1,)
        delta = qp.delta_mid.reshape(mid) * qp.delta_last.reshape(last)
        zp = qp.zp_mid.reshape(mid) + qp.zp_last.reshape(last)
        return fake_quant(x, QParams(delta, zp), cfg.a_bits)
    # broadcast trailing-shaped params against higher-rank activations
    delta, zp = qp.delta, qp.zero_point
    if 0 < delta.dim() < x.dim():
        shape = (1,) * (x.dim() - delta.dim()) + tuple(delta.shape)
        delta = delta.reshape(shape)
        zp = zp.reshape(shape)
    return fake_quant(x, QParams(delta, zp), cfg.a_bits)


def softmax_q_apply(qstate: Optional[QState], cfg: QConfig, name: str,
                    attn_weights: torch.Tensor) -> torch.Tensor:
    """Quantize post-softmax attention weights (aqtizer_w): log2 when
    t2i_log_quant (per-call max under t2i_real_time, else a calibrated or
    pinned delta), otherwise a uniform always-zero affine quantizer."""
    if not cfg.use_aq or qstate is None:
        return attn_weights
    if cfg.t2i_log_quant:
        if cfg.t2i_real_time:
            return log2_real_time_quant(attn_weights, cfg.softmax_bits)
        if cfg.log_max_1:
            return log2_fake_quant(attn_weights, torch.ones((), device=attn_weights.device),
                                   cfg.softmax_bits)
        delta = qstate.get("sm", {}).get(name)
        if delta is None:
            return attn_weights
        return log2_fake_quant(attn_weights, delta, cfg.softmax_bits)
    qp = qstate.get("a", {}).get(name)
    if qp is None:
        return attn_weights
    return fake_quant(attn_weights, qp, cfg.softmax_bits, always_zero=True)
