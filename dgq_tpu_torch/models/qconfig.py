"""Quantization configuration, runtime quantizer state and the activation
taps of calibration (port of `dgq_tpu/models/qconfig.py`).

  * QConfig: the static policy, with the JAX package's field names so one
    dict builds both.
  * QState: a plain dict {'a': {layer_name: QParams | GroupQParams},
    'sm': {attn_name: delta}}; time-aware states carry a leading [T] slot
    axis on every leaf.
  * Taps: every activation-quantizer input publishes its pre-quant tensor
    to the collector installed by `collect_act_taps`, also when quantization
    is off (see `TapCollector`).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from dgq_tpu_torch.ops import fake_quant as fake_quant_ops
from dgq_tpu_torch.quant.affine import QParams, fake_quant
from dgq_tpu_torch.quant.log2 import log2_fake_quant, log2_real_time_quant
from dgq_tpu_torch.utils.profiler import span

QState = Dict[str, Any]


# ---------------------------------------------------------------------------
# Activation taps. The JAX package's collectors are jitted, so XLA drops
# every tap a collector does not return. Here the forward is eager and a tap
# costs whatever its collector keeps, so a collector names the taps it wants
# and reduces each one where it is published: a full-width forward has
# hundreds of taps, and one 64px self-attention softmax at batch 8 is 4.3 GB.
# ---------------------------------------------------------------------------
class TapCollector:
    """Receives the taps of the forwards run under `collect_act_taps`.

    names: the tap names to receive (None: every tap). reduce(name, x, prev)
    -> the value stored under `name` (default: x itself; prev is the value
    stored before, or None). shapes_only=True stores each tap's shape (a
    tuple) and never makes a tap that is computed only for the collector
    (the unfolded conv input, the post-softmax weights under the fused
    attention). `store` keeps the values in the order of first publication."""

    def __init__(self, names=None, reduce: Optional[Callable] = None,
                 shapes_only: bool = False):
        self.names = None if names is None else frozenset(names)
        self.reduce = reduce
        self.shapes_only = shapes_only
        self.store: dict = {}

    def wants(self, name: str) -> bool:
        return self.names is None or name in self.names

    def put(self, name: str, x, shape: Optional[tuple] = None) -> None:
        """x: a tensor, or a function that makes the tensor of shape `shape`
        (called only when the collector keeps more than shapes)."""
        if not self.wants(name):
            return
        if self.shapes_only:
            self.store[name] = tuple(x.shape if shape is None else shape)
            return
        if callable(x):
            x = x()
        self.store[name] = x if self.reduce is None else self.reduce(
            name, x, self.store.get(name))


_TAPS: contextvars.ContextVar[Optional[TapCollector]] = contextvars.ContextVar(
    "dgq_torch_act_taps", default=None)


@contextlib.contextmanager
def collect_act_taps(collector: TapCollector):
    token = _TAPS.set(collector)
    try:
        yield collector
    finally:
        _TAPS.reset(token)


def _tap(name: str, x, shape: Optional[tuple] = None) -> None:
    """Publish a pre-quant tensor (or, with `shape`, a function that makes
    one that exists only for the collector) to the installed collector."""
    c = _TAPS.get()
    if c is not None:
        c.put(name, x, shape)


def taps_active() -> bool:
    """True when a tap collector is installed."""
    return _TAPS.get() is not None


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
    # gate of models.layers._int8_xla_eligible. use_int8_conv: k x k convs
    # with packed 'w_q8c' codes and a per-tensor activation scale run as an
    # s8 conv (models.layers._int8_conv); the two flags are independent
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


# the MMDiT's layers that stay float, as conv_in and conv_out in the UNets
MMDIT_UNQUANTIZED = ("pos_embed.proj", "proj_out")


def joint_act_sites(spec) -> list:
    """The activation quantizers of an MMDiT (`models.mmdit_sd3`), both
    streams: the input of every linear of `spec` but proj_out, then each
    joint attention's aqtizer_q, aqtizer_k and aqtizer_v (on the text-first
    joint q, k and v)."""
    names = [n for n, k, _ in spec if k == "linear" and n not in MMDIT_UNQUANTIZED]
    for n, k, _ in spec:
        if k == "linear" and n.endswith(".attn.to_q"):
            pre = n[: -len(".to_q")]
            names += [f"{pre}.aqtizer_q", f"{pre}.aqtizer_k", f"{pre}.aqtizer_v"]
    return names


def aq_apply(qstate: Optional[QState], cfg: QConfig, name: str,
             x: torch.Tensor, start_rows: int = 0) -> torch.Tensor:
    """Apply the activation quantizer registered for `name`, if any; the
    first `start_rows` rows along axis -2 pass through unquantized (the
    start-peak key row) and are not published to the tap.

    Per-tensor, last-axis and group parameters (f32) on a card, where no
    gradient is wanted, take the one-launch kernel (`ops.fake_quant`, bit
    for bit the chain); CPU tensors, learnable deltas, bf16 parameters and
    other broadcasts take `quant.affine.fake_quant`'s chain."""
    _tap(name, x[..., start_rows:, :] if start_rows else x)
    if not cfg.use_aq or qstate is None:
        return x
    qp = qstate.get("a", {}).get(name)
    if qp is None:
        return x
    with span("dgq.fake_quant", device=True):
        if isinstance(qp, GroupQParams):
            delta, zp, mid = qp.delta_last, qp.zp_last, (qp.delta_mid, qp.zp_mid)
        else:
            delta, zp, mid = qp.delta, qp.zero_point, None
        if fake_quant_ops.kernel_takes(x, delta, zp, mid, start_rows):
            return fake_quant_ops.fused_fake_quant(x, delta, zp, cfg.a_bits, start_rows, mid,
                                                   checked=True)
        if x.is_cuda:
            fake_quant_ops.LAUNCHES["fake_quant_plain"] += 1
        if not start_rows:
            return _fake_quant_chain(qp, cfg, x)
        return torch.cat([x[..., :start_rows, :],
                          _fake_quant_chain(qp, cfg, x[..., start_rows:, :])], dim=-2)


def _fake_quant_chain(qp, cfg: QConfig, x: torch.Tensor) -> torch.Tensor:
    """`quant.affine.fake_quant` with group or plain parameters broadcast
    against x."""
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
    _tap(name, attn_weights)
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
