"""Uniform affine fake-quantization primitives (port of
`dgq_tpu/quant/affine.py`).

clamp(round(x/delta)+zp, NB, PB) then delta*(xq-zp), in the shifted-clip
form, with a straight-through estimator on the round. Rounding is half to
even, as `jnp.round`, so the results are bit-identical to the JAX package.
The EMA range helpers serve activation calibration (`calib.act_calib`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class QParams(NamedTuple):
    """Affine quantizer parameters. delta/zero_point broadcast against the
    tensor being quantized: scalars per tensor, (O,1,1,1) conv / (O,1)
    linear per out channel (torch layouts). Time-aware activation params
    carry a leading [T] slot axis."""

    delta: torch.Tensor
    zero_point: torch.Tensor


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """round() with a straight-through (identity) gradient."""
    return x + (torch.round(x) - x).detach()


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """`jnp.clip`: min(max(x, lo), hi), with torch.clamp's values. Where x ties
    a bound the gradient splits in halves between x and the bound, as JAX's
    does (torch.clamp hands all of it to x). Where no gradient is taken it is
    torch.clamp itself, one pass. Where one is, a number bound becomes a 0-d
    tensor of x's dtype filled on x's device (a copy from the host would wait
    for the card's queue)."""
    if not (torch.is_grad_enabled()
            and any(torch.is_tensor(t) and t.requires_grad for t in (x, lo, hi))):
        return torch.clamp(x, lo, hi)
    if not torch.is_tensor(lo):
        lo = torch.full((), lo, dtype=x.dtype, device=x.device)
    if not torch.is_tensor(hi):
        hi = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def quant_bounds(bits: int, symmetric: bool, always_zero: bool) -> tuple[int, int]:
    """Integer clamp bounds NB/PB."""
    level = 2 ** bits
    if symmetric and not always_zero:
        return -level // 2, level // 2 - 1
    return 0, level - 1


def fake_quant(x: torch.Tensor, qp: QParams, bits: int, symmetric: bool = False,
               always_zero: bool = False) -> torch.Tensor:
    """Quantize-dequantize x: clip(r + zp, nb, pb) - zp == clip(r, nb - zp,
    pb - zp), so the zero point lives in the clip bounds. The clip is `clip`'s,
    so the gradients with respect to x and delta are JAX's, ties included.

    The arithmetic runs in the promoted dtype of x and delta, as JAX promotes
    arrays (a bf16 activation with an f32 delta computes in f32); PyTorch
    would keep a 0-d delta from promoting."""
    delta = torch.as_tensor(qp.delta, device=x.device)
    zp = torch.as_tensor(qp.zero_point, device=x.device)
    x = x.to(torch.promote_types(x.dtype, delta.dtype))
    nb, pb = quant_bounds(bits, symmetric, always_zero)
    x_q = clip(ste_round(x / delta), nb - zp, pb - zp)
    return delta * x_q


def int_code_offset(bits: int, symmetric: bool = False, always_zero: bool = False) -> int:
    """Signed-representation bias for integer codes: asymmetric codes live in
    [0, 2^bits - 1] and are recentered by 2^(bits-1) into the int8 range;
    symmetric codes are already signed."""
    nb, _ = quant_bounds(bits, symmetric, always_zero)
    return 2 ** (bits - 1) if nb == 0 else 0


def quantize_int(x: torch.Tensor, qp: QParams, bits: int, symmetric: bool = False,
                 always_zero: bool = False, dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Real integer quantization: clamp(round(x/delta)+zp, NB, PB) - offset as
    signed integers (see int_code_offset). Dequantization is
    delta*(code + offset - zp)."""
    nb, pb = quant_bounds(bits, symmetric, always_zero)
    off = int_code_offset(bits, symmetric, always_zero)
    codes = torch.clamp(torch.round(x / qp.delta) + qp.zero_point, nb, pb) - off
    return codes.to(dtype)


def dequantize_int(codes: torch.Tensor, qp: QParams, bits: int, symmetric: bool = False,
                   always_zero: bool = False,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of quantize_int."""
    off = int_code_offset(bits, symmetric, always_zero)
    return (qp.delta * (codes.to(out_dtype) + off - qp.zero_point)).to(out_dtype)


def ema_minmax_update(x: torch.Tensor, x_min, x_max, momentum: float = 0.95):
    """EMA running min/max (the reference's act_momentum_update)."""
    return (x_min * momentum + x.min() * (1.0 - momentum),
            x_max * momentum + x.max() * (1.0 - momentum))


def minmax_qparams_from_range(x_min, x_max, bits: int, symmetric: bool = False,
                              always_zero: bool = False) -> QParams:
    """Affine params for a known [min, max] range, as the minmax scaler gives
    them for a tensor whose extremes are x_min / x_max (x_min clamped <= 0,
    x_max >= 0). Python floats become float32 tensors, as `jnp.asarray`
    makes them in the JAX package."""
    x_min = torch.as_tensor(x_min, dtype=torch.float32)
    x_max = torch.as_tensor(x_max, dtype=torch.float32)
    level = 2 ** bits
    lo = torch.clamp(x_min, max=0.0)
    hi = torch.clamp(x_max, min=0.0)
    delta = (hi - lo) / (level - 1)
    if symmetric:
        hi2 = torch.maximum(torch.abs(lo), hi)
        lo = -hi2
        delta = (hi2 - lo) / (level - 2)
    if always_zero:
        delta = hi / (level - 1)
    delta = torch.clamp(delta, min=1e-8)
    if symmetric or always_zero:
        zero_point = torch.zeros_like(delta)
    else:
        zero_point = torch.round(-lo / delta)
    return QParams(delta=delta, zero_point=zero_point)
