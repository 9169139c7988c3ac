"""Scale initializers for affine quantizers (port of
`dgq_tpu/quant/scalers.py`, the minmax family the deploy path uses).

The searched scalers (mse, kl, hist, omse, logminmax) are calibration tools
and raise NotImplementedError until the calibration slice (ROADMAP queue 1,
slice 5).
"""
from __future__ import annotations

import enum

import torch

from dgq_tpu_torch.quant.affine import QParams


class Scaler(str, enum.Enum):
    MINMAX = "minmax"
    MSE = "mse"
    KL = "kl"
    HIST = "hist"
    OMSE = "omse"
    LOGMINMAX = "logminmax"


def _minmax_from_range(x_min, x_max, level: int, symmetric: bool,
                       always_zero: bool) -> QParams:
    delta = (x_max - x_min) / (level - 1)
    if symmetric:
        hi = torch.maximum(torch.abs(x_min), x_max)
        x_min = -hi
        delta = (hi - x_min) / (level - 2)
    if always_zero:
        delta = x_max / (level - 1)
    delta = torch.clamp(delta, min=1e-8)
    if symmetric or always_zero:
        zp = torch.zeros_like(delta)
    else:
        zp = torch.round(-x_min / delta)
    return QParams(delta=delta, zero_point=zp)


def minmax_scale(x: torch.Tensor, level: int, symmetric: bool,
                 always_zero: bool) -> QParams:
    """Per-tensor minmax; x_min clamped <= 0, x_max clamped >= 0."""
    x_min = torch.clamp(x.min(), max=0.0)
    x_max = torch.clamp(x.max(), min=0.0)
    return _minmax_from_range(x_min, x_max, level, symmetric, always_zero)


def minmax_scale_rows(flat: torch.Tensor, level: int, symmetric: bool,
                      always_zero: bool) -> QParams:
    """Minmax per row of a (rows, n) tensor."""
    x_min = torch.clamp(flat.amin(dim=1), max=0.0)
    x_max = torch.clamp(flat.amax(dim=1), min=0.0)
    return _minmax_from_range(x_min, x_max, level, symmetric, always_zero)


def _require_minmax(scaler) -> None:
    if Scaler(scaler) != Scaler.MINMAX:
        raise NotImplementedError(
            f"scaler {Scaler(scaler).value!r} is not ported: ROADMAP queue 1, "
            "slice 5 (calibration), item 13")


def init_scale_channelwise(x: torch.Tensor, bits: int, scaler: Scaler = Scaler.MINMAX,
                           symmetric: bool = False, always_zero: bool = False) -> QParams:
    """Per-out-channel (leading axis) initialization for weights; results
    broadcast as (O,1,1,1) conv / (O,1) linear."""
    _require_minmax(scaler)
    n = x.shape[0]
    qp = minmax_scale_rows(x.float().reshape(n, -1), 2 ** bits, symmetric, always_zero)
    bshape = (n,) + (1,) * (x.dim() - 1)
    return QParams(qp.delta.reshape(bshape), qp.zero_point.reshape(bshape))
