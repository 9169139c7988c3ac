"""AdaRound's learned rounding, the deploy half (port of
`dgq_tpu/quant/adaround.py`): the rectified sigmoid of the learned offsets,
the quantize-dequantize that rounds with them, and the offsets' init, which
a reconstruction starts from. The reconstruction itself (the rounding
regularizer and its temperature schedule) belongs to calibration and is not
ported here.

Weights are in the port's layout (out channel first); alpha has the weight's
shape and the QParams broadcast against it as in `quant.affine`.
"""
from __future__ import annotations

import torch

from dgq_tpu_torch.quant.affine import QParams

GAMMA = -0.1
ZETA = 1.1


def adaround_init_alpha(w: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """alpha from the rounding remainder rest = w/delta - floor(w/delta):
    -log((zeta - gamma) / (rest - gamma) - 1), so that the soft target
    sigmoid(alpha) (zeta - gamma) + gamma equals rest at init."""
    rest = w / delta - torch.floor(w / delta)
    return -torch.log((ZETA - GAMMA) / (rest - GAMMA) - 1.0)


def adaround_soft_targets(alpha: torch.Tensor) -> torch.Tensor:
    """clip(sigmoid(alpha) (zeta - gamma) + gamma, 0, 1)."""
    return torch.clamp(torch.sigmoid(alpha) * (ZETA - GAMMA) + GAMMA, 0.0, 1.0)


def adaround_quant(w: torch.Tensor, qp: QParams, alpha: torch.Tensor, bits: int,
                   symmetric: bool = False, soft: bool = True) -> torch.Tensor:
    """Quantize-dequantize w with learned rounding: floor(w/delta) plus the
    soft target (soft=True, as a reconstruction trains it) or plus
    (alpha >= 0) (soft=False, the deploy fold), clipped, dequantized."""
    level = 2 ** bits
    x_floor = torch.floor(w / qp.delta)
    if soft:
        x_int = x_floor + adaround_soft_targets(alpha)
    else:
        x_int = x_floor + (alpha >= 0).to(x_floor.dtype)
    nb = -level // 2 if symmetric else 0
    pb = level // 2 - 1 if symmetric else level - 1
    x_q = torch.clamp(x_int + qp.zero_point, nb, pb)
    return qp.delta * (x_q - qp.zero_point)
