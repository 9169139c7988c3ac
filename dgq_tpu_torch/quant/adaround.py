"""AdaRound's learned rounding (port of `dgq_tpu/quant/adaround.py`): the
rectified sigmoid of the learned offsets, the quantize-dequantize that
rounds with them, the offsets' init, and the rounding regularizer with its
temperature schedule that `calib.reconstruction` adds to the loss. The clips
are `quant.affine.clip`'s, whose gradient at a bound is JAX's.

Weights are in the port's layout (out channel first); alpha has the weight's
shape and the QParams broadcast against it as in `quant.affine`.
"""
from __future__ import annotations

import torch

from dgq_tpu_torch.quant.affine import QParams, clip

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
    return clip(torch.sigmoid(alpha) * (ZETA - GAMMA) + GAMMA, 0.0, 1.0)


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
    x_q = clip(x_int + qp.zero_point, nb, pb)
    return qp.delta * (x_q - qp.zero_point)


def rounding_reg_loss(alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """The relaxation regularizer sum(1 - |2h - 1|^beta) over the soft
    targets h, which pushes them to 0 or 1; beta is annealed by
    `linear_temp_decay` during a reconstruction."""
    h = adaround_soft_targets(alpha)
    return torch.sum(1.0 - torch.abs(2.0 * h - 1.0) ** beta)


def linear_temp_decay(t: torch.Tensor, t_max: int, warmup: float = 0.0,
                      start_b: float = 20.0, end_b: float = 2.0) -> torch.Tensor:
    """The temperature: start_b until warmup * t_max, then a linear decay to
    end_b at t_max. t is a float32 tensor (the step), and every operation
    stays in float32, as the JAX package's does."""
    start_decay = warmup * t_max
    rel_t = (t - start_decay) / (t_max - start_decay)
    decayed = end_b + (start_b - end_b) * torch.clamp(1.0 - rel_t, min=0.0)
    return torch.where(t < start_decay, torch.full_like(t, start_b), decayed)
