"""Log2 softmax quantizer (port of `dgq_tpu/quant/log2.py`).

Post-softmax weights x in (0, 1] are quantized on a log2 grid:
    x_q = clamp(round(-log2(x / delta)), NB, PB);  x_dq = 2^{-x_q} * delta,
with a static (calibrated) delta, or delta = max(x) of the call
(`real_time`). Calibration picks the static delta by a quantile search
(`log2_init_delta`) and moves it by an EMA of the batch maxima
(`log2_ema_update`).
"""
from __future__ import annotations

import torch

from dgq_tpu_torch.parallel.mesh import batch_reduce_
from dgq_tpu_torch.quant.affine import quant_bounds
from dgq_tpu_torch.quant.scalers import lp_loss

QUANTILES = (0.999, 0.9999, 0.99999)


def _apply(x: torch.Tensor, delta, nb: int, pb: int) -> torch.Tensor:
    x_q = torch.clamp(torch.round(-torch.log2(x / delta)), nb, pb)
    return (2.0 ** (-x_q)) * delta


def tail_quantiles(flat: torch.Tensor, qs) -> list:
    """`jnp.quantile(flat, q)` (linear interpolation, float32 arithmetic:
    position q * (n - 1), weights 1 - frac and frac, and the sum
    low * (1 - frac) + high * frac with its second product fused, one
    rounding, as XLA compiles it) for each q of `qs`.

    `torch.quantile` refuses inputs over 2^24 elements, and a 64px
    self-attention softmax at calibration batch 8 holds about 1.07e9. Every q
    here lies in the top of the distribution, so only the largest
    n - floor(min(q) * (n - 1)) values are taken (`topk`, sorted) instead of
    sorting the whole tensor."""
    n = flat.numel()
    f32 = torch.float32
    # the position in float32, as JAX computes it (n itself rounds above 2^24)
    pos = [torch.tensor(q, dtype=f32) * (torch.tensor(float(n), dtype=f32) - 1) for q in qs]
    lows = [min(int(torch.floor(p)), n - 1) for p in pos]
    highs = [min(int(torch.ceil(p)), n - 1) for p in pos]
    k = n - min(lows)
    top = torch.topk(flat, k, sorted=True).values  # descending: index i is top[n - 1 - i]
    out = []
    for p, lo, hi in zip(pos, lows, highs):
        hw = (p - torch.floor(p)).to(flat.device)
        lw = 1.0 - hw
        low = top[n - 1 - lo].to(f32) * lw
        # fma(high, frac, low * (1 - frac)): the float64 product is exact
        out.append((top[n - 1 - hi].double() * hw.double() + low.double()).to(f32))
    return out


def log2_init_delta(x: torch.Tensor, bits: int, symmetric: bool = False,
                    always_zero: bool = True) -> torch.Tensor:
    """Quantile search for the static delta: the first of the 0.999, 0.9999
    and 0.99999 quantiles with a strictly lower mean squared error than the
    ones before it (starting from max(x) at error 1e10)."""
    nb, pb = quant_bounds(bits, symmetric, always_zero)
    best_score = torch.tensor(1e10, dtype=x.dtype, device=x.device)
    best_delta = x.max()
    for d in tail_quantiles(x.reshape(-1), QUANTILES):
        score = lp_loss(x, _apply(x, d, nb, pb), p=2.0)
        take = score < best_score
        best_score = torch.where(take, score, best_score)
        best_delta = torch.where(take, d.to(best_delta.dtype), best_delta)
    return best_delta


def log2_fake_quant(x: torch.Tensor, delta, bits: int, symmetric: bool = False,
                    always_zero: bool = True) -> torch.Tensor:
    """Static-delta log2 quantize-dequantize."""
    nb, pb = quant_bounds(bits, symmetric, always_zero)
    return _apply(x, torch.as_tensor(delta, device=x.device), nb, pb)


def log2_real_time_quant(x: torch.Tensor, bits: int, symmetric: bool = False,
                         always_zero: bool = True) -> torch.Tensor:
    """`real_time` mode: delta = max over the whole tensor (over every
    rank's rows in a data-parallel run, `parallel.mesh.batch_reduce_`)."""
    nb, pb = quant_bounds(bits, symmetric, always_zero)
    return _apply(x, batch_reduce_(x.max(), "max"), nb, pb)


def log2_ema_update(delta, x: torch.Tensor, momentum: float = 0.95) -> torch.Tensor:
    """EMA delta update during running-stat passes (x: the batch, or its max)."""
    return momentum * delta + (1.0 - momentum) * torch.as_tensor(x).max()
