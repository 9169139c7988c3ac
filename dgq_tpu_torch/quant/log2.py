"""Log2 softmax quantizer (port of `dgq_tpu/quant/log2.py`, deploy half).

Post-softmax weights x in (0, 1] are quantized on a log2 grid:
    x_q = clamp(round(-log2(x / delta)), NB, PB);  x_dq = 2^{-x_q} * delta,
with a static (calibrated) delta, or delta = max(x) of the call
(`real_time`). The calibration search (`log2_init_delta`) waits for the
calibration slice.
"""
from __future__ import annotations

import torch

from dgq_tpu_torch.quant.affine import quant_bounds


def _apply(x: torch.Tensor, delta, nb: int, pb: int) -> torch.Tensor:
    x_q = torch.clamp(torch.round(-torch.log2(x / delta)), nb, pb)
    return (2.0 ** (-x_q)) * delta


def log2_fake_quant(x: torch.Tensor, delta, bits: int, symmetric: bool = False,
                    always_zero: bool = True) -> torch.Tensor:
    """Static-delta log2 quantize-dequantize."""
    nb, pb = quant_bounds(bits, symmetric, always_zero)
    return _apply(x, torch.as_tensor(delta, device=x.device), nb, pb)


def log2_real_time_quant(x: torch.Tensor, bits: int, symmetric: bool = False,
                         always_zero: bool = True) -> torch.Tensor:
    """`real_time` mode: delta = max over the whole tensor."""
    nb, pb = quant_bounds(bits, symmetric, always_zero)
    return _apply(x, x.max(), nb, pb)
