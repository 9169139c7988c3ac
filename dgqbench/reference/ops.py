"""Plain layers and DGQ's quantizers, written from the published
descriptions, for the benchmark's reference.

Tensors are NHWC (images) or (B, T, C) (tokens); conv weights OIHW, linear
weights (out, in). Every function computes in the dtype `dt` it is given:
float32 for the reference itself, bfloat16 for the control that stands in
for the program at the precision below the configuration's. The caller
turns TF32 off (`strict_f32`), so a float32 product here is a float32
product.

Quantizers:
  * affine A8: q = clamp(round(x / delta) + zp, 0, 2^b - 1), x_q = (q - zp) delta,
    rounding half to even;
  * W4 minmax per out channel: lo = min(w, 0), hi = max(w, 0), delta =
    (hi - lo) / (2^b - 1) (at least 1e-8), zp = round(-lo / delta);
  * DGQ group activations (every k x k conv): the unfolded input (B, C k k, L),
    mid axis c-major, one (delta, zp) per (channel, tap) row;
  * log2 softmax, real time: delta = the largest post-softmax weight of the
    whole call (both CFG halves; key 0 left out under start_peak), code =
    clamp(round(-log2(p / delta)), 0, 2^b - 1), p_q = 2^-code delta; under
    start_peak key 0 keeps its weight unquantized.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def strict_f32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def rel_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| / ||ref||, the sums in float64."""
    if got.shape != ref.shape:
        return math.inf
    d = torch.linalg.vector_norm(got.float() - ref.float(), dtype=torch.float64)
    r = torch.linalg.vector_norm(ref.float(), dtype=torch.float64)
    return float(d / r) if float(r) > 0 else (0.0 if float(d) == 0 else math.inf)


def fake_quant(x, delta, zp, bits: int):
    q = torch.clamp(torch.round(x / delta) + zp, 0, 2 ** bits - 1)
    return (q - zp) * delta


def minmax_weight_qparams(w: torch.Tensor, bits: int):
    """Per-out-channel (delta, zp) of a weight, float32, shaped to broadcast."""
    flat = w.float().reshape(w.shape[0], -1)
    lo = torch.clamp(flat.amin(dim=1), max=0.0)
    hi = torch.clamp(flat.amax(dim=1), min=0.0)
    delta = torch.clamp((hi - lo) / (2 ** bits - 1), min=1e-8)
    zp = torch.round(-lo / delta)
    shape = (-1,) + (1,) * (w.dim() - 1)
    return delta.reshape(shape), zp.reshape(shape)


def fold_weight(w: torch.Tensor, bits: int) -> torch.Tensor:
    """W4 minmax quantize-dequantize, in float32."""
    delta, zp = minmax_weight_qparams(w, bits)
    return fake_quant(w.float(), delta, zp, bits)


def linear(x, w, b=None):
    y = torch.matmul(x, w.to(x.dtype).t())
    return y if b is None else y + b.to(x.dtype)


def conv(x, w, b, stride: int, pad: int):
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), None, stride, pad).permute(0, 2, 3, 1)
    return y if b is None else y + b.to(x.dtype)


def group_quant_conv(x, w, b, delta, zp, bits: int, stride: int, pad: int):
    """Conv of the group-quantized unfolded input: delta, zp (C k k,)."""
    bsz, h, wd, c = x.shape
    o, _, k, _ = w.shape
    ho, wo = (h + 2 * pad - k) // stride + 1, (wd + 2 * pad - k) // stride + 1
    cols = F.unfold(x.permute(0, 3, 1, 2), k, padding=pad, stride=stride)  # (B, Ckk, L)
    cols = fake_quant(cols, delta.to(x.dtype)[None, :, None], zp.to(x.dtype)[None, :, None], bits)
    y = torch.matmul(w.to(x.dtype).reshape(o, -1), cols)  # (B, O, L)
    y = y.reshape(bsz, o, ho, wo).permute(0, 2, 3, 1)
    return y if b is None else y + b.to(x.dtype)


def group_norm(x, scale, bias, groups: int = 32, eps: float = 1e-5):
    y = F.group_norm(x.permute(0, 3, 1, 2), groups, scale.to(x.dtype), bias.to(x.dtype), eps)
    return y.permute(0, 2, 3, 1)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    return F.layer_norm(x, (x.shape[-1],), scale.to(x.dtype), bias.to(x.dtype), eps)


def silu(x):
    return x * torch.sigmoid(x)


def timestep_embedding(t: torch.Tensor, dim: int, dt) -> torch.Tensor:
    """Sinusoidal projection, cos then sin (flip_sin_to_cos, shift 0), in
    float64 and then cast, so that the reference carries no rounding of the
    large arguments."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float64,
                                                        device=t.device) / half)
    arg = t.double()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(arg), torch.sin(arg)], dim=-1).to(dt)


def upsample2x(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _chunks(n: int, rows: int, per_row: int, budget: int = 1 << 28) -> list:
    """Slices of range(n) whose score blocks hold about `budget` elements."""
    step = max(1, budget // max(1, rows * per_row))
    return [slice(i, min(n, i + step)) for i in range(0, n, step)]


def attention_core(q, k, v, scale: float, mode: str, bits: int = 8,
                   start_peak: bool = False):
    """softmax(q k^T scale) v over (BH, T, D) / (BH, S, D), in blocks of heads.
    mode "none" (plain) or "log2_real_time" (DGQ's softmax quantizer, its
    delta the largest weight of the whole tensor)."""
    bh, t, _ = q.shape
    s = k.shape[1]
    blocks = _chunks(bh, t, s)

    def probs(sl):
        return torch.softmax(torch.matmul(q[sl], k[sl].transpose(-1, -2)) * scale, dim=-1)

    delta = None
    if mode == "log2_real_time":
        delta = max((probs(sl)[..., 1:] if start_peak else probs(sl)).amax() for sl in blocks)
    elif mode != "none":
        raise ValueError(f"unknown softmax mode {mode!r}")
    out = torch.empty(bh, t, v.shape[-1], dtype=q.dtype, device=q.device)
    for sl in blocks:
        p = probs(sl)
        if delta is not None:
            code = torch.clamp(torch.round(-torch.log2(p / delta)), 0, 2 ** bits - 1)
            pq = torch.exp2(-code) * delta
            if start_peak:
                pq[..., 0] = p[..., 0]
            p = pq
        out[sl] = torch.matmul(p, v[sl])
    return out
