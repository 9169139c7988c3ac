"""NHWC layer primitives with quantization hook points (port of the deploy
half of `dgq_tpu/models/layers.py`).

Activations stay NHWC, as in the JAX package, so the two compare like with
like; a conv views its input as NCHW with `permute` (a channels_last view,
no copy) and runs `F.conv2d` on OIHW weights. Weights arrive already
fake-quantized (folded at load); activation quantizers apply through
`aq_apply`. Attention runs the fused kernels (`ops.attention`) when
`cfg.use_pallas_attention`, and the materialized softmax otherwise.

Params are dicts: conv {'w': OIHW, 'b': (O,)}, linear {'w': (O, I), 'b'},
norms {'scale', 'bias'}.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from dgq_tpu_torch.models.qconfig import QConfig, QState, aq_apply, softmax_q_apply
from dgq_tpu_torch.ops.attention import fused_attention


def linear(p, x: torch.Tensor) -> torch.Tensor:
    y = F.linear(x, p["w"].to(x.dtype))
    if p.get("b") is not None:
        y = y + p["b"]
    return y


def conv2d(p, x: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """NHWC conv with OIHW weights."""
    y = F.conv2d(x.permute(0, 3, 1, 2), p["w"].to(x.dtype), stride=stride, padding=padding)
    y = y.permute(0, 2, 3, 1)
    if p.get("b") is not None:
        y = y + p["b"]
    return y


def quant_conv2d(p, x: torch.Tensor, name: str, qstate: Optional[QState], cfg: QConfig,
                 stride: int = 1, padding: int = 0) -> torch.Tensor:
    """QuantLayer-conv forward: activation fake-quant, then the conv. The
    conv keeps the activation's own dtype (the quantizer's f32 delta would
    otherwise upcast a bf16 run)."""
    return conv2d(p, aq_apply(qstate, cfg, name, x).to(x.dtype), stride, padding)


def quant_linear(p, x: torch.Tensor, name: str, qstate: Optional[QState],
                 cfg: QConfig) -> torch.Tensor:
    """QuantLayer-linear forward: activation fake-quant, then the matmul in
    the activation's own dtype."""
    return linear(p, aq_apply(qstate, cfg, name, x).to(x.dtype))


def group_norm(p, x: torch.Tensor, groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over NHWC: one pass of per-channel f32 sum and sum of
    squares, group aggregation on the (B, C) partials, then x*A + B in the
    input dtype."""
    b, h, w, c = x.shape
    cg = c // groups
    xf = x.float()
    s1 = xf.sum(dim=(1, 2))
    s2 = (xf * xf).sum(dim=(1, 2))
    g1 = s1.reshape(b, groups, cg).sum(dim=2)
    g2 = s2.reshape(b, groups, cg).sum(dim=2)
    n = h * w * cg
    mean = g1 / n
    var = g2 / n - mean * mean
    rstd = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(cg, dim=1)
    rstd_c = rstd.repeat_interleave(cg, dim=1)
    a = rstd_c * p["scale"].float()[None, :]
    bb = p["bias"].float()[None, :] - mean_c * a
    out = xf * a[:, None, None, :] + bb[:, None, None, :]
    return out.to(x.dtype)


def layer_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, one-pass f32 statistics."""
    xf = x.float()
    s1 = xf.sum(dim=-1, keepdim=True)
    s2 = (xf * xf).sum(dim=-1, keepdim=True)
    n = x.shape[-1]
    mean = s1 / n
    var = s2 / n - mean * mean
    rstd = torch.rsqrt(var + eps)
    a = rstd * p["scale"].float()
    out = xf * a + (p["bias"].float() - mean * a)
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def timestep_embedding(timesteps: torch.Tensor, num_channels: int = 320) -> torch.Tensor:
    """Sinusoidal timestep projection, cos then sin. Arguments reach ~1000
    rad, so they are reduced mod 2*pi first."""
    half = num_channels // 2
    exponent = (-math.log(10000.0)
                * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    two_pi = 2.0 * math.pi
    emb = emb - two_pi * torch.floor(emb / two_pi)
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


def geglu_ff(p, prefix: str, x: torch.Tensor, qstate, cfg) -> torch.Tensor:
    """GEGLU feed-forward: proj -> chunk -> x1 * gelu(x2) (exact erf)."""
    h = quant_linear(p[f"{prefix}.net.0.proj"], x, f"{prefix}.net.0.proj", qstate, cfg)
    x1, x2 = h.chunk(2, dim=-1)
    h = x1 * F.gelu(x2)
    return quant_linear(p[f"{prefix}.net.2"], h, f"{prefix}.net.2", qstate, cfg)


def _sm_select(qstate, cfg: QConfig, prefix: str):
    """Softmax-quant mode + static delta for the fused attention."""
    if cfg.use_aq and cfg.t2i_log_quant:
        sm_mode = "log2_real_time" if cfg.t2i_real_time else "log2"
        sm_delta = (
            torch.ones(()) if cfg.log_max_1
            else (qstate or {}).get("sm", {}).get(f"{prefix}.aqtizer_w")
        )
        if sm_mode == "log2" and sm_delta is None:
            sm_mode = "none"
        return sm_mode, sm_delta
    if cfg.use_aq and (qstate or {}).get("a", {}).get(f"{prefix}.aqtizer_w") is not None:
        # the kernel quantizes with zero point 0, exact for aqtizer_w, which
        # the reference builds always_zero
        return "uniform", qstate["a"][f"{prefix}.aqtizer_w"].delta
    return "none", None


def attention(p, prefix: str, x: torch.Tensor, ehs: Optional[torch.Tensor],
              num_heads: int, qstate: Optional[QState], cfg: QConfig,
              start_peak: bool = False) -> torch.Tensor:
    """Quantization-aware attention. Quant points: aqtizer_q on q, aqtizer_k
    on k (sparing key 0 under start_peak), aqtizer_w on the f32
    post-softmax weights (again sparing key 0), aqtizer_v on v."""
    b, t, c = x.shape
    head_dim = c // num_heads
    scale = head_dim ** -0.5

    q = quant_linear(p[f"{prefix}.to_q"], x, f"{prefix}.to_q", qstate, cfg)
    kv_in = ehs if ehs is not None else x
    k = quant_linear(p[f"{prefix}.to_k"], kv_in, f"{prefix}.to_k", qstate, cfg)
    v = quant_linear(p[f"{prefix}.to_v"], kv_in, f"{prefix}.to_v", qstate, cfg)
    s = kv_in.shape[1]

    q = q.reshape(b, t, num_heads, head_dim).permute(0, 2, 1, 3)
    k = k.reshape(b, s, num_heads, head_dim).permute(0, 2, 1, 3)
    v = v.reshape(b, s, num_heads, head_dim).permute(0, 2, 1, 3)

    q = aq_apply(qstate, cfg, f"{prefix}.aqtizer_q", q)
    if start_peak:
        k = torch.cat([k[..., 0:1, :],
                       aq_apply(qstate, cfg, f"{prefix}.aqtizer_k", k[..., 1:, :])], dim=-2)
    else:
        k = aq_apply(qstate, cfg, f"{prefix}.aqtizer_k", k)
    v = aq_apply(qstate, cfg, f"{prefix}.aqtizer_v", v)

    if cfg.use_pallas_attention:
        sm_mode, sm_delta = _sm_select(qstate, cfg, prefix)
        out = fused_attention(
            q.reshape(b * num_heads, t, head_dim),
            k.reshape(b * num_heads, s, head_dim),
            v.reshape(b * num_heads, s, head_dim),
            scale, sm_mode=sm_mode, sm_bits=cfg.softmax_bits, sm_delta=sm_delta,
            start_peak=start_peak and cfg.use_aq,
        )
        out = out.reshape(b, num_heads, t, head_dim)
    else:
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        attn = torch.softmax(scores, dim=-1)
        if start_peak:
            attn = torch.cat([
                attn[..., 0:1],
                softmax_q_apply(qstate, cfg, f"{prefix}.aqtizer_w", attn[..., 1:])], dim=-1)
        else:
            attn = softmax_q_apply(qstate, cfg, f"{prefix}.aqtizer_w", attn)
        out = torch.matmul(attn.to(v.dtype), v)
    out = out.permute(0, 2, 1, 3).reshape(b, t, c).to(x.dtype)
    return quant_linear(p[f"{prefix}.to_out.0"], out, f"{prefix}.to_out.0", qstate, cfg)


def basic_transformer_block(p, prefix: str, x: torch.Tensor, ehs: Optional[torch.Tensor],
                            num_heads: int, qstate, cfg: QConfig) -> torch.Tensor:
    """Self-attn -> cross-attn -> GEGLU FF, each residual. start_peak
    applies only to the cross attention (attn2)."""
    h = layer_norm(p[f"{prefix}.norm1"], x)
    x = attention(p, f"{prefix}.attn1", h, None, num_heads, qstate, cfg) + x
    h = layer_norm(p[f"{prefix}.norm2"], x)
    x = attention(p, f"{prefix}.attn2", h, ehs, num_heads, qstate, cfg,
                  start_peak=cfg.t2i_start_peak) + x
    h = layer_norm(p[f"{prefix}.norm3"], x)
    return geglu_ff(p, f"{prefix}.ff", h, qstate, cfg) + x


def resnet_block(p, prefix: str, x: torch.Tensor, temb: torch.Tensor, qstate,
                 cfg: QConfig, has_shortcut: bool) -> torch.Tensor:
    """ResnetBlock2D, NHWC."""
    h = silu(group_norm(p[f"{prefix}.norm1"], x))
    h = quant_conv2d(p[f"{prefix}.conv1"], h, f"{prefix}.conv1", qstate, cfg, 1, 1)
    te = quant_linear(p[f"{prefix}.time_emb_proj"], silu(temb),
                      f"{prefix}.time_emb_proj", qstate, cfg)
    h = h + te[:, None, None, :]
    h = silu(group_norm(p[f"{prefix}.norm2"], h))
    h = quant_conv2d(p[f"{prefix}.conv2"], h, f"{prefix}.conv2", qstate, cfg, 1, 1)
    if has_shortcut:
        x = quant_conv2d(p[f"{prefix}.conv_shortcut"], x, f"{prefix}.conv_shortcut",
                         qstate, cfg, 1, 0)
    return x + h


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return x.reshape(b, h * 2, w * 2, c)
