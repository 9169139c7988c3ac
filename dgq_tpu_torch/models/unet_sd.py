"""SD v1.4 UNet on NHWC tensors (port of `dgq_tpu/models/unet_sd.py`).

The hardcoded SD v1.4 topology (320/640/1280 channels, one-layer
transformers, twelve skip connections) as a function over a flat params
dict keyed by the reference state-dict paths. The reconstruction capture
(`record`, `inject_at`) is a calibration tool and waits for slice 5.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from dgq_tpu_torch.models.layers import (
    basic_transformer_block,
    conv2d,
    group_norm,
    quant_conv2d,
    quant_linear,
    resnet_block,
    silu,
    timestep_embedding,
    upsample_nearest2x,
)
from dgq_tpu_torch.models.qconfig import QConfig, QState

NUM_HEADS = 8
CROSS_DIM = 768


def transformer_2d(p, prefix, x, ehs, n_layers, qstate, cfg):
    """Transformer2DModel with conv proj_in/proj_out."""
    b, h, w, c = x.shape
    res = x
    x = group_norm(p[f"{prefix}.norm"], x, eps=1e-6)
    x = quant_conv2d(p[f"{prefix}.proj_in"], x, f"{prefix}.proj_in", qstate, cfg, 1, 0)
    inner = x.shape[-1]
    x = x.reshape(b, h * w, inner)
    for i in range(n_layers):
        x = basic_transformer_block(p, f"{prefix}.transformer_blocks.{i}", x, ehs,
                                    NUM_HEADS, qstate, cfg)
    x = x.reshape(b, h, w, inner)
    x = quant_conv2d(p[f"{prefix}.proj_out"], x, f"{prefix}.proj_out", qstate, cfg, 1, 0)
    return x + res


def cross_attn_down_block(p, prefix, x, temb, ehs, qstate, cfg, has_shortcut, has_down):
    skips = []
    for i in range(2):
        x = resnet_block(p, f"{prefix}.resnets.{i}", x, temb, qstate, cfg,
                         has_shortcut and i == 0)
        x = transformer_2d(p, f"{prefix}.attentions.{i}", x, ehs, 1, qstate, cfg)
        skips.append(x)
    if has_down:
        name = f"{prefix}.downsamplers.0.conv"
        x = quant_conv2d(p[name], x, name, qstate, cfg, 2, 1)
        skips.append(x)
    return x, skips


def down_block(p, prefix, x, temb, qstate, cfg):
    skips = []
    for i in range(2):
        x = resnet_block(p, f"{prefix}.resnets.{i}", x, temb, qstate, cfg, False)
        skips.append(x)
    return x, skips


def cross_attn_up_block(p, prefix, x, skips, temb, ehs, qstate, cfg, has_up):
    for i in range(3):
        x = torch.cat([x, skips.pop()], dim=-1)
        x = resnet_block(p, f"{prefix}.resnets.{i}", x, temb, qstate, cfg, True)
        x = transformer_2d(p, f"{prefix}.attentions.{i}", x, ehs, 1, qstate, cfg)
    if has_up:
        x = upsample_nearest2x(x)
        name = f"{prefix}.upsamplers.0.conv"
        x = quant_conv2d(p[name], x, name, qstate, cfg, 1, 1)
    return x


def up_block(p, prefix, x, skips, temb, qstate, cfg):
    for i in range(3):
        x = torch.cat([x, skips.pop()], dim=-1)
        x = resnet_block(p, f"{prefix}.resnets.{i}", x, temb, qstate, cfg, True)
    x = upsample_nearest2x(x)
    name = f"{prefix}.upsamplers.0.conv"
    return quant_conv2d(p[name], x, name, qstate, cfg, 1, 1)


def mid_block(p, prefix, x, temb, ehs, qstate, cfg):
    x = resnet_block(p, f"{prefix}.resnets.0", x, temb, qstate, cfg, False)
    x = transformer_2d(p, f"{prefix}.attentions.0", x, ehs, 1, qstate, cfg)
    return resnet_block(p, f"{prefix}.resnets.1", x, temb, qstate, cfg, False)


def unet_sd_apply(params: dict, sample: torch.Tensor, timesteps: torch.Tensor,
                  encoder_hidden_states: torch.Tensor, qstate: Optional[QState] = None,
                  cfg: QConfig = QConfig()) -> torch.Tensor:
    """UNet forward. sample is NHWC (B, 64, 64, 4); timesteps (B,) or a
    scalar tensor."""
    if timesteps.dim() == 0:
        timesteps = timesteps.expand(sample.shape[0])
    base = params["conv_in"]["w"].shape[0]  # 320 for real SD v1.4
    t_emb = timestep_embedding(timesteps, base).to(sample.dtype)
    emb = quant_linear(params["time_embedding.linear_1"], t_emb,
                       "time_embedding.linear_1", qstate, cfg)
    emb = quant_linear(params["time_embedding.linear_2"], silu(emb),
                       "time_embedding.linear_2", qstate, cfg)

    # conv_in / conv_out are never quantized
    x = conv2d(params["conv_in"], sample, 1, 1)
    ehs = encoder_hidden_states
    s0 = x
    x, (s1, s2, s3) = cross_attn_down_block(params, "down_blocks.0", x, emb, ehs,
                                            qstate, cfg, False, True)
    x, (s4, s5, s6) = cross_attn_down_block(params, "down_blocks.1", x, emb, ehs,
                                            qstate, cfg, True, True)
    x, (s7, s8, s9) = cross_attn_down_block(params, "down_blocks.2", x, emb, ehs,
                                            qstate, cfg, True, True)
    x, (s10, s11) = down_block(params, "down_blocks.3", x, emb, qstate, cfg)
    x = mid_block(params, "mid_block", x, emb, ehs, qstate, cfg)
    x = up_block(params, "up_blocks.0", x, [s9, s10, s11], emb, qstate, cfg)
    x = cross_attn_up_block(params, "up_blocks.1", x, [s6, s7, s8], emb, ehs, qstate, cfg, True)
    x = cross_attn_up_block(params, "up_blocks.2", x, [s3, s4, s5], emb, ehs, qstate, cfg, True)
    x = cross_attn_up_block(params, "up_blocks.3", x, [s0, s1, s2], emb, ehs, qstate, cfg, False)
    x = silu(group_norm(params["conv_norm_out"], x))
    return conv2d(params["conv_out"], x, 1, 1)


# --------------------------------------------------------------------------
# Model spec: (name, kind, meta) for init / conversion / quantization.
# conv meta: (cin, cout, k, stride, pad); linear meta: (cin, cout, bias).
# --------------------------------------------------------------------------
def _transformer_spec(prefix, inner, cross):
    out = []
    for attn, kvdim in ((f"{prefix}.attn1", inner), (f"{prefix}.attn2", cross)):
        out += [
            (f"{attn}.to_q", "linear", (inner, inner, False)),
            (f"{attn}.to_k", "linear", (kvdim, inner, False)),
            (f"{attn}.to_v", "linear", (kvdim, inner, False)),
            (f"{attn}.to_out.0", "linear", (inner, inner, True)),
        ]
    out += [
        (f"{prefix}.norm1", "layernorm", (inner,)),
        (f"{prefix}.norm2", "layernorm", (inner,)),
        (f"{prefix}.norm3", "layernorm", (inner,)),
        (f"{prefix}.ff.net.0.proj", "linear", (inner, inner * 8, True)),
        (f"{prefix}.ff.net.2", "linear", (inner * 4, inner, True)),
    ]
    return out


def _resnet_spec(prefix, cin, cout, shortcut, temb_dim):
    out = [
        (f"{prefix}.norm1", "groupnorm", (cin,)),
        (f"{prefix}.conv1", "conv", (cin, cout, 3, 1, 1)),
        (f"{prefix}.time_emb_proj", "linear", (temb_dim, cout, True)),
        (f"{prefix}.norm2", "groupnorm", (cout,)),
        (f"{prefix}.conv2", "conv", (cout, cout, 3, 1, 1)),
    ]
    if shortcut:
        out.append((f"{prefix}.conv_shortcut", "conv", (cin, cout, 1, 1, 0)))
    return out


def _transformer2d_spec(prefix, c, n_layers, cross):
    out = [
        (f"{prefix}.norm", "groupnorm", (c,)),
        (f"{prefix}.proj_in", "conv", (c, c, 1, 1, 0)),
        (f"{prefix}.proj_out", "conv", (c, c, 1, 1, 0)),
    ]
    for i in range(n_layers):
        out += _transformer_spec(f"{prefix}.transformer_blocks.{i}", c, cross)
    return out


def sd_unet_spec(base: int = 320, cross: int = CROSS_DIM):
    """Full layer spec for SD v1.4 (base=320, cross=768); smaller values give
    a structurally identical tiny model for tests."""
    c1, c2, c3 = base, base * 2, base * 4
    temb = base * 4
    spec = [
        ("conv_in", "conv", (4, c1, 3, 1, 1)),
        ("time_embedding.linear_1", "linear", (c1, temb, True)),
        ("time_embedding.linear_2", "linear", (temb, temb, True)),
        ("conv_norm_out", "groupnorm", (c1,)),
        ("conv_out", "conv", (c1, 4, 3, 1, 1)),
    ]
    for bi, (cin0, cout) in enumerate([(c1, c1), (c1, c2), (c2, c3)]):
        pre = f"down_blocks.{bi}"
        spec += _resnet_spec(f"{pre}.resnets.0", cin0, cout, bi != 0, temb)
        spec += _resnet_spec(f"{pre}.resnets.1", cout, cout, False, temb)
        spec += _transformer2d_spec(f"{pre}.attentions.0", cout, 1, cross)
        spec += _transformer2d_spec(f"{pre}.attentions.1", cout, 1, cross)
        spec += [(f"{pre}.downsamplers.0.conv", "conv", (cout, cout, 3, 2, 1))]
    spec += _resnet_spec("down_blocks.3.resnets.0", c3, c3, False, temb)
    spec += _resnet_spec("down_blocks.3.resnets.1", c3, c3, False, temb)
    spec += _resnet_spec("mid_block.resnets.0", c3, c3, False, temb)
    spec += _resnet_spec("mid_block.resnets.1", c3, c3, False, temb)
    spec += _transformer2d_spec("mid_block.attentions.0", c3, 1, cross)
    for i in range(3):
        spec += _resnet_spec(f"up_blocks.0.resnets.{i}", c3 + c3, c3, True, temb)
    spec += [("up_blocks.0.upsamplers.0.conv", "conv", (c3, c3, 3, 1, 1))]
    for pre, cout, prev, cin, has_up in [
        ("up_blocks.1", c3, c3, c2, True),
        ("up_blocks.2", c2, c3, c1, True),
        ("up_blocks.3", c1, c2, c1, False),
    ]:
        extras = [prev, cout, cin]
        for i in range(3):
            spec += _resnet_spec(f"{pre}.resnets.{i}", cout + extras[i], cout, True, temb)
            spec += _transformer2d_spec(f"{pre}.attentions.{i}", cout, 1, cross)
        if has_up:
            spec += [(f"{pre}.upsamplers.0.conv", "conv", (cout, cout, 3, 1, 1))]
    return spec


def quantizable_layers(spec=None):
    """Conv/linear layers (the reference wraps every one; conv_in/conv_out
    keep float weights at fold time but are listed)."""
    spec = spec or sd_unet_spec()
    return [(n, k, m) for (n, k, m) in spec if k in ("conv", "linear")]


@torch.no_grad()
def init_unet_sd(generator: torch.Generator, device="cuda", dtype=torch.float32,
                 spec=None) -> dict:
    """Random params of reference shapes (OIHW convs, (O, I) linears),
    N(0, 1/fan_in) weights, zero biases, unit norms. Drawn on `device` from
    `generator` (which must live on that device), so a full-width model never
    passes through the host."""
    spec = spec if spec is not None else sd_unet_spec()

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w / math.sqrt(fan_in)).to(dtype)

    params = {}
    for name, kind, meta in spec:
        if kind == "conv":
            cin, cout, ksz, _, _ = meta
            params[name] = {"w": normal((cout, cin, ksz, ksz), cin * ksz * ksz),
                            "b": torch.zeros(cout, dtype=dtype, device=device)}
        elif kind == "linear":
            cin, cout, bias = meta
            params[name] = {"w": normal((cout, cin), cin),
                            "b": torch.zeros(cout, dtype=dtype, device=device) if bias else None}
        else:
            (c,) = meta
            params[name] = {"scale": torch.ones(c, dtype=dtype, device=device),
                            "bias": torch.zeros(c, dtype=dtype, device=device)}
    return params
