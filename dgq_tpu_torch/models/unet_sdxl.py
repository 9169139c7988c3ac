"""SDXL-turbo UNet on NHWC tensors (port of `dgq_tpu/models/unet_sdxl.py`).

Differences from SD v1.4 (`unet_sd`):
  * linear (not conv) proj_in/proj_out, applied after/before the token
    reshape;
  * 3 down blocks: plain DownBlock2D(320) with downsampler, CrossAttn(640,
    2 layers), CrossAttn(1280, 10 layers, no downsampler); the mid block has
    a 10-layer transformer; 3 up blocks mirror it; the final UpBlock2D has no
    upsampler;
  * additional conditioning: a sinusoidal projection (256) of time_ids and
    the add_embedding MLP over [text_embeds, time_embeds];
  * cross-attention dim 2048; heads = channels / 64;
  * the CrossAttn down blocks' first resnet always has a conv shortcut.
"""
from __future__ import annotations

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
from dgq_tpu_torch.models.unet_sd import _resnet_spec, _transformer_spec, init_unet_sd

SDXL_CROSS = 2048


def _heads(inner: int, base: int) -> int:
    return inner // min(64, base)


def transformer_2d_linear(p, prefix, x, ehs, n_layers, base, qstate, cfg):
    """SDXL Transformer2DModel: linear proj, reshape first."""
    b, h, w, c = x.shape
    res = x
    x = group_norm(p[f"{prefix}.norm"], x, eps=1e-6)
    x = x.reshape(b, h * w, c)
    x = quant_linear(p[f"{prefix}.proj_in"], x, f"{prefix}.proj_in", qstate, cfg)
    for i in range(n_layers):
        x = basic_transformer_block(p, f"{prefix}.transformer_blocks.{i}", x, ehs,
                                    _heads(c, base), qstate, cfg)
    x = quant_linear(p[f"{prefix}.proj_out"], x, f"{prefix}.proj_out", qstate, cfg)
    return x.reshape(b, h, w, c) + res


def _n_tr_layers(p: dict, prefix: str) -> int:
    """Transformer depth of a block, read off the params dict, so tiny test
    models can shrink the 2/10-layer stacks."""
    n = 0
    while f"{prefix}.transformer_blocks.{n}.attn1.to_q" in p:
        n += 1
    return n


def unet_sdxl_apply(params: dict, sample: torch.Tensor, timesteps: torch.Tensor,
                    encoder_hidden_states: torch.Tensor, text_embeds: torch.Tensor,
                    time_ids: torch.Tensor, qstate: Optional[QState] = None,
                    cfg: QConfig = QConfig()) -> torch.Tensor:
    """UNet forward. sample is NHWC (B, 128, 128, 4); timesteps (B,) or a
    scalar tensor; text_embeds (B, 1280); time_ids (B, 6)."""
    p = params
    ehs = encoder_hidden_states
    if timesteps.dim() == 0:
        timesteps = timesteps.expand(sample.shape[0])
    base = p["conv_in"]["w"].shape[0]
    temb_dim = p["time_embedding.linear_2"]["w"].shape[0]
    add_ch = (p["add_embedding.linear_1"]["w"].shape[1] - temb_dim) // 6

    t_emb = timestep_embedding(timesteps, base).to(sample.dtype)
    emb = quant_linear(p["time_embedding.linear_1"], t_emb, "time_embedding.linear_1", qstate, cfg)
    emb = quant_linear(p["time_embedding.linear_2"], silu(emb), "time_embedding.linear_2",
                       qstate, cfg)

    time_embeds = timestep_embedding(time_ids.reshape(-1), add_ch)
    time_embeds = time_embeds.reshape(text_embeds.shape[0], -1)
    add_embeds = torch.cat([text_embeds.float(), time_embeds], dim=-1).to(emb.dtype)
    aug = quant_linear(p["add_embedding.linear_1"], add_embeds, "add_embedding.linear_1",
                       qstate, cfg)
    aug = quant_linear(p["add_embedding.linear_2"], silu(aug), "add_embedding.linear_2",
                       qstate, cfg)
    emb = emb + aug

    x = conv2d(p["conv_in"], sample, 1, 1)

    # down 0: plain resnets + downsampler
    s0 = x
    x = resnet_block(p, "down_blocks.0.resnets.0", x, emb, qstate, cfg, False)
    s1 = x
    x = resnet_block(p, "down_blocks.0.resnets.1", x, emb, qstate, cfg, False)
    s2 = x
    name = "down_blocks.0.downsamplers.0.conv"
    x = quant_conv2d(p[name], x, name, qstate, cfg, 2, 1)
    s3 = x

    def cross_down(prefix, x, n_layers, has_down):
        skips = []
        for i in range(2):
            x = resnet_block(p, f"{prefix}.resnets.{i}", x, emb, qstate, cfg, i == 0)
            x = transformer_2d_linear(p, f"{prefix}.attentions.{i}", x, ehs, n_layers, base,
                                      qstate, cfg)
            skips.append(x)
        if has_down:
            nm = f"{prefix}.downsamplers.0.conv"
            x = quant_conv2d(p[nm], x, nm, qstate, cfg, 2, 1)
            skips.append(x)
        return x, skips

    n_lo = _n_tr_layers(p, "down_blocks.1.attentions.0")
    n_hi = _n_tr_layers(p, "down_blocks.2.attentions.0")
    x, (s4, s5, s6) = cross_down("down_blocks.1", x, n_lo, True)
    x, (s7, s8) = cross_down("down_blocks.2", x, n_hi, False)

    # mid
    x = resnet_block(p, "mid_block.resnets.0", x, emb, qstate, cfg, False)
    x = transformer_2d_linear(p, "mid_block.attentions.0", x, ehs, n_hi, base, qstate, cfg)
    x = resnet_block(p, "mid_block.resnets.1", x, emb, qstate, cfg, False)

    def cross_up(prefix, x, skips, n_layers):
        for i in range(3):
            x = torch.cat([x, skips.pop()], dim=-1)
            x = resnet_block(p, f"{prefix}.resnets.{i}", x, emb, qstate, cfg, True)
            x = transformer_2d_linear(p, f"{prefix}.attentions.{i}", x, ehs, n_layers, base,
                                      qstate, cfg)
        x = upsample_nearest2x(x)
        nm = f"{prefix}.upsamplers.0.conv"
        return quant_conv2d(p[nm], x, nm, qstate, cfg, 1, 1)

    x = cross_up("up_blocks.0", x, [s6, s7, s8], n_hi)
    x = cross_up("up_blocks.1", x, [s3, s4, s5], n_lo)
    # final plain up block, no upsampler
    for i, s in enumerate([s2, s1, s0]):
        x = torch.cat([x, s], dim=-1)
        x = resnet_block(p, f"up_blocks.2.resnets.{i}", x, emb, qstate, cfg, True)

    x = silu(group_norm(p["conv_norm_out"], x))
    return conv2d(p["conv_out"], x, 1, 1)


def _transformer2d_linear_spec(prefix, c, n_layers, cross):
    out = [
        (f"{prefix}.norm", "groupnorm", (c,)),
        (f"{prefix}.proj_in", "linear", (c, c, True)),
        (f"{prefix}.proj_out", "linear", (c, c, True)),
    ]
    for i in range(n_layers):
        out += _transformer_spec(f"{prefix}.transformer_blocks.{i}", c, cross)
    return out


def sdxl_unet_spec(base: int = 320, cross: int = SDXL_CROSS, add_ch: int = 256,
                   depths: tuple = (2, 10)):
    """Layer spec for the SDXL-turbo UNet. depths = (low-res transformer
    depth, high-res depth): (2, 10) for the real model; tests shrink it
    (unet_sdxl_apply reads the depth from the params)."""
    d_lo, d_hi = depths
    c1, c2, c3 = base, base * 2, base * 4
    temb = base * 4
    spec = [
        ("conv_in", "conv", (4, c1, 3, 1, 1)),
        ("time_embedding.linear_1", "linear", (c1, temb, True)),
        ("time_embedding.linear_2", "linear", (temb, temb, True)),
        ("add_embedding.linear_1", "linear", (temb + add_ch * 6, temb, True)),
        ("add_embedding.linear_2", "linear", (temb, temb, True)),
        ("conv_norm_out", "groupnorm", (c1,)),
        ("conv_out", "conv", (c1, 4, 3, 1, 1)),
    ]
    # down 0: plain
    spec += _resnet_spec("down_blocks.0.resnets.0", c1, c1, False, temb)
    spec += _resnet_spec("down_blocks.0.resnets.1", c1, c1, False, temb)
    spec += [("down_blocks.0.downsamplers.0.conv", "conv", (c1, c1, 3, 2, 1))]
    # down 1 & 2 (cross attn)
    for pre, cin, cout, n_layers, has_down in [
        ("down_blocks.1", c1, c2, d_lo, True),
        ("down_blocks.2", c2, c3, d_hi, False),
    ]:
        spec += _resnet_spec(f"{pre}.resnets.0", cin, cout, True, temb)
        spec += _resnet_spec(f"{pre}.resnets.1", cout, cout, False, temb)
        spec += _transformer2d_linear_spec(f"{pre}.attentions.0", cout, n_layers, cross)
        spec += _transformer2d_linear_spec(f"{pre}.attentions.1", cout, n_layers, cross)
        if has_down:
            spec += [(f"{pre}.downsamplers.0.conv", "conv", (cout, cout, 3, 2, 1))]
    # mid
    spec += _resnet_spec("mid_block.resnets.0", c3, c3, False, temb)
    spec += _resnet_spec("mid_block.resnets.1", c3, c3, False, temb)
    spec += _transformer2d_linear_spec("mid_block.attentions.0", c3, d_hi, cross)
    # up
    for pre, cout, prev, cin, n_layers in [
        ("up_blocks.0", c3, c3, c2, d_hi),
        ("up_blocks.1", c2, c3, c1, d_lo),
    ]:
        extras = [prev, cout, cin]
        for i in range(3):
            spec += _resnet_spec(f"{pre}.resnets.{i}", cout + extras[i], cout, True, temb)
            spec += _transformer2d_linear_spec(f"{pre}.attentions.{i}", cout, n_layers, cross)
        spec += [(f"{pre}.upsamplers.0.conv", "conv", (cout, cout, 3, 1, 1))]
    # up 2: plain, no upsampler
    extras = [c2, c1, c1]
    for i in range(3):
        spec += _resnet_spec(f"up_blocks.2.resnets.{i}", c1 + extras[i], c1, True, temb)
    return spec


def init_unet_sdxl(generator: torch.Generator, device="cuda", base: int = 320,
                   cross: int = SDXL_CROSS, add_ch: int = 256,
                   dtype: torch.dtype = torch.float32) -> dict:
    """Random params of the SDXL-turbo UNet's shapes, drawn on `device`."""
    return init_unet_sd(generator, device, dtype, spec=sdxl_unet_spec(base, cross, add_ch))
