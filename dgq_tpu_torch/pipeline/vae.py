"""Stable Diffusion KL-VAE decoder on NHWC tensors (port of the decoder of
`dgq_tpu/pipeline/vae.py`).

post_quant_conv (1x1, 4->4), conv_in 4->512, mid (resnet / single-head
spatial attention / resnet), 4 up stages of 3 resnets (512, 512, 256, 128)
with nearest-2x upsampling between, GroupNorm+SiLU+conv_out -> RGB. Latents
are scaled by 1/0.18215 first (SD v1.4), or 1/0.13025 (SDXL, whose decoder
has the same architecture; pass `scale=SDXL_VAE_SCALE`).

The mid-block attention always goes through `fused_attention`: on the GPU
that is the K2 flash kernel, which streams K/V through shared memory, so the
TPU's VMEM cap and its chunked-softmax branch do not apply; on the CPU it is
the plain materialized softmax.
"""
from __future__ import annotations

import torch

from dgq_tpu_torch.models.layers import conv2d, group_norm, linear, silu, upsample_nearest2x
from dgq_tpu_torch.models.unet_sd import init_unet_sd
from dgq_tpu_torch.ops.attention import fused_attention

SD_VAE_SCALE = 0.18215
SDXL_VAE_SCALE = 0.13025


def _resnet(p, prefix, x):
    h = conv2d(p[f"{prefix}.conv1"], silu(group_norm(p[f"{prefix}.norm1"], x, eps=1e-6)), 1, 1)
    h = conv2d(p[f"{prefix}.conv2"], silu(group_norm(p[f"{prefix}.norm2"], h, eps=1e-6)), 1, 1)
    if f"{prefix}.conv_shortcut" in p:
        x = conv2d(p[f"{prefix}.conv_shortcut"], x, 1, 0)
    return x + h


def _attn(p, prefix, x):
    b, h, w, c = x.shape
    res = x
    x = group_norm(p[f"{prefix}.group_norm"], x, eps=1e-6).reshape(b, h * w, c)
    q = linear(p[f"{prefix}.to_q"], x)
    k = linear(p[f"{prefix}.to_k"], x)
    v = linear(p[f"{prefix}.to_v"], x)
    # one head of width c: (B, T, c) is already the (BH, T, D) layout
    o = fused_attention(q.contiguous(), k.contiguous(), v.contiguous(), c ** -0.5,
                        sm_mode="none")
    o = linear(p[f"{prefix}.to_out.0"], o)
    return o.reshape(b, h, w, c) + res


@torch.no_grad()
def vae_decode(params: dict, latents: torch.Tensor, scale: float = SD_VAE_SCALE) -> torch.Tensor:
    """latents NHWC (B, h, w, 4) -> images NHWC (B, 8h, 8w, 3) in about [-1, 1]."""
    x = latents / scale
    x = conv2d(params["post_quant_conv"], x, 1, 0)
    x = conv2d(params["decoder.conv_in"], x, 1, 1)
    x = _resnet(params, "decoder.mid_block.resnets.0", x)
    x = _attn(params, "decoder.mid_block.attentions.0", x)
    x = _resnet(params, "decoder.mid_block.resnets.1", x)
    for i in range(4):
        for j in range(3):
            x = _resnet(params, f"decoder.up_blocks.{i}.resnets.{j}", x)
        if i < 3:
            x = conv2d(params[f"decoder.up_blocks.{i}.upsamplers.0.conv"],
                       upsample_nearest2x(x), 1, 1)
    x = silu(group_norm(params["decoder.conv_norm_out"], x, eps=1e-6))
    return conv2d(params["decoder.conv_out"], x, 1, 1)


def vae_decoder_spec(base: int = 128):
    """(name, kind, meta) spec. base=128 is real SD; smaller for tests.
    Channels: conv_in -> 4*base; up stages [4b, 4b, 2b, b]."""
    c4, c2, c1 = base * 4, base * 2, base
    spec = [
        ("post_quant_conv", "conv", (4, 4, 1, 1, 0)),
        ("decoder.conv_in", "conv", (4, c4, 3, 1, 1)),
        ("decoder.conv_norm_out", "groupnorm", (c1,)),
        ("decoder.conv_out", "conv", (c1, 3, 3, 1, 1)),
    ]
    for pre in ("decoder.mid_block.resnets.0", "decoder.mid_block.resnets.1"):
        spec += [
            (f"{pre}.norm1", "groupnorm", (c4,)),
            (f"{pre}.conv1", "conv", (c4, c4, 3, 1, 1)),
            (f"{pre}.norm2", "groupnorm", (c4,)),
            (f"{pre}.conv2", "conv", (c4, c4, 3, 1, 1)),
        ]
    spec += [
        ("decoder.mid_block.attentions.0.group_norm", "groupnorm", (c4,)),
        ("decoder.mid_block.attentions.0.to_q", "linear", (c4, c4, True)),
        ("decoder.mid_block.attentions.0.to_k", "linear", (c4, c4, True)),
        ("decoder.mid_block.attentions.0.to_v", "linear", (c4, c4, True)),
        ("decoder.mid_block.attentions.0.to_out.0", "linear", (c4, c4, True)),
    ]
    cin = c4
    for i, cout in enumerate([c4, c4, c2, c1]):
        for j in range(3):
            pre = f"decoder.up_blocks.{i}.resnets.{j}"
            spec += [
                (f"{pre}.norm1", "groupnorm", (cin,)),
                (f"{pre}.conv1", "conv", (cin, cout, 3, 1, 1)),
                (f"{pre}.norm2", "groupnorm", (cout,)),
                (f"{pre}.conv2", "conv", (cout, cout, 3, 1, 1)),
            ]
            if cin != cout:
                spec += [(f"{pre}.conv_shortcut", "conv", (cin, cout, 1, 1, 0))]
            cin = cout
        if i < 3:
            spec += [(f"decoder.up_blocks.{i}.upsamplers.0.conv", "conv", (cout, cout, 3, 1, 1))]
    return spec


def init_vae_decoder(generator: torch.Generator, device="cuda", base: int = 128,
                     dtype=torch.float32) -> dict:
    return init_unet_sd(generator, device, dtype, spec=vae_decoder_spec(base))
