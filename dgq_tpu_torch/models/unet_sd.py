"""SD v1.4 UNet on NHWC tensors (port of `dgq_tpu/models/unet_sd.py`).

The hardcoded SD v1.4 topology (320/640/1280 channels, one-layer
transformers, twelve skip connections) as a function over a flat params
dict keyed by the reference state-dict paths. With `record=` the forward
stashes every reconstruction unit's (inputs, output) under the JAX
package's keys, and `inject_at` adds a tensor to a unit's output: weight
reconstruction (`calib.reconstruction`) captures units and takes the
gradient at one through them. A `CaptureUntil` record ends the forward
with `StopForward` once its unit is recorded, so a capture runs only the
UNet's prefix up to the unit.
"""
from __future__ import annotations

import contextlib
import contextvars
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
from dgq_tpu_torch.parallel.tp import out_count
from dgq_tpu_torch.utils.profiler import span, untimed_every_other

NUM_HEADS = 8
CROSS_DIM = 768

# Injection points: a tensor added to a unit's output. The gradient of a
# loss with respect to an injected zero is the gradient at the unit's output
# (the Fisher weighting of reconstruction).
_INJECT: contextvars.ContextVar = contextvars.ContextVar("dgq_inject", default=None)


@contextlib.contextmanager
def inject_at(store: dict):
    """Inside the block, every unit named in `store` gets store[name] added to
    its output."""
    token = _INJECT.set(store)
    try:
        yield
    finally:
        _INJECT.reset(token)


class StopForward(Exception):
    """Raised by `_rec` once a `CaptureUntil` record holds its unit."""


class CaptureUntil(dict):
    """A `record` that ends the forward (`StopForward`) right after `key` is
    recorded: the capture of one unit runs no layer past it. Every rank of a
    tp group runs the same forward and records the same keys, so each stops
    after the same layer, with no collective of a later layer pending."""

    def __init__(self, key: str):
        super().__init__()
        self.key = key


def _rec(record, key, inputs, out):
    """Stash a reconstruction unit's (inputs, output) when capturing, after
    adding any injection registered for it."""
    inj = _INJECT.get()
    if inj is not None and key in inj:
        out = out + inj[key]
    if record is not None:
        record[key] = (inputs, out)
        if isinstance(record, CaptureUntil) and record.key == key:
            raise StopForward(key)
    return out


def transformer_2d(p, prefix, x, ehs, n_layers, qstate, cfg, record=None):
    """Transformer2DModel with conv proj_in/proj_out."""
    b, h, w, c = x.shape
    res = x
    x = group_norm(p[f"{prefix}.norm"], x, eps=1e-6)
    x_in = x
    x = quant_conv2d(p[f"{prefix}.proj_in"], x, f"{prefix}.proj_in", qstate, cfg, 1, 0)
    x = _rec(record, f"{prefix}.proj_in", (x_in,), x)
    inner = x.shape[-1]
    x = x.reshape(b, h * w, inner)
    for i in range(n_layers):
        x_in = x
        x = basic_transformer_block(p, f"{prefix}.transformer_blocks.{i}", x, ehs,
                                    NUM_HEADS, qstate, cfg)
        x = _rec(record, f"{prefix}.transformer_blocks.{i}", (x_in, ehs), x)
    x = x.reshape(b, h, w, inner)
    x_in = x
    x = quant_conv2d(p[f"{prefix}.proj_out"], x, f"{prefix}.proj_out", qstate, cfg, 1, 0)
    x = _rec(record, f"{prefix}.proj_out", (x_in,), x)
    return x + res


def _resnet(p, prefix, x, temb, qstate, cfg, shortcut, record):
    out = resnet_block(p, prefix, x, temb, qstate, cfg, shortcut)
    return _rec(record, prefix, (x, temb), out)


def cross_attn_down_block(p, prefix, x, temb, ehs, qstate, cfg, has_shortcut, has_down,
                          record=None):
    skips = []
    for i in range(2):
        x = _resnet(p, f"{prefix}.resnets.{i}", x, temb, qstate, cfg,
                    has_shortcut and i == 0, record)
        x = transformer_2d(p, f"{prefix}.attentions.{i}", x, ehs, 1, qstate, cfg, record)
        skips.append(x)
    if has_down:
        name = f"{prefix}.downsamplers.0.conv"
        x = _rec(record, name, (x,), quant_conv2d(p[name], x, name, qstate, cfg, 2, 1))
        skips.append(x)
    return x, skips


def down_block(p, prefix, x, temb, qstate, cfg, record=None):
    skips = []
    for i in range(2):
        x = _resnet(p, f"{prefix}.resnets.{i}", x, temb, qstate, cfg, False, record)
        skips.append(x)
    return x, skips


def cross_attn_up_block(p, prefix, x, skips, temb, ehs, qstate, cfg, has_up, record=None):
    for i in range(3):
        x = torch.cat([x, skips.pop()], dim=-1)
        x = _resnet(p, f"{prefix}.resnets.{i}", x, temb, qstate, cfg, True, record)
        x = transformer_2d(p, f"{prefix}.attentions.{i}", x, ehs, 1, qstate, cfg, record)
    if has_up:
        x = upsample_nearest2x(x)
        name = f"{prefix}.upsamplers.0.conv"
        x = _rec(record, name, (x,), quant_conv2d(p[name], x, name, qstate, cfg, 1, 1))
    return x


def up_block(p, prefix, x, skips, temb, qstate, cfg, record=None):
    for i in range(3):
        x = torch.cat([x, skips.pop()], dim=-1)
        x = _resnet(p, f"{prefix}.resnets.{i}", x, temb, qstate, cfg, True, record)
    x = upsample_nearest2x(x)
    name = f"{prefix}.upsamplers.0.conv"
    return _rec(record, name, (x,), quant_conv2d(p[name], x, name, qstate, cfg, 1, 1))


def mid_block(p, prefix, x, temb, ehs, qstate, cfg, record=None):
    x = _resnet(p, f"{prefix}.resnets.0", x, temb, qstate, cfg, False, record)
    x = transformer_2d(p, f"{prefix}.attentions.0", x, ehs, 1, qstate, cfg, record)
    return _resnet(p, f"{prefix}.resnets.1", x, temb, qstate, cfg, False, record)


def unet_sd_apply(params: dict, sample: torch.Tensor, timesteps: torch.Tensor,
                  encoder_hidden_states: torch.Tensor, qstate: Optional[QState] = None,
                  cfg: QConfig = QConfig(), record: Optional[dict] = None) -> torch.Tensor:
    """UNet forward. sample is NHWC (B, 64, 64, 4); timesteps (B,) or a
    scalar tensor. With `record` (a dict) every reconstruction unit's
    (inputs, output) is stashed in it."""
    # every second traced call leaves the quantizers' extents untimed
    with span("dgq.unet"), untimed_every_other("dgq.unet"):
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        base = out_count(params["conv_in"])  # 320 for real SD v1.4
        t_emb = timestep_embedding(timesteps, base).to(sample.dtype)
        emb = quant_linear(params["time_embedding.linear_1"], t_emb,
                           "time_embedding.linear_1", qstate, cfg)
        emb = _rec(record, "time_embedding.linear_1", (t_emb,), emb)
        emb_in = silu(emb)
        emb = quant_linear(params["time_embedding.linear_2"], emb_in,
                           "time_embedding.linear_2", qstate, cfg)
        emb = _rec(record, "time_embedding.linear_2", (emb_in,), emb)

        # conv_in / conv_out are never quantized
        x = conv2d(params["conv_in"], sample, 1, 1)
        ehs = encoder_hidden_states
        s0 = x
        # each stage is a span named by its parameter prefix
        with span("dgq.unet.down_blocks.0"):
            x, (s1, s2, s3) = cross_attn_down_block(params, "down_blocks.0", x, emb, ehs,
                                                    qstate, cfg, False, True, record)
        with span("dgq.unet.down_blocks.1"):
            x, (s4, s5, s6) = cross_attn_down_block(params, "down_blocks.1", x, emb, ehs,
                                                    qstate, cfg, True, True, record)
        with span("dgq.unet.down_blocks.2"):
            x, (s7, s8, s9) = cross_attn_down_block(params, "down_blocks.2", x, emb, ehs,
                                                    qstate, cfg, True, True, record)
        with span("dgq.unet.down_blocks.3"):
            x, (s10, s11) = down_block(params, "down_blocks.3", x, emb, qstate, cfg, record)
        with span("dgq.unet.mid_block"):
            x = mid_block(params, "mid_block", x, emb, ehs, qstate, cfg, record)
        with span("dgq.unet.up_blocks.0"):
            x = up_block(params, "up_blocks.0", x, [s9, s10, s11], emb, qstate, cfg, record)
        with span("dgq.unet.up_blocks.1"):
            x = cross_attn_up_block(params, "up_blocks.1", x, [s6, s7, s8], emb, ehs, qstate,
                                    cfg, True, record)
        with span("dgq.unet.up_blocks.2"):
            x = cross_attn_up_block(params, "up_blocks.2", x, [s3, s4, s5], emb, ehs, qstate,
                                    cfg, True, record)
        with span("dgq.unet.up_blocks.3"):
            x = cross_attn_up_block(params, "up_blocks.3", x, [s0, s1, s2], emb, ehs, qstate,
                                    cfg, False, record)
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
                 spec=None, store=None) -> dict:
    """Random params of reference shapes (OIHW convs, (O, I) linears),
    N(0, 1/fan_in) weights, zero biases, unit norms. Drawn on `device` from
    `generator` (which must live on that device), so a full-width model never
    passes through the host. store: where the params are kept (default
    `device`); each weight is drawn on `device` and moved there at once, so
    the values do not depend on it and the card holds one leaf at a time."""
    spec = spec if spec is not None else sd_unet_spec()
    draw, device = device, store if store is not None else device

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=draw, dtype=torch.float32)
        return (w / math.sqrt(fan_in)).to(device, dtype)

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
