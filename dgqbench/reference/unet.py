"""The UNets of SD v1.4 and SDXL-turbo and the KL-VAE decoder, plain, over
the layers of `reference.ops`, with DGQ's W4A8 policy where it is asked for.

`Policy` is what a forward needs to know of the quantization: the time
slot's activation quantizers `act` ({name: (delta, zp)}, delta a scalar or,
for a group conv, one per row of the c-major unfolded input), the softmax
quantizer's bits and modes. An empty `act` and `log2=False` give the float
forward.

Each forward hands every reconstruction unit (a resnet, a transformer
block, a lone conv or linear) to `unit(key, inputs, fn)`, and every layer
(a quantized conv or linear, a norm, the attention core) to the model's
`layer(kind, name, inputs, fn)`; each returns the output: `run_free`
computes it, `Record` / `RecordLayers` also keep it, `Follow` /
`FollowLayers` take the program's recorded output after comparing. That
lets a check judge each layer from the program's own inputs where a whole
trajectory, and even one transformer block, is chaotic. A `unit` may raise
`Stop` to end the forward.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from dgqbench.reference import ops


class Stop(Exception):
    """Raised by a `unit` callback to end a forward early."""


@dataclasses.dataclass
class Policy:
    act: dict = dataclasses.field(default_factory=dict)
    a_bits: int = 8
    sm_bits: int = 8
    log2_real_time: bool = False
    start_peak: bool = False
    group_layers: frozenset = frozenset()


def run_free(key, inputs, fn):
    return fn(*inputs)


def run_free_layer(kind, name, inputs, fn):
    return fn(*inputs)


class Record:
    """A free forward that keeps every unit's (inputs, output), the form of
    the program's `record=`."""

    def __init__(self, stop_at: Optional[str] = None):
        self.rec: dict = {}
        self.stop_at = stop_at

    def __call__(self, key, inputs, fn):
        out = fn(*inputs)
        self.rec[key] = (inputs, out)
        if key == self.stop_at:
            raise Stop(key)
        return out


def _same(p_in, inputs) -> bool:
    return len(p_in) == len(inputs) and all(a.shape == b.shape for a, b in zip(p_in, inputs))


def _glue(p_in, inputs) -> float:
    return max(ops.rel_gap(a, b.to(a.dtype)) for a, b in zip(p_in, inputs))


class RecordLayers:
    """Keeps every layer's (kind, name, inputs, output), in call order."""

    def __init__(self):
        self.rec: list = []

    def __call__(self, kind, name, inputs, fn):
        out = fn(*inputs)
        self.rec.append((kind, name, inputs, out))
        return out


class FollowLayers:
    """Walks a program's layer record in call order: for each layer, `glue`
    gets the gap between the input the reference forms from the program's
    earlier outputs and the input the program recorded, `layers` the gap
    between the reference layer on the program's input and the program's
    output, and the forward goes on from the program's output. A layer the
    program did not run here, or ran at other shapes, reads as an infinite
    gap, and the forward goes on from the reference's own values."""

    def __init__(self, rec: list):
        self.rec, self.at = rec, 0
        self.glue: list = []
        self.layers: list = []
        self.where: list = []  # (kind, name) of each entry of `layers`

    def __call__(self, kind, name, inputs, fn):
        dt = inputs[0].dtype
        p_kind, p_name, p_in, p_out = (self.rec[self.at] if self.at < len(self.rec)
                                       else (None, None, (), None))
        self.at += 1
        if p_kind != kind or p_name not in (None, name) or not _same(p_in, inputs):
            self.glue.append(math.inf)
            return fn(*inputs)
        self.glue.append(_glue(p_in, inputs))
        out = fn(*(x.to(dt) for x in p_in))
        self.where.append((kind, name))
        if p_out.shape != out.shape:
            self.layers.append(math.inf)
            return out
        self.layers.append(ops.rel_gap(p_out, out))
        return p_out.to(dt)

    def finish(self):
        """An infinite gap where the program ran layers the reference did not."""
        if self.at != len(self.rec):
            self.glue.append(math.inf)


class Follow:
    """Compares the program's record unit by unit, each unit layer by layer.
    `layers_of(key, inputs)` gives the program's layer record of one unit
    run again alone from its recorded inputs, and its output again; the unit
    then runs from that record (`FollowLayers`). `layers` gets each layer's
    gap; `glue` the gaps between the inputs the reference forms from the
    program's earlier outputs and the inputs the program recorded, and
    between each unit's output as the reference forms it and the program's;
    `rerun` the largest difference between a unit's output again and as
    recorded."""

    def __init__(self, rec: dict, model: "Model", layers_of: Callable):
        self.rec, self.model, self.layers_of = rec, model, layers_of
        self.glue: list = []
        self.layers: list = []
        self.where: list = []
        self.rerun = 0.0

    def __call__(self, key, inputs, fn):
        dt = inputs[0].dtype
        p_in, p_out = self.rec.get(key, ((), None))
        if p_out is None or not _same(p_in, inputs):
            self.glue.append(math.inf)
            return fn(*inputs)
        self.glue.append(_glue(p_in, inputs))
        p_in = tuple(x.to(dt) for x in p_in)
        layers, again = self.layers_of(key, p_in)
        self.rerun = max(self.rerun, float((again.float() - p_out.float()).abs().max())
                         if again.shape == p_out.shape else math.inf)
        follow = FollowLayers(layers)
        self.model.layer = follow
        try:
            out = fn(*p_in)
        finally:
            self.model.layer = run_free_layer
        follow.finish()
        self.glue += follow.glue + [ops.rel_gap(p_out, out) if p_out.shape == out.shape
                                    else math.inf]
        self.layers += follow.layers
        self.where += [(kind, f"{key}/{name}") for kind, name in follow.where]
        return p_out.to(dt)


class Model:
    """Weights ({name: {"w", "b"} or {"scale", "bias"}}), the policy and the
    compute dtype of one forward."""

    def __init__(self, params: dict, policy: Policy, dt=torch.float32, heads: Callable = None):
        self.p, self.pol, self.dt = params, policy, dt
        self.heads = heads
        self.layer = run_free_layer

    def aq(self, name, x):
        qp = self.pol.act.get(name)
        if qp is None:
            return x
        return ops.fake_quant(x, qp[0].to(x.dtype), qp[1].to(x.dtype), self.pol.a_bits)

    def qlinear(self, name, x):
        p = self.p[name]
        return self.layer("linear", name, (x,),
                          lambda y: ops.linear(self.aq(name, y), p["w"], p.get("b")))

    def qconv(self, name, x, stride, pad):
        p = self.p[name]
        if name in self.pol.group_layers and name in self.pol.act:
            d, z = self.pol.act[name]
            fn = lambda y: ops.group_quant_conv(y, p["w"], p.get("b"), d, z,  # noqa: E731
                                                self.pol.a_bits, stride, pad)
        else:
            fn = lambda y: ops.conv(self.aq(name, y), p["w"], p.get("b"), stride, pad)  # noqa: E731
        return self.layer("conv", name, (x,), fn)

    def gn(self, name, x, eps=1e-5):
        p = self.p[name]
        return self.layer("gn", name, (x,),
                          lambda y: ops.group_norm(y, p["scale"], p["bias"], eps=eps))

    def ln(self, name, x):
        p = self.p[name]
        return self.layer("ln", name, (x,), lambda y: ops.layer_norm(y, p["scale"], p["bias"]))

    def resnet(self, pre, x, temb):
        h = self.qconv(f"{pre}.conv1", ops.silu(self.gn(f"{pre}.norm1", x)), 1, 1)
        h = h + self.qlinear(f"{pre}.time_emb_proj", ops.silu(temb))[:, None, None, :]
        h = self.qconv(f"{pre}.conv2", ops.silu(self.gn(f"{pre}.norm2", h)), 1, 1)
        if f"{pre}.conv_shortcut" in self.p:
            x = self.qconv(f"{pre}.conv_shortcut", x, 1, 0)
        return x + h

    def attention(self, pre, x, ehs, heads, start_peak):
        b, t, c = x.shape
        d = c // heads
        kv = x if ehs is None else ehs
        s = kv.shape[1]
        q = self.qlinear(f"{pre}.to_q", x).reshape(b, t, heads, d).transpose(1, 2)
        k = self.qlinear(f"{pre}.to_k", kv).reshape(b, s, heads, d).transpose(1, 2)
        v = self.qlinear(f"{pre}.to_v", kv).reshape(b, s, heads, d).transpose(1, 2)
        q = self.aq(f"{pre}.aqtizer_q", q)
        if start_peak:
            k = torch.cat([k[..., :1, :], self.aq(f"{pre}.aqtizer_k", k[..., 1:, :])], dim=-2)
        else:
            k = self.aq(f"{pre}.aqtizer_k", k)
        v = self.aq(f"{pre}.aqtizer_v", v)
        mode = "log2_real_time" if self.pol.log2_real_time else "none"
        o = self.layer("attn", pre, (q.reshape(b * heads, t, d), k.reshape(b * heads, s, d),
                                     v.reshape(b * heads, s, d)),
                       lambda q_, k_, v_: ops.attention_core(
                           q_, k_, v_, d ** -0.5, mode, self.pol.sm_bits,
                           start_peak and self.pol.log2_real_time))
        o = o.reshape(b, heads, t, d).transpose(1, 2).reshape(b, t, c)
        return self.qlinear(f"{pre}.to_out.0", o)

    def block(self, pre, x, ehs, heads):
        x = self.attention(f"{pre}.attn1", self.ln(f"{pre}.norm1", x), None, heads, False) + x
        x = self.attention(f"{pre}.attn2", self.ln(f"{pre}.norm2", x), ehs, heads,
                           self.pol.start_peak) + x
        h = self.qlinear(f"{pre}.ff.net.0.proj", self.ln(f"{pre}.norm3", x))
        h1, h2 = h.chunk(2, dim=-1)
        return self.qlinear(f"{pre}.ff.net.2", h1 * torch.nn.functional.gelu(h2)) + x

    def run_unit(self, key, inputs, spec_meta: dict):
        """One reconstruction unit alone: a resnet (x, temb), a transformer
        block (x, ehs), or a lone conv / linear (x,); spec_meta maps a layer's
        name to its (kind, meta) in the layer list."""
        if ".transformer_blocks." in key:
            return self.block(key, inputs[0], inputs[1], self.heads(inputs[0].shape[-1]))
        if ".resnets." in key:
            return self.resnet(key, *inputs)
        kind, meta = spec_meta[key]
        if kind == "conv":
            return self.qconv(key, inputs[0], meta[3], meta[4])
        return self.qlinear(key, inputs[0])

    def depth(self, pre):
        n = 0
        while f"{pre}.transformer_blocks.{n}.attn1.to_q" in self.p:
            n += 1
        return n

    def transformer_2d(self, pre, x, ehs, unit, linear_proj):
        b, h, w, c = x.shape
        heads = self.heads(c)
        res = x
        x = self.gn(f"{pre}.norm", x, eps=1e-6)
        if linear_proj:
            x = x.reshape(b, h * w, c)
            x = unit(f"{pre}.proj_in", (x,), lambda y: self.qlinear(f"{pre}.proj_in", y))
        else:
            x = unit(f"{pre}.proj_in", (x,), lambda y: self.qconv(f"{pre}.proj_in", y, 1, 0))
            x = x.reshape(b, h * w, c)
        for i in range(self.depth(pre)):
            key = f"{pre}.transformer_blocks.{i}"
            x = unit(key, (x, ehs), lambda y, e, key=key: self.block(key, y, e, heads))
        if linear_proj:
            x = unit(f"{pre}.proj_out", (x,), lambda y: self.qlinear(f"{pre}.proj_out", y))
            x = x.reshape(b, h, w, c)
        else:
            x = x.reshape(b, h, w, c)
            x = unit(f"{pre}.proj_out", (x,), lambda y: self.qconv(f"{pre}.proj_out", y, 1, 0))
        return x + res

    def res_unit(self, pre, x, temb, unit):
        return unit(pre, (x, temb), lambda y, e: self.resnet(pre, y, e))

    def conv_unit(self, name, x, stride, unit):
        return unit(name, (x,), lambda y: self.qconv(name, y, stride, 1))

    def time_embedding(self, t, base, unit):
        temb = ops.timestep_embedding(t, base, self.dt)
        emb = unit("time_embedding.linear_1", (temb,),
                   lambda y: self.qlinear("time_embedding.linear_1", y))
        emb_in = ops.silu(emb)
        return unit("time_embedding.linear_2", (emb_in,),
                    lambda y: self.qlinear("time_embedding.linear_2", y))

    def head(self, x):
        x = ops.silu(self.gn("conv_norm_out", x))
        return ops.conv(x, self.p["conv_out"]["w"], self.p["conv_out"]["b"], 1, 1)


def sd_unet(m: Model, sample, t, ehs, unit=run_free):
    """SD v1.4's UNet: NHWC sample (B, 64, 64, 4), timesteps (B,), ehs (B, 77, 768)."""
    base = m.p["conv_in"]["w"].shape[0]
    ehs = ehs.to(m.dt)
    emb = m.time_embedding(t, base, unit)
    x = ops.conv(sample.to(m.dt), m.p["conv_in"]["w"], m.p["conv_in"]["b"], 1, 1)
    skips = [x]
    for bi in range(3):
        pre = f"down_blocks.{bi}"
        for i in range(2):
            x = m.res_unit(f"{pre}.resnets.{i}", x, emb, unit)
            x = m.transformer_2d(f"{pre}.attentions.{i}", x, ehs, unit, False)
            skips.append(x)
        x = m.conv_unit(f"{pre}.downsamplers.0.conv", x, 2, unit)
        skips.append(x)
    for i in range(2):
        x = m.res_unit(f"down_blocks.3.resnets.{i}", x, emb, unit)
        skips.append(x)
    x = m.res_unit("mid_block.resnets.0", x, emb, unit)
    x = m.transformer_2d("mid_block.attentions.0", x, ehs, unit, False)
    x = m.res_unit("mid_block.resnets.1", x, emb, unit)
    for bi in range(4):
        pre = f"up_blocks.{bi}"
        for i in range(3):
            x = torch.cat([x, skips.pop()], dim=-1)
            x = m.res_unit(f"{pre}.resnets.{i}", x, emb, unit)
            if bi > 0:
                x = m.transformer_2d(f"{pre}.attentions.{i}", x, ehs, unit, False)
        if bi < 3:
            x = m.conv_unit(f"{pre}.upsamplers.0.conv", ops.upsample2x(x), 1, unit)
    return m.head(x)


def sdxl_unet(m: Model, sample, t, ehs, text_embeds, time_ids, unit=run_free):
    """SDXL-turbo's UNet: NHWC sample (B, 128, 128, 4), timesteps (B,), ehs
    (B, 77, 2048), pooled text_embeds (B, 1280), time_ids (B, 6)."""
    base = m.p["conv_in"]["w"].shape[0]
    ehs = ehs.to(m.dt)
    emb = m.time_embedding(t, base, unit)
    add_ch = (m.p["add_embedding.linear_1"]["w"].shape[1] - text_embeds.shape[-1]) // 6
    time_embeds = ops.timestep_embedding(time_ids.reshape(-1), add_ch, m.dt)
    add = torch.cat([text_embeds.to(m.dt), time_embeds.reshape(text_embeds.shape[0], -1)], dim=-1)
    aug = unit("add_embedding.linear_1", (add,),
               lambda y: m.qlinear("add_embedding.linear_1", y))
    aug_in = ops.silu(aug)
    aug = unit("add_embedding.linear_2", (aug_in,),
               lambda y: m.qlinear("add_embedding.linear_2", y))
    emb = emb + aug
    x = ops.conv(sample.to(m.dt), m.p["conv_in"]["w"], m.p["conv_in"]["b"], 1, 1)
    skips = [x]
    for i in range(2):
        x = m.res_unit(f"down_blocks.0.resnets.{i}", x, emb, unit)
        skips.append(x)
    x = m.conv_unit("down_blocks.0.downsamplers.0.conv", x, 2, unit)
    skips.append(x)
    for bi in (1, 2):
        pre = f"down_blocks.{bi}"
        for i in range(2):
            x = m.res_unit(f"{pre}.resnets.{i}", x, emb, unit)
            x = m.transformer_2d(f"{pre}.attentions.{i}", x, ehs, unit, True)
            skips.append(x)
        if bi == 1:
            x = m.conv_unit(f"{pre}.downsamplers.0.conv", x, 2, unit)
            skips.append(x)
    x = m.res_unit("mid_block.resnets.0", x, emb, unit)
    x = m.transformer_2d("mid_block.attentions.0", x, ehs, unit, True)
    x = m.res_unit("mid_block.resnets.1", x, emb, unit)
    for bi in range(3):
        pre = f"up_blocks.{bi}"
        for i in range(3):
            x = torch.cat([x, skips.pop()], dim=-1)
            x = m.res_unit(f"{pre}.resnets.{i}", x, emb, unit)
            if bi < 2:
                x = m.transformer_2d(f"{pre}.attentions.{i}", x, ehs, unit, True)
        if bi < 2:
            x = m.conv_unit(f"{pre}.upsamplers.0.conv", ops.upsample2x(x), 1, unit)
    return m.head(x)


def vae_decode(p: dict, latents, scale: float, dt=torch.float32):
    """KL-VAE decoder: NHWC latents (B, h, w, 4) -> images (B, 8h, 8w, 3) in about [-1, 1]."""
    def conv(name, x, pad):
        return ops.conv(x, p[name]["w"], p[name]["b"], 1, pad)

    def gn(name, x):
        return ops.group_norm(x, p[name]["scale"], p[name]["bias"], eps=1e-6)

    def resnet(pre, x):
        h = conv(f"{pre}.conv1", ops.silu(gn(f"{pre}.norm1", x)), 1)
        h = conv(f"{pre}.conv2", ops.silu(gn(f"{pre}.norm2", h)), 1)
        if f"{pre}.conv_shortcut" in p:
            x = conv(f"{pre}.conv_shortcut", x, 0)
        return x + h

    x = conv("decoder.conv_in", conv("post_quant_conv", latents.to(dt) / scale, 0), 1)
    x = resnet("decoder.mid_block.resnets.0", x)
    att = "decoder.mid_block.attentions.0"
    b, h, w, c = x.shape
    y = gn(f"{att}.group_norm", x).reshape(b, h * w, c)
    q, k, v = (ops.linear(y, p[f"{att}.{n}"]["w"], p[f"{att}.{n}"]["b"])
               for n in ("to_q", "to_k", "to_v"))
    o = ops.attention_core(q, k, v, c ** -0.5, "none")
    x = ops.linear(o, p[f"{att}.to_out.0"]["w"], p[f"{att}.to_out.0"]["b"]).reshape(b, h, w, c) + x
    x = resnet("decoder.mid_block.resnets.1", x)
    for i in range(4):
        for j in range(3):
            x = resnet(f"decoder.up_blocks.{i}.resnets.{j}", x)
        if i < 3:
            x = conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", ops.upsample2x(x), 1)
    return conv("decoder.conv_out", ops.silu(gn("decoder.conv_norm_out", x)), 1)


def to_uint8(images: torch.Tensor) -> torch.Tensor:
    """Decoded images in about [-1, 1] -> uint8, in the images' dtype."""
    return (torch.clamp(images / 2 + 0.5, 0.0, 1.0) * 255).round().to(torch.uint8)
