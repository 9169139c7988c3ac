"""A plain PyTorch reference of Stable Diffusion 3 medium under DGQ's W4A8
policy: the MMDiT forward, the flow-matching Euler sampler with
classifier-free guidance and the 16-channel VAE decode, written from
diffusers' `SD3Transformer2DModel`, `FlowMatchEulerDiscreteScheduler`
(shift 3.0) and `AutoencoderKL` (stabilityai/stable-diffusion-3-medium-
diffusers) and from DGQ's quantizers. It imports torch and numpy only.

Float32, with TF32 off (`strict_f32`) so that a float32 product is one.
Tensors are NHWC (latents, images) or (B, T, C) (tokens); conv weights
OIHW, linear weights (out, in).

Quantizers (`Policy`):
  * W4 minmax per out channel, folded once (`fold`; the patch embedding and
    proj_out stay float);
  * A8 affine q = clamp(round(x / delta) + zp, 0, 255), x_q = (q - zp)
    delta on every quantized linear's input, delta and zp one value or one
    a channel of the last axis (a g=8 state's factors, expanded);
  * the joint q, k and v per tensor; under start_peak the key row of CLIP's
    start token passes through;
  * the log2 real-time softmax: delta = the largest weight of the whole
    call outside the start token's column, code = clamp(round(-log2(p /
    delta)), 0, 255), p_q = 2^-code delta, the start token's column exact;
  * time slots selected by step index (`slot`).

The joint attention runs in diffusers' key order, [image; text], so the
start token is key T (4096 at 1024 px): `attention_core(peak_col=T)`.

Each forward hands its units (the embedding linears, each joint block,
norm_out.linear) to `unit(key, inputs, fn)` and its layers (every quantized
linear, each norm-modulate, the attention core) to the model's `layer(kind,
name, inputs, fn)`; both default to computing fn(*inputs). A check can put
its own in their place.

Departures from diffusers: the timestep's sinusoid is formed in float64
and cast (diffusers forms it in float32); the position table is formed in
float64 as diffusers' numpy version does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

UNQUANTIZED = ("pos_embed.proj", "proj_out")


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
    d = torch.linalg.vector_norm(got.double() - ref.double())
    r = torch.linalg.vector_norm(ref.double())
    return float(d / r) if float(r) > 0 else (0.0 if float(d) == 0 else math.inf)


# ----------------------------------------------------------------- specs ---
def mmdit_spec(layers: int = 24, heads: int = 24, head_dim: int = 64, in_channels: int = 16,
               patch: int = 2, joint_dim: int = 4096, pooled_dim: int = 2048,
               freq_dim: int = 256) -> list:
    """The MMDiT's (name, kind, meta) in forward order under diffusers'
    names (transformer/config.json: num_layers 24, 24 heads of 64, patch 2,
    16 channels, joint_attention_dim 4096, pooled_projection_dim 2048):
    conv meta (cin, cout, k, stride, pad), linear meta (cin, cout, bias)."""
    d = heads * head_dim
    out = [("pos_embed.proj", "conv", (in_channels, d, patch, patch, 0))]
    for mlp, cin in (("timestep_embedder", freq_dim), ("text_embedder", pooled_dim)):
        out += [(f"time_text_embed.{mlp}.linear_1", "linear", (cin, d, True)),
                (f"time_text_embed.{mlp}.linear_2", "linear", (d, d, True))]
    out.append(("context_embedder", "linear", (joint_dim, d, True)))
    for i in range(layers):
        pre, last = f"transformer_blocks.{i}", i == layers - 1
        out.append((f"{pre}.norm1.linear", "linear", (d, 6 * d, True)))
        out.append((f"{pre}.norm1_context.linear", "linear", (d, 2 * d if last else 6 * d, True)))
        for n in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj", "to_out.0"):
            out.append((f"{pre}.attn.{n}", "linear", (d, d, True)))
        if not last:
            out.append((f"{pre}.attn.to_add_out", "linear", (d, d, True)))
        out += [(f"{pre}.ff.net.0.proj", "linear", (d, 4 * d, True)),
                (f"{pre}.ff.net.2", "linear", (4 * d, d, True))]
        if not last:
            out += [(f"{pre}.ff_context.net.0.proj", "linear", (d, 4 * d, True)),
                    (f"{pre}.ff_context.net.2", "linear", (4 * d, d, True))]
    return out + [("norm_out.linear", "linear", (d, 2 * d, True)),
                  ("proj_out", "linear", (d, patch * patch * in_channels, True))]


def act_sites(spec) -> list:
    """Every activation quantizer: each quantized linear's input, then each
    joint attention's q, k and v."""
    out = [n for n, k, _ in spec if k == "linear" and n not in UNQUANTIZED]
    for n, k, _ in spec:
        if n.endswith(".attn.to_q"):
            out += [n[:-4] + q for q in ("aqtizer_q", "aqtizer_k", "aqtizer_v")]
    return out


def vae_spec(base: int = 128, latent_channels: int = 16) -> list:
    """SD3's KL decoder (vae/config.json: block_out_channels (128, 256, 512,
    512), 16 latent channels, no post_quant_conv)."""
    c4, c2, c1 = 4 * base, 2 * base, base
    out = [("decoder.conv_in", "conv", (latent_channels, c4, 3, 1, 1)),
           ("decoder.conv_norm_out", "groupnorm", (c1,)),
           ("decoder.conv_out", "conv", (c1, 3, 3, 1, 1))]
    for pre in ("decoder.mid_block.resnets.0", "decoder.mid_block.resnets.1"):
        out += [(f"{pre}.norm1", "groupnorm", (c4,)), (f"{pre}.conv1", "conv", (c4, c4, 3, 1, 1)),
                (f"{pre}.norm2", "groupnorm", (c4,)), (f"{pre}.conv2", "conv", (c4, c4, 3, 1, 1))]
    att = "decoder.mid_block.attentions.0"
    out += [(f"{att}.group_norm", "groupnorm", (c4,))]
    out += [(f"{att}.{n}", "linear", (c4, c4, True)) for n in ("to_q", "to_k", "to_v", "to_out.0")]
    cin = c4
    for i, cout in enumerate([c4, c4, c2, c1]):
        for j in range(3):
            pre = f"decoder.up_blocks.{i}.resnets.{j}"
            out += [(f"{pre}.norm1", "groupnorm", (cin,)),
                    (f"{pre}.conv1", "conv", (cin, cout, 3, 1, 1)),
                    (f"{pre}.norm2", "groupnorm", (cout,)),
                    (f"{pre}.conv2", "conv", (cout, cout, 3, 1, 1))]
            if cin != cout:
                out += [(f"{pre}.conv_shortcut", "conv", (cin, cout, 1, 1, 0))]
            cin = cout
        if i < 3:
            out += [(f"decoder.up_blocks.{i}.upsamplers.0.conv", "conv", (cout, cout, 3, 1, 1))]
    return out


# ------------------------------------------------------------ quantizers ---
def fake_quant(x, delta, zp, bits: int = 8):
    q = torch.clamp(torch.round(x / delta) + zp, 0, 2 ** bits - 1)
    return (q - zp) * delta


def fold_weight(w: torch.Tensor, bits: int = 4) -> torch.Tensor:
    """W4 minmax per out channel: lo = min(w, 0), hi = max(w, 0), delta =
    max((hi - lo) / (2^b - 1), 1e-8), zp = round(-lo / delta)."""
    flat = w.float().reshape(w.shape[0], -1)
    lo = torch.clamp(flat.amin(dim=1), max=0.0)
    hi = torch.clamp(flat.amax(dim=1), min=0.0)
    delta = torch.clamp((hi - lo) / (2 ** bits - 1), min=1e-8)
    zp = torch.round(-lo / delta)
    shape = (-1,) + (1,) * (w.dim() - 1)
    return fake_quant(w.float(), delta.reshape(shape), zp.reshape(shape), bits)


def fold(params: dict, bits: int = 4) -> dict:
    """Every conv and linear weight W4-folded but the patch embedding and proj_out."""
    return {n: ({"w": fold_weight(p["w"], bits), "b": p.get("b")}
                if "w" in p and n not in UNQUANTIZED else p) for n, p in params.items()}


def slot(quantizers: dict, step: int) -> dict:
    """Step `step`'s quantizers from {name: (delta, zp)} stacked over slots."""
    return {n: (d[step], z[step]) for n, (d, z) in quantizers.items()}


@dataclasses.dataclass
class Policy:
    act: dict = dataclasses.field(default_factory=dict)  # {name: (delta, zp)}
    a_bits: int = 8
    sm_bits: int = 8
    log2_real_time: bool = False
    start_peak: bool = False


# ---------------------------------------------------------------- layers ---
def linear(x, w, b=None):
    y = torch.matmul(x, w.to(x.dtype).t())
    return y if b is None else y + b.to(x.dtype)


def conv(x, w, b, stride: int, pad: int):
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), None, stride, pad).permute(0, 2, 3, 1)
    return y if b is None else y + b.to(x.dtype)


def group_norm(x, scale, bias, groups: int = 32, eps: float = 1e-6):
    y = F.group_norm(x.permute(0, 3, 1, 2), groups, scale.to(x.dtype), bias.to(x.dtype), eps)
    return y.permute(0, 2, 3, 1)


def ln_modulate(x, shift, scale, eps: float = 1e-6):
    """LayerNorm without affine, then x (1 + scale) + shift over the tokens."""
    y = F.layer_norm(x, (x.shape[-1],), eps=eps)
    return y * (1 + scale[:, None, :]) + shift[:, None, :]


def silu(x):
    return x * torch.sigmoid(x)


def gelu_tanh(x):
    return 0.5 * x * (1 + torch.tanh(math.sqrt(2 / math.pi) * (x + 0.044715 * x ** 3)))


def timestep_embedding(t: torch.Tensor, dim: int, dt) -> torch.Tensor:
    """Sinusoidal projection, cos then sin (flip_sin_to_cos, shift 0), in float64, then cast."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float64,
                                                        device=t.device) / half)
    arg = t.double()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(arg), torch.sin(arg)], dim=-1).to(dt)


def pos_embed(dim: int, grid: int, base: int, h: int, w: int) -> torch.Tensor:
    """diffusers' `get_2d_sincos_pos_embed(dim, grid, base_size=base)` (its
    numpy form), cropped to the centre h x w as `PatchEmbed.cropped_pos_embed`."""
    gh = np.arange(grid, dtype=np.float32) / (grid / base)
    gw = np.arange(grid, dtype=np.float32) / (grid / base)
    g = np.stack(np.meshgrid(gw, gh), axis=0).reshape(2, 1, grid, grid)

    def one_d(d, pos):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    table = np.concatenate([one_d(dim // 2, g[0]), one_d(dim // 2, g[1])], axis=1)
    top, left = (grid - h) // 2, (grid - w) // 2
    table = table.reshape(grid, grid, dim)[top:top + h, left:left + w].reshape(h * w, dim)
    return torch.from_numpy(table).float()


def _chunks(n: int, rows: int, per_row: int, budget: int = 1 << 28) -> list:
    step = max(1, budget // max(1, rows * per_row))
    return [slice(i, min(n, i + step)) for i in range(0, n, step)]


def attention_core(q, k, v, scale: float, log2_real_time: bool = False, bits: int = 8,
                   peak_col=None):
    """softmax(q k^T scale) v over (BH, N, D), in blocks of heads; with
    log2_real_time the log2 quantizer whose delta is the largest weight of
    the whole call outside column `peak_col`, which stays exact."""
    bh, n, _ = q.shape
    blocks = _chunks(bh, n, k.shape[1])

    def probs(sl):
        return torch.softmax(torch.matmul(q[sl], k[sl].transpose(-1, -2)) * scale, dim=-1)

    def outside(p):
        if peak_col is None:
            return p
        return torch.cat([p[..., :peak_col], p[..., peak_col + 1:]], dim=-1)

    delta = max(outside(probs(sl)).amax() for sl in blocks) if log2_real_time else None
    out = torch.empty(bh, n, v.shape[-1], dtype=q.dtype, device=q.device)
    for sl in blocks:
        p = probs(sl)
        if delta is not None:
            code = torch.clamp(torch.round(-torch.log2(p / delta)), 0, 2 ** bits - 1)
            pq = torch.exp2(-code) * delta
            if peak_col is not None:
                pq[..., peak_col] = p[..., peak_col]
            p = pq
        out[sl] = torch.matmul(p, v[sl])
    return out


def run_free(key, inputs, fn):
    return fn(*inputs)


def run_free_layer(kind, name, inputs, fn):
    return fn(*inputs)


# ----------------------------------------------------------------- model ---
class MMDiT:
    """SD3's MMDiT over folded weights ({name: {"w", "b"}}), a policy and a
    compute dtype. Geometry: heads of `head_dim`, the position table's grid
    `pos_max` and base size `sample_size / patch`."""

    def __init__(self, params: dict, policy: Policy, dt=torch.float32, head_dim: int = 64,
                 sample_size: int = 128, pos_max: int = 192):
        self.p, self.pol, self.dt = params, policy, dt
        self.head_dim, self.sample_size, self.pos_max = head_dim, sample_size, pos_max
        self.layer = run_free_layer

    def aq(self, name, x):
        qp = self.pol.act.get(name)
        if qp is None:
            return x
        return fake_quant(x, qp[0].to(x.dtype), qp[1].to(x.dtype), self.pol.a_bits)

    def qlinear(self, name, x):
        p = self.p[name]
        return self.layer("linear", name, (x,),
                          lambda y: linear(self.aq(name, y), p["w"], p.get("b")))

    def modulate(self, x, shift, scale):
        return self.layer("adaln", None, (x, shift, scale), ln_modulate)

    def joint_attention(self, pre, nx, nc, context_out: bool):
        b, t, d = nx.shape
        s = nc.shape[1]
        h, hd = d // self.head_dim, self.head_dim

        def heads(image, text):  # diffusers' order: [image; text]
            return torch.cat([image, text], dim=1).reshape(b, t + s, h, hd).transpose(1, 2)

        qx, kx, vx = (self.qlinear(f"{pre}.{n}", nx) for n in ("to_q", "to_k", "to_v"))
        qc, kc, vc = (self.qlinear(f"{pre}.{n}", nc)
                      for n in ("add_q_proj", "add_k_proj", "add_v_proj"))
        q = self.aq(f"{pre}.aqtizer_q", heads(qx, qc))
        k = heads(kx, kc)
        if self.pol.start_peak:  # CLIP's start token, key t, passes through
            k = torch.cat([self.aq(f"{pre}.aqtizer_k", k[..., :t, :]), k[..., t:t + 1, :],
                           self.aq(f"{pre}.aqtizer_k", k[..., t + 1:, :])], dim=-2)
        else:
            k = self.aq(f"{pre}.aqtizer_k", k)
        v = self.aq(f"{pre}.aqtizer_v", heads(vx, vc))
        peak = t if self.pol.start_peak and self.pol.log2_real_time else None
        o = self.layer("attn", pre, tuple(a.reshape(b * h, t + s, hd) for a in (q, k, v)),
                       lambda q_, k_, v_: attention_core(q_, k_, v_, hd ** -0.5,
                                                         self.pol.log2_real_time,
                                                         self.pol.sm_bits, peak))
        o = o.reshape(b, h, t + s, hd).transpose(1, 2).reshape(b, t + s, d)
        a_x = self.qlinear(f"{pre}.to_out.0", o[:, :t])
        return a_x, (self.qlinear(f"{pre}.to_add_out", o[:, t:]) if context_out else None)

    def ff(self, pre, x):
        return self.qlinear(f"{pre}.net.2", gelu_tanh(self.qlinear(f"{pre}.net.0.proj", x)))

    def block(self, pre, x, c, temb, last: bool):
        """One joint block; returns [x; c] along the tokens, x alone when `last`."""
        st = silu(temb)
        sh1, sc1, g1, sh2, sc2, g2 = self.qlinear(f"{pre}.norm1.linear", st).chunk(6, dim=-1)
        nx = self.modulate(x, sh1, sc1)
        cmod = self.qlinear(f"{pre}.norm1_context.linear", st)
        if last:
            csc1, csh1 = cmod.chunk(2, dim=-1)
        else:
            csh1, csc1, cg1, csh2, csc2, cg2 = cmod.chunk(6, dim=-1)
        nc = self.modulate(c, csh1, csc1)
        a_x, a_c = self.joint_attention(f"{pre}.attn", nx, nc, not last)
        x = x + g1[:, None, :] * a_x
        x = x + g2[:, None, :] * self.ff(f"{pre}.ff", self.modulate(x, sh2, sc2))
        if last:
            return x
        c = c + cg1[:, None, :] * a_c
        c = c + cg2[:, None, :] * self.ff(f"{pre}.ff_context", self.modulate(c, csh2, csc2))
        return torch.cat([x, c], dim=1)

    def depth(self):
        n = 0
        while f"transformer_blocks.{n}.norm1.linear" in self.p:
            n += 1
        return n

    def embed(self, sample, t, ehs, pooled, unit=run_free):
        """(x tokens, c tokens, temb) from NHWC latents, timesteps, prompt
        embeddings and pooled embeddings."""
        p = self.p
        dt = self.dt
        freq = p["time_text_embed.timestep_embedder.linear_1"]["w"].shape[1]
        embs = []
        for mlp, inp in (("timestep_embedder", timestep_embedding(t, freq, dt)),
                         ("text_embedder", pooled.to(dt))):
            n1, n2 = f"time_text_embed.{mlp}.linear_1", f"time_text_embed.{mlp}.linear_2"
            h = silu(unit(n1, (inp,), lambda y, n=n1: self.qlinear(n, y)))
            embs.append(unit(n2, (h,), lambda y, n=n2: self.qlinear(n, y)))
        temb = embs[0] + embs[1]
        ehs = ehs.to(dt)
        c = unit("context_embedder", (ehs,), lambda y: self.qlinear("context_embedder", y))
        w = p["pos_embed.proj"]["w"]
        patch = w.shape[-1]
        x = conv(sample.to(dt), w, p["pos_embed.proj"]["b"], patch, 0)
        b, gh, gw, d = x.shape
        table = pos_embed(d, self.pos_max, self.sample_size // patch, gh, gw)
        return x.reshape(b, gh * gw, d) + table.to(x.device, dt), c, temb

    def __call__(self, sample, t, ehs, pooled, unit=run_free):
        """Velocity (B, H, W, C) of NHWC latents at timesteps t (B,)."""
        x, c, temb = self.embed(sample, t, ehs, pooled, unit)
        n, tokens = self.depth(), x.shape[1]
        for i in range(n):
            key, last = f"transformer_blocks.{i}", i == n - 1
            out = unit(key, (x, c, temb),
                       lambda x_, c_, e_, key=key, last=last: self.block(key, x_, c_, e_, last))
            x, c = out[:, :tokens], out[:, tokens:]
        return self.head(x, temb, sample.shape, unit)

    def head(self, x, temb, shape, unit=run_free):
        st = silu(temb)
        scale, shift = unit("norm_out.linear", (st,),
                            lambda y: self.qlinear("norm_out.linear", y)).chunk(2, dim=-1)
        x = self.modulate(x, shift, scale)
        x = linear(x, self.p["proj_out"]["w"], self.p["proj_out"]["b"])
        b, hh, ww, _ = shape
        patch = self.p["pos_embed.proj"]["w"].shape[-1]
        co = x.shape[-1] // patch ** 2
        x = x.reshape(b, hh // patch, ww // patch, patch, patch, co).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, hh, ww, co)


# --------------------------------------------------------------- sampler ---
def flow_sigmas(steps: int, shift: float = 3.0, train_steps: int = 1000):
    """(sigmas (steps + 1,), timesteps (steps,)) float32, as
    FlowMatchEulerDiscreteScheduler(shift=shift).set_timesteps(steps) gives
    them: its training sigmas shifted once, timesteps spaced linearly from
    1000 sigma_max to 1000 sigma_min and shifted again, a final 0."""
    ts = np.linspace(1, train_steps, train_steps, dtype=np.float32)[::-1].copy()
    s = ts / train_steps
    s = shift * s / (1 + (shift - 1) * s)
    sigma_max, sigma_min = float(s[0]), float(s[-1])
    t = np.linspace(sigma_max * train_steps, sigma_min * train_steps, steps)
    sig = t / train_steps
    sig = torch.from_numpy(shift * sig / (1 + (shift - 1) * sig)).float()
    return torch.cat([sig, torch.zeros(1)]), sig * train_steps


def cfg_step(x, v, scale: float, sigma, sigma_next):
    """One flow-Euler step of the CFG batch [uncond; text]'s velocity v."""
    v_u, v_c = v.chunk(2, dim=0)
    return x + (float(sigma_next) - float(sigma)) * (v_u + scale * (v_c - v_u))


def sample(model_for_step, latents, ehs, pooled, ehs_u, pooled_u, steps: int = 28,
           scale: float = 7.0, shift: float = 3.0):
    """The whole sampler: model_for_step(i) gives step i's model (its
    slot's quantizers); the CFG batch is [uncond; text]."""
    sig, ts = flow_sigmas(steps, shift)
    x = latents
    e, p = torch.cat([ehs_u, ehs]), torch.cat([pooled_u, pooled])
    for i in range(steps):
        v = model_for_step(i)(torch.cat([x, x]), ts[i].expand(2 * x.shape[0]).to(x.device), e, p)
        x = cfg_step(x, v, scale, sig[i], sig[i + 1])
    return x


# ------------------------------------------------------------------- VAE ---
def vae_decode(p: dict, latents, scale: float = 1.5305, shift: float = 0.0609, dt=torch.float32):
    """SD3's KL decoder: 16 latent channels, no post_quant_conv, NHWC
    latents (B, h, w, 16) / scale + shift -> images (B, 8h, 8w, 3) in about [-1, 1]."""
    def cv(name, x, pad):
        return conv(x, p[name]["w"], p[name]["b"], 1, pad)

    def gn(name, x):
        return group_norm(x, p[name]["scale"], p[name]["bias"])

    def resnet(pre, x):
        h = cv(f"{pre}.conv1", silu(gn(f"{pre}.norm1", x)), 1)
        h = cv(f"{pre}.conv2", silu(gn(f"{pre}.norm2", h)), 1)
        if f"{pre}.conv_shortcut" in p:
            x = cv(f"{pre}.conv_shortcut", x, 0)
        return x + h

    x = cv("decoder.conv_in", latents.to(dt) / scale + shift, 1)
    x = resnet("decoder.mid_block.resnets.0", x)
    att = "decoder.mid_block.attentions.0"
    b, h, w, c = x.shape
    y = gn(f"{att}.group_norm", x).reshape(b, h * w, c)
    q, k, v = (linear(y, p[f"{att}.{n}"]["w"], p[f"{att}.{n}"]["b"])
               for n in ("to_q", "to_k", "to_v"))
    o = attention_core(q, k, v, c ** -0.5)
    x = linear(o, p[f"{att}.to_out.0"]["w"], p[f"{att}.to_out.0"]["b"]).reshape(b, h, w, c) + x
    x = resnet("decoder.mid_block.resnets.1", x)
    for i in range(4):
        for j in range(3):
            x = resnet(f"decoder.up_blocks.{i}.resnets.{j}", x)
        if i < 3:
            x = cv(f"decoder.up_blocks.{i}.upsamplers.0.conv",
                   x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2), 1)
    return cv("decoder.conv_out", silu(gn("decoder.conv_norm_out", x)), 1)


def to_uint8(images: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(images / 2 + 0.5, 0.0, 1.0) * 255).round().to(torch.uint8)
