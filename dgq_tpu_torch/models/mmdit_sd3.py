"""Stable Diffusion 3 medium's MMDiT on NHWC latents (diffusers'
`SD3Transformer2DModel`, stabilityai/stable-diffusion-3-medium-diffusers,
transformer/config.json; Esser et al., arXiv:2403.03206). No JAX
counterpart: the JAX package runs UNets only.

  * patch embedding: a 2 x 2 stride-2 conv (16 -> 1536) to 4096 tokens at
    128 x 128 latents, plus the centre crop of a 2-D sin-cos table built
    for a 192 x 192 grid (`pos_embed_table`);
  * conditioning: temb = MLP_t(sincos_256(t)) + MLP_p(pooled), the context
    Linear(4096 -> 1536) over the prompt embeddings;
  * 24 joint blocks: each stream (image x, text c) has its own adaLN-zero
    modulation (shift, scale, gate for attention and MLP), projections and
    GELU-tanh MLP, and the two meet in one softmax (`layers.joint_attention`,
    text first); the last block's text stream feeds only q, k and v, its
    modulation is (scale, shift);
  * output: norm-modulate by `norm_out`, proj_out (1536 -> 64), unpatchify.

Quantization (`QConfig`): every linear but proj_out through `quant_linear`
(the W4 fold, A8 on its input, `aq_apply`, `qconfig.joint_act_sites`); the
patch embedding and proj_out stay float, as conv_in and conv_out do in SD
(`quantized_spec` leaves them out of the fold). The adaLN and embedding linears take the rule of
SD's time-embedding linears: quantized like every other linear.

`record=` stashes each reconstruction unit's (inputs, output): the
embedding linears alone, each joint block (inputs (x, c, temb), output the
joint sequence [x; c], x alone for the last block) and norm_out.linear.
The layer functions are called through the `layers` module, so a caller
can watch them.
"""
from __future__ import annotations

from typing import Optional

import torch

from dgq_tpu_torch.models import layers as L
from dgq_tpu_torch.models.qconfig import MMDIT_UNQUANTIZED, QConfig, QState
from dgq_tpu_torch.models.unet_sd import _rec, init_unet_sd
from dgq_tpu_torch.parallel.tp import out_count
from dgq_tpu_torch.utils.profiler import span, untimed_every_other



def mmdit_sd3_spec(layers: int = 24, heads: int = 24, head_dim: int = 64,
                   in_channels: int = 16, patch: int = 2, joint_dim: int = 4096,
                   pooled_dim: int = 2048, freq_dim: int = 256) -> list:
    """(name, kind, meta) of the MMDiT under diffusers' state-dict names:
    conv (cin, cout, k, stride, pad), linear (cin, cout, bias)."""
    d = heads * head_dim
    spec = [("pos_embed.proj", "conv", (in_channels, d, patch, patch, 0)),
            ("time_text_embed.timestep_embedder.linear_1", "linear", (freq_dim, d, True)),
            ("time_text_embed.timestep_embedder.linear_2", "linear", (d, d, True)),
            ("time_text_embed.text_embedder.linear_1", "linear", (pooled_dim, d, True)),
            ("time_text_embed.text_embedder.linear_2", "linear", (d, d, True)),
            ("context_embedder", "linear", (joint_dim, d, True))]
    for i in range(layers):
        pre, last = f"transformer_blocks.{i}", i == layers - 1
        spec += [(f"{pre}.norm1.linear", "linear", (d, 6 * d, True)),
                 (f"{pre}.norm1_context.linear", "linear", (d, (2 if last else 6) * d, True))]
        names = ["to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj", "to_out.0"]
        spec += [(f"{pre}.attn.{n}", "linear", (d, d, True))
                 for n in names + ([] if last else ["to_add_out"])]
        for ff in ("ff",) + (() if last else ("ff_context",)):
            spec += [(f"{pre}.{ff}.net.0.proj", "linear", (d, 4 * d, True)),
                     (f"{pre}.{ff}.net.2", "linear", (4 * d, d, True))]
    spec += [("norm_out.linear", "linear", (d, 2 * d, True)),
             ("proj_out", "linear", (d, patch * patch * in_channels, True))]
    return spec


def quantized_spec(spec) -> list:
    """The layers the W4 fold takes: all but the patch embedding and proj_out."""
    return [s for s in spec if s[0] not in MMDIT_UNQUANTIZED]


def init_mmdit_sd3(generator: torch.Generator, device="cuda", spec=None,
                   dtype=torch.float32) -> dict:
    """Random params of the MMDiT's shapes: N(0, 1/fan_in) weights, zero biases."""
    return init_unet_sd(generator, device, dtype, spec=spec or mmdit_sd3_spec())


def _sincos_1d(dim: int, pos: torch.Tensor) -> torch.Tensor:
    omega = 1.0 / 10000.0 ** (torch.arange(dim // 2, dtype=torch.float64) / (dim / 2.0))
    out = pos.double().reshape(-1, 1) * omega[None, :]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)


_POS_TABLES: dict = {}


def pos_embed_table(dim: int, grid: int, base: int, h: int, w: int, device) -> torch.Tensor:
    """The (h w, dim) f32 position embedding of an h x w patch grid: the
    centre crop of diffusers' `get_2d_sincos_pos_embed(dim, grid, base_size=
    base)`, coordinates arange(grid) / (grid / base) in f32, the table
    [emb of the column coordinate, emb of the row coordinate] (diffusers
    calls them emb_h and emb_w in that order), each [sin, cos] over
    1 / 10000^(i / (dim / 4)), formed in f64. Cached a shape and device."""
    key = (dim, grid, base, h, w, str(device))
    if key not in _POS_TABLES:
        coord = torch.arange(grid, dtype=torch.float32) / (grid / base)
        rows, cols = torch.meshgrid(coord, coord, indexing="ij")
        table = torch.cat([_sincos_1d(dim // 2, cols), _sincos_1d(dim // 2, rows)], dim=1)
        top, left = (grid - h) // 2, (grid - w) // 2
        table = table.reshape(grid, grid, dim)[top:top + h, left:left + w].reshape(h * w, dim)
        _POS_TABLES[key] = table.float().to(device)
    return _POS_TABLES[key]


def joint_block(p, pre: str, x: torch.Tensor, c: torch.Tensor, temb: torch.Tensor,
                num_heads: int, qstate: Optional[QState], cfg: QConfig, last: bool):
    """One joint transformer block: (x, c) -> (x, c), c None after the last."""
    st = L.silu(temb)
    with span("dgq.adaln", device=True):
        mod = L.quant_linear(p[f"{pre}.norm1.linear"], st, f"{pre}.norm1.linear", qstate, cfg)
        sh1, sc1, g1, sh2, sc2, g2 = mod.chunk(6, dim=-1)
        nx = L.ln_modulate(x, sh1, sc1)
        cmod = L.quant_linear(p[f"{pre}.norm1_context.linear"], st,
                              f"{pre}.norm1_context.linear", qstate, cfg)
        if last:
            csc1, csh1 = cmod.chunk(2, dim=-1)
        else:
            csh1, csc1, cg1, csh2, csc2, cg2 = cmod.chunk(6, dim=-1)
        nc = L.ln_modulate(c, csh1, csc1)
    a_x, a_c = L.joint_attention(p, f"{pre}.attn", nx, nc, num_heads, qstate, cfg,
                                 context_out=not last)
    x = x + g1[:, None, :] * a_x
    with span("dgq.adaln", device=True):
        h = L.ln_modulate(x, sh2, sc2)
    x = x + g2[:, None, :] * L.gelu_tanh_ff(p, f"{pre}.ff", h, qstate, cfg)
    if last:
        return x, None
    c = c + cg1[:, None, :] * a_c
    with span("dgq.adaln", device=True):
        h = L.ln_modulate(c, csh2, csc2)
    return x, c + cg2[:, None, :] * L.gelu_tanh_ff(p, f"{pre}.ff_context", h, qstate, cfg)


def depth(p: dict) -> int:
    n = 0
    while f"transformer_blocks.{n}.norm1.linear" in p:
        n += 1
    return n


def mmdit_sd3_apply(params: dict, sample: torch.Tensor, timesteps: torch.Tensor,
                    encoder_hidden_states: torch.Tensor, pooled_projections: torch.Tensor,
                    qstate: Optional[QState] = None, cfg: QConfig = QConfig(),
                    record: Optional[dict] = None, head_dim: int = 64, sample_size: int = 128,
                    pos_embed_max_size: int = 192) -> torch.Tensor:
    """Velocity of NHWC latents sample (B, H, W, 16) at timesteps (B,) or a
    scalar (sigma x 1000), prompt embeddings (B, S, 4096), pooled (B, 2048).
    The geometry defaults are SD3 medium's (transformer/config.json: heads
    of 64, sample_size 128, so the table's base is 64 patches,
    pos_embed_max_size 192)."""
    p = params
    with span("dgq.mmdit"), untimed_every_other("dgq.mmdit"):
        b, hh, ww, _ = sample.shape
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(b)
        d = out_count(p["pos_embed.proj"])
        patch = p["pos_embed.proj"]["w"].shape[-1]
        heads = d // head_dim
        with span("dgq.mmdit.embed"):
            t_emb = L.timestep_embedding(timesteps, p[
                "time_text_embed.timestep_embedder.linear_1"]["w"].shape[1]).to(sample.dtype)
            embs = []
            for mlp, inp in (("timestep_embedder", t_emb), ("text_embedder",
                                                            pooled_projections.to(sample.dtype))):
                n1, n2 = f"time_text_embed.{mlp}.linear_1", f"time_text_embed.{mlp}.linear_2"
                h = _rec(record, n1, (inp,), L.quant_linear(p[n1], inp, n1, qstate, cfg))
                h_in = L.silu(h)
                embs.append(_rec(record, n2, (h_in,), L.quant_linear(p[n2], h_in, n2, qstate,
                                                                      cfg)))
            temb = embs[0] + embs[1]
            ehs = encoder_hidden_states.to(sample.dtype)
            c = _rec(record, "context_embedder", (ehs,),
                     L.quant_linear(p["context_embedder"], ehs, "context_embedder", qstate, cfg))
            x = L.conv2d(p["pos_embed.proj"], sample, patch, 0)
            gh, gw = x.shape[1], x.shape[2]
            x = x.reshape(b, gh * gw, d) + pos_embed_table(
                d, pos_embed_max_size, sample_size // patch, gh, gw, x.device).to(x.dtype)
        n = depth(p)
        for i in range(n):
            key, last = f"transformer_blocks.{i}", i == n - 1
            with span(f"dgq.mmdit.blocks.{i}"):
                x_in, c_in = x, c
                x, c = joint_block(p, key, x, c, temb, heads, qstate, cfg, last)
                if record is not None:
                    record[key] = ((x_in, c_in, temb), x if last else torch.cat([x, c], dim=1))
        with span("dgq.mmdit.final"):
            st = L.silu(temb)
            mod = _rec(record, "norm_out.linear", (st,),
                       L.quant_linear(p["norm_out.linear"], st, "norm_out.linear", qstate, cfg))
            scale, shift = mod.chunk(2, dim=-1)
            x = L.linear(p["proj_out"], L.ln_modulate(x, shift, scale))
            co = x.shape[-1] // (patch * patch)
            x = x.reshape(b, gh, gw, patch, patch, co).permute(0, 1, 3, 2, 4, 5)
            return x.reshape(b, gh * patch, gw * patch, co)
