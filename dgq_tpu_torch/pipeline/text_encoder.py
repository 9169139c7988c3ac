"""CLIP text encoders, SD v1.4's prompt encoder and SDXL's pair (port of
`dgq_tpu/pipeline/text_encoder.py`).

CLIP-L (openai/clip-vit-large-patch14: width 768, 12 layers, 12 heads, 77
tokens, quick-GELU) is a pure function over a params dict, with a converter
from the HF torch state dict. SDXL adds OpenCLIP ViT-bigG (width 1280, 32
layers, exact GELU), whose projected pooled output feeds the UNet's
add_embedding; the same functions cover it with other widths.

Params keep the HF layouts: linears (O, I) as `models.layers.linear` takes
them, and `text_projection` (proj, width) as HF's bias-free Linear stores
it (the JAX package keeps (width, proj) and right-multiplies). The
attention is a plain matmul and softmax, as in the JAX package, where it
runs outside any Pallas kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from dgq_tpu_torch.io.convert import _tensor
from dgq_tpu_torch.models.layers import layer_norm, linear


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def clip_attention(p, prefix: str, x: torch.Tensor, num_heads: int,
                   causal_mask: torch.Tensor) -> torch.Tensor:
    b, t, c = x.shape
    hd = c // num_heads

    def heads(y):
        return y.reshape(b, t, num_heads, hd).transpose(1, 2)

    q = heads(linear(p[f"{prefix}.q_proj"], x) * (hd ** -0.5))
    k = heads(linear(p[f"{prefix}.k_proj"], x))
    v = heads(linear(p[f"{prefix}.v_proj"], x))
    # scores and softmax in f32, probabilities in v's dtype
    scores = q.float() @ k.float().transpose(-1, -2)
    scores = scores.masked_fill(~causal_mask, float("-inf"))
    attn = torch.softmax(scores, dim=-1).to(v.dtype)
    out = (attn @ v).transpose(1, 2).reshape(b, t, c)
    return linear(p[f"{prefix}.out_proj"], out)


def _encode_layers(params, input_ids, num_layers, num_heads, act, capture_penultimate: bool):
    """The transformer stack; optionally also the hidden state before the
    last layer (HF output_hidden_states[-2])."""
    # 'gelu' is the exact erf form (HF nn.GELU's default)
    act_fn = quick_gelu if act == "quick_gelu" else (lambda h: F.gelu(h, approximate="none"))
    t = input_ids.shape[-1]
    x = params["token_embedding"][input_ids] + params["position_embedding"][:t]
    mask = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device))
    penult = None
    for i in range(num_layers):
        if capture_penultimate and i == num_layers - 1:
            penult = x
        pre = f"encoder.layers.{i}"
        h = layer_norm(params[f"{pre}.layer_norm1"], x)
        x = x + clip_attention(params, f"{pre}.self_attn", h, num_heads, mask)
        h = layer_norm(params[f"{pre}.layer_norm2"], x)
        h = act_fn(linear(params[f"{pre}.mlp.fc1"], h))
        x = x + linear(params[f"{pre}.mlp.fc2"], h)
    return x, penult


@torch.no_grad()
def clip_text_encode(params: dict, input_ids: torch.Tensor, num_layers: int = 12,
                     num_heads: int = 12, final_norm: bool = True, act: str = "quick_gelu",
                     skip_last: int = 0) -> torch.Tensor:
    """Hidden states (B, 77, width), what SD feeds the UNet.

    skip_last=1 stops after num_layers - 1 layers and skips the final layer
    norm (HF output_hidden_states[-2], which SDXL feeds the UNet).
    act: 'quick_gelu' (openai CLIP-L) or 'gelu' (OpenCLIP bigG)."""
    if skip_last:
        x, _ = _encode_layers(params, input_ids, num_layers - skip_last, num_heads, act, False)
        return x
    x, _ = _encode_layers(params, input_ids, num_layers, num_heads, act, False)
    if final_norm:
        x = layer_norm(params["final_layer_norm"], x)
    return x


def _eos_positions(input_ids: torch.Tensor, eos_id: int) -> torch.Tensor:
    """First EOS token of each row (HF CLIP pooling for non-legacy EOS ids);
    the row's argmax id where it holds none."""
    is_eos = input_ids == eos_id
    pos = torch.argmax(is_eos.int(), dim=-1)
    return torch.where(is_eos.any(dim=-1), pos, torch.argmax(input_ids, dim=-1))


def _pool(params, x, input_ids, eos_id):
    eos = _eos_positions(input_ids, eos_id)
    pooled = x[torch.arange(x.shape[0], device=x.device), eos]
    return F.linear(pooled, params["text_projection"].to(pooled.dtype))


@torch.no_grad()
def clip_text_pooled(params: dict, input_ids: torch.Tensor, num_layers: int, num_heads: int,
                     act: str = "gelu", eos_id: int = 49407) -> torch.Tensor:
    """Projected pooled output (B, proj_dim): the final-normed hidden state
    at the first EOS token through text_projection (HF
    CLIPTextModelWithProjection's text_embeds, SDXL's pooled embeds)."""
    x = clip_text_encode(params, input_ids, num_layers, num_heads, final_norm=True, act=act)
    return _pool(params, x, input_ids, eos_id)


@torch.no_grad()
def sdxl_encode_prompt(params_l: dict, params_g: dict, ids_l: torch.Tensor,
                       ids_g: torch.Tensor, layers_l: int = 12, heads_l: int = 12,
                       layers_g: int = 32, heads_g: int = 20, eos_id: int = 49407) -> tuple:
    """SDXL's dual-encoder prompt encoding -> (encoder_hidden_states
    (B, 77, 768 + 1280), pooled (B, 1280)): the penultimate hidden states of
    CLIP-L and bigG side by side, and bigG's projected pooled embedding. The
    bigG stack runs once, the penultimate state captured on the way."""
    h_l = clip_text_encode(params_l, ids_l, layers_l, heads_l, act="quick_gelu", skip_last=1)
    x_g, h_g = _encode_layers(params_g, ids_g, layers_g, heads_g, "gelu",
                              capture_penultimate=True)
    x_g = layer_norm(params_g["final_layer_norm"], x_g)
    return torch.cat([h_l, h_g], dim=-1), _pool(params_g, x_g, ids_g, eos_id)


def hf_clip_text_to_params(state: dict, device="cuda") -> dict:
    """An HF CLIPTextModel state dict (arrays or tensors; keys with or
    without 'text_model.') -> params. A top-level 'text_projection.weight'
    (CLIPTextModelWithProjection, SDXL's second encoder) becomes
    params['text_projection'], (proj, width)."""
    s = {(k[len("text_model."):] if k.startswith("text_model.") else k): v
         for k, v in state.items()}

    def t(key):
        return _tensor(s[key], device)

    def norm(pre):
        return {"scale": t(f"{pre}.weight"), "bias": t(f"{pre}.bias")}

    params = {
        "token_embedding": t("embeddings.token_embedding.weight"),
        "position_embedding": t("embeddings.position_embedding.weight"),
        "final_layer_norm": norm("final_layer_norm"),
    }
    if "text_projection.weight" in s:
        params["text_projection"] = t("text_projection.weight")
    i = 0
    while f"encoder.layers.{i}.layer_norm1.weight" in s:
        pre = f"encoder.layers.{i}"
        for ln in ("layer_norm1", "layer_norm2"):
            params[f"{pre}.{ln}"] = norm(f"{pre}.{ln}")
        for lin in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                    "self_attn.out_proj", "mlp.fc1", "mlp.fc2"):
            params[f"{pre}.{lin}"] = {"w": t(f"{pre}.{lin}.weight"), "b": t(f"{pre}.{lin}.bias")}
        i += 1
    return params


def clip_meta_from_params(params: dict) -> tuple[int, int]:
    """(num_layers, num_heads) of a converted params dict: the layer count
    from the encoder.layers.N keys, heads as width // 64 (the CLIP family
    keeps head_dim 64: CLIP-L 12, bigG 20; encoders narrower than 64 get
    one head)."""
    layers = 0
    while f"encoder.layers.{layers}.layer_norm1" in params:
        layers += 1
    return layers, max(1, params["token_embedding"].shape[1] // 64)


@torch.no_grad()
def init_clip_text(generator: torch.Generator, device="cuda", vocab: int = 49408,
                   width: int = 768, layers: int = 12, seq: int = 77, mlp_ratio: int = 4,
                   dtype=torch.float32, proj_dim: int = 0) -> dict:
    """Random params drawn on `device` from `generator` (which lives there).
    proj_dim > 0 adds text_projection (the WithProjection variant, SDXL's
    second encoder)."""
    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=device) * std).to(dtype)

    def norm():
        return {"scale": torch.ones(width, dtype=dtype, device=device),
                "bias": torch.zeros(width, dtype=dtype, device=device)}

    params = {"token_embedding": normal((vocab, width), 0.02),
              "position_embedding": normal((seq, width), 0.01),
              "final_layer_norm": norm()}
    dims = {"self_attn.q_proj": (width, width), "self_attn.k_proj": (width, width),
            "self_attn.v_proj": (width, width), "self_attn.out_proj": (width, width),
            "mlp.fc1": (width, width * mlp_ratio), "mlp.fc2": (width * mlp_ratio, width)}
    for i in range(layers):
        pre = f"encoder.layers.{i}"
        params[f"{pre}.layer_norm1"], params[f"{pre}.layer_norm2"] = norm(), norm()
        for name, (ci, co) in dims.items():
            params[f"{pre}.{name}"] = {"w": normal((co, ci), 1 / math.sqrt(ci)),
                                       "b": torch.zeros(co, dtype=dtype, device=device)}
    if proj_dim:
        params["text_projection"] = normal((proj_dim, width), 1 / math.sqrt(width))
    return params
