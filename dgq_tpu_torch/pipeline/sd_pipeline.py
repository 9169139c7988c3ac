"""Text-to-image pipelines: CLIP text encoding -> denoising -> VAE decode
(port of `dgq_tpu/pipeline/sd_pipeline.py`), and SD3 medium's (no JAX
counterpart), which takes prompt embeddings only.

Weights come from local HF snapshots through the converters; every stage
also runs with random weights. Each pipeline runs on its `device` (the card
by default).

The initial latents are drawn from a `torch.Generator` on the device seeded
with `seed`. The JAX package draws them from `jax.random.PRNGKey(seed)`, a
stream no port reproduces without JAX, so the same seed gives other
latents here; `_initial_latents` is the one place that draws them, so a
test can hand both packages the same ones.

`generate_from_embeddings(rows=)` generates some rows of a batch (a
data-parallel rank's): the latents are drawn for the whole batch first, so
each row gets the noise it gets when the whole batch runs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from dgq_tpu_torch.models.mmdit_sd3 import mmdit_sd3_apply
from dgq_tpu_torch.models.qconfig import QConfig, QState
from dgq_tpu_torch.models.unet_sd import unet_sd_apply
from dgq_tpu_torch.models.unet_sdxl import unet_sdxl_apply
from dgq_tpu_torch.pipeline.sampler import sd3_sample, sd_sample, sdxl_turbo_sample
from dgq_tpu_torch.pipeline.text_encoder import clip_text_encode, sdxl_encode_prompt
from dgq_tpu_torch.pipeline.vae import (
    SD3_VAE_SCALE,
    SD3_VAE_SHIFT,
    SDXL_VAE_SCALE,
    latents_to_images,
    vae_decode,
)
from dgq_tpu_torch.utils.profiler import span


def _token_ids(tokenizer, prompts: list[str], device) -> torch.Tensor:
    ids = tokenizer(prompts, padding="max_length", max_length=77, truncation=True,
                    return_tensors="np").input_ids
    return torch.as_tensor(np.asarray(ids), dtype=torch.long, device=device)


def _initial_latents(b: int, height: int, width: int, seed: int, device,
                     channels: int = 4) -> torch.Tensor:
    """NHWC noise latents (b, height // 8, width // 8, channels), f32."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(b, height // 8, width // 8, channels, generator=g, device=device)


@dataclasses.dataclass
class SDPipeline:
    """Stable Diffusion v1.4 over the functional parts.

    unet_params should already have their quantized weights folded; qstate
    carries the activation quantizers ([T]-stacked when time_aware)."""

    unet_params: dict
    text_params: Optional[dict] = None
    vae_params: Optional[dict] = None
    tokenizer: Optional[object] = None  # HF CLIPTokenizer (local files)
    cfg: QConfig = QConfig()
    qstate: Optional[QState] = None
    time_aware: bool = False
    unet_apply: object = unet_sd_apply
    device: str = "cuda"

    def encode_prompts(self, prompts: list[str], negative: str = "") -> tuple:
        if self.tokenizer is None or self.text_params is None:
            raise RuntimeError(
                "tokenizer/text encoder weights unavailable; pass prompt "
                "embeddings directly to generate_from_embeddings()")
        text = clip_text_encode(self.text_params, _token_ids(self.tokenizer, prompts,
                                                             self.device))
        uncond = clip_text_encode(self.text_params, _token_ids(
            self.tokenizer, [negative] * len(prompts), self.device))
        return text, uncond

    def _initial_latents(self, b: int, height: int, width: int, seed: int) -> torch.Tensor:
        return _initial_latents(b, height, width, seed, self.device)

    def generate_from_embeddings(self, ehs_text: torch.Tensor, ehs_uncond: torch.Tensor,
                                 steps: int = 25, scheduler: str = "pndm",
                                 guidance_scale: float = 7.5, height: int = 512,
                                 width: int = 512, seed: int = 42,
                                 rows: Optional[list] = None) -> np.ndarray:
        """Latents (no VAE) or uint8 images, as numpy; of the batch rows
        `rows` only, when given."""
        with span("dgq.generate"):
            latents = self._initial_latents(ehs_text.shape[0], height, width, seed)
            if rows is not None:
                latents, ehs_text, ehs_uncond = latents[rows], ehs_text[rows], ehs_uncond[rows]
            final = sd_sample(self.unet_params, latents, ehs_text, ehs_uncond,
                              num_inference_steps=steps, scheduler=scheduler,
                              guidance_scale=guidance_scale, qstate=self.qstate, cfg=self.cfg,
                              time_aware=self.time_aware, unet_apply=self.unet_apply)
            if self.vae_params is None:
                return final.cpu().numpy()
            images = vae_decode(self.vae_params, final)
            # the batch's one wait for the card
            with span("dgq.images"):
                return latents_to_images(images)

    def __call__(self, prompts: list[str], steps: int = 25, **kw) -> np.ndarray:
        text, uncond = self.encode_prompts(prompts)
        return self.generate_from_embeddings(text, uncond, steps=steps, **kw)


@dataclasses.dataclass
class SDXLTurboPipeline:
    """SDXL-turbo: 1 to 4 Euler steps, guidance 0, 1024px.

    Prompts are encoded by the dual-encoder scheme (`sdxl_encode_prompt`)
    from text_params_l / _g and the two tokenizers. Layer and head counts
    are fields, so tiny test encoders work."""

    unet_params: dict
    vae_params: Optional[dict] = None
    text_params_l: Optional[dict] = None
    text_params_g: Optional[dict] = None
    tokenizer: Optional[object] = None    # CLIPTokenizer (encoder 1)
    tokenizer_2: Optional[object] = None  # CLIPTokenizer (encoder 2, '!' pad)
    layers_l: int = 12
    heads_l: int = 12
    layers_g: int = 32
    heads_g: int = 20
    cfg: QConfig = QConfig()
    qstate: Optional[QState] = None
    time_aware: bool = False
    unet_apply: object = unet_sdxl_apply
    device: str = "cuda"

    def encode_prompts(self, prompts: list[str]) -> tuple:
        """-> (encoder_hidden_states (B, 77, 2048), pooled text_embeds (B, 1280))."""
        if None in (self.tokenizer, self.tokenizer_2, self.text_params_l, self.text_params_g):
            raise RuntimeError(
                "tokenizers/text encoder weights unavailable; pass embeddings "
                "directly to generate_from_embeddings()")
        return sdxl_encode_prompt(
            self.text_params_l, self.text_params_g,
            _token_ids(self.tokenizer, prompts, self.device),
            _token_ids(self.tokenizer_2, prompts, self.device),
            layers_l=self.layers_l, heads_l=self.heads_l,
            layers_g=self.layers_g, heads_g=self.heads_g,
            eos_id=self.tokenizer_2.eos_token_id)

    def __call__(self, prompts: list[str], steps: int = 4, **kw) -> np.ndarray:
        ehs, pooled = self.encode_prompts(prompts)
        return self.generate_from_embeddings(ehs, pooled, steps=steps, **kw)

    def _initial_latents(self, b: int, height: int, width: int, seed: int) -> torch.Tensor:
        return _initial_latents(b, height, width, seed, self.device)

    def generate_from_embeddings(self, ehs_text: torch.Tensor, text_embeds: torch.Tensor,
                                 steps: int = 4, height: int = 1024, width: int = 1024,
                                 seed: int = 42, rows: Optional[list] = None) -> np.ndarray:
        with span("dgq.generate"):
            latents = self._initial_latents(ehs_text.shape[0], height, width, seed)
            if rows is not None:
                latents, ehs_text, text_embeds = latents[rows], ehs_text[rows], text_embeds[rows]
            b = latents.shape[0]
            # SDXL micro-conditioning time_ids: (orig_h, orig_w, crop_t, crop_l, h, w)
            time_ids = torch.tensor([[height, width, 0.0, 0.0, height, width]],
                                    dtype=torch.float32, device=self.device).repeat(b, 1)
            final = sdxl_turbo_sample(self.unet_params, latents, ehs_text, text_embeds,
                                      time_ids, unet_apply=self.unet_apply,
                                      num_inference_steps=steps, qstate=self.qstate,
                                      cfg=self.cfg, time_aware=self.time_aware)
            if self.vae_params is None:
                return final.cpu().numpy()
            images = vae_decode(self.vae_params, final, scale=SDXL_VAE_SCALE)
            with span("dgq.images"):
                return latents_to_images(images)


@dataclasses.dataclass
class SD3Pipeline:
    """Stable Diffusion 3 medium: the MMDiT (`models.mmdit_sd3`), 28
    flow-matching Euler steps with classifier-free guidance 7.0 (shift 3.0),
    1024px, the 16-channel VAE decode. Its text encoders (CLIP-L, CLIP-G,
    T5-XXL) are not part of the port: prompts come as embeddings, (B, 333,
    4096) (77 CLIP rows padded to 4096 columns, then 256 T5 rows) and pooled
    (B, 2048). `geometry` overrides mmdit_sd3_apply's head_dim, sample_size
    and pos_embed_max_size (SD3 medium's by default; tiny test models change
    them); a time-aware qstate has a slot a step, selected by step index."""

    transformer_params: dict
    vae_params: Optional[dict] = None
    cfg: QConfig = QConfig()
    qstate: Optional[QState] = None
    time_aware: bool = False
    transformer_apply: object = mmdit_sd3_apply
    geometry: dict = dataclasses.field(default_factory=dict)
    device: str = "cuda"

    def encode_prompts(self, prompts: list[str]) -> tuple:
        raise RuntimeError(
            "text encoders (CLIP-L, CLIP-G, T5-XXL) unavailable; pass prompt embeddings "
            "directly to generate_from_embeddings()")

    def _apply(self, params, x, t, ehs, pooled, qstate=None, cfg=QConfig()):
        return self.transformer_apply(params, x, t, ehs, pooled, qstate=qstate, cfg=cfg,
                                      **self.geometry)

    def generate_from_embeddings(self, ehs_text: torch.Tensor, pooled_text: torch.Tensor,
                                 ehs_uncond: torch.Tensor, pooled_uncond: torch.Tensor,
                                 steps: int = 28, guidance_scale: float = 7.0,
                                 height: int = 1024, width: int = 1024, seed: int = 42,
                                 rows: Optional[list] = None) -> np.ndarray:
        """Latents (no VAE) or uint8 images, as numpy; of the batch rows
        `rows` only, when given."""
        with span("dgq.generate"):
            channels = self.transformer_params["pos_embed.proj"]["w"].shape[1]
            latents = _initial_latents(ehs_text.shape[0], height, width, seed, self.device,
                                       channels)
            if rows is not None:
                latents, ehs_text, pooled_text = latents[rows], ehs_text[rows], pooled_text[rows]
                ehs_uncond, pooled_uncond = ehs_uncond[rows], pooled_uncond[rows]
            final = sd3_sample(self.transformer_params, latents, ehs_text, pooled_text,
                               ehs_uncond, pooled_uncond, self._apply,
                               num_inference_steps=steps, guidance_scale=guidance_scale,
                               qstate=self.qstate, cfg=self.cfg, time_aware=self.time_aware)
            if self.vae_params is None:
                return final.cpu().numpy()
            images = vae_decode(self.vae_params, final, scale=SD3_VAE_SCALE, shift=SD3_VAE_SHIFT)
            with span("dgq.images"):
                return latents_to_images(images)
