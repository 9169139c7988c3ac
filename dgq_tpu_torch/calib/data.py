"""Calibration data generation, prompt inputs for runs without text-encoder
weights, and COCO caption sampling (port of `dgq_tpu/calib/data.py`).

The calibration data are the exact UNet inputs of the fp sampling loop
(the samplers' `capture=True`: the CFG-doubled, scheduler-scaled latents and
the timestep of every call), rearranged by timestep so that chunk t holds
every prompt's latents at denoising call t. The `.npz` cache has the JAX
package's keys and layouts (`lmi`, `t`, `ehs`, `interval`; SDXL adds `te`,
`ti`), so either package reads the other's file.

The JAX package draws its initial latents and stand-in embeddings from
`jax.random`; no port reproduces that stream without JAX, so these draw from
a `torch.Generator` on the target device seeded from `seed`: the same shapes
and distributions, other values. `cali_latents` is the one place the
calibration latents are drawn, so a test can hand both packages the same.
"""
from __future__ import annotations

import json
import os
import random
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def synthetic_prompt_embeddings(n: int, seq: int = 77, dim: int = 768, seed: int = 0,
                                device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Stand-in (text, uncond) prompt embeddings, shaped and scaled like
    CLIP hidden states; uncond is one draw repeated over the batch."""
    g = torch.Generator(device=device).manual_seed(seed)
    text = torch.randn(n, seq, dim, generator=g, device=device)
    uncond = torch.randn(1, seq, dim, generator=g, device=device).expand(n, seq, dim)
    return text, uncond


def synthetic_sdxl_embeddings(n: int, seq: int = 77, dim: int = 2048, pooled_dim: int = 1280,
                              seed: int = 0, device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Stand-in (hidden-state, pooled) SDXL prompt embeddings."""
    g = torch.Generator(device=device).manual_seed(seed)
    text = torch.randn(n, seq, dim, generator=g, device=device)
    pooled = torch.randn(n, pooled_dim, generator=g, device=device)
    return text, pooled


def get_coco_prompts(path: str, num: int = 64, seed: Optional[int] = None) -> list[str]:
    """`num` captions sampled from a COCO annotations json."""
    with open(path) as f:
        anns = json.load(f)["annotations"]
    captions = [a["caption"] for a in anns]
    return random.Random(seed).sample(captions, num)


def cali_latents(seed: int, start: int, shape: tuple, device) -> torch.Tensor:
    """Initial NHWC latents of the prompt batch that starts at prompt
    `start`: a `torch.Generator` on `device` seeded with seed * 2**20 + start
    (the JAX package folds `start` into `PRNGKey(seed)`)."""
    g = torch.Generator(device=device).manual_seed(seed * (1 << 20) + start)
    return torch.randn(shape, generator=g, device=device)


def _device_of(params: dict):
    return params["conv_in"]["w"].device


def _load_cache(cache_path: Optional[str], keys: tuple):
    if not (cache_path and os.path.exists(cache_path)):
        return None
    z = np.load(cache_path)
    return tuple(torch.from_numpy(np.asarray(z[k])) for k in keys), int(z["interval"])


def _save_cache(cache_path: Optional[str], **arrays) -> None:
    """Write the .npz cache: on rank 0 alone in a process group (the ranks
    of a tp group build the data together)."""
    if cache_path and not (dist.is_initialized() and dist.get_rank() != 0):
        os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
        np.savez(cache_path, **arrays)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


@torch.no_grad()
def generate_sd_cali_data(params: dict, ehs_text: torch.Tensor, ehs_uncond: torch.Tensor,
                          steps: int = 25, scheduler: str = "pndm",
                          guidance_scale: float = 7.5, latent_hw: int = 64, seed: int = 42,
                          batch_size: int = 8, cache_path: Optional[str] = None,
                          unet_apply=None):
    """-> ((lmi, t, ehs), interval): CPU tensors ordered by timestep chunk,
    interval = 2 * n_prompts (CFG doubling). Per prompt batch the CFG layout
    is [uncond_batch | text_batch]. PNDM makes steps + 1 UNet calls, DDIM
    steps. ehs_text / ehs_uncond: (N, 77, C) prompt embeddings."""
    from dgq_tpu_torch.pipeline.sampler import sd_sample

    cached = _load_cache(cache_path, ("lmi", "t", "ehs"))
    if cached is not None:
        return cached
    device = _device_of(params)
    kw = {} if unet_apply is None else {"unet_apply": unet_apply}
    n = ehs_text.shape[0]
    lmis, ts, ehss = [], [], []
    for i in range(0, n, batch_size):
        et = ehs_text[i:i + batch_size].to(device)
        eu = ehs_uncond[i:i + batch_size].to(device)
        latents = cali_latents(seed, i, (et.shape[0], latent_hw, latent_hw, 4), device)
        _, (lmi, t) = sd_sample(params, latents, et, eu, num_inference_steps=steps,
                                scheduler=scheduler, guidance_scale=guidance_scale,
                                capture=True, **kw)
        lmis.append(_np(lmi))  # (calls, 2b, H, W, C)
        ts.append(_np(t))
        ehss.append(np.concatenate([_np(eu), _np(et)], axis=0))

    calls = lmis[0].shape[0]
    lmi_by_t = [np.concatenate([x[c] for x in lmis], axis=0) for c in range(calls)]
    ehs_cat = np.concatenate(ehss, axis=0)
    lmi_all = np.concatenate(lmi_by_t, axis=0)
    t_all = np.concatenate([np.full((lmi_by_t[c].shape[0],), ts[0][c], np.int32)
                            for c in range(calls)])
    ehs_all = np.concatenate([ehs_cat] * calls, axis=0)
    interval = 2 * n
    _save_cache(cache_path, lmi=lmi_all, t=t_all, ehs=ehs_all, interval=interval)
    return tuple(torch.from_numpy(a) for a in (lmi_all, t_all, ehs_all)), interval


@torch.no_grad()
def generate_sdxl_cali_data(params: dict, ehs_text: torch.Tensor, pooled_embeds: torch.Tensor,
                            steps: int = 4, latent_hw: int = 128, seed: int = 42,
                            batch_size: int = 4, cache_path: Optional[str] = None,
                            unet_apply=None):
    """SDXL-turbo calibration data: Euler trailing sampling at guidance 0,
    so no CFG doubling and interval = n_prompts. -> ((lmi, t, ehs,
    text_embeds, time_ids), interval), the SDXL UNet's five positional
    inputs, ordered by timestep chunk."""
    from dgq_tpu_torch.models.unet_sdxl import unet_sdxl_apply
    from dgq_tpu_torch.pipeline.sampler import sdxl_turbo_sample

    cached = _load_cache(cache_path, ("lmi", "t", "ehs", "te", "ti"))
    if cached is not None:
        return cached
    device = _device_of(params)
    apply_fn = unet_apply or unet_sdxl_apply
    n = ehs_text.shape[0]
    px = latent_hw * 8
    lmis, ts, ehss, tes, tis = [], [], [], [], []
    for i in range(0, n, batch_size):
        et = ehs_text[i:i + batch_size].to(device)
        pe = pooled_embeds[i:i + batch_size].to(device)
        b = et.shape[0]
        # micro-conditioning: (orig_h, orig_w, crop_t, crop_l, h, w)
        time_ids = torch.tensor([[px, px, 0.0, 0.0, px, px]], dtype=torch.float32,
                                device=device).repeat(b, 1)
        latents = cali_latents(seed, i, (b, latent_hw, latent_hw, 4), device)
        _, (lmi, t) = sdxl_turbo_sample(params, latents, et, pe, time_ids, unet_apply=apply_fn,
                                        num_inference_steps=steps, capture=True)
        lmis.append(_np(lmi))  # (T, b, H, W, C)
        ts.append(_np(t))
        ehss.append(_np(et))
        tes.append(_np(pe))
        tis.append(_np(time_ids))

    calls = lmis[0].shape[0]
    lmi_all = np.concatenate([np.concatenate([x[c] for x in lmis], axis=0)
                              for c in range(calls)])
    ehs_all = np.concatenate([np.concatenate(ehss, axis=0)] * calls, axis=0)
    te_all = np.concatenate([np.concatenate(tes, axis=0)] * calls, axis=0)
    ti_all = np.concatenate([np.concatenate(tis, axis=0)] * calls, axis=0)
    t_all = np.concatenate([np.full((n,), ts[0][c], np.int32) for c in range(calls)])
    interval = n
    _save_cache(cache_path, lmi=lmi_all, t=t_all, ehs=ehs_all, te=te_all, ti=ti_all,
                interval=interval)
    return tuple(torch.from_numpy(a) for a in (lmi_all, t_all, ehs_all, te_all, ti_all)), interval


def _sd_stand_ins(n, cross, pooled, seed, device):
    return synthetic_prompt_embeddings(n, dim=cross, seed=seed, device=device)


def _sdxl_stand_ins(n, cross, pooled, seed, device):
    return synthetic_sdxl_embeddings(n, dim=cross, pooled_dim=pooled, seed=seed, device=device)


# Each CLI family's stand-in prompt embeddings, (n, cross width, pooled width,
# seed, device) -> the pair its sampler takes, and its calibration-data
# generator, keyed as `models.families.FAMILIES`.
STAND_IN_EMBEDDINGS = {"sd": _sd_stand_ins, "sdxl": _sdxl_stand_ins}
CALI_DATA = {"sd": generate_sd_cali_data, "sdxl": generate_sdxl_cali_data}
