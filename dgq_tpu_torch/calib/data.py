"""Prompt inputs for inference without text-encoder weights, and COCO
caption sampling (port of the inference part of `dgq_tpu/calib/data.py`;
calibration-data generation waits for slice 5).

The JAX package draws its stand-in embeddings from `jax.random`; no port
reproduces that stream without JAX, so these draw from a `torch.Generator`
on the target device seeded with `seed`: the same shapes and
distributions, other values.
"""
from __future__ import annotations

import json
import random
from typing import Optional

import torch


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
