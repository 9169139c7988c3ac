"""DDIM for SD v1.4 (port of the DDIM part of `dgq_tpu/pipeline/schedulers.py`;
PNDM-PLMS and Euler wait for later slices).

SD v1.4 betas: scaled_linear 0.00085 -> 0.012, 1000 train steps,
steps_offset=1, set_alpha_to_one=False.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def sd_alphas_cumprod(num_train_timesteps: int = 1000, beta_start: float = 0.00085,
                      beta_end: float = 0.012) -> np.ndarray:
    """scaled_linear beta schedule -> cumulative alpha products."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train_timesteps) ** 2
    return np.cumprod(1.0 - betas, axis=0)


class DDIMConsts(NamedTuple):
    timesteps: torch.Tensor   # [T] int32
    alpha_t: torch.Tensor     # [T] f32, alpha_cumprod at t
    alpha_prev: torch.Tensor  # [T] f32, at t_prev (final step -> alphas_cumprod[0])


def make_ddim(num_inference_steps: int, num_train_timesteps: int = 1000,
              steps_offset: int = 1, set_alpha_to_one: bool = False) -> DDIMConsts:
    """Per-step constants, on the host (the loop reads them as scalars)."""
    step = num_train_timesteps // num_inference_steps
    timesteps = (np.arange(0, num_inference_steps) * step).round()[::-1].astype(np.int64)
    timesteps = timesteps + steps_offset
    ac = sd_alphas_cumprod(num_train_timesteps)
    prev_t = timesteps - step
    final_alpha = 1.0 if set_alpha_to_one else ac[0]
    alpha_prev = np.where(prev_t >= 0, ac[np.clip(prev_t, 0, None)], final_alpha)
    return DDIMConsts(
        timesteps=torch.tensor(timesteps, dtype=torch.int32),
        alpha_t=torch.tensor(ac[timesteps], dtype=torch.float32),
        alpha_prev=torch.tensor(alpha_prev, dtype=torch.float32),
    )


def ddim_step(latents: torch.Tensor, eps: torch.Tensor, alpha_t: torch.Tensor,
              alpha_prev: torch.Tensor) -> torch.Tensor:
    """Deterministic DDIM update (eta=0), epsilon prediction. Math in f32
    (alpha_t/alpha_prev are f32 scalar tensors), result in the latents' dtype
    so a bf16 loop carry stays bf16."""
    x = latents.float()
    e = eps.float()
    x0 = (x - torch.sqrt(1.0 - alpha_t) * e) / torch.sqrt(alpha_t)
    out = torch.sqrt(alpha_prev) * x0 + torch.sqrt(1.0 - alpha_prev) * e
    return out.to(latents.dtype)
