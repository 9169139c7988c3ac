"""DDIM and PNDM-PLMS for SD v1.4 and Euler-discrete for SDXL-turbo (port of
`dgq_tpu/pipeline/schedulers.py`), and flow-matching Euler for SD3 (no JAX
counterpart).

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


# ------------------------------------------------------------ PNDM / PLMS ---
class PNDMConsts(NamedTuple):
    """Per-UNet-call constants. With skip_prk_steps=True, diffusers PNDM runs
    PLMS: the second timestep is repeated (one extra UNet call at the start),
    so there are T+1 calls for T steps."""

    timesteps: torch.Tensor   # [T+1] int32: t passed to the UNet at each call
    alpha_t: torch.Tensor     # [T+1] f32
    alpha_prev: torch.Tensor  # [T+1] f32


class PNDMState(NamedTuple):
    ets: torch.Tensor         # [4, ...latent shape...] eps history, newest last
    num_ets: int              # count of valid entries
    cur_sample: torch.Tensor  # latent stashed across the first two calls


def make_pndm(num_inference_steps: int, num_train_timesteps: int = 1000,
              steps_offset: int = 1, set_alpha_to_one: bool = False) -> PNDMConsts:
    step = num_train_timesteps // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * step).round().astype(np.int64)
    ts = (ts + steps_offset)[::-1]  # descending
    if num_inference_steps == 1:
        call_ts = ts
        eff_t, eff_prev = ts, ts - step
    else:
        # diffusers plms_timesteps (skip_prk_steps): the UNet-call sequence is
        # [t_max, t2, t2, t3, ...]; both of the first two calls integrate
        # t_max -> t2 (the step_plms counter == 1 branch)
        call_ts = np.concatenate([ts[:1], ts[1:2], ts[1:]])
        eff_t = np.concatenate([ts[:1], ts[:1], ts[1:]])
        eff_prev = np.concatenate([ts[1:2], ts[1:2], ts[1:] - step])
    ac = sd_alphas_cumprod(num_train_timesteps)
    final_alpha = 1.0 if set_alpha_to_one else ac[0]
    alpha_prev = np.where(eff_prev >= 0, ac[np.clip(eff_prev, 0, None)], final_alpha)
    return PNDMConsts(
        timesteps=torch.tensor(call_ts.copy(), dtype=torch.int32),
        alpha_t=torch.tensor(ac[eff_t], dtype=torch.float32),
        alpha_prev=torch.tensor(alpha_prev, dtype=torch.float32),
    )


def _pndm_prev_sample(sample, eps, alpha_t, alpha_prev):
    """diffusers PNDM `_get_prev_sample`."""
    beta_t = 1.0 - alpha_t
    beta_prev = 1.0 - alpha_prev
    sample_coeff = torch.sqrt(alpha_prev / alpha_t)
    eps_coeff = alpha_t * torch.sqrt(beta_prev) + torch.sqrt(alpha_t * beta_t * alpha_prev)
    return sample_coeff * sample - (alpha_prev - alpha_t) * eps / eps_coeff


def pndm_init_state(latents: torch.Tensor) -> PNDMState:
    return PNDMState(ets=torch.zeros((4,) + tuple(latents.shape), dtype=latents.dtype,
                                     device=latents.device),
                     num_ets=0, cur_sample=latents)


def pndm_plms_step(state: PNDMState, call_idx: int, latents: torch.Tensor, eps: torch.Tensor,
                   alpha_t: torch.Tensor, alpha_prev: torch.Tensor):
    """One PLMS UNet-call update (diffusers `step_plms`); call_idx is a host
    integer, so the branches the JAX package selects on the device are taken
    in Python.

    call_idx 0: record eps, stash the sample, take a half-informed first step.
    call_idx 1: average with the new eps, restart from the stashed sample.
    call_idx >= 2: Adams-Bashforth multistep on the eps history."""
    eps = eps.to(state.ets.dtype)
    if call_idx == 1:
        ets, num_ets = state.ets, state.num_ets
        eps_prime = (eps + ets[-1]) / 2.0
        sample = state.cur_sample
    else:
        ets = torch.cat([state.ets[1:], eps[None]], dim=0)
        num_ets = state.num_ets + 1
        e1, e2, e3, e4 = ets[-1], ets[-2], ets[-3], ets[-4]
        if num_ets == 1:
            eps_prime = eps
        elif num_ets == 2:
            eps_prime = (3.0 * e1 - e2) / 2.0
        elif num_ets == 3:
            eps_prime = (23.0 * e1 - 16.0 * e2 + 5.0 * e3) / 12.0
        else:
            eps_prime = (55.0 * e1 - 59.0 * e2 + 37.0 * e3 - 9.0 * e4) / 24.0
        sample = latents
    prev = _pndm_prev_sample(sample.float(), eps_prime.float(), alpha_t,
                             alpha_prev).to(latents.dtype)
    cur = latents if call_idx == 0 else state.cur_sample
    return PNDMState(ets, num_ets, cur), prev


# -------------------------------------------------------- Euler discrete ----
class EulerConsts(NamedTuple):
    timesteps: torch.Tensor   # [T] f32 (UNet conditioning values)
    sigmas: torch.Tensor      # [T+1] f32 (sigma_T ... sigma_0 = 0)


def make_euler(num_inference_steps: int, num_train_timesteps: int = 1000,
               timestep_spacing: str = "trailing") -> EulerConsts:
    """EulerDiscrete for SDXL-turbo (trailing spacing, 1-4 steps, no noise).
    Constants on the host, as make_ddim."""
    ac = sd_alphas_cumprod(num_train_timesteps)
    all_sigmas = np.sqrt((1.0 - ac) / ac)
    if timestep_spacing == "trailing":
        ts = np.arange(num_train_timesteps, 0, -num_train_timesteps / num_inference_steps)
        ts = (ts - 1).round().astype(np.float32)
    else:  # leading
        step = num_train_timesteps // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * step).round()[::-1].astype(np.float32)
    sigmas = np.interp(ts, np.arange(0, num_train_timesteps), all_sigmas)
    sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
    return EulerConsts(timesteps=torch.tensor(ts.copy()), sigmas=torch.tensor(sigmas))


def euler_scale_model_input(latents: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Math in f32, result in the latents' dtype (see ddim_step)."""
    x = latents.float() / torch.sqrt(sigma.float() ** 2 + 1.0)
    return x.to(latents.dtype)


def euler_step(latents: torch.Tensor, eps: torch.Tensor, sigma: torch.Tensor,
               sigma_next: torch.Tensor) -> torch.Tensor:
    """Euler update, epsilon prediction: x0 = x - sigma*eps; dx = (x - x0)/sigma."""
    x = latents.float()
    pred_original = x - sigma * eps.float()
    derivative = (x - pred_original) / sigma
    return (x + derivative * (sigma_next - sigma)).to(latents.dtype)


def euler_init_sigma(num_inference_steps: int, **kw) -> torch.Tensor:
    return make_euler(num_inference_steps, **kw).sigmas[0]


class FlowMatchConsts(NamedTuple):
    timesteps: torch.Tensor  # [N] f32, sigma x 1000
    sigmas: torch.Tensor     # [N + 1] f32, the last 0


def flow_shift(sigma, shift: float):
    return shift * sigma / (1 + (shift - 1) * sigma)


def make_flow_match(num_inference_steps: int, shift: float = 3.0,
                    num_train_timesteps: int = 1000) -> FlowMatchConsts:
    """diffusers' FlowMatchEulerDiscreteScheduler (SD3: shift 3.0, no
    dynamic shifting). Its training sigmas are shifted once, so the last is
    s(1 / 1000) in f32; set_timesteps spaces sigma x 1000 linearly from 1000
    to that in f64 and shifts again: sigma_i = s(u_i), u = linspace(1,
    s(0.001), N), s(u) = shift u / (1 + (shift - 1) u); then f32, t = 1000
    sigma, and a final sigma of 0."""
    s_min = float(flow_shift(torch.tensor(1.0 / num_train_timesteps, dtype=torch.float32),
                             shift))
    u = np.linspace(1.0, s_min, num_inference_steps)
    sigmas = torch.tensor(flow_shift(u, shift), dtype=torch.float32)
    return FlowMatchConsts(timesteps=sigmas * num_train_timesteps,
                           sigmas=torch.cat([sigmas, torch.zeros(1)]))


def flow_euler_step(latents: torch.Tensor, v: torch.Tensor, sigma: torch.Tensor,
                    sigma_next: torch.Tensor) -> torch.Tensor:
    """x + (sigma_next - sigma) v, in f32, the result in the latents' dtype."""
    return (latents.float() + (sigma_next - sigma) * v.float()).to(latents.dtype)
