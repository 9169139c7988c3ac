"""The samplers' schedules, as diffusers' schedulers define them.

SD v1.4: scaled_linear betas 0.00085 to 0.012 over 1000 steps,
steps_offset 1, set_alpha_to_one False; PNDM with skip_prk_steps (the PLMS
updates), classifier-free guidance. SDXL-turbo: Euler discrete, trailing
spacing. DGQ's time-aware quantizers take slot (1000 - t) // (1000 // steps).
"""
from __future__ import annotations

import numpy as np
import torch


def alphas_cumprod() -> np.ndarray:
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def time_slot(t: int, steps: int) -> int:
    return (1000 - int(t)) // (1000 // steps)


def pndm_calls(steps: int) -> list:
    """The UNet's timesteps, one a call: [t_1, t_2, t_2, t_3, ..., t_N]."""
    ratio = 1000 // steps
    ts = (np.arange(steps) * ratio + 1)[::-1]
    if steps == 1:
        return [int(ts[0])]
    return [int(t) for t in np.concatenate([ts[:1], ts[1:2], ts[1:]])]


class PLMS:
    """diffusers `PNDMScheduler.step_plms`, the state of one trajectory."""

    def __init__(self, steps: int):
        self.ratio = 1000 // steps
        self.ac = alphas_cumprod()
        self.ets: list = []
        self.counter = 0
        self.cur_sample = None

    def _prev(self, sample, t, t_prev, eps):
        a_t = float(self.ac[t])
        a_prev = float(self.ac[t_prev]) if t_prev >= 0 else float(self.ac[0])
        b_t, b_prev = 1.0 - a_t, 1.0 - a_prev
        coeff = (a_prev / a_t) ** 0.5
        denom = a_t * b_prev ** 0.5 + (a_t * b_t * a_prev) ** 0.5
        return coeff * sample - (a_prev - a_t) * eps / denom

    def step(self, eps, t: int, sample):
        t_prev = t - self.ratio
        if self.counter != 1:
            self.ets = self.ets[-3:] + [eps]
        else:
            t_prev, t = t, t + self.ratio
        if len(self.ets) == 1 and self.counter == 0:
            self.cur_sample = sample
        elif len(self.ets) == 1 and self.counter == 1:
            eps = (eps + self.ets[-1]) / 2
            sample, self.cur_sample = self.cur_sample, None
        elif len(self.ets) == 2:
            eps = (3 * self.ets[-1] - self.ets[-2]) / 2
        elif len(self.ets) == 3:
            eps = (23 * self.ets[-1] - 16 * self.ets[-2] + 5 * self.ets[-3]) / 12
        else:
            eps = (55 * self.ets[-1] - 59 * self.ets[-2] + 37 * self.ets[-3]
                   - 9 * self.ets[-4]) / 24
        self.counter += 1
        return self._prev(sample, t, t_prev, eps)


def guided(eps: torch.Tensor, scale: float) -> torch.Tensor:
    """Classifier-free guidance over the [uncond, text] halves of a batch."""
    u, c = eps.chunk(2, dim=0)
    return u + scale * (c - u)


def initial_latents(b: int, height: int, width: int, seed: int, device) -> torch.Tensor:
    """The noise a pipeline draws for `seed`: NHWC (b, h/8, w/8, 4), from a
    generator on the device."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(b, height // 8, width // 8, 4, generator=g, device=device)
