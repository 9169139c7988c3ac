"""SD v1.4 sampling (DDIM or PNDM-PLMS) with classifier-free guidance and
SDXL-turbo sampling (Euler, guidance 0) (port of
`dgq_tpu/pipeline/sampler.py`).

The JAX package compiles the loop into one `lax.scan`; here it is a Python
loop. Time-aware activation qparams carry a leading [T_slots] axis; each step
picks its slot by a host-side index (the schedule is known on the host), so
no step waits on the device.
"""
from __future__ import annotations

from typing import Optional

import torch

from dgq_tpu_torch.models.qconfig import GroupQParams, QConfig, QState
from dgq_tpu_torch.models.unet_sd import unet_sd_apply
from dgq_tpu_torch.pipeline import schedulers as sch
from dgq_tpu_torch.quant.affine import QParams


def timestep_slot(t, num_inference_steps: int):
    """act_{(1000 - t) // (1000 // steps)} (the reference's slot map)."""
    return (1000 - t) // (1000 // num_inference_steps)


def check_time_aware_steps(num_inference_steps: int, time_aware: bool, qstate) -> None:
    """The reference's slot formula assumes 1000 % steps == 0; any other step
    count would index slots that were never calibrated, so reject loudly."""
    if time_aware and qstate is not None and 1000 % num_inference_steps:
        raise ValueError(
            f"time-aware qstates require num_inference_steps dividing 1000 "
            f"(got {num_inference_steps}): the reference slot map "
            f"(calibration.py:300-304) is undefined otherwise")


def select_time_qstate(qstate: Optional[QState], t: int, steps: int) -> Optional[QState]:
    """The slice of stacked [T_slots, ...] activation qparams for timestep t."""
    if qstate is None:
        return None
    slot = int(timestep_slot(int(t), steps))

    def pick(leaf):
        if isinstance(leaf, QParams):
            return QParams(leaf.delta[slot], leaf.zero_point[slot])
        if isinstance(leaf, GroupQParams):
            return GroupQParams(leaf.delta_mid[slot], leaf.zp_mid[slot],
                                leaf.delta_last[slot], leaf.zp_last[slot])
        return leaf[slot]

    out = dict(qstate)
    for key in ("a", "sm"):
        if key in qstate:
            out[key] = {name: pick(leaf) for name, leaf in qstate[key].items()}
    return out


@torch.no_grad()
def sd_sample(params: dict, latents: torch.Tensor, ehs_text: torch.Tensor,
              ehs_uncond: torch.Tensor, num_inference_steps: int = 50,
              scheduler: str = "ddim", guidance_scale: float = 7.5,
              qstate: Optional[QState] = None, cfg: QConfig = QConfig(),
              time_aware: bool = False, unet_apply=unet_sd_apply, capture: bool = False):
    """SD v1.4 latent sampling from NHWC noise latents (B, 64, 64, 4).
    The CFG batch is [uncond, text].

    Returns the final latents; with capture=True also the UNet's inputs of
    every call, stacked as the JAX sampler's scan stacks them:
    (x, (latent_model_input (calls, 2B, 64, 64, 4), timesteps (calls,) int32)),
    calls = steps + 1 under PNDM."""
    if scheduler not in ("ddim", "pndm"):
        raise ValueError(f"unknown scheduler {scheduler}")
    check_time_aware_steps(num_inference_steps, time_aware, qstate)
    ehs = torch.cat([ehs_uncond, ehs_text], dim=0)
    ddim = scheduler == "ddim"
    consts = sch.make_ddim(num_inference_steps) if ddim else sch.make_pndm(num_inference_steps)
    x = latents
    state = None if ddim else sch.pndm_init_state(latents)
    inputs = []
    for i in range(len(consts.timesteps)):  # PNDM makes one more UNet call than steps
        t = int(consts.timesteps[i])
        qs = select_time_qstate(qstate, t, num_inference_steps) if time_aware else qstate
        lmi = torch.cat([x, x], dim=0)
        tt = torch.full((lmi.shape[0],), t, dtype=torch.int32, device=lmi.device)
        eps = unet_apply(params, lmi, tt, ehs, qstate=qs, cfg=cfg)
        if capture:
            inputs.append(lmi)
        eps_u, eps_t = eps.chunk(2, dim=0)
        eps = eps_u + guidance_scale * (eps_t - eps_u)
        if ddim:
            x = sch.ddim_step(x, eps, consts.alpha_t[i], consts.alpha_prev[i])
        else:
            state, x = sch.pndm_plms_step(state, i, x, eps, consts.alpha_t[i],
                                          consts.alpha_prev[i])
    if capture:
        return x, (torch.stack(inputs), consts.timesteps.to(latents.device))
    return x


@torch.no_grad()
def sdxl_turbo_sample(params: dict, latents: torch.Tensor, ehs_text: torch.Tensor,
                      added_text_embeds: torch.Tensor, added_time_ids: torch.Tensor,
                      unet_apply, num_inference_steps: int = 4,
                      qstate: Optional[QState] = None, cfg: QConfig = QConfig(),
                      time_aware: bool = False, capture: bool = False):
    """SDXL-turbo sampling: Euler trailing, guidance 0 (no CFG doubling).
    latents: (B, 128, 128, 4) NHWC noise ~N(0,1), scaled by sigma_max here.
    `unet_apply` is `models.unet_sdxl.unet_sdxl_apply`. With capture=True
    also returns the UNet's inputs of every step, as the JAX sampler does:
    (x, (x_in (steps, B, 128, 128, 4), timesteps (steps,) f32))."""
    check_time_aware_steps(num_inference_steps, time_aware, qstate)
    consts = sch.make_euler(num_inference_steps)
    # the carry (and so every UNet activation) stays in the latents' dtype:
    # sigmas are f32 and a bare multiply would promote a bf16 run to f32
    x = (latents.float() * consts.sigmas[0]).to(latents.dtype)
    inputs = []
    for i in range(num_inference_steps):
        t, sigma, sigma_next = consts.timesteps[i], consts.sigmas[i], consts.sigmas[i + 1]
        qs = select_time_qstate(qstate, int(t), num_inference_steps) if time_aware else qstate
        x_in = sch.euler_scale_model_input(x, sigma)
        tt = torch.full((x.shape[0],), float(t), dtype=torch.float32, device=x.device)
        eps = unet_apply(params, x_in, tt, ehs_text, text_embeds=added_text_embeds,
                         time_ids=added_time_ids, qstate=qs, cfg=cfg)
        if capture:
            inputs.append(x_in)
        x = sch.euler_step(x, eps, sigma, sigma_next)
    if capture:
        return x, (torch.stack(inputs), consts.timesteps.to(latents.device))
    return x
