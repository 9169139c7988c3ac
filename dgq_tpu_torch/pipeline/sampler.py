"""SD v1.4 sampling (DDIM or PNDM-PLMS) with classifier-free guidance and
SDXL-turbo sampling (Euler, guidance 0) (port of
`dgq_tpu/pipeline/sampler.py`), and SD3's flow-matching Euler with
classifier-free guidance (`sd3_sample`, no JAX counterpart).

The JAX package compiles the loop into one `lax.scan`; here it is a Python
loop. Time-aware activation qparams carry a leading [T_slots] axis; each step
picks its slot by a host-side index (the schedule is known on the host), so
no step waits on the device. The UNet samplers take the reference's slot
map from the timestep (`timestep_slot`); the flow sampler's timesteps are
fractions of 1000 and its 28 steps do not divide 1000, so it takes slot i
at step i (`sd3_sample`).
"""
from __future__ import annotations

from typing import Optional

import torch

from dgq_tpu_torch.models.qconfig import GroupQParams, QConfig, QState
from dgq_tpu_torch.models.unet_sd import unet_sd_apply
from dgq_tpu_torch.pipeline import schedulers as sch
from dgq_tpu_torch.quant.affine import QParams
from dgq_tpu_torch.utils.profiler import span


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
    return select_slot_qstate(qstate, int(timestep_slot(int(t), steps)))


def select_slot_qstate(qstate: Optional[QState], slot: int) -> Optional[QState]:
    """The slice `slot` of stacked [T_slots, ...] activation qparams."""
    if qstate is None:
        return None

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
        with span("dgq.sampler.slot"):
            qs = select_time_qstate(qstate, t, num_inference_steps) if time_aware else qstate
        lmi = torch.cat([x, x], dim=0)
        tt = torch.full((lmi.shape[0],), t, dtype=torch.int32, device=lmi.device)
        eps = unet_apply(params, lmi, tt, ehs, qstate=qs, cfg=cfg)
        if capture:
            inputs.append(lmi)
        with span("dgq.sampler.update"):
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
        with span("dgq.sampler.slot"):
            qs = (select_time_qstate(qstate, int(t), num_inference_steps) if time_aware
                  else qstate)
        x_in = sch.euler_scale_model_input(x, sigma)
        tt = torch.full((x.shape[0],), float(t), dtype=torch.float32, device=x.device)
        eps = unet_apply(params, x_in, tt, ehs_text, text_embeds=added_text_embeds,
                         time_ids=added_time_ids, qstate=qs, cfg=cfg)
        if capture:
            inputs.append(x_in)
        with span("dgq.sampler.update"):
            x = sch.euler_step(x, eps, sigma, sigma_next)
    if capture:
        return x, (torch.stack(inputs), consts.timesteps.to(latents.device))
    return x


def check_slot_count(qstate: Optional[QState], steps: int) -> None:
    """A time-aware state selected by step index needs a slot a step."""
    leaves = [leaf for key in ("a", "sm") for leaf in (qstate or {}).get(key, {}).values()]
    for leaf in leaves:
        lead = (leaf.delta if isinstance(leaf, QParams)
                else leaf.delta_last if isinstance(leaf, GroupQParams) else leaf)
        if lead.dim() == 0 or lead.shape[0] < steps:
            raise ValueError(f"a time-aware state selected by step index needs {steps} slots, "
                             f"one a step; a leaf has shape {tuple(lead.shape)}")


@torch.no_grad()
def sd3_sample(params: dict, latents: torch.Tensor, ehs_text: torch.Tensor,
               pooled_text: torch.Tensor, ehs_uncond: torch.Tensor, pooled_uncond: torch.Tensor,
               transformer_apply, num_inference_steps: int = 28, guidance_scale: float = 7.0,
               shift: float = 3.0, qstate: Optional[QState] = None, cfg: QConfig = QConfig(),
               time_aware: bool = False):
    """SD3 sampling: flow-matching Euler (`schedulers.make_flow_match`) from
    NHWC noise latents (B, 128, 128, 16), unscaled, with classifier-free
    guidance over the CFG batch [uncond, text]: v = v_u + g (v_c - v_u), x +=
    (sigma_{i+1} - sigma_i) v. `transformer_apply(params, x, t, ehs, pooled,
    qstate=, cfg=)` is `models.mmdit_sd3.mmdit_sd3_apply` or a wrapper of it;
    t = 1000 sigma. A time-aware state takes slot i at step i."""
    if time_aware:
        check_slot_count(qstate, num_inference_steps)
    consts = sch.make_flow_match(num_inference_steps, shift)
    ehs = torch.cat([ehs_uncond, ehs_text], dim=0)
    pooled = torch.cat([pooled_uncond, pooled_text], dim=0)
    x = latents
    for i in range(num_inference_steps):
        with span("dgq.sampler.slot"):
            qs = select_slot_qstate(qstate, i) if time_aware else qstate
        lmi = torch.cat([x, x], dim=0)
        tt = torch.full((lmi.shape[0],), float(consts.timesteps[i]), dtype=torch.float32,
                        device=lmi.device)
        v = transformer_apply(params, lmi, tt, ehs, pooled, qstate=qs, cfg=cfg)
        with span("dgq.sampler.update"):
            v_u, v_c = v.chunk(2, dim=0)
            x = sch.flow_euler_step(x, v_u + guidance_scale * (v_c - v_u), consts.sigmas[i],
                                    consts.sigmas[i + 1])
    return x
