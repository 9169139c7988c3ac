"""The model families the port knows, one entry each (`FAMILIES`): what the
CLIs, the pipeline assembly and `cli.flops` need to know of a family, so none
of them branches on its name. SD v1.4 ("sd") and SDXL-turbo ("sdxl") are the
CLIs' (`CLI_FAMILIES`); SD3 medium ("sd3") reaches `pipeline.prepare` only.

What a family needs from a layer above this one is kept there, under the same
keys: its pipeline (`pipeline.prepare.PIPELINES`), its stand-in prompt
embeddings and calibration data (`calib.data.STAND_IN_EMBEDDINGS`,
`CALI_DATA`) and its calibration prompt pair (`cli.common`). Every family's
random weights are `unet_sd.init_unet_sd` over its spec.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from dgq_tpu_torch.models.mmdit_sd3 import mmdit_sd3_apply, mmdit_sd3_spec
from dgq_tpu_torch.models.unet_sd import init_unet_sd, sd_unet_spec, unet_sd_apply
from dgq_tpu_torch.models.unet_sdxl import sdxl_unet_spec, unet_sdxl_apply


@dataclasses.dataclass(frozen=True)
class Family:
    """What the port knows of one model family.

    spec(base=None, depths=(2, 10)): the denoiser's layer spec, at width
    `base` (None: the published width); `depths` are SDXL's transformer
    depths. from_hf(state, spec, device): the denoiser's params from a
    diffusers state dict, the one in the snapshot folder `weights`."""

    spec: Callable
    apply: Callable
    from_hf: Callable
    weights: str
    latent_hw: int
    latent_channels: int
    cross: int                    # width of the prompt embeddings the denoiser attends to
    pooled: int                   # width of the pooled prompt embedding (0: none)
    attn_head_dim: Optional[int]  # None: heads of width / 8 (`utils.flops.spec_roofline`)
    steps: int                    # default sampler steps
    image_size: int               # default image height and width, px
    cali_batch: Optional[int]     # prompt batch of calibration (None: the port has none)
    text_encoders: int            # the CLIP text encoders the port runs for its prompts


def _sd_spec(base=None, depths=(2, 10)):
    return sd_unet_spec(base=base or 320)


def _sdxl_spec(base=None, depths=(2, 10)):
    return sdxl_unet_spec(base=base or 320, depths=tuple(depths))


def _sd3_spec(base=None, depths=(2, 10)):
    """SD3 medium at its published widths: `base` and `depths` are the UNets'."""
    return mmdit_sd3_spec()


def _unet_from_hf(state, spec, device):
    from dgq_tpu_torch.io.convert import torch_unet_to_params

    return torch_unet_to_params(state, spec, device)


def _mmdit_from_hf(state, spec, device):
    """SD3's depth and widths are read from the state's shapes, not from spec."""
    from dgq_tpu_torch.io.convert import hf_sd3_transformer_to_params

    return hf_sd3_transformer_to_params(state, device)


FAMILIES = {
    "sd": Family(spec=_sd_spec, apply=unet_sd_apply, from_hf=_unet_from_hf, weights="unet",
                 latent_hw=64, latent_channels=4, cross=768, pooled=0, attn_head_dim=None,
                 steps=25, image_size=512, cali_batch=8, text_encoders=1),
    "sdxl": Family(spec=_sdxl_spec, apply=unet_sdxl_apply, from_hf=_unet_from_hf,
                   weights="unet", latent_hw=128, latent_channels=4, cross=2048, pooled=1280,
                   attn_head_dim=64, steps=4, image_size=1024, cali_batch=4, text_encoders=2),
    "sd3": Family(spec=_sd3_spec, apply=mmdit_sd3_apply, from_hf=_mmdit_from_hf,
                  weights="transformer", latent_hw=128, latent_channels=16, cross=4096,
                  pooled=2048, attn_head_dim=64, steps=28, image_size=1024, cali_batch=None,
                  text_encoders=0),
}

# the families the CLIs take for --model
CLI_FAMILIES = ("sd", "sdxl")


def family(name: str) -> Family:
    if name not in FAMILIES:
        raise ValueError(f"unknown model type {name}")
    return FAMILIES[name]


def build_model(model_type: str, base: Optional[int] = None, seed: int = 0,
                hf_unet_path: Optional[str] = None, sdxl_depths: tuple = (2, 10),
                init_params: bool = True, device="cuda", host: bool = False):
    """-> (spec, params, apply, latent_hw, cross) of a family's denoiser.

    hf_unet_path: a torch state dict (file or snapshot directory) of the
    reference denoiser, converted on load. Without it, random weights drawn
    on `device` from a generator seeded with `seed` (smoke and benchmark runs
    only); init_params=False gives params=None, for callers that take the
    weights from a checkpoint. host=True keeps the whole weights on the
    host, for a run that moves only its shards to the card
    (`parallel.mesh.shard_params_tp`): random weights are still drawn on
    `device`, the same values, one leaf at a time."""
    fam = family(model_type)
    spec = fam.spec(base, sdxl_depths)
    if hf_unet_path:
        from dgq_tpu_torch.io.hf_loader import load_state_dict_any

        params = fam.from_hf(load_state_dict_any(hf_unet_path), spec, "cpu" if host else device)
    elif init_params:
        params = init_unet_sd(torch.Generator(device=device).manual_seed(seed), device,
                              spec=spec, store="cpu" if host else None)
    else:
        params = None
    return spec, params, fam.apply, fam.latent_hw, fam.cross


def pooled_dim_for(base: Optional[int] = None) -> int:
    """SDXL's pooled text-embedding width at width `base`: add_embedding.linear_1
    takes [pooled, 6 * add_ch] with pooled = the time-embedding width, 4 * base
    (1280 for the real model, `FAMILIES["sdxl"].pooled`)."""
    return 4 * (base or 320)
