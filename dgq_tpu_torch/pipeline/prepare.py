"""One-call pipeline assembly from a local HF snapshot tree (port of
`dgq_tpu/pipeline/prepare.py`). Point it at a snapshot directory laid out
the diffusers way

    <root>/unet/diffusion_pytorch_model.safetensors (or .bin)
    <root>/vae/...
    <root>/text_encoder/...          [SDXL: + text_encoder_2/]
    <root>/tokenizer/                [SDXL: + tokenizer_2/]

and every component is converted into the port's params on `device`.
Missing components leave None (the pipeline methods that need them raise);
only the UNet is required. `transformers` is imported only to load a
tokenizer. SD3 ("sd3") reads <root>/transformer/ in the UNet's place and
<root>/vae/ (16 latent channels); its text encoders are not loaded.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

from dgq_tpu_torch.io.convert import hf_sd3_transformer_to_params
from dgq_tpu_torch.io.hf_loader import load_state_dict_any
from dgq_tpu_torch.models.qconfig import QConfig, QState
from dgq_tpu_torch.pipeline.sd_pipeline import SD3Pipeline, SDPipeline, SDXLTurboPipeline
from dgq_tpu_torch.pipeline.text_encoder import hf_clip_text_to_params
from dgq_tpu_torch.pipeline.vae import hf_vae_to_params


def _load_sub(root: str, sub: str, convert, device):
    path = os.path.join(root, sub)
    if not os.path.isdir(path):
        return None
    return convert(load_state_dict_any(path), device=device)


def _load_tokenizer(root: str, sub: str):
    path = os.path.join(root, sub)
    if not os.path.isdir(path):
        return None
    try:
        from transformers import CLIPTokenizer

        return CLIPTokenizer.from_pretrained(path)
    except Exception as e:  # noqa: BLE001 (the pipeline reports the missing tokenizer later)
        logging.getLogger("dgq_tpu_torch").warning("tokenizer load failed at %s: %r", path, e)
        return None


def prepare_pipeline(model_type: str, snapshot_dir: str, unet_params: Optional[dict] = None,
                     cfg: QConfig = QConfig(), qstate: Optional[QState] = None,
                     time_aware: bool = False, base: Optional[int] = None, device="cuda"):
    """An SDPipeline / SDXLTurboPipeline / SD3Pipeline from a snapshot directory.

    unet_params overrides the snapshot's UNet (SD3: its transformer; pass
    quantize-folded params); otherwise <root>/unet (<root>/transformer) is
    converted."""
    if model_type == "sd3":
        if unet_params is None:
            unet_params = _load_sub(snapshot_dir, "transformer", hf_sd3_transformer_to_params,
                                    device)
            if unet_params is None:
                raise FileNotFoundError(f"no transformer/ under {snapshot_dir}")
        return SD3Pipeline(transformer_params=unet_params,
                           vae_params=_load_sub(snapshot_dir, "vae", hf_vae_to_params, device),
                           cfg=cfg, qstate=qstate, time_aware=time_aware, device=device)
    if unet_params is None:
        from dgq_tpu_torch.cli.common import build_model

        _, unet_params, _, _, _ = build_model(
            model_type, base=base, hf_unet_path=os.path.join(snapshot_dir, "unet"),
            device=device)

    vae_params = _load_sub(snapshot_dir, "vae", hf_vae_to_params, device)
    text_params = _load_sub(snapshot_dir, "text_encoder", hf_clip_text_to_params, device)
    tokenizer = _load_tokenizer(snapshot_dir, "tokenizer")

    if model_type == "sd":
        return SDPipeline(unet_params=unet_params, text_params=text_params,
                          vae_params=vae_params, tokenizer=tokenizer, cfg=cfg, qstate=qstate,
                          time_aware=time_aware, device=device)
    if model_type == "sdxl":
        return SDXLTurboPipeline(
            unet_params=unet_params, vae_params=vae_params, text_params_l=text_params,
            text_params_g=_load_sub(snapshot_dir, "text_encoder_2", hf_clip_text_to_params,
                                    device),
            tokenizer=tokenizer, tokenizer_2=_load_tokenizer(snapshot_dir, "tokenizer_2"),
            cfg=cfg, qstate=qstate, time_aware=time_aware, device=device)
    raise ValueError(f"unknown model type {model_type}")
