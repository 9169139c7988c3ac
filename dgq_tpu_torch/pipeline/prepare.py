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

from dgq_tpu_torch.io.hf_loader import load_state_dict_any
from dgq_tpu_torch.models.families import build_model, family
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


def _sd(denoiser, apply, vae, texts, tokenizers, **kw):
    return SDPipeline(unet_params=denoiser, unet_apply=apply, vae_params=vae,
                      text_params=texts[0], tokenizer=tokenizers[0], **kw)


def _sdxl(denoiser, apply, vae, texts, tokenizers, **kw):
    return SDXLTurboPipeline(unet_params=denoiser, unet_apply=apply, vae_params=vae,
                             text_params_l=texts[0], text_params_g=texts[1],
                             tokenizer=tokenizers[0], tokenizer_2=tokenizers[1], **kw)


def _sd3(denoiser, apply, vae, texts, tokenizers, **kw):
    return SD3Pipeline(transformer_params=denoiser, transformer_apply=apply, vae_params=vae, **kw)


# Each family's pipeline from (denoiser params, its apply, VAE, [text encoders],
# [tokenizers], **fields), keyed as `models.families.FAMILIES`; None where a
# part is missing.
PIPELINES = {"sd": _sd, "sdxl": _sdxl, "sd3": _sd3}

# the snapshot folders of the first and second text encoder and tokenizer
_TEXT_PARTS = (("text_encoder", "tokenizer"), ("text_encoder_2", "tokenizer_2"))


def prepare_pipeline(model_type: str, snapshot_dir: str, unet_params: Optional[dict] = None,
                     cfg: QConfig = QConfig(), qstate: Optional[QState] = None,
                     time_aware: bool = False, base: Optional[int] = None, device="cuda"):
    """An SDPipeline / SDXLTurboPipeline / SD3Pipeline from a snapshot directory.

    unet_params overrides the snapshot's UNet (SD3: its transformer; pass
    quantize-folded params); otherwise <root>/unet (<root>/transformer) is
    converted."""
    fam = family(model_type)
    if unet_params is None:
        _, unet_params, _, _, _ = build_model(
            model_type, base=base, hf_unet_path=os.path.join(snapshot_dir, fam.weights),
            device=device)
    parts = _TEXT_PARTS[:fam.text_encoders]
    return PIPELINES[model_type](
        unet_params, fam.apply, _load_sub(snapshot_dir, "vae", hf_vae_to_params, device),
        [_load_sub(snapshot_dir, enc, hf_clip_text_to_params, device) for enc, _ in parts],
        [_load_tokenizer(snapshot_dir, tok) for _, tok in parts],
        cfg=cfg, qstate=qstate, time_aware=time_aware, device=device)
