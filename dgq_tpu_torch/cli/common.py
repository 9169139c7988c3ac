"""Shared CLI plumbing, the inference half (port of `dgq_tpu/cli/common.py`):
the device, model construction and weight loading, logging, and the
quantization flags. The calibration half waits for slice 5.

The model is chosen by --model {sd,sdxl}; the DIFFUSERS_REWRITE environment
variable gives the default, as in the reference.
"""
from __future__ import annotations

import argparse
import datetime
import logging
import os
import random
from typing import Optional

import torch


def model_type_from_env(default: str = "sd") -> str:
    return os.environ.get("DIFFUSERS_REWRITE", default)


def resolve_device(name: str) -> str:
    """The device a CLI runs on. 'cuda' without a usable card is an error:
    the entry points never fall back to the CPU on their own."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for, but torch.cuda.is_available() is "
                           "false; pass --device cpu to run on the CPU")
    if name not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {name!r}: cuda or cpu")
    return name


def setup_logging(outdir: str) -> tuple[str, logging.Logger]:
    os.makedirs(outdir, exist_ok=True)
    outpath = os.path.join(outdir, datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S"))
    os.makedirs(outpath, exist_ok=True)
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s -   %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S",
        level=logging.INFO,
        handlers=[logging.FileHandler(os.path.join(outpath, "run.log")),
                  logging.StreamHandler()],
    )
    return outpath, logging.getLogger("dgq_tpu_torch")


def build_model(model_type: str, base: Optional[int] = None, seed: int = 0,
                hf_unet_path: Optional[str] = None, sdxl_depths: tuple = (2, 10),
                init_params: bool = True, device="cuda"):
    """-> (spec, params, unet_apply, latent_hw, cross).

    hf_unet_path: a torch state dict (file or snapshot directory) of the
    reference UNet, converted on load. Without it, random weights drawn on
    `device` from a generator seeded with `seed` (smoke and benchmark runs
    only); init_params=False gives params=None, for callers that take the
    weights from a checkpoint."""
    if model_type == "sd":
        from dgq_tpu_torch.models.unet_sd import sd_unet_spec, unet_sd_apply

        spec = sd_unet_spec(base=base or 320)
        apply_fn, latent_hw, cross = unet_sd_apply, 64, 768
    elif model_type == "sdxl":
        from dgq_tpu_torch.models.unet_sdxl import sdxl_unet_spec, unet_sdxl_apply

        spec = sdxl_unet_spec(base=base or 320, depths=tuple(sdxl_depths))
        apply_fn, latent_hw, cross = unet_sdxl_apply, 128, 2048
    else:
        raise ValueError(f"unknown model type {model_type}")

    if hf_unet_path:
        from dgq_tpu_torch.io.convert import torch_unet_to_params
        from dgq_tpu_torch.io.hf_loader import load_state_dict_any

        params = torch_unet_to_params(load_state_dict_any(hf_unet_path), spec, device)
    elif init_params:
        from dgq_tpu_torch.models.unet_sd import init_unet_sd

        params = init_unet_sd(torch.Generator(device=device).manual_seed(seed), device,
                              spec=spec)
    else:
        params = None
    return spec, params, apply_fn, latent_hw, cross


def pooled_dim_for(model_type: str, base: Optional[int] = None) -> int:
    """SDXL's pooled text-embedding width: add_embedding.linear_1 takes
    [pooled, 6 * add_ch] with pooled = the time-embedding width, 4 * base
    (1280 for the real model)."""
    del model_type
    return 4 * (base or 320)


def load_prompts(path: str, num: int, seed: Optional[int] = None) -> list:
    """Prompts from a COCO annotations json (`num` sampled captions) or a
    plain-text file (one prompt per line; `num` sampled when it has more)."""
    if path.endswith(".json"):
        from dgq_tpu_torch.calib.data import get_coco_prompts

        return get_coco_prompts(path, num, seed=seed)
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    if len(lines) <= num:
        return lines
    return random.Random(seed).sample(lines, num)


def parse_depths(s: str) -> tuple:
    return tuple(int(x) for x in s.split(","))


def add_quant_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--sdxl_depths", type=parse_depths, default=(2, 10),
                    help="SDXL transformer depths 'lo,hi' (tiny smoke runs)")
    ap.add_argument("--wq", type=int, default=4, help="weight bits")
    ap.add_argument("--aq", type=int, default=8, help="activation bits")
    ap.add_argument("--softmax_a_bit", type=int, default=8)
    ap.add_argument("--t2i_log_quant", action="store_true")
    ap.add_argument("--t2i_real_time", action="store_true")
    ap.add_argument("--t2i_start_peak", action="store_true")
    ap.add_argument("--time_aware_aqtizer", action="store_true")
    ap.add_argument("--group_impl", default="taps",
                    choices=["taps", "fused", "unfold", "im2col"],
                    help="group-conv execution path (taps = per-tap codes and "
                         "accumulated matmuls; fused = the hand-written group "
                         "conv kernel where eligible; unfold = the reference's "
                         "materialized im2col)")
    ap.add_argument("--pallas_attn", action="store_true",
                    help="fused attention kernels with the softmax quantizer "
                         "inside (the hand-written CUDA kernels on the card)")
    ap.add_argument("--multihost", action="store_true",
                    help="multi-process runtime (not ported: raises)")
    ap.add_argument("--prompt_path", default=None,
                    help="captions: COCO annotations json or a plain-text "
                         "file, one prompt per line")
    ap.add_argument("--text_weights", default=None,
                    help="CLIP text encoder state dict (file or HF snapshot dir)")
    ap.add_argument("--tokenizer", default=None,
                    help="HF CLIPTokenizer directory (vocab.json/merges.txt)")
    ap.add_argument("--text_weights_2", default=None,
                    help="[sdxl] second text encoder (OpenCLIP-bigG "
                         "WithProjection state dict)")
    ap.add_argument("--tokenizer_2", default=None,
                    help="[sdxl] tokenizer for the second encoder")


def maybe_init_multihost(args) -> None:
    """--multihost is refused: multi-GPU is not ported yet."""
    if getattr(args, "multihost", False):
        raise NotImplementedError(
            "--multihost is not ported to dgq_tpu_torch: ROADMAP queue 1, item 17 "
            "(parallel/mesh.py onto torch.distributed)")


def qconfig_from_args(args, use_wq=True, use_aq=False):
    from dgq_tpu_torch.models.qconfig import QConfig

    return QConfig(
        w_bits=args.wq, a_bits=args.aq, softmax_bits=args.softmax_a_bit,
        use_wq=use_wq, use_aq=use_aq,
        t2i_log_quant=args.t2i_log_quant, t2i_real_time=args.t2i_real_time,
        t2i_start_peak=args.t2i_start_peak,
        group_conv_impl=getattr(args, "group_impl", "taps"),
        use_pallas_attention=getattr(args, "pallas_attn", False),
    )
