"""Quantized inference (port of `dgq_tpu/cli/infer.py`, the reference's
inference_qmodel): the fp image, then the quantized image, for one prompt
with the same seed, side by side.

    python -m dgq_tpu_torch.cli.infer --cali_ckpt merged.pth --use_aq --use_group \\
        --t2i_log_quant --t2i_real_time --t2i_start_peak --time_aware_aqtizer

It runs on the card (--device cuda, the default) and refuses to start
without one; --device cpu runs the plain versions on the CPU. With
--multihost (torchrun or SLURM) every rank runs both images and rank 0
writes them. `main(argv)` takes the argument list, so it can be driven
in-process.
"""
from __future__ import annotations

import argparse
import os
import re
import time

import numpy as np
import torch

from dgq_tpu_torch.cli.common import (
    add_quant_args,
    announce_rank,
    build_model,
    maybe_init_multihost,
    model_type_from_env,
    pooled_dim_for,
    qconfig_from_args,
    resolve_device,
    writes_files,
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="DGQ quantized inference (PyTorch port)")
    ap.add_argument("--model", default=model_type_from_env(), choices=["sd", "sdxl"])
    add_quant_args(ap)
    ap.add_argument("--prompt", default="a painting of a virus monster playing guitar")
    ap.add_argument("--cali_ckpt", default=None, help="weight-only or merged ckpt")
    ap.add_argument("--use_aq", action="store_true")
    ap.add_argument("--use_group", action="store_true")
    ap.add_argument("--num_inference_steps", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--fp16", action="store_true",
                    help="bfloat16 UNet weights (the activations stay float32)")
    # --text_weights/--text_weights_2/--tokenizer/--tokenizer_2 come from add_quant_args
    ap.add_argument("--unet_weights", default=None)
    ap.add_argument("--vae_weights", default=None, help="HF VAE dir")
    ap.add_argument("--base", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--outdir", default=".")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; fails without a card) or cpu")
    return ap.parse_args(argv)


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _bf16_leaves(params: dict) -> dict:
    """Every float32 tensor of a flat params dict as bfloat16, the rest as
    it is (new dicts; the input is not changed)."""
    return {n: {k: v.to(torch.bfloat16) if torch.is_tensor(v) and v.dtype == torch.float32
                else v for k, v in p.items()} for n, p in params.items()}


def main(argv=None) -> dict:
    """Runs the CLI; returns {'outputs': saved .npy paths, 'load_fold_s':
    seconds to load the checkpoint and fold the weights, 'run_s': {tag:
    seconds of that run}}."""
    args = parse_args(argv)
    maybe_init_multihost(args)
    device = resolve_device(args.device)
    announce_rank(device)
    steps = args.num_inference_steps
    if steps < 0:
        steps = 25 if args.model == "sd" else 4

    from dgq_tpu_torch.calib.act_calib import stack_time_qstates
    from dgq_tpu_torch.calib.data import synthetic_prompt_embeddings, synthetic_sdxl_embeddings
    from dgq_tpu_torch.calib.weight_calib import fold_weight_quant, quantize_model_weights
    from dgq_tpu_torch.io.dgq_ckpt import load_merged
    from dgq_tpu_torch.io.hf_loader import load_state_dict_any
    from dgq_tpu_torch.models.qconfig import QConfig
    from dgq_tpu_torch.pipeline.sd_pipeline import SDPipeline, SDXLTurboPipeline
    from dgq_tpu_torch.pipeline.text_encoder import hf_clip_text_to_params
    from dgq_tpu_torch.pipeline.vae import hf_vae_to_params

    def model(init_params):
        return build_model(args.model, base=args.base, seed=args.seed,
                           hf_unet_path=args.unet_weights, sdxl_depths=args.sdxl_depths,
                           init_params=init_params, device=device)

    # a checkpoint that holds weights replaces the random init, so skip it
    spec, params, apply_fn, _, cross = model(not args.cali_ckpt)
    cfg = qconfig_from_args(args, use_wq=True, use_aq=args.use_aq)

    qstate = None
    time_aware = False
    _sync(device)
    t0 = time.perf_counter()
    if args.cali_ckpt:
        p2, wqp, alphas, per_t, group_layers = load_merged(args.cali_ckpt, spec, device)
        if p2 is not None:
            params = p2
        elif params is None:
            params = model(True)[1]
        params_q = fold_weight_quant(params, wqp or {}, spec, cfg,
                                     alphas=alphas or None, soft=False)
        if args.use_group and group_layers:
            cfg = cfg.replace(group_conv_layers=group_layers)
        if args.use_aq and per_t:
            if args.time_aware_aqtizer and len(per_t) > 1:
                qstate = stack_time_qstates(per_t)
                time_aware = True
            else:
                qstate = per_t["act_0"]
    else:
        params_q, _ = quantize_model_weights(params, spec, cfg)
    _sync(device)
    load_fold_s = time.perf_counter() - t0

    # text encoders, VAE and tokenizers (optional local files)
    text_params = text_params_2 = vae_params = tokenizer = tokenizer_2 = None
    if args.text_weights:
        text_params = hf_clip_text_to_params(load_state_dict_any(args.text_weights), device)
    if args.text_weights_2:
        text_params_2 = hf_clip_text_to_params(load_state_dict_any(args.text_weights_2), device)
    if args.vae_weights:
        vae_params = hf_vae_to_params(load_state_dict_any(args.vae_weights), device)
    if args.tokenizer or args.tokenizer_2:
        from transformers import CLIPTokenizer

        if args.tokenizer:
            tokenizer = CLIPTokenizer.from_pretrained(args.tokenizer)
        if args.tokenizer_2:
            tokenizer_2 = CLIPTokenizer.from_pretrained(args.tokenizer_2)

    if args.fp16:
        params_q = _bf16_leaves(params_q)

    hw = dict(height=args.height or (512 if args.model == "sd" else 1024),
              width=args.width or (512 if args.model == "sd" else 1024))
    outputs, run_s = [], {}

    def run(p, c, qs, ta, tag):
        _sync(device)
        t = time.perf_counter()
        if args.model == "sdxl":
            pipe = SDXLTurboPipeline(
                unet_params=p, vae_params=vae_params, cfg=c, qstate=qs, time_aware=ta,
                unet_apply=apply_fn, text_params_l=text_params, text_params_g=text_params_2,
                tokenizer=tokenizer, tokenizer_2=tokenizer_2, device=device)
            if None not in (tokenizer, tokenizer_2, text_params, text_params_2):
                imgs = pipe([args.prompt] * 2, steps=steps, seed=args.seed, **hw)
            else:
                text, pooled = synthetic_sdxl_embeddings(
                    2, dim=cross, pooled_dim=pooled_dim_for(args.model, args.base),
                    seed=args.seed, device=device)
                imgs = pipe.generate_from_embeddings(text, pooled, steps=steps, seed=args.seed,
                                                     **hw)
        else:
            pipe = SDPipeline(unet_params=p, text_params=text_params, vae_params=vae_params,
                              tokenizer=tokenizer, cfg=c, qstate=qs, time_aware=ta,
                              unet_apply=apply_fn, device=device)
            if tokenizer is not None and text_params is not None:
                imgs = pipe([args.prompt] * 2, steps=steps, seed=args.seed, **hw)
            else:
                text, uncond = synthetic_prompt_embeddings(2, dim=cross, seed=args.seed,
                                                           device=device)
                imgs = pipe.generate_from_embeddings(text, uncond, steps=steps, seed=args.seed,
                                                     scheduler="pndm", **hw)
        run_s[tag] = time.perf_counter() - t  # imgs is on the host: the device is done
        if not writes_files():
            return
        for i in range(imgs.shape[0]):
            name = f"tmp_{args.model}_{args.prompt.replace(' ', '_')}_{i}_{tag}"
            out = os.path.join(args.outdir, name + ".npy")
            np.save(out, imgs[i])
            outputs.append(out)
            print(f"saved {out}")
            if imgs.dtype == np.uint8:
                try:
                    from PIL import Image
                except ImportError:
                    continue
                Image.fromarray(imgs[i]).save(os.path.join(args.outdir, name + ".png"))

    run(params, QConfig(), None, False, "fp")
    if args.use_group:
        # the group count is not in the checkpoint (its deltas are expanded
        # per channel): take it from the reference file name `...w{W}a{A}g{G}.pth`
        m = re.search(r"g(\d+)", os.path.basename(args.cali_ckpt or ""))
        gtag = f"g{m.group(1)}" if m else "g"
    else:
        gtag = "g1"
    tag = f"w{args.wq}a{args.aq if args.use_aq else 32}{gtag}"
    run(params_q, cfg, qstate, time_aware, tag)
    return {"outputs": outputs, "load_fold_s": load_fold_s, "run_s": run_s}


if __name__ == "__main__":
    main()
