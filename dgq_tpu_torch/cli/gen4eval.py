"""Batch image generation for evaluation (port of `dgq_tpu/cli/gen4eval.py`;
the reference's src/gen4eval_SD.py / gen4eval_SDXL.py / gen4eval_fp.py).

    python -m dgq_tpu_torch.cli.gen4eval --prompts metadata.csv --outdir eval_images \\
        --cali_ckpt merged.pth --use_aq --use_group --t2i_log_quant --t2i_real_time \\
        --t2i_start_peak --time_aware_aqtizer --vae_weights vae/ --im256

Each image is named '{global_prompt_idx}_{rep}' (the reference's name_rep
scheme) and written as .png (a 256px copy under '<outdir>_im256' with
--im256) when a VAE decodes it, else as the raw latents' .npy.
Two kinds of data parallelism: --gpu_rank / --world_size slice the prompt
list over independent processes (`parallel.mesh.shard_prompts`, the
reference's scheme), and --dp N splits each batch's rows over N ranks of a
process group started by torchrun:

    torchrun --nproc_per_node 2 -m dgq_tpu_torch.cli.gen4eval --dp 2 ...

Each rank draws the whole batch's initial latents and stand-in embeddings,
keeps its rows (a tail batch padded to a multiple of dp with copies of its
last row, whose outputs are dropped) and writes their files under the
global names. The real-time softmax quantizer's delta, a reduction over
the whole batch, is reduced over every rank's rows (`parallel.mesh.
batch_split`; a padded copy moves no min or max), so the images are those
of --dp 1 up to the order of sums, which a quantized trajectory can grow
over many steps. --batch must be a multiple of --dp.

It runs on the card (--device cuda, the default) and refuses to start
without one; --device cpu runs on the CPU. Initial latents and stand-in
prompt embeddings come from `torch.Generator`s seeded as the JAX CLI seeds
`jax.random`: the same seed gives other noise (ROADMAP queue 3).
`main(argv)` takes the argument list, so it can be driven in-process.
"""
from __future__ import annotations

import argparse
import csv
import os
import time

import numpy as np


def read_prompts(path: str) -> list[str]:
    """metadata.csv (COCO-30k: a 'caption' or 'prompt' column) or
    PartiPrompts.tsv (the first column, a 'Prompt' header skipped)."""
    prompts = []
    if path.endswith(".tsv"):
        with open(path) as f:
            for i, row in enumerate(csv.reader(f, delimiter="\t")):
                if i == 0 and row and row[0].lower() == "prompt":
                    continue
                if row:
                    prompts.append(row[0])
    else:
        with open(path) as f:
            for row in csv.DictReader(f):
                prompts.append(row.get("caption") or row.get("prompt")
                               or list(row.values())[0])
    return prompts


def parse_args(argv=None):
    from dgq_tpu_torch.cli.common import add_quant_args, model_type_from_env

    ap = argparse.ArgumentParser(description="DGQ eval generation (PyTorch port)")
    ap.add_argument("--model", default=model_type_from_env(), choices=["sd", "sdxl"])
    add_quant_args(ap)
    ap.add_argument("--prompts", required=True, help="metadata.csv / PartiPrompts.tsv")
    ap.add_argument("--outdir", default="eval_images")
    ap.add_argument("--gpu_rank", type=int, default=0)
    ap.add_argument("--world_size", type=int, default=1)
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel ranks: each batch's rows split over them (start the "
                         "ranks with torchrun --nproc_per_node N)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=-1)
    ap.add_argument("--n_per_prompt", type=int, default=1)
    ap.add_argument("--height", type=int, default=-1,
                    help="image height (default 512 sd / 1024 sdxl)")
    ap.add_argument("--width", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--cali_ckpt", default=None)
    ap.add_argument("--use_aq", action="store_true")
    ap.add_argument("--use_group", action="store_true")
    ap.add_argument("--fp", action="store_true", help="full precision (no quant)")
    ap.add_argument("--im256", action="store_true", help="also save 256px copies")
    # --text_weights/--text_weights_2/--tokenizer/--tokenizer_2 come from add_quant_args
    ap.add_argument("--unet_weights", default=None)
    ap.add_argument("--vae_weights", default=None)
    ap.add_argument("--base", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; fails without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Runs the CLI; returns {'files': written paths, 'images': count,
    'generate_s': generation seconds (model set-up excluded), 'load_fold_s':
    seconds to build the model and fold its weights}."""
    args = parse_args(argv)
    from dgq_tpu_torch.cli.common import (
        announce_rank,
        build_model,
        dp_mesh,
        maybe_init_multihost,
        pooled_dim_for,
        qconfig_from_args,
        resolve_device,
    )

    if args.batch % args.dp:
        raise SystemExit(f"--batch {args.batch} must be a multiple of --dp {args.dp}")
    maybe_init_multihost(args)
    mesh = dp_mesh(args, "dgq_tpu_torch.cli.gen4eval")
    device = resolve_device(args.device)
    announce_rank(device)
    import torch

    from dgq_tpu_torch.calib.data import synthetic_prompt_embeddings, synthetic_sdxl_embeddings
    from dgq_tpu_torch.io.hf_loader import load_state_dict_any
    from dgq_tpu_torch.models.qconfig import QConfig
    from dgq_tpu_torch.parallel.mesh import batch_rows, batch_split, shard_prompts
    from dgq_tpu_torch.pipeline.sd_pipeline import SDPipeline, SDXLTurboPipeline
    from dgq_tpu_torch.pipeline.text_encoder import hf_clip_text_to_params
    from dgq_tpu_torch.pipeline.vae import hf_vae_to_params

    steps = args.steps if args.steps > 0 else (25 if args.model == "sd" else 4)
    all_prompts = read_prompts(args.prompts)
    prompts = shard_prompts(all_prompts, args.gpu_rank, args.world_size)
    # this rank's global prompt index base (shard_prompts slices contiguously),
    # so names do not collide across ranks
    per_rank = (len(all_prompts) + args.world_size - 1) // args.world_size
    prompt_base = args.gpu_rank * per_rank
    os.makedirs(args.outdir, exist_ok=True)
    im256_dir = args.outdir.rstrip("/") + "_im256"
    if args.im256:
        os.makedirs(im256_dir, exist_ok=True)

    t0 = time.perf_counter()
    from_ckpt = bool(args.cali_ckpt) and not args.fp
    spec, params, apply_fn, _, cross = build_model(
        args.model, base=args.base, seed=args.seed, hf_unet_path=args.unet_weights,
        sdxl_depths=args.sdxl_depths, init_params=not from_ckpt, device=device)
    qstate, time_aware = None, False
    if args.fp:
        cfg, params_q = QConfig(), params
    else:
        cfg = qconfig_from_args(args, use_wq=True, use_aq=args.use_aq)
        if args.cali_ckpt:
            from dgq_tpu_torch.calib.act_calib import stack_time_qstates
            from dgq_tpu_torch.calib.weight_calib import fold_weight_quant
            from dgq_tpu_torch.io.dgq_ckpt import load_merged

            p2, wqp, alphas, per_t, group_layers = load_merged(args.cali_ckpt, spec, device)
            if p2 is not None:
                params = p2
            elif params is None:
                params = build_model(args.model, base=args.base, seed=args.seed,
                                     sdxl_depths=args.sdxl_depths, device=device)[1]
            params_q = fold_weight_quant(params, wqp or {}, spec, cfg, alphas=alphas or None,
                                         soft=False)
            if args.use_group and group_layers:
                cfg = cfg.replace(group_conv_layers=group_layers)
            if args.use_aq and per_t:
                if args.time_aware_aqtizer and len(per_t) > 1:
                    qstate, time_aware = stack_time_qstates(per_t), True
                else:
                    qstate = per_t["act_0"]
        else:
            from dgq_tpu_torch.calib.weight_calib import quantize_model_weights

            params_q, _ = quantize_model_weights(params, spec, cfg)

    # text encoders and tokenizers are optional: stand-in embeddings without them
    text_params = text_params_2 = tokenizer = tokenizer_2 = vae_params = None
    if args.text_weights and args.tokenizer:
        from transformers import CLIPTokenizer

        text_params = hf_clip_text_to_params(load_state_dict_any(args.text_weights), device)
        tokenizer = CLIPTokenizer.from_pretrained(args.tokenizer)
    if args.text_weights_2 and args.tokenizer_2:
        from transformers import CLIPTokenizer

        text_params_2 = hf_clip_text_to_params(load_state_dict_any(args.text_weights_2), device)
        tokenizer_2 = CLIPTokenizer.from_pretrained(args.tokenizer_2)
    if args.vae_weights:
        vae_params = hf_vae_to_params(load_state_dict_any(args.vae_weights), device)
    if device == "cuda":
        torch.cuda.synchronize()
    load_fold_s = time.perf_counter() - t0

    if args.model == "sdxl":
        pipe = SDXLTurboPipeline(
            unet_params=params_q, vae_params=vae_params, cfg=cfg, qstate=qstate,
            time_aware=time_aware, unet_apply=apply_fn, text_params_l=text_params,
            text_params_g=text_params_2, tokenizer=tokenizer, tokenizer_2=tokenizer_2,
            device=device)
    else:
        pipe = SDPipeline(unet_params=params_q, text_params=text_params, vae_params=vae_params,
                          tokenizer=tokenizer, cfg=cfg, qstate=qstate, time_aware=time_aware,
                          unet_apply=apply_fn, device=device)

    def batch_embeds(batch_prompts, seed):
        """The (cond, other) embedding pair of one batch: the encoders when
        mounted, stand-ins otherwise."""
        if args.model == "sdxl":
            if None not in (tokenizer, tokenizer_2, text_params, text_params_2):
                return pipe.encode_prompts(batch_prompts)
            return synthetic_sdxl_embeddings(
                len(batch_prompts), dim=cross, pooled_dim=pooled_dim_for(args.model, args.base),
                seed=seed, device=device)
        if tokenizer is not None and text_params is not None:
            return pipe.encode_prompts(batch_prompts)
        return synthetic_prompt_embeddings(len(batch_prompts), dim=cross, seed=seed,
                                           device=device)

    size_kw = {}
    if args.height > 0:
        size_kw["height"] = args.height
    if args.width > 0:
        size_kw["width"] = args.width
    t_start = time.perf_counter()
    files = []
    count = 0
    with batch_split(mesh):  # the real-time delta over every rank's rows
        for i in range(0, len(prompts), args.batch):
            batch_prompts = prompts[i : i + args.batch]
            n_real = len(batch_prompts)
            positions, rows = range(n_real), None
            if mesh is not None:
                # this rank's rows of the batch padded to a dp multiple; a padded
                # row repeats the last one and its output is dropped
                mine = batch_rows(mesh, -(-n_real // mesh.dp) * mesh.dp)
                positions = range(mine.start, mine.stop)
                rows = [min(p, n_real - 1) for p in positions]
            for rep in range(args.n_per_prompt):
                seed = args.seed + rep * 100003 + i
                emb_a, emb_b = batch_embeds(batch_prompts, seed)
                imgs = pipe.generate_from_embeddings(emb_a, emb_b, steps=steps, seed=seed,
                                                     rows=rows, **size_kw)
                for j, img in zip(positions, imgs):
                    if j >= n_real:
                        continue
                    count += 1
                    # '{global_prompt_idx}_{rep}': collision-free for any
                    # n_per_prompt and rank count; eval_scores recovers the prompt
                    # index from the stem for CLIP alignment
                    name = f"{prompt_base + i + j}_{rep}"
                    if img.dtype == np.uint8:
                        from PIL import Image

                        files.append(os.path.join(args.outdir, f"{name}.png"))
                        Image.fromarray(img).save(files[-1])
                        if args.im256:
                            files.append(os.path.join(im256_dir, f"{name}.png"))
                            Image.fromarray(img).resize((256, 256)).save(files[-1])
                    else:
                        files.append(os.path.join(args.outdir, f"{name}.npy"))
                        np.save(files[-1], img)
    dt = time.perf_counter() - t_start
    dp = f", dp rank {mesh.rank} of {mesh.dp}" if mesh is not None else ""
    print(f"rank {args.gpu_rank}{dp}: {count} images in {dt:.1f}s "
          f"({count / max(dt, 1e-9):.3f} img/s)")
    return {"files": files, "images": count, "generate_s": dt, "load_fold_s": load_fold_s}


if __name__ == "__main__":
    from dgq_tpu_torch.parallel.mesh import leave_multihost

    main()
    leave_multihost()  # a rank of a process group leaves it before it exits
