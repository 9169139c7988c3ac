"""DGQ group activation quantization (port of `dgq_tpu/cli/quantize_act.py`,
the reference's src/quantize_act.py):

    python -m dgq_tpu_torch.cli.quantize_act --model sd --cali_ckpt W --wq 4 --aq 8 \\
        --softmax_a_bit 8 --group_num 8 --t2i_log_quant --t2i_real_time \\
        --t2i_start_peak --time_aware_aqtizer --pallas_attn

Loads a weight-only checkpoint, folds its weights, generates (or reads from
the cache) calibration data with the fp weights, runs per-timestep
activation calibration with k-means grouping and writes
`cali_ckpt_activation_w{W}a{A}g{G}.pth`, which `cli.ckpt_tools merge` joins
with the weights for `cli.infer`. The run is on the card unless --device cpu
is given; `main(argv)` takes the argument list and returns what it wrote.
With --multihost (torchrun or SLURM) every rank runs the calibration and
rank 0 writes the checkpoint ('act_ckpt' is None on the other ranks).
"""
from __future__ import annotations

import argparse
import os

from dgq_tpu_torch.cli.common import (
    add_quant_args,
    build_cali_data,
    build_model,
    built_once,
    cali_embeddings_from_args,
    maybe_init_multihost,
    model_type_from_env,
    pooled_dim_for,
    qconfig_from_args,
    resolve_device,
    setup_logging,
    slot_clock,
    timed,
    writes_files,
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="DGQ group activation quantization (PyTorch port)")
    ap.add_argument("--model", default=model_type_from_env(), choices=["sd", "sdxl"])
    ap.add_argument("--outdir", default="results")
    add_quant_args(ap)
    ap.add_argument("--cali_ckpt", required=True, help="weight-only checkpoint")
    ap.add_argument("--group_num", type=int, default=8)
    ap.add_argument("--group_mode", default="minmax", choices=["minmax", "mean"])
    ap.add_argument("--cali_prompt_data_n", type=int, default=64)
    ap.add_argument("--cali_data_path", default="./data/cali_data")
    ap.add_argument("--step_size", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--base", type=int, default=None)
    ap.add_argument("--latent_hw", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    if args.step_size < 0:
        args.step_size = 25 if args.model == "sd" else 4
    return args


def main(argv=None) -> dict:
    """Runs the CLI; returns {'act_ckpt': path, 'per_t': the activation
    states, 'group_layers': the group conv names, 'seconds': {'cali_data',
    'act_slots': [seconds of each time slot]}}."""
    args = parse_args(argv)
    maybe_init_multihost(args)
    device = resolve_device(args.device)
    outpath, log = setup_logging(args.outdir, device)
    from dgq_tpu_torch.calib.act_calib import calibrate_activations
    from dgq_tpu_torch.calib.weight_calib import fold_weight_quant
    from dgq_tpu_torch.io.dgq_ckpt import load_weight_only, save_act_ckpt
    from dgq_tpu_torch.quant.scalers import Scaler

    # the weights come from the checkpoint: no random init
    spec, _, apply_fn, latent_hw, cross = build_model(
        args.model, base=args.base, seed=args.seed, sdxl_depths=args.sdxl_depths,
        init_params=False, device=device)
    cfg = qconfig_from_args(args, use_wq=True, use_aq=True)

    log.info(f"loading weight-only checkpoint {args.cali_ckpt}")
    params, wqp, alphas = load_weight_only(args.cali_ckpt, spec, device)
    params_q = fold_weight_quant(params, wqp, spec, cfg, alphas=alphas or None, soft=False)

    pooled = pooled_dim_for(args.model, args.base)
    embeds, tag = cali_embeddings_from_args(args, args.model, cross, args.cali_prompt_data_n,
                                            args.seed, pooled_dim=pooled, device=device)
    if tag:
        log.info(f"caption-conditioned calibration data ({args.prompt_path})")
    seconds = {}
    (cali_data, interval), seconds["cali_data"] = timed(device, lambda: built_once(
        lambda: build_cali_data(
            args.model, params, apply_fn, cross, args.cali_prompt_data_n, args.step_size,
            args.latent_hw or latent_hw, args.seed, cache_prefix=args.cali_data_path,
            pooled_dim=pooled, embeds=embeds, embeds_tag=tag)))
    log.info(f"calibration set: {cali_data[0].shape[0]} samples, interval {interval}, "
             f"{seconds['cali_data']:.2f} s")
    progress, slot_seconds = slot_clock(device, log)
    per_t, group_layers = calibrate_activations(
        params_q, spec, cfg, cali_data, interval=interval, group_num=args.group_num,
        group_mode=args.group_mode, batch_size=8 if args.model == "sd" else 4,
        scaler=Scaler.MINMAX, unet_apply=apply_fn, progress=progress)
    seconds["act_slots"] = slot_seconds()
    out = None
    if writes_files():
        out = os.path.join(outpath,
                           f"cali_ckpt_activation_w{args.wq}a{args.aq}g{args.group_num}.pth")
        save_act_ckpt(out, per_t, spec)
        log.info(f"activation checkpoint saved to {out}")
    log.info(f"group conv layers: {len(group_layers)}")
    return {"act_ckpt": out, "per_t": per_t, "group_layers": group_layers, "seconds": seconds}


if __name__ == "__main__":
    main()
