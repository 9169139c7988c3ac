"""Weight PTQ without reconstruction (port of `dgq_tpu/cli/quantize_weight.py`,
the reference's src/quantize_weight.py):

    python -m dgq_tpu_torch.cli.quantize_weight --model sd --wq 4 --cali --no_recon [--use_aq]
    python -m dgq_tpu_torch.cli.quantize_weight --model sdxl --wq 4 --fast --no_recon

Per-out-channel weight scales (MSE search with --cali, else minmax) are
written as a weight-only checkpoint `cali_ckpt.pth_weight_only`; --use_aq
then calibrates vanilla (g=1) time-aware activation scales on the folded
weights and writes the merged `cali_ckpt.pth`. --resume_w starts from an
existing weight-only checkpoint instead. Without HF weights or prompt data,
random weights and synthetic prompt embeddings drive the same machinery.

AdaRound / BRECQ reconstruction (the default without --no_recon, and the
flags that only it reads) is not ported and raises. The run is on the card
unless --device cpu is given. `main(argv)` takes the argument list and
returns what it wrote, so it can be driven in-process.
"""
from __future__ import annotations

import argparse
import os

from dgq_tpu_torch.cli.common import (
    add_quant_args,
    build_cali_data,
    build_model,
    cali_embeddings_from_args,
    maybe_init_multihost,
    model_type_from_env,
    pooled_dim_for,
    qconfig_from_args,
    resolve_device,
    setup_logging,
    slot_clock,
    timed,
)

RECON = "ROADMAP queue 1, the reconstruction slice (calib/reconstruction.py)"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="DGQ weight quantization (PyTorch port)")
    ap.add_argument("--model", default=model_type_from_env(), choices=["sd", "sdxl"])
    ap.add_argument("--outdir", default="results")
    add_quant_args(ap)
    ap.add_argument("--use_aq", action="store_true",
                    help="also run vanilla activation calibration afterwards")
    ap.add_argument("--running_stat", action="store_true", default=True)
    ap.add_argument("--no_running_stat", dest="running_stat", action="store_false")
    ap.add_argument("--cali", action="store_true", help="MSE scale init (else minmax)")
    ap.add_argument("--cali_prompt_data_n", type=int, default=64)
    ap.add_argument("--cali_data_path", default="./data/cali_data")
    ap.add_argument("--step_size", type=int, default=-1)
    ap.add_argument("--no_recon", action="store_true")
    ap.add_argument("--resume_w", default=None,
                    help="resume from an existing weight-only checkpoint (continues "
                         "into the activation phase with --use_aq)")
    ap.add_argument("--dp", type=int, default=1, help="data-parallel devices (not ported)")
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel devices (not ported)")
    ap.add_argument("--partial_dir", default=None,
                    help="per-unit reconstruction saves (not ported)")
    ap.add_argument("--tib_recon", action="store_true",
                    help="temporal-information block reconstruction (not ported)")
    ap.add_argument("--recon_loss", default="mse",
                    choices=["mse", "fisher_diag", "fisher_full"],
                    help="reconstruction loss (not ported)")
    ap.add_argument("--fast", action="store_true", help="minmax init")
    ap.add_argument("--debug", action="store_true", help="= --fast, 4 prompts, 10 iters")
    ap.add_argument("--iters", type=int, default=20000)
    ap.add_argument("--max_units", type=int, default=None)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--unet_weights", default=None,
                    help="path to torch UNet state dict (HF snapshot)")
    ap.add_argument("--base", type=int, default=None,
                    help="override model width (tiny smoke runs)")
    ap.add_argument("--latent_hw", type=int, default=None,
                    help="override latent size (tiny smoke runs)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    if args.debug:
        args.fast = True
        args.cali_prompt_data_n = 4
        args.iters = 10
    if args.step_size < 0:
        args.step_size = 25 if args.model == "sd" else 4
    return args


def refuse_unported(args) -> None:
    """Reconstruction and the flags only it (or multi-device) reads raise;
    nothing is skipped silently."""
    if not (args.no_recon or args.resume_w):
        raise NotImplementedError(
            f"weight reconstruction (AdaRound/BRECQ) is not ported: pass --no_recon or "
            f"--resume_w; {RECON}")
    asked = [flag for flag, on in (
        ("--dp", args.dp > 1), ("--tp", args.tp > 1), ("--partial_dir", args.partial_dir),
        ("--tib_recon", args.tib_recon), ("--recon_loss", args.recon_loss != "mse")) if on]
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)} serve reconstruction or multi-device runs, which are not "
            f"ported: {RECON}; multi-device: ROADMAP queue 1, item 17")


def main(argv=None) -> dict:
    """Runs the CLI; returns {'weight_only': path or None, 'merged': path or
    None, 'params', 'wqp': the weights and their scales, 'per_t': the
    activation states or None, 'seconds': {'weight_init', 'cali_data',
    'act_slots': [seconds of each time slot]}}."""
    args = parse_args(argv)
    maybe_init_multihost(args)
    refuse_unported(args)
    device = resolve_device(args.device)
    outpath, log = setup_logging(args.outdir)
    from dgq_tpu_torch.calib.act_calib import calibrate_activations
    from dgq_tpu_torch.calib.weight_calib import fold_weight_quant, init_weight_qparams
    from dgq_tpu_torch.io.dgq_ckpt import load_weight_only, save_merged, save_weight_only
    from dgq_tpu_torch.quant.scalers import Scaler

    spec, params, apply_fn, latent_hw, cross = build_model(
        args.model, base=args.base, seed=args.seed, hf_unet_path=args.unet_weights,
        sdxl_depths=args.sdxl_depths, init_params=not args.resume_w, device=device)
    cfg = qconfig_from_args(args, use_wq=True)
    latent_hw = args.latent_hw or latent_hw
    pooled = pooled_dim_for(args.model, args.base)
    seconds = {}
    result = {"weight_only": None, "merged": None, "per_t": None, "seconds": seconds}
    path = os.path.join(outpath, "cali_ckpt.pth")
    alphas = None
    if args.resume_w:
        log.info(f"resuming from {args.resume_w}")
        params, wqp, alphas = load_weight_only(args.resume_w, spec, device)
        alphas = alphas or None
        if not args.use_aq:
            save_weight_only(f"{path}_weight_only", params, wqp, spec, alphas=alphas)
            result["weight_only"] = f"{path}_weight_only"
            log.info(f"resumed checkpoint re-saved to {path}_weight_only")
    else:
        scaler = Scaler.MINMAX if (args.fast or not args.cali) else Scaler.MSE
        log.info(f"weight scale init: {scaler} w{args.wq}")
        wqp, seconds["weight_init"] = timed(
            device, lambda: init_weight_qparams(params, spec, args.wq, scaler))
        log.info(f"weight scale init: {seconds['weight_init']:.2f} s")
        save_weight_only(f"{path}_weight_only", params, wqp, spec)
        result["weight_only"] = f"{path}_weight_only"
        log.info(f"calibrated model saved to {path}_weight_only")
    result.update(params=params, wqp=wqp)

    if args.use_aq:
        # vanilla (g=1) activation calibration, written with the weights as
        # one merged checkpoint (the reference nests {'weight': {'weight':
        # ...}} here, which its own loader never reads back; the flat merged
        # format is what both loaders read)
        embeds, tag = cali_embeddings_from_args(args, args.model, cross,
                                                args.cali_prompt_data_n, args.seed,
                                                pooled_dim=pooled, device=device)
        (cali_data, interval), seconds["cali_data"] = timed(device, lambda: build_cali_data(
            args.model, params, apply_fn, cross, args.cali_prompt_data_n, args.step_size,
            latent_hw, args.seed, cache_prefix=args.cali_data_path, pooled_dim=pooled,
            embeds=embeds, embeds_tag=tag))
        log.info(f"calibration set: {cali_data[0].shape[0]} samples, interval {interval}, "
                 f"{seconds['cali_data']:.2f} s")
        cfg_aq = qconfig_from_args(args, use_wq=True, use_aq=True)
        params_q = fold_weight_quant(params, wqp, spec, cfg, alphas=alphas, soft=False)
        progress, slot_seconds = slot_clock(device, log)
        per_t, _ = calibrate_activations(
            params_q, spec, cfg_aq, cali_data, interval=interval, group_num=0,
            running_stat=args.running_stat, batch_size=8 if args.model == "sd" else 4,
            unet_apply=apply_fn, progress=progress)
        seconds["act_slots"] = slot_seconds()
        save_merged(path, params, wqp, spec, per_t, alphas=alphas)
        result.update(merged=path, per_t=per_t)
        log.info(f"calibrated model (weight+act) saved to {path}")
    return result


if __name__ == "__main__":
    main()
