"""Weight PTQ (port of `dgq_tpu/cli/quantize_weight.py`, the reference's
src/quantize_weight.py):

    python -m dgq_tpu_torch.cli.quantize_weight --model sd --wq 4 --cali [--use_aq]
    python -m dgq_tpu_torch.cli.quantize_weight --model sd --wq 4 --cali --no_recon
    python -m dgq_tpu_torch.cli.quantize_weight --model sdxl --wq 4 --fast --no_recon

Per-out-channel weight scales (MSE search with --cali, else minmax), then by
default AdaRound / BRECQ reconstruction of every unit (`calib.reconstruction`:
--iters Adam steps a unit, --recon_loss mse / fisher_diag / fisher_full,
--tib_recon, --partial_dir per-unit saves to resume from, --max_units), are
written as a weight-only checkpoint `cali_ckpt.pth_weight_only` that carries
the learned offsets; --no_recon keeps nearest rounding. --use_aq then
calibrates vanilla (g=1) time-aware activation scales on the folded weights
and writes the merged `cali_ckpt.pth`. --resume_w starts from an existing
weight-only checkpoint instead. Without HF weights or prompt data, random
weights and synthetic prompt embeddings drive the same machinery.

The reconstruction differentiates the UNet's attention, which only the plain
layers allow: with --pallas_attn it is refused, as the JAX package cannot
differentiate its Pallas attention either. --dp N runs the reconstruction
data-parallel over N ranks, one process each, started by torchrun:

    torchrun --nproc_per_node 2 -m dgq_tpu_torch.cli.quantize_weight --dp 2 ...

Each rank holds its slice of every unit's captures and the gradients are
summed over the ranks (`calibrate_weights(mesh=)`); the weight-scale init
and the activation calibration run on every rank, and rank 0 writes. --tp N
cuts every weight's out channels over N ranks right after the model is
built, as the JAX package shards them (`parallel.mesh.shard_params_tp`: the
weights are built on the host and each rank moves only its shards to its
card); every later step runs on the shards, each cut layer gathering its
out channels (`parallel.tp`), and every write gathers the whole tensors
first. --dp and --tp combine, over dp * tp ranks:

    torchrun --nproc_per_node 4 -m dgq_tpu_torch.cli.quantize_weight --dp 2 --tp 2 ...

The run is on the card unless --device cpu is given. `main(argv)` takes
the argument list and returns what it wrote (rank 0's paths; None on the
other ranks), so it can be driven in-process.
"""
from __future__ import annotations

import argparse
import os

import torch.distributed as dist

from dgq_tpu_torch.cli.common import (
    add_quant_args,
    build_cali_data,
    build_model,
    built_once,
    cali_embeddings_from_args,
    dp_mesh,
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
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel ranks: the reconstruction's captures shard over them "
                         "and its gradients are summed (start the ranks with torchrun "
                         "--nproc_per_node N)")
    ap.add_argument("--tp", type=int, default=1,
                    help="channel-parallel ranks: every weight's out channels shard over them "
                         "(start dp * tp ranks with torchrun)")
    ap.add_argument("--partial_dir", default=None,
                    help="save one .pth per reconstruction unit as it completes and resume "
                         "by skipping units already saved there (check them with "
                         "`ckpt_tools check`)")
    ap.add_argument("--tib_recon", action="store_true",
                    help="jointly reconstruct the temporal-information block (TFMQ)")
    ap.add_argument("--recon_loss", default="mse",
                    choices=["mse", "fisher_diag", "fisher_full"],
                    help="reconstruction loss")
    ap.add_argument("--fast", action="store_true", help="minmax init")
    ap.add_argument("--debug", action="store_true", help="= --fast, 4 prompts, 10 iters")
    ap.add_argument("--iters", type=int, default=20000)
    ap.add_argument("--max_units", type=int, default=None,
                    help="limit the reconstruction walk to the first N units (debug and "
                         "smoke runs only)")
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
    """Reconstruction with the fused attention kernels raises; nothing is
    skipped silently."""
    if args.pallas_attn and not (args.no_recon or args.resume_w):
        raise NotImplementedError(
            "--pallas_attn with weight reconstruction: the reconstruction differentiates the "
            "UNet's attention, and the fused attention kernels have no backward (the JAX "
            "package cannot differentiate its Pallas attention either). Drop --pallas_attn, "
            "or pass --no_recon; ROADMAP queue 3, differences kept on purpose")


def main(argv=None) -> dict:
    """Runs the CLI; returns {'weight_only': path or None, 'merged': path or
    None, 'params', 'wqp', 'alphas': the weights, their scales and the
    learned offsets (None without reconstruction; with --tp the rank's
    shards), 'per_t': the activation states or None, 'seconds': {'build' (the
    weights built or their spec made), 'shard' (the weights cut and moved
    to the card), 'weight_init', 'cali_data', 'recon', 'act_slots': [seconds
    of each time slot]}}."""
    args = parse_args(argv)
    refuse_unported(args)
    maybe_init_multihost(args)
    mesh = dp_mesh(args, "dgq_tpu_torch.cli.quantize_weight")
    device = resolve_device(args.device)
    outpath, log = setup_logging(args.outdir, device)
    if mesh is not None:
        log.info(f"mesh: dp={mesh.dp} tp={mesh.tp} ({mesh.world} ranks, gradients summed "
                 f"over the {dist.get_backend()} group"
                 + (", weights cut over tp" if mesh.tp > 1 else "") + ")")
    writes = writes_files()
    from dgq_tpu_torch.calib.act_calib import calibrate_activations
    from dgq_tpu_torch.calib.reconstruction import calibrate_weights
    from dgq_tpu_torch.calib.weight_calib import fold_weight_quant, init_weight_qparams
    from dgq_tpu_torch.io.dgq_ckpt import load_weight_only, save_merged, save_weight_only
    from dgq_tpu_torch.parallel.mesh import gather_params_tp, shard_params_tp
    from dgq_tpu_torch.quant.scalers import Scaler

    # with --tp the whole weights stay on the host; each rank moves its shards
    host = mesh is not None and mesh.tp > 1
    seconds = {}
    (spec, params, apply_fn, latent_hw, cross), seconds["build"] = timed(
        device, lambda: build_model(args.model, base=args.base, seed=args.seed,
                                    hf_unet_path=args.unet_weights, sdxl_depths=args.sdxl_depths,
                                    init_params=not args.resume_w, device=device, host=host))
    cfg = qconfig_from_args(args, use_wq=True)
    latent_hw = args.latent_hw or latent_hw
    pooled = pooled_dim_for(args.model, args.base)
    result = {"weight_only": None, "merged": None, "per_t": None, "seconds": seconds}
    path = os.path.join(outpath, "cali_ckpt.pth") if writes else None
    alphas = None
    cali = {}

    def whole(params, wqp, alphas):
        """The whole tensors for a write (gathered over the tp group onto
        the host; every rank takes part, rank 0 writes)."""
        return (gather_params_tp(mesh, params), gather_params_tp(mesh, wqp, like=params),
                alphas and gather_params_tp(mesh, alphas, like=params))

    def cali_data():
        """The calibration set (made once, or read from the .npz cache)."""
        if not cali:
            embeds, tag = cali_embeddings_from_args(args, args.model, cross,
                                                    args.cali_prompt_data_n, args.seed,
                                                    pooled_dim=pooled, device=device)
            (cali["data"], cali["interval"]), seconds["cali_data"] = timed(
                device, lambda: built_once(lambda: build_cali_data(
                    args.model, params, apply_fn, cross, args.cali_prompt_data_n,
                    args.step_size, latent_hw, args.seed, cache_prefix=args.cali_data_path,
                    pooled_dim=pooled, embeds=embeds, embeds_tag=tag), mesh))
            log.info(f"calibration set: {cali['data'][0].shape[0]} samples, interval "
                     f"{cali['interval']}, {seconds['cali_data']:.2f} s")
        return cali["data"], cali["interval"]

    if args.resume_w:
        log.info(f"resuming from {args.resume_w}")
        params, wqp, alphas = load_weight_only(args.resume_w, spec, "cpu" if host else device)
        alphas = alphas or None
        if not args.use_aq and writes:
            save_weight_only(f"{path}_weight_only", params, wqp, spec, alphas=alphas)
            result["weight_only"] = f"{path}_weight_only"
            log.info(f"resumed checkpoint re-saved to {path}_weight_only")
        params = shard_params_tp(mesh, params)
        wqp = shard_params_tp(mesh, wqp, like=params)
        alphas = alphas and shard_params_tp(mesh, alphas, like=params)
    else:
        params, seconds["shard"] = timed(device, lambda: shard_params_tp(mesh, params))
        scaler = Scaler.MINMAX if (args.fast or not args.cali) else Scaler.MSE
        log.info(f"weight scale init: {scaler} w{args.wq}")
        wqp, seconds["weight_init"] = timed(
            device, lambda: init_weight_qparams(params, spec, args.wq, scaler))
        log.info(f"weight scale init: {seconds['weight_init']:.2f} s")
        if not args.no_recon:
            data, _ = cali_data()
            alphas, seconds["recon"] = timed(device, lambda: calibrate_weights(
                params, spec, cfg, wqp, data, iters=args.iters,
                batch_size=8 if args.model == "sd" else 4, w=0.01, warmup=0.2, asym=True,
                seed=args.seed, unet_apply=apply_fn, progress=log.info,
                partial_dir=args.partial_dir, max_units=args.max_units,
                tib_recon=args.tib_recon, opt_mode=args.recon_loss, mesh=mesh))
            log.info(f"reconstruction: {len(alphas)} layers, {seconds['recon']:.2f} s")
        w_params, w_wqp, w_alphas = whole(params, wqp, alphas)
        if writes:
            save_weight_only(f"{path}_weight_only", w_params, w_wqp, spec, alphas=w_alphas)
            result["weight_only"] = f"{path}_weight_only"
            log.info(f"calibrated model saved to {path}_weight_only")
        del w_params, w_wqp, w_alphas
    result.update(params=params, wqp=wqp, alphas=alphas)

    if args.use_aq:
        # vanilla (g=1) activation calibration, written with the weights as
        # one merged checkpoint (the reference nests {'weight': {'weight':
        # ...}} here, which its own loader never reads back; the flat merged
        # format is what both loaders read)
        data, interval = cali_data()
        cfg_aq = qconfig_from_args(args, use_wq=True, use_aq=True)
        params_q = fold_weight_quant(params, wqp, spec, cfg, alphas=alphas, soft=False)
        progress, slot_seconds = slot_clock(device, log)
        per_t, _ = calibrate_activations(
            params_q, spec, cfg_aq, data, interval=interval, group_num=0,
            running_stat=args.running_stat, batch_size=8 if args.model == "sd" else 4,
            unet_apply=apply_fn, progress=progress)
        seconds["act_slots"] = slot_seconds()
        result["per_t"] = per_t
        w_params, w_wqp, w_alphas = whole(params, wqp, alphas)
        if writes:
            save_merged(path, w_params, w_wqp, spec, per_t, alphas=w_alphas)
            result["merged"] = path
            log.info(f"calibrated model (weight+act) saved to {path}")
    return result


if __name__ == "__main__":
    from dgq_tpu_torch.parallel.mesh import leave_multihost

    main()
    leave_multihost()  # a rank of a process group leaves it before it exits
