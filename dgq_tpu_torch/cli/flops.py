"""Model cost CLI (port of `dgq_tpu/cli/flops.py`; the reference's
`python diffusers_rewrite/sd.py flops unet`):

    python -m dgq_tpu_torch.cli.flops --model sd
    python -m dgq_tpu_torch.cli.flops --model sdxl --wq 4 --aq 8
    python -m dgq_tpu_torch.cli.flops --model sd --roofline --batch 8 --steps 50

Prints the same lines as the JAX package's CLI. --roofline's defaults are one
NVIDIA H100 SXM's published peaks; its 'bound' column says MXU where the
compute bound wins (the tensor cores on this card) and HBM where the memory
bound does. Nothing here touches a device.
"""
from __future__ import annotations

import argparse

from dgq_tpu_torch.models.families import CLI_FAMILIES, FAMILIES
from dgq_tpu_torch.utils.flops import H100_BF16_TFS, H100_HBM_GBS, bops, spec_cost, spec_roofline


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="DGQ model cost accounting (PyTorch port)")
    ap.add_argument("--model", default="sd", choices=CLI_FAMILIES)
    ap.add_argument("--wq", type=int, default=32)
    ap.add_argument("--aq", type=int, default=32)
    ap.add_argument("--roofline", action="store_true",
                    help="speed-of-light UNet step time on one NVIDIA H100")
    ap.add_argument("--batch", type=int, default=8,
                    help="UNet batch (CFG-doubled latents) for --roofline")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--cfg", type=int, default=2,
                    help="latents per image in the batch (2 = CFG pair)")
    ap.add_argument("--peak_tfs", type=float, default=H100_BF16_TFS,
                    help="card bf16 peak TF/s (H100 SXM default)")
    ap.add_argument("--hbm_gbs", type=float, default=H100_HBM_GBS,
                    help="card memory GB/s (H100 SXM default)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    fam = FAMILIES[args.model]
    spec, hw = fam.spec(), fam.latent_hw
    cost = spec_cost(spec, latent_hw=hw)
    print(f"#Params: {cost['params'] / 1e6:.4f} M")
    print(f"#MACs: {cost['macs'] / 1e9:.4f} G")
    print(f"#FLOPs: {cost['flops'] / 1e9:.4f} G")
    print(f"#BOPs: {bops(cost['macs'], args.wq, args.aq) / 1e12:.4f} T")

    if args.roofline:
        r = spec_roofline(spec, latent_hw=hw, batch=args.batch,
                          peak_tfs=args.peak_tfs, hbm_gbs=args.hbm_gbs,
                          attn_head_dim=fam.attn_head_dim)
        print(f"\nRoofline, one UNet forward, batch {args.batch} "
              f"({args.peak_tfs:.0f} TF/s, {args.hbm_gbs:.0f} GB/s):")
        print(f"{'latent':>8} {'compute ms':>11} {'memory ms':>10} "
              f"{'SOL ms':>8} {'bound':>7}")
        for h, lv in r["per_scale"].items():
            bound = "MXU" if lv["compute_s"] > lv["memory_s"] else "HBM"
            print(f"{h:>6}px {lv['compute_s'] * 1e3:>11.2f} "
                  f"{lv['memory_s'] * 1e3:>10.2f} "
                  f"{lv['sol_s'] * 1e3:>8.2f} {bound:>7}")
        print(f"{'total':>8} {r['compute_s'] * 1e3:>11.2f} "
              f"{r['memory_s'] * 1e3:>10.2f} {r['sol_s'] * 1e3:>8.2f}")
        imgs = args.batch / args.cfg
        sol_img_s = imgs / (args.steps * r["sol_s"])
        print(f"SOL sampler throughput ({args.steps} steps, {imgs:.0f} "
              f"images/batch, UNet only): {sol_img_s:.3f} img/s")


if __name__ == "__main__":
    main()
