#!/usr/bin/env python3
"""Where one sampling step's time goes on the card, for the port's full-width
configurations (2 images, bf16: SD v1.4 at 512px, CFG batch 4; SDXL-turbo at
1024px, batch 2).

    python3 chip_profile.py      # from the repository root; needs one CUDA card
    python3 chip_profile.py --changed   # only the f32 rows (the CLIs' activations)

For each of the SD g=1 path (unpacked, with packed attention, and with the
int8 deploy path), the g=8 path with the fused group conv (unpacked and
packed), the same with the static log2 softmax (`log_max_1`, unpacked and
packed), the g=8 path with the taps group conv and the SDXL-turbo path (int8
deploy path on; off; off with packed attention), it runs one 1-step sampler
call (one UNet forward) three times unprofiled (host wall after a
synchronise) and once under `torch.profiler`, and prints: host wall, the
number of device kernels and how many of them are copies (a permute made
contiguous, a concatenation, a dtype cast: every kernel with "copy" in its
name), device busy time (the union of the kernels' intervals), the idle share
1 - busy / unprofiled wall (the profiler slows the host, not the kernels, so
the profiled wall would overstate it), and device time by bucket (kernels
bucketed by name). Host walls of two calls spread by tens of percent on a
shared host, so each packed step is also timed against its unpacked step in
turns (unpacked, packed, packed, unpacked, five rounds) and the two medians are
printed side by side. The unquantized (fp) SD step, whose 32 attentions are
the flash kernel, is profiled the same way, and one VAE decode of 2 images is
timed at 512px and at 1024px (host wall after a synchronise, median of five;
its one attention is the flash kernel at head dim 512). Before the steps it
times the static-delta attention kernels K4 / K4p and the int8 matmul K6 on
their own at their main-path shapes (`kernel_times`: device-only time and
the wrapper's host time, through the wrappers' public entries, so that the
same script times a parent tree's kernels). The f32 rows (`f32_rows`) are
the forwards the CLIs run, f32 activations over the same bf16 weights (as
`--fp16` runs them): SD g=8 with the fused group conv and the kernels'
attention (K5, K3b), g=1 (K1), g=8 with the static log2 softmax (K5, K4),
the g=8 forward with the taps group conv, the fp forward with
the kernels' attention (K2 at head dims 40 to 160), and one f32 VAE decode
of 2 images at 512px (K2 at head dim 512), each profiled as above.
`--changed` runs only the f32 rows. The last line repeats the figures as
one JSON object. It
shares the model set-up with chip_smoke.py and, like it, refuses to run
without a card.
"""
import json
import statistics
import subprocess
import time

BUCKETS = (
    ("attention kernels (K1-K4, K1p-K4p)",
     ("attention_kernel", "flash_tc_kernel", "quant_tc_kernel", "flash_tf32_kernel",
      "quant_tf32_kernel")),
    ("group conv kernels (K5: fold, conv, split-K finish)",
     ("group_conv", "fold_kernel", "fold_oihw_kernel", "finish_kernel")),
    ("int8 matmul kernel (K6)", ("int8_matmul_kernel", "int8_wgmma_kernel")),
    ("library convs", ("fprop", "implicit_gemm", "cudnn", "conv2d", "convolve")),
    ("library matmuls", ("gemm", "nvjet", "cutlass", "cublas", "splitk")),
    ("reductions", ("reduce",)),
)


def _bucket(name):
    low = name.lower()
    for bucket, keys in BUCKETS:
        if any(k in low for k in keys):
            return bucket
    return "elementwise and copies"


def sd_step(model, qstate, cfg):
    """One 1-step `sd_sample`: one SD v1.4 forward at CFG batch 4, on the
    packed parameters when the policy says packed_attention."""
    from dgq_tpu_torch.pipeline.sampler import sd_sample

    params = model["params_packed" if cfg.packed_attention else "params"]
    return lambda: sd_sample(params, model["latents"], model["ehs_t"], model["ehs_u"],
                             num_inference_steps=1, guidance_scale=7.5, qstate=qstate, cfg=cfg,
                             time_aware=True)


def sdxl_step(model, qstate, cfg):
    """One 1-step `sdxl_turbo_sample`: one SDXL forward at batch 2."""
    from dgq_tpu_torch.models.unet_sdxl import unet_sdxl_apply
    from dgq_tpu_torch.pipeline.sampler import sdxl_turbo_sample

    return lambda: sdxl_turbo_sample(model["params"], model["latents"], model["ehs"],
                                     model["text_embeds"], model["time_ids"], unet_sdxl_apply,
                                     num_inference_steps=1, qstate=qstate, cfg=cfg)


def profile_step(sample, label, batch, tag):
    """`sample` drives one sampling step; it is timed and profiled here."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def step():
        sample()
        torch.cuda.synchronize()

    step()  # warm-up
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        walls.append(1e3 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        wall_prof = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy = (busy + cur_e - cur_s) / 1e3  # us -> ms
    by_bucket = {}
    for e in kernels:
        b = _bucket(e.name)
        by_bucket[b] = by_bucket.get(b, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    copies = [e for e in kernels if "copy" in e.name.lower()]
    rec = {"config": label, "wall_ms_unprofiled_median": statistics.median(walls),
           "wall_ms_unprofiled": walls, "wall_ms_profiled": wall_prof,
           "device_kernels": len(kernels), "copy_kernels": len(copies),
           "copy_kernels_ms": sum(e.time_range.end - e.time_range.start for e in copies) / 1e3,
           "device_busy_ms": busy,
           "idle_share": 1.0 - busy / statistics.median(walls),
           "device_ms_by_bucket": dict(sorted(by_bucket.items(), key=lambda kv: -kv[1]))}
    print(f"{label}: one step (one UNet forward at batch {batch}): host wall "
          f"{rec['wall_ms_unprofiled_median']:.2f} ms unprofiled (median of {walls}), "
          f"{wall_prof:.2f} ms profiled; {len(kernels)} device kernels of which {len(copies)} "
          f"copies ({rec['copy_kernels_ms']:.2f} ms), device busy "
          f"{busy:.2f} ms, idle share {rec['idle_share']:.3f}; device ms by bucket "
          f"{rec['device_ms_by_bucket']} | {tag}", flush=True)
    return rec


def in_turns(unpacked, packed, label, tag, rounds=5):
    """Host wall of one step (ended by a synchronise) of two versions of a
    path, taken in turns so that both see the same host: unpacked, packed,
    packed, unpacked per round. Returns the medians."""
    import torch

    def wall(sample):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    wall(unpacked), wall(packed)  # warm-up
    u, p = [], []
    for _ in range(rounds):
        u.append(wall(unpacked))
        p.append(wall(packed))
        p.append(wall(packed))
        u.append(wall(unpacked))
    rec = {"config": label, "unpacked_wall_ms_median": statistics.median(u),
           "packed_wall_ms_median": statistics.median(p), "unpacked_wall_ms": u,
           "packed_wall_ms": p}
    print(f"{label}, one step in turns ({rounds} rounds of unpacked, packed, packed, unpacked): "
          f"host wall median unpacked {rec['unpacked_wall_ms_median']:.2f} ms (min {min(u):.2f}, "
          f"max {max(u):.2f}), packed attention {rec['packed_wall_ms_median']:.2f} ms (min "
          f"{min(p):.2f}, max {max(p):.2f}), ratio "
          f"{rec['packed_wall_ms_median'] / rec['unpacked_wall_ms_median']:.3f} | {tag}",
          flush=True)
    return rec


# (label, M, K, N) of K6 on the main paths (chip_smoke.py's first six), and
# (label, heads, T, S, head_dim, slot, mode, start_peak) of K4 at SD 64px self
# (CFG batch 4) and SDXL 64px self (batch 2)
K6_SHAPES = [
    ("SD 64px FF-in", 16384, 320, 2560),
    ("SD 8px FF-out", 256, 5120, 1280),
    ("SD cross to_k", 308, 768, 320),
    ("SD time embedding", 4, 320, 1280),
    ("SDXL 32px FF-in", 2048, 1280, 10240),
    ("SDXL add_embedding.linear_1", 2, 2816, 1280),
]
K4_SHAPES = [
    ("SD 64px self log2", 4, 8, 4096, 4096, 40, 64, "log2", False),
    ("SD 64px self log2 start_peak", 4, 8, 4096, 4096, 40, 64, "log2", True),
    ("SD 64px self uniform start_peak", 4, 8, 4096, 4096, 40, 64, "uniform", True),
    ("SD 64px cross log2 start_peak", 4, 8, 4096, 77, 40, 64, "log2", True),
    ("SDXL 64px self log2", 2, 10, 4096, 4096, 64, 64, "log2", False),
]


def kernel_times(tag):
    """K4 (classic and packed entries) and K6 on their own, bf16, through
    `fused_attention` and `quantized_matmul` as the model calls them:
    device-only ms (chip_smoke's `_device_ms`) and the wrapper's host
    microseconds a call (`_host_us`)."""
    import torch

    import chip_smoke
    from dgq_tpu_torch.ops import attention as A
    from dgq_tpu_torch.ops import int8_matmul as M8

    g = torch.Generator(device="cuda").manual_seed(5)
    bf, recs = torch.bfloat16, []
    for label, b, h, t, s, d, dp, mode, sp in K4_SHAPES:
        q = (2.0 * torch.randn(b * h, t, d, generator=g, device="cuda")).to(bf)
        k = (2.0 * torch.randn(b * h, s, d, generator=g, device="cuda")).to(bf)
        v = torch.randn(b * h, s, d, generator=g, device="cuda").to(bf)
        qp, kp, vp = (A.repack_heads(x, h, dp) for x in (q, k, v))
        delta = torch.tensor(1.0 if mode == "log2" else 1.0 / 255.0, device="cuda", dtype=bf)
        kw = dict(sm_mode=mode, sm_bits=8, sm_delta=delta, start_peak=sp)
        for entry, fn in (("K4", lambda: A.fused_attention(q, k, v, d ** -0.5, **kw)),
                          ("K4p", lambda: A.fused_attention(qp, kp, vp, d ** -0.5, num_heads=h,
                                                            head_dim=d, **kw))):
            rec = {"kernel": entry, "shape": label, "device_ms": chip_smoke._device_ms(fn),
                   "host_us": chip_smoke._host_us(fn)}
            recs.append(rec)
            print(f"{entry} {label} (B={b}, H={h}, T={t}, S={s}, d={d}): device-only "
                  f"{rec['device_ms']:.4f} ms, wrapper host {rec['host_us']:.1f} us | {tag}",
                  flush=True)
        del q, k, v, qp, kp, vp
    for label, m, k, n in K6_SHAPES:
        x = (2.0 * torch.randn(m, k, generator=g, device="cuda")).to(bf)
        wq = torch.randint(-8, 8, (n, k), generator=g, device="cuda",
                           dtype=torch.int32).to(torch.int8)
        args = (x, wq, 0.003 + 0.002 * torch.rand(n, generator=g, device="cuda"),
                torch.round(torch.randn(n, generator=g, device="cuda")),
                torch.tensor(0.05, device="cuda"), torch.tensor(0.0, device="cuda"),
                torch.randn(n, generator=g, device="cuda").to(bf),
                wq.sum(dim=1, dtype=torch.int32).float())
        rec = {"kernel": "K6", "shape": label,
               "device_ms": chip_smoke._device_ms(lambda: M8.quantized_matmul(*args)),
               "host_us": chip_smoke._host_us(lambda: M8.quantized_matmul(*args))}
        recs.append(rec)
        print(f"K6 {label} (M={m}, K={k}, N={n}): device-only {rec['device_ms']:.4f} ms, "
              f"wrapper host {rec['host_us']:.1f} us | {tag}", flush=True)
    torch.cuda.empty_cache()
    return recs


def time_decode(vae, latents, scale, label, tag, reps=5):
    """Host wall of one `vae_decode` of `latents`, ended by a synchronise."""
    import torch
    from dgq_tpu_torch.pipeline.vae import vae_decode

    walls = []
    for i in range(reps + 1):  # the first is the warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vae_decode(vae, latents, scale=scale)
        torch.cuda.synchronize()
        if i:
            walls.append(1e3 * (time.perf_counter() - t0))
    rec = {"config": label, "wall_ms_median": statistics.median(walls), "wall_ms": walls}
    print(f"{label}: VAE decode of {latents.shape[0]} images, host wall median "
          f"{rec['wall_ms_median']:.2f} ms of {walls} | {tag}", flush=True)
    return rec


def f32_rows(model, tag):
    """The f32 forwards of the CLIs (`--fp16`: bf16 weights, f32 activations,
    f32 activation states), one step each, and one f32 decode at 512px."""
    import torch

    import chip_smoke
    from dgq_tpu_torch.models.qconfig import QConfig
    from dgq_tpu_torch.pipeline.vae import SD_VAE_SCALE, init_vae_decoder, vae_decode
    from dgq_tpu_torch.utils.synthetic import synthetic_group_qstate, synthetic_pertensor_qstate

    f32 = torch.float32
    m32 = {**model, "latents": model["latents"].float(), "ehs_t": model["ehs_t"].float(),
           "ehs_u": model["ehs_u"].float()}
    qs, group_layers = synthetic_group_qstate(model["spec"], 1, True, f32)
    g8 = QConfig(w_bits=4, a_bits=8, **chip_smoke._g8_kwargs(group_layers, "fused"))
    g1 = QConfig(w_bits=4, a_bits=8, softmax_bits=8, use_wq=True, use_aq=True,
                 use_pallas_attention=True)
    records = [
        profile_step(sd_step(m32, qs, g8), "f32 g=8 fused group conv (K5, K3b)", 4, tag),
        profile_step(sd_step(m32, synthetic_pertensor_qstate(model["spec"], 1, True, f32), g1),
                     "f32 g=1 (K1)", 4, tag),
        profile_step(sd_step(m32, qs, g8.replace(t2i_real_time=False, log_max_1=True)),
                     "f32 g=8 static log2 fused group conv (K5, K4)", 4, tag),
        profile_step(sd_step(m32, qs, g8.replace(group_conv_impl="taps")),
                     "f32 g=8 taps group conv (K3b)", 4, tag),
        profile_step(sd_step(m32, None, QConfig(use_pallas_attention=True)),
                     "f32 fp, the kernels' attention (K2)", 4, tag),
    ]
    g = torch.Generator(device="cuda").manual_seed(8)
    vae = init_vae_decoder(g, "cuda", dtype=f32)
    records.append(profile_step(lambda: vae_decode(vae, m32["latents"], scale=SD_VAE_SCALE),
                                "f32 VAE decode at 512px (K2 at head dim 512)", 2, tag))
    del vae
    torch.cuda.empty_cache()
    return records


def main():
    import sys

    import torch

    import chip_smoke
    from dgq_tpu_torch.models.qconfig import QConfig
    from dgq_tpu_torch.ops import build
    from dgq_tpu_torch.pipeline.vae import SD_VAE_SCALE, SDXL_VAE_SCALE
    from dgq_tpu_torch.utils.synthetic import synthetic_group_qstate, synthetic_pertensor_qstate

    if not torch.cuda.is_available():
        raise SystemExit("chip_profile.py needs a CUDA GPU: torch.cuda.is_available() is false")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    tag = f"card: {card}"
    build.load_kernels()
    changed_only = "--changed" in sys.argv[1:]
    if changed_only:
        model = chip_smoke.build_model(tag)
        records = f32_rows(model, tag)
        print(json.dumps({"card": card, "steps": records}))
        return
    kernels = kernel_times(tag)
    model = chip_smoke.build_model(tag)
    spec, bf = model["spec"], torch.bfloat16
    qs_g1 = synthetic_pertensor_qstate(spec, 1, True, bf)
    qs_g8, group_layers = synthetic_group_qstate(spec, 1, True, bf)
    g1 = QConfig(w_bits=4, a_bits=8, softmax_bits=8, use_wq=True, use_aq=True,
                 use_pallas_attention=True)
    g8 = QConfig(w_bits=4, a_bits=8, **chip_smoke._g8_kwargs(group_layers, "fused"))
    g1p, g8p = g1.replace(packed_attention=True), g8.replace(packed_attention=True)
    log2 = g8.replace(t2i_real_time=False, log_max_1=True)
    log2p = log2.replace(packed_attention=True)
    fp = QConfig(use_pallas_attention=True)
    records, turns = f32_rows(model, tag), []
    records += [
        profile_step(sd_step(model, qs_g1, g1), "g=1", 4, tag),
        profile_step(sd_step(model, qs_g1, g1p), "g=1 packed attention", 4, tag),
        profile_step(sd_step(model, qs_g1, g1.replace(use_int8_matmul=True)),
                     "g=1 int8 deploy path", 4, tag),
        profile_step(sd_step(model, qs_g8, g8), "g=8 fused group conv", 4, tag),
        profile_step(sd_step(model, qs_g8, g8p), "g=8 fused group conv, packed attention", 4, tag),
        profile_step(sd_step(model, qs_g8, log2), "g=8 static log2", 4, tag),
        profile_step(sd_step(model, qs_g8, log2p), "g=8 static log2, packed attention", 4, tag),
        profile_step(sd_step(model, None, fp), "fp (no activation quantizer)", 4, tag),
        profile_step(sd_step(model, None, fp.replace(packed_attention=True)),
                     "fp, packed attention", 4, tag),
        profile_step(sd_step(model, qs_g8, g8.replace(group_conv_impl="taps")),
                     "g=8 taps group conv", 4, tag),
    ]
    turns += [in_turns(sd_step(model, qs_g1, g1), sd_step(model, qs_g1, g1p), "g=1", tag),
              in_turns(sd_step(model, qs_g8, g8), sd_step(model, qs_g8, g8p),
                       "g=8 fused group conv", tag),
              in_turns(sd_step(model, qs_g8, log2), sd_step(model, qs_g8, log2p),
                       "g=8 static log2", tag)]
    g = torch.Generator(device="cuda").manual_seed(7)
    decodes = [time_decode(model["vae"], model["latents"], SD_VAE_SCALE, "SD decode at 512px", tag),
               time_decode(model["vae"],
                           torch.randn(2, 128, 128, 4, generator=g, device="cuda").to(bf),
                           SDXL_VAE_SCALE, "SDXL decode at 1024px", tag)]
    del model, qs_g1, qs_g8
    torch.cuda.empty_cache()  # SDXL needs 20 GB while it folds
    model = chip_smoke.build_sdxl_model(tag)
    qs = synthetic_pertensor_qstate(model["spec"], 0, False, bf)
    xl = QConfig(w_bits=4, a_bits=8, softmax_bits=8, use_wq=True, use_aq=True,
                 t2i_log_quant=True, t2i_real_time=True, t2i_start_peak=True,
                 use_pallas_attention=True, use_int8_matmul=True)
    off = xl.replace(use_int8_matmul=False)
    records += [
        profile_step(sdxl_step(model, qs, xl), "SDXL-turbo int8 deploy path", 2, tag),
        profile_step(sdxl_step(model, qs, off), "SDXL-turbo int8 path off", 2, tag),
        profile_step(sdxl_step(model, qs, off.replace(packed_attention=True)),
                     "SDXL-turbo int8 path off, packed attention", 2, tag),
    ]
    turns.append(in_turns(sdxl_step(model, qs, off),
                          sdxl_step(model, qs, off.replace(packed_attention=True)),
                          "SDXL-turbo int8 path off", tag))
    print(json.dumps({"card": card, "kernels": kernels, "steps": records, "in_turns": turns,
                      "decodes": decodes}))


if __name__ == "__main__":
    main()
