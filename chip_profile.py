#!/usr/bin/env python3
"""Where one sampling step's time goes on the card, for the port's full-width
configurations (SD v1.4, 2 images, 512px, CFG batch 4, bf16).

    python3 chip_profile.py      # from the repository root; needs one CUDA card

For each of the g=1 path, the g=8 path with the fused group conv and the g=8
path with the taps group conv, it runs one 1-step `sd_sample` (one UNet
forward) three times unprofiled (host wall after a synchronise) and once under
`torch.profiler`, and prints: host wall, the number of device kernels, device
busy time (the union of the kernels' intervals), the idle share
1 - busy / unprofiled wall (the profiler slows the host, not the kernels, so
the profiled wall would overstate it), and device time by bucket (kernels
bucketed by name). The last line repeats the figures as one JSON object. It
shares the model set-up with chip_smoke.py and, like it, refuses to run
without a card.
"""
import json
import statistics
import subprocess
import time

BUCKETS = (
    ("attention kernels (K1-K4)", ("attention_kernel",)),
    ("group conv kernel (K5)", ("group_conv_kernel",)),
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


def profile_step(model, label, qstate, cfg, tag):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dgq_tpu_torch.pipeline.sampler import sd_sample

    def step():
        sd_sample(model["params"], model["latents"], model["ehs_t"], model["ehs_u"],
                  num_inference_steps=1, guidance_scale=7.5, qstate=qstate, cfg=cfg,
                  time_aware=True)
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
    rec = {"config": label, "wall_ms_unprofiled_median": statistics.median(walls),
           "wall_ms_unprofiled": walls, "wall_ms_profiled": wall_prof,
           "device_kernels": len(kernels), "device_busy_ms": busy,
           "idle_share": 1.0 - busy / statistics.median(walls),
           "device_ms_by_bucket": dict(sorted(by_bucket.items(), key=lambda kv: -kv[1]))}
    print(f"{label}: one step (one UNet forward at batch 4): host wall "
          f"{rec['wall_ms_unprofiled_median']:.2f} ms unprofiled (median of {walls}), "
          f"{wall_prof:.2f} ms profiled; {len(kernels)} device kernels, device busy "
          f"{busy:.2f} ms, idle share {rec['idle_share']:.3f}; device ms by bucket "
          f"{rec['device_ms_by_bucket']} | {tag}", flush=True)
    return rec


def main():
    import torch

    import chip_smoke
    from dgq_tpu_torch.models.qconfig import QConfig
    from dgq_tpu_torch.ops import build
    from dgq_tpu_torch.utils.synthetic import synthetic_group_qstate, synthetic_pertensor_qstate

    if not torch.cuda.is_available():
        raise SystemExit("chip_profile.py needs a CUDA GPU: torch.cuda.is_available() is false")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    tag = f"card: {card}"
    build.load_kernels()
    model = chip_smoke.build_model(tag)
    spec, bf = model["spec"], torch.bfloat16
    qs_g1 = synthetic_pertensor_qstate(spec, 1, True, bf)
    qs_g8, group_layers = synthetic_group_qstate(spec, 1, True, bf)
    g1 = QConfig(w_bits=4, a_bits=8, softmax_bits=8, use_wq=True, use_aq=True,
                 use_pallas_attention=True)
    g8 = QConfig(w_bits=4, a_bits=8, **chip_smoke._g8_kwargs(group_layers, "fused"))
    records = [
        profile_step(model, "g=1", qs_g1, g1, tag),
        profile_step(model, "g=8 fused group conv", qs_g8, g8, tag),
        profile_step(model, "g=8 taps group conv", qs_g8, g8.replace(group_conv_impl="taps"), tag),
    ]
    print(json.dumps({"card": card, "steps": records}))


if __name__ == "__main__":
    main()
