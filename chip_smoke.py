#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`dgq_tpu_torch`) once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (any failure raises, so the exit code is non-zero):
  1. build the hand-written CUDA kernels from dgq_tpu_torch/csrc/ (nvcc, sm_90a);
  2. hold each kernel against its plain PyTorch version at the main path's
     shapes, with the tolerance stated in `_check`, and time both;
  3. a small-input check: the tiny UNet on the card against the same model
     on the CPU (plain attention), fp and W8A8;
  4. the main path at full width: SD v1.4 (random weights from a seed),
     W4 minmax fold, time-aware per-tensor A8 + uniform A8 softmax
     quantizers, 2 images at 512px, 10 DDIM steps with CFG 7.5 in bf16, then
     the VAE decode; the kernels' launch counts over that run are checked.
The last two lines are the kernels' JSON record and the result line
{"ok": true, "device": {...}}. The first line is the card's name and power
limit as nvidia-smi gives them; every number printed after it was measured
in this run on that card, and its line says so (`| card: ...`).
"""
import json
import re
import statistics
import subprocess
import time

STEPS = 10
IMAGES = 2
SOURCE = "dgq_tpu_torch/csrc/attention.cu"
REPLACES = {
    "static_uniform_attention": "dgq_tpu/ops/pallas/attention.py:256",
    "flash_attention": "dgq_tpu/ops/pallas/attention.py:464",
}


def _median_ms(fn, reps=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _check(out, ref, v, delta=None):
    """bf16 tolerance. Each side rounds its f32 result to bf16 once (half an
    ulp, <= 2^-8 relative), so |err| <= 2^-7 |ref| + 1e-5 max|V|. With the
    uniform softmax quantizer (delta), exp and the summation order differ
    from the plain version, so a probability within float error of a bin
    boundary may take the neighbouring code: a few one-bin flips,
    |err| <= 2 delta max|V| more, with the mean bounded."""
    out, ref = out.float(), ref.float()
    if out.shape != ref.shape or not bool(out.isfinite().all()):
        raise AssertionError(f"bad kernel output: shape {tuple(out.shape)}, finite "
                             f"{bool(out.isfinite().all())}")
    err = (out - ref).abs()
    vmax = float(v.float().abs().max())
    bound = 2.0 ** -7 * ref.abs() + 1e-5 * vmax
    if delta is not None:
        bound = bound + 2.0 * delta * vmax
        mean_bound = 2.0 ** -8 * float(ref.abs().mean()) + 0.01 * delta * vmax
        if float(err.mean()) > mean_bound:
            raise AssertionError(f"mean error {float(err.mean())} > {mean_bound}")
    if not bool((err <= bound).all()):
        raise AssertionError(f"error exceeds the bound by {float((err - bound).max())}")
    return float(err.max()), float(err.mean())


def compare_kernels(tag):
    """Phase 2: each kernel against attention_reference at the main path's
    shapes (SD 512px: CFG batch 2 x IMAGES, 8 heads; VAE: IMAGES, one head)."""
    import torch
    from dgq_tpu_torch.ops.attention import attention_reference, fused_attention

    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    delta = torch.tensor(1.0 / 255.0, device="cuda", dtype=bf)  # the synthetic g=1 delta
    bh = 2 * IMAGES * 8
    cases = []
    for px, t, d in [(64, 4096, 40), (32, 1024, 80), (16, 256, 160), (8, 64, 160)]:
        for kind, s in (("self", t), ("cross", 77)):
            cases.append(("static_uniform_attention", f"{px}px {kind}", bh, t, s, d))
    cases.append(("flash_attention", "VAE mid-block", IMAGES, 4096, 4096, 512))
    cases.append(("flash_attention", "64px self (fp UNet)", bh, 4096, 4096, 40))
    summary = {}
    for name, label, bh, t, s, d in cases:
        q = (2.0 * torch.randn(bh, t, d, generator=g, device="cuda")).to(bf)
        k = (2.0 * torch.randn(bh, s, d, generator=g, device="cuda")).to(bf)
        v = torch.randn(bh, s, d, generator=g, device="cuda").to(bf)
        mode = "uniform" if name == "static_uniform_attention" else "none"
        dl = delta if mode == "uniform" else None

        def kernel():
            return fused_attention(q, k, v, d ** -0.5, sm_mode=mode, sm_bits=8, sm_delta=dl)

        def plain():
            return attention_reference(q, k, v, d ** -0.5, mode, 8, dl)

        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        mx, mean = _check(out, ref, v, float(delta) if dl is not None else None)
        ms, plain_ms = _median_ms(kernel), _median_ms(plain)
        print(f"{name} {label} (BH={bh}, T={t}, S={s}, D={d}, bf16): max_abs_err {mx:.6g} "
              f"mean_abs_err {mean:.3g}; median ms kernel {ms:.4f} plain {plain_ms:.4f} | {tag}",
              flush=True)
        rec = summary.setdefault(name, {"max_abs_err": 0.0})
        rec["max_abs_err"] = max(rec["max_abs_err"], mx)
        if "ms" not in rec:  # the first case of each kernel is its largest main-path shape
            rec.update(ms=ms, plain_ms=plain_ms, at=label)
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    return summary


def small_input_check(tag):
    """Phase 3: the tiny UNet (base 32) on the card (kernels) against the same
    weights and inputs on the CPU (plain attention), f32 with TF32 off.
    fp: atol 1e-4 (summation order). W8A8: the chaos bound of the JAX
    package's tests, err <= max(5 * chaos, 1e-4), chaos = the CPU net's
    largest output change under four 1e-6 input perturbations."""
    import torch
    from dgq_tpu_torch.calib.weight_calib import quantize_model_weights
    from dgq_tpu_torch.models.qconfig import QConfig
    from dgq_tpu_torch.models.unet_sd import init_unet_sd, sd_unet_spec, unet_sd_apply
    from dgq_tpu_torch.ops.attention import LAUNCHES
    from dgq_tpu_torch.utils.synthetic import synthetic_pertensor_qstate

    saved_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = sd_unet_spec(base=32, cross=64)
    g = torch.Generator().manual_seed(1)
    params = init_unet_sd(g, spec=spec)
    x = torch.randn(2, 16, 16, 4, generator=g)
    ehs = torch.randn(2, 77, 64, generator=g)
    t = torch.tensor([500, 500], dtype=torch.int32)
    noise = [1e-6 * torch.randn(x.shape, generator=g) for _ in range(4)]

    def cuda(tree):
        if isinstance(tree, dict):
            return {k: cuda(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return type(tree)(*(cuda(v) for v in tree))
        return None if tree is None else tree.cuda()

    kw = dict(w_bits=8, a_bits=8, softmax_bits=8, use_wq=True, use_aq=True,
              use_pallas_attention=True)
    params_q, _ = quantize_model_weights(params, spec, QConfig(**kw))
    qstate = synthetic_pertensor_qstate(spec, 0, False, torch.float32)
    with torch.no_grad():
        for label, p, qs, cfg in [("fp", params, None, QConfig(use_pallas_attention=True)),
                                  ("W8A8", params_q, qstate, QConfig(**kw))]:
            before = dict(LAUNCHES)
            ref = unet_sd_apply(p, x, t, ehs, qstate=qs, cfg=cfg)
            out = unet_sd_apply(cuda(p), x.cuda(), t.cuda(), ehs.cuda(), qstate=cuda(qs),
                                cfg=cfg).cpu()
            launched = {n: LAUNCHES[n] - before[n] for n in LAUNCHES}
            err = float((out - ref).abs().max())
            if label == "fp":
                bound = 1e-4
            else:
                chaos = max(float((unet_sd_apply(p, x + n, t, ehs, qstate=qs, cfg=cfg) - ref)
                                  .abs().max()) for n in noise)
                bound = max(5 * chaos, 1e-4)
            print(f"tiny UNet {label}: card vs CPU max_abs_err {err:.6g} (bound {bound:.6g}); "
                  f"kernel launches {launched} | {tag}", flush=True)
            if not (err <= bound and bool(out.isfinite().all())):
                raise AssertionError(f"tiny UNet {label}: {err} > {bound}")
            if sum(launched.values()) == 0:
                raise AssertionError(f"tiny UNet {label} launched no kernel")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved_tf32


def main_path(tag):
    """Phase 4: the g=1 W4A8 SD v1.4 sampling path at full width."""
    import torch
    from dgq_tpu_torch.calib.act_calib import attention_prefixes, softmax_qpoint_names
    from dgq_tpu_torch.calib.weight_calib import quantize_model_weights
    from dgq_tpu_torch.models.qconfig import QConfig
    from dgq_tpu_torch.models.unet_sd import init_unet_sd, quantizable_layers, sd_unet_spec
    from dgq_tpu_torch.ops.attention import LAUNCHES, reset_launch_counts
    from dgq_tpu_torch.pipeline.sampler import sd_sample
    from dgq_tpu_torch.pipeline.vae import init_vae_decoder, vae_decode
    from dgq_tpu_torch.utils.synthetic import synthetic_pertensor_qstate

    bf = torch.bfloat16
    spec = sd_unet_spec()
    g = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = init_unet_sd(g, "cuda", torch.float32, spec)
    n_params = sum(v.numel() for p in params.values() for v in p.values() if v is not None)
    n_quant = len(quantizable_layers(spec))
    if n_params != 859_520_964 or n_quant != 282:
        raise AssertionError(f"SD v1.4 has {n_params} params / {n_quant} quant layers")
    cfg = QConfig(w_bits=4, a_bits=8, softmax_bits=8, use_wq=True, use_aq=True,
                  use_pallas_attention=True)
    params_q, _ = quantize_model_weights(params, spec, cfg)
    del params
    params_q = {n: {k: None if v is None else v.to(bf) for k, v in p.items()}
                for n, p in params_q.items()}
    qstate = synthetic_pertensor_qstate(spec, STEPS, True, bf, device="cuda")
    n_attn = len(attention_prefixes(spec))
    if n_attn != 32 or not all(n in qstate["a"] for n in softmax_qpoint_names(spec)):
        raise AssertionError("every attention needs a uniform A8 aqtizer_w")
    vae = init_vae_decoder(g, "cuda", dtype=bf)
    latents = torch.randn(IMAGES, 64, 64, 4, generator=g, device="cuda").to(bf)
    ehs_t = torch.randn(IMAGES, 77, 768, generator=g, device="cuda").to(bf)
    ehs_u = torch.randn(IMAGES, 77, 768, generator=g, device="cuda").to(bf)
    torch.cuda.synchronize()
    print(f"SD v1.4: {n_params / 1e6:.2f}M params, {n_quant} quant layers, {n_attn} "
          f"attentions; init + W4 fold {time.perf_counter() - t0:.2f} s | {tag}", flush=True)

    def run(steps):
        lat = sd_sample(params_q, latents, ehs_t, ehs_u, num_inference_steps=steps,
                        guidance_scale=7.5, qstate=qstate, cfg=cfg, time_aware=True)
        torch.cuda.synchronize()
        t_lat = time.perf_counter()
        return lat, t_lat, vae_decode(vae, lat)

    run(1)  # warm-up (allocator, library handles), not counted
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat, t_lat, images = run(STEPS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = dict(LAUNCHES)
    if launches["static_uniform_attention"] != n_attn * STEPS:
        raise AssertionError(f"K1 ran {launches['static_uniform_attention']} times, "
                             f"expected {n_attn * STEPS}")
    if launches["flash_attention"] < 1:
        raise AssertionError("K2 (VAE attention) never ran")
    if tuple(images.shape) != (IMAGES, 512, 512, 3) or not bool(images.isfinite().all()):
        raise AssertionError(f"bad images: {tuple(images.shape)}")
    if not bool(lat.isfinite().all()) or float(images.float().std()) == 0.0:
        raise AssertionError("degenerate output")
    print(f"main path: {IMAGES} images 512px, {STEPS} DDIM steps CFG 7.5 bf16: sampling "
          f"{t_lat - t0:.4f} s ({(t_lat - t0) / STEPS:.4f} s per step = one UNet forward at "
          f"batch {2 * IMAGES}), VAE decode {t1 - t_lat:.4f} s, {(t1 - t0) / IMAGES:.4f} s "
          f"per image; launches {launches} | {tag}", flush=True)
    return launches


def main():
    import torch

    import dgq_tpu_torch  # noqa: F401  (fails outside the repository)
    from dgq_tpu_torch.ops import build

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA GPU: torch.cuda.is_available() is false")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)  # the nvidia-smi line as it is
    tag = f"card: {card}"

    t0 = time.perf_counter()
    lib = build.build_kernels()
    build.load_kernels()
    print(f"build: {time.perf_counter() - t0:.2f} s ({lib.name}) | {tag}", flush=True)
    log = lib.with_suffix(".log").read_text() if lib.with_suffix(".log").exists() else ""
    for m in re.finditer(r"attention_kernelI(\w+?)Li(\d+)ELi(\d+)ELb([01])E.*?\n.*?\n"
                         r"\s*(\d+) bytes stack frame, (\d+) bytes spill stores.*?\n"
                         r".*?Used (\d+) registers", log):
        dtype = "bf16" if "bfloat16" in m.group(1) else "f32"
        kname = "K1 uniform" if m.group(4) == "1" else "K2 flash"
        print(f"  ptxas {kname} {dtype} DP={m.group(2)} RM={m.group(3)}: "
              f"{m.group(7)} registers, {m.group(6)} bytes spilled | {tag}")

    summary = compare_kernels(tag)
    small_input_check(tag)
    launches = main_path(tag)

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": summary[name]["max_abs_err"],
         "ms": summary[name]["ms"], "plain_ms": summary[name]["plain_ms"]}
        for name in ("static_uniform_attention", "flash_attention")]}
    print("kernels: max_abs_err is the largest over the shapes above; ms / plain_ms at "
          + ", ".join(f"{n}: {summary[n]['at']}" for n in summary) + f" | {tag}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
