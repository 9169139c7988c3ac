#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`dgq_tpu_torch`) once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (any failure raises, so the exit code is non-zero):
  1. build the hand-written CUDA kernels from dgq_tpu_torch/csrc/ (nvcc, sm_90a,
     one compiler process per source);
  2. hold each kernel against its plain PyTorch version at the main paths'
     shapes, with the tolerance stated in `_check` / `_check_share` /
     `_check_conv`, and time both (and the one library call that computes the
     same function, where there is one);
  3. a small-input check: the tiny UNet on the card against the same model
     on the CPU (plain versions), fp, W8A8 g=1, the g=8 configuration and the
     static-log2 configuration;
  4. the main paths at full width, SD v1.4 (random weights from a seed), W4
     minmax fold, 2 images at 512px, DDIM with CFG 7.5 in bf16, VAE decode:
     4a the g=1 path (time-aware per-tensor A8 + uniform A8 softmax);
     4b the g=8 flagship path (time-aware group-quantized k x k convs through
        the fused kernel, log2 real_time softmax with start_peak), then one
        step with group_conv_impl="taps" for the record;
     4c one step of the static-log2 (`log_max_1`) configuration.
     The kernels' launch counts over each run are checked.
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

STEPS_G1 = 10
STEPS_G8 = 10
IMAGES = 2
ATTN_SRC = "dgq_tpu_torch/csrc/attention.cu"
CONV_SRC = "dgq_tpu_torch/csrc/group_conv.cu"
# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "static_uniform_attention": (ATTN_SRC, "dgq_tpu/ops/pallas/attention.py:256"),
    "flash_attention": (ATTN_SRC, "dgq_tpu/ops/pallas/attention.py:464"),
    "rt_stats": (ATTN_SRC, "dgq_tpu/ops/pallas/attention.py:352"),
    "quant_accum": (ATTN_SRC, "dgq_tpu/ops/pallas/attention.py:373"),
    "static_quant_attention": (ATTN_SRC, "dgq_tpu/ops/pallas/attention.py:215"),
    "group_quant_conv": (CONV_SRC, "dgq_tpu/ops/pallas/group_conv.py:74"),
}
# the card's published peaks (NVIDIA H100 SXM data sheet): bf16 tensor-core
# rate and device-memory rate, for the least time a kernel's work could take
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


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


def _bound(flops, nbytes):
    """The least time (ms) the card could take: the larger of the operations
    over the bf16 peak and the bytes (each input read once, each output
    written once) over the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


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


def _check_share(out, ref):
    """The log2 quantizers (K3b, K4): a code flips at a half-integer exponent
    and changes that probability by a factor of 2, so an error's size is not
    bounded but the share of outputs with one is: under 5e-4 may be off by
    more than 2e-3 + 2^-7 |ref| (2e-3 as the JAX package's kernel tests; the
    second term is each side's one rounding to bf16)."""
    out, ref = out.float(), ref.float()
    if out.shape != ref.shape or not bool(out.isfinite().all()):
        raise AssertionError(f"bad kernel output: shape {tuple(out.shape)}")
    err = (out - ref).abs()
    share = float((err > 2e-3 + 2.0 ** -7 * ref.abs()).float().mean())
    if share >= 5e-4:
        raise AssertionError(f"mismatch share {share} >= 5e-4 (max err {float(err.max())})")
    return float(err.max()), share


def _check_conv(out, ref):
    """K5: the codes and folded weights are the same numbers on both sides, so
    only the f32 summation order and each side's one rounding to bf16 differ:
    |err| <= 2e-3 + 2^-7 |ref|."""
    out, ref = out.float(), ref.float()
    if out.shape != ref.shape or not bool(out.isfinite().all()):
        raise AssertionError(f"bad kernel output: shape {tuple(out.shape)}")
    err = (out - ref).abs()
    bound = 2e-3 + 2.0 ** -7 * ref.abs()
    if not bool((err <= bound).all()):
        raise AssertionError(f"error exceeds the bound by {float((err - bound).max())}")
    return float(err.max())


class _Summary(dict):
    """Per kernel: the largest max_abs_err (and mismatch share) over its
    cases, and the timings of its first case, its largest main-path shape."""

    def add(self, name, label, mx, ms, plain_ms, bound, library_ms=None, share=None):
        rec = self.setdefault(name, {"max_abs_err": 0.0})
        rec["max_abs_err"] = max(rec["max_abs_err"], mx)
        if share is not None:
            rec["mismatch_share"] = max(rec.get("mismatch_share", 0.0), share)
        if "ms" not in rec:
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                       library_ms=library_ms, at=label)


def compare_attention(tag, summary):
    """Phase 2, attention: each kernel against its plain version at the main
    paths' shapes (SD 512px: CFG batch 2 x IMAGES, 8 heads; VAE: IMAGES, one
    head). Work per call: Q K^T and P V are 2*BH*T*S*D flops each (rt_stats
    does the first only); bytes are q, k, v, o once each, plus z."""
    import torch
    import torch.nn.functional as F
    from dgq_tpu_torch.ops import attention as A

    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    delta_u = torch.tensor(1.0 / 255.0, device="cuda", dtype=bf)  # the synthetic g=1 delta
    one = torch.ones((), device="cuda", dtype=bf)                 # log_max_1
    bh = 2 * IMAGES * 8
    levels = [(64, 4096, 40), (32, 1024, 80), (16, 256, 160), (8, 64, 160)]
    cases = []
    for px, t, d in levels:
        for kind, s in (("self", t), ("cross", 77)):
            cases.append(("static_uniform_attention", f"{px}px {kind}", bh, t, s, d, {}))
    cases.append(("flash_attention", "VAE mid-block", IMAGES, 4096, 4096, 512, {}))
    cases.append(("flash_attention", "64px self (fp UNet)", bh, 4096, 4096, 40, {}))
    for px, t, d in levels:  # the g=8 path: self without, cross with start_peak
        cases.append(("rt", f"{px}px self", bh, t, t, d, {"sp": False}))
        cases.append(("rt", f"{px}px cross start_peak", bh, t, 77, d, {"sp": True}))
    for kind, s in (("self", 4096), ("cross", 77)):
        for mode, sp in (("log2", False), ("log2", True), ("uniform", True)):
            label = f"64px {kind} {mode}" + (" start_peak" if sp else "")
            cases.append(("static_quant_attention", label, bh, 4096, s, 40,
                          {"mode": mode, "sp": sp}))

    for name, label, bh_, t, s, d, opt in cases:
        q = (2.0 * torch.randn(bh_, t, d, generator=g, device="cuda")).to(bf)
        k = (2.0 * torch.randn(bh_, s, d, generator=g, device="cuda")).to(bf)
        v = torch.randn(bh_, s, d, generator=g, device="cuda").to(bf)
        scale = d ** -0.5
        shape = f"(BH={bh_}, T={t}, S={s}, D={d}, bf16)"
        qk_flops = 2.0 * bh_ * t * s * d
        io_bytes = 2.0 * (2 * q.numel() + k.numel() + v.numel())
        if name == "rt":
            sp = opt["sp"]
            z, red = A.rt_stats(q, k, scale, sp)
            z_ref, red_ref = A.rt_stats_reference(q, k, scale, sp)
            torch.cuda.synchronize()
            z_err = float((z - z_ref).abs().max())
            red_rel = float(((red - red_ref) / red_ref).abs())
            # f32 sums of up to 4096 exps in another order, on numbers of size ~30
            if not (z_err <= 1e-4 and red_rel <= 1e-4):
                raise AssertionError(f"rt_stats {label}: z err {z_err}, reduction rel {red_rel}")
            ms = _median_ms(lambda: A.rt_stats(q, k, scale, sp))
            plain_ms = _median_ms(lambda: A.rt_stats_reference(q, k, scale, sp))
            bound = _bound(qk_flops, 2.0 * (q.numel() + k.numel()) + 4.0 * z.numel())
            summary.add("rt_stats", label, z_err, ms, plain_ms, bound)
            print(f"rt_stats {label} {shape}: max_abs_err(z) {z_err:.3g} reduction rel err "
                  f"{red_rel:.3g}; median ms kernel {ms:.4f} plain {plain_ms:.4f} bound "
                  f"{bound[0]:.4f} ({bound[1]}) | {tag}", flush=True)

            delta = A.rt_delta(red, sp)
            out = A.quant_accum(q, k, v, z, red, scale, 8, sp)
            ref = A.attention_reference(q, k, v, scale, "log2", 8, delta, sp)
            torch.cuda.synchronize()
            mx, share = _check_share(out, ref)
            ms = _median_ms(lambda: A.quant_accum(q, k, v, z, red, scale, 8, sp))
            plain_ms = _median_ms(
                lambda: A.attention_reference(q, k, v, scale, "log2", 8, delta, sp))
            bound = _bound(2 * qk_flops, io_bytes + 4.0 * z.numel())
            summary.add("quant_accum", label, mx, ms, plain_ms, bound, share=share)
            print(f"quant_accum {label} {shape}: max_abs_err {mx:.6g} mismatch share "
                  f"{share:.3g}; median ms kernel {ms:.4f} plain {plain_ms:.4f} bound "
                  f"{bound[0]:.4f} ({bound[1]}) | {tag}", flush=True)

            # the two launches behind the one wrapper, against the real_time plain version
            both = A.fused_attention(q, k, v, scale, sm_mode="log2_real_time", start_peak=sp)
            ref = A.attention_reference(q, k, v, scale, "log2_real_time", 8, None, sp)
            mx, share = _check_share(both, ref)
            ms = _median_ms(lambda: A.fused_attention(q, k, v, scale, sm_mode="log2_real_time",
                                                      start_peak=sp))
            print(f"log2_real_time_attention {label} {shape}: max_abs_err {mx:.6g} mismatch "
                  f"share {share:.3g}; median ms both launches {ms:.4f} | {tag}", flush=True)
            del z, red, out, ref, both
            continue

        mode = {"static_uniform_attention": "uniform", "flash_attention": "none"}.get(
            name, opt.get("mode"))
        sp = opt.get("sp", False)
        dl = {"uniform": delta_u, "log2": one, "none": None}[mode]

        def kernel():
            return A.fused_attention(q, k, v, scale, sm_mode=mode, sm_bits=8, sm_delta=dl,
                                     start_peak=sp)

        def plain():
            return A.attention_reference(q, k, v, scale, mode, 8, dl, sp)

        before = dict(A.LAUNCHES)
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        if A.LAUNCHES[name] != before[name] + 1:
            raise AssertionError(f"{label} did not launch {name}")
        share, library_ms = None, None
        if name == "static_quant_attention":
            mx, share = _check_share(out, ref)
            note = f"mismatch share {share:.3g}"
        else:
            mx, mean = _check(out, ref, v, float(delta_u) if mode == "uniform" else None)
            note = f"mean_abs_err {mean:.3g}"
        ms, plain_ms = _median_ms(kernel), _median_ms(plain)
        if name == "flash_attention":
            # the one PyTorch call that computes K2's function; timed here, used nowhere
            library_ms = _median_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
            note += f"; library (scaled_dot_product_attention) ms {library_ms:.4f}"
        bound = _bound(2 * qk_flops, io_bytes)
        summary.add(name, label, mx, ms, plain_ms, bound, library_ms, share)
        print(f"{name} {label} {shape}: max_abs_err {mx:.6g} {note}; median ms kernel {ms:.4f} "
              f"plain {plain_ms:.4f} bound {bound[0]:.4f} ({bound[1]}) | {tag}", flush=True)
        del q, k, v, out, ref
    torch.cuda.empty_cache()


def compare_group_conv(tag, summary):
    """Phase 2, K5 at the four resolutions of the g=8 path (3x3, stride 1, CFG
    batch 2 x IMAGES, bf16; synthetic scales spread around the qstate's 0.05 /
    128 so that every (tap, channel) differs). Work per call: 2*M*9*C*O flops;
    bytes are x, w, dm, zm, bias and the output once each. The wrapper's time
    includes the per-call weight pre-scale w * dm * dl, timed on its own too."""
    import torch
    from dgq_tpu_torch.ops import group_conv as G

    g = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16
    b = 2 * IMAGES
    for h, c, o in [(64, 320, 320), (32, 640, 640), (16, 1280, 1280), (8, 2560, 1280)]:
        x = (2.0 * torch.randn(b, h, h, c, generator=g, device="cuda")).to(bf)
        w = (torch.randn(3, 3, c, o, generator=g, device="cuda") / (9 * c) ** 0.5).to(bf)
        dm = 0.03 + 0.04 * torch.rand(9, c, generator=g, device="cuda")
        zm = 100.0 + 56.0 * torch.rand(9, c, generator=g, device="cuda")
        dl, zl = torch.ones(1, device="cuda"), torch.zeros(1, device="cuda")
        bias = 0.1 * torch.randn(o, generator=g, device="cuda")
        args = (x, w, dm, zm, dl, zl, bias)
        before = G.LAUNCHES["group_quant_conv"]
        out = G.group_quant_conv(*args)
        ref = G.group_quant_conv_reference(*args)
        torch.cuda.synchronize()
        if G.LAUNCHES["group_quant_conv"] != before + 1:
            raise AssertionError("group_quant_conv did not launch its kernel")
        mx = _check_conv(out, ref)
        ms = _median_ms(lambda: G.group_quant_conv(*args))
        plain_ms = _median_ms(lambda: G.group_quant_conv_reference(*args))
        fold_ms = _median_ms(lambda: G._fold(x, w, dm, zm, dl, zl, 3, 3))
        nbytes = 2.0 * (x.numel() + w.numel() + out.numel()) + 4.0 * (2 * dm.numel() + o)
        bound = _bound(2.0 * b * h * h * 9 * c * o, nbytes)
        label = f"{h}px {c}->{o}"
        summary.add("group_quant_conv", label, mx, ms, plain_ms, bound)
        print(f"group_quant_conv {label} (B={b}, H=W={h}, C={c}, O={o}, 3x3, bf16): max_abs_err "
              f"{mx:.6g}; median ms kernel+fold {ms:.4f} (weight pre-scale alone {fold_ms:.4f}) "
              f"plain {plain_ms:.4f} bound {bound[0]:.4f} ({bound[1]}) | {tag}", flush=True)
        del x, w, out, ref
    torch.cuda.empty_cache()


def _launch_counts():
    from dgq_tpu_torch.ops import attention as A, group_conv as G

    return {**A.LAUNCHES, **G.LAUNCHES}


def _reset_launch_counts():
    from dgq_tpu_torch.ops import attention as A, group_conv as G

    A.reset_launch_counts()
    G.reset_launch_counts()


def _g8_kwargs(group_layers, impl):
    """The flagship policy of the JAX bench's --group 8 run."""
    return dict(use_wq=True, use_aq=True, softmax_bits=8, t2i_log_quant=True,
                t2i_real_time=True, t2i_start_peak=True, use_pallas_attention=True,
                group_conv_layers=group_layers, group_conv_impl=impl)


def small_input_check(tag):
    """Phase 3: the tiny UNet (base 32) on the card (kernels) against the same
    weights and inputs on the CPU (plain versions), f32 with TF32 off.
    fp: atol 1e-4 (summation order). Quantized configurations: the chaos
    bound of the JAX package's tests, err <= max(5 * chaos, 1e-4), chaos = the
    CPU net's largest output change under sixteen 1e-6 input perturbations
    (the change is heavy-tailed: most draws flip no quantizer bin and move
    nothing, one in three moves the output by 0.03 to 0.06)."""
    import torch
    from dgq_tpu_torch.calib.weight_calib import quantize_model_weights
    from dgq_tpu_torch.models.qconfig import QConfig
    from dgq_tpu_torch.models.unet_sd import init_unet_sd, sd_unet_spec, unet_sd_apply
    from dgq_tpu_torch.utils.synthetic import synthetic_group_qstate, synthetic_pertensor_qstate

    saved_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = sd_unet_spec(base=32, cross=64)
    g = torch.Generator().manual_seed(1)
    params = init_unet_sd(g, "cpu", spec=spec)
    x = torch.randn(2, 16, 16, 4, generator=g)
    ehs = torch.randn(2, 77, 64, generator=g)
    t = torch.tensor([500, 500], dtype=torch.int32)
    noise = [1e-6 * torch.randn(x.shape, generator=g) for _ in range(16)]

    def cuda(tree):
        if isinstance(tree, dict):
            return {k: cuda(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return type(tree)(*(cuda(v) for v in tree))
        if hasattr(tree, "delta_mid"):
            return type(tree)(*(cuda(v) for v in (tree.delta_mid, tree.zp_mid, tree.delta_last,
                                                  tree.zp_last)))
        return None if tree is None else tree.cuda()

    kw = dict(w_bits=8, a_bits=8, softmax_bits=8, use_wq=True, use_aq=True,
              use_pallas_attention=True)
    params_q, _ = quantize_model_weights(params, spec, QConfig(**kw))
    qs_g1 = synthetic_pertensor_qstate(spec, 0, False, torch.float32, device="cpu")
    qs_g8, group_layers = synthetic_group_qstate(spec, 0, False, torch.float32, device="cpu")
    g8 = QConfig(w_bits=8, a_bits=8, **_g8_kwargs(group_layers, "fused"))
    configs = [
        ("fp", params, None, QConfig(use_pallas_attention=True), ()),
        ("W8A8 g=1", params_q, qs_g1, QConfig(**kw), ("static_uniform_attention",)),
        ("W8A8 g=8 fused", params_q, qs_g8, g8, ("rt_stats", "quant_accum", "group_quant_conv")),
        ("W8A8 g=8 static log2", params_q, qs_g8,
         g8.replace(t2i_real_time=False, log_max_1=True), ("static_quant_attention",)),
    ]
    with torch.no_grad():
        for label, p, qs, cfg, must_launch in configs:
            ref = unet_sd_apply(p, x, t, ehs, qstate=qs, cfg=cfg)
            _reset_launch_counts()
            out = unet_sd_apply(cuda(p), x.cuda(), t.cuda(), ehs.cuda(), qstate=cuda(qs),
                                cfg=cfg).cpu()
            launched = {n: c for n, c in _launch_counts().items() if c}
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
            if not launched or any(n not in launched for n in must_launch):
                raise AssertionError(f"tiny UNet {label} launched {launched}, "
                                     f"expected {must_launch}")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved_tf32


def build_model(tag):
    """SD v1.4 at full width with W4-folded bf16 weights, the VAE decoder and
    the sampler's inputs, all drawn on the card from one seed."""
    import torch
    from dgq_tpu_torch.calib.act_calib import attention_prefixes
    from dgq_tpu_torch.calib.weight_calib import quantize_model_weights
    from dgq_tpu_torch.models.qconfig import QConfig
    from dgq_tpu_torch.models.unet_sd import init_unet_sd, quantizable_layers, sd_unet_spec
    from dgq_tpu_torch.pipeline.vae import init_vae_decoder

    bf = torch.bfloat16
    spec = sd_unet_spec()
    g = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = init_unet_sd(g, "cuda", torch.float32, spec)
    n_params = sum(v.numel() for p in params.values() for v in p.values() if v is not None)
    n_quant = len(quantizable_layers(spec))
    n_attn = len(attention_prefixes(spec))
    if n_params != 859_520_964 or n_quant != 282 or n_attn != 32:
        raise AssertionError(f"SD v1.4 has {n_params} params / {n_quant} quant layers / "
                             f"{n_attn} attentions")
    params_q, _ = quantize_model_weights(params, spec, QConfig(w_bits=4, use_wq=True))
    del params
    params_q = {n: {k: None if v is None else v.to(bf) for k, v in p.items()}
                for n, p in params_q.items()}
    model = {
        "spec": spec, "params": params_q, "vae": init_vae_decoder(g, "cuda", dtype=bf),
        "latents": torch.randn(IMAGES, 64, 64, 4, generator=g, device="cuda").to(bf),
        "ehs_t": torch.randn(IMAGES, 77, 768, generator=g, device="cuda").to(bf),
        "ehs_u": torch.randn(IMAGES, 77, 768, generator=g, device="cuda").to(bf),
    }
    torch.cuda.synchronize()
    print(f"SD v1.4: {n_params / 1e6:.2f}M params, {n_quant} quant layers, {n_attn} "
          f"attentions; init + W4 fold {time.perf_counter() - t0:.2f} s | {tag}", flush=True)
    return model


def sample_and_decode(model, qstate, cfg, steps):
    """One run of the path: sd_sample then vae_decode. Returns the latents,
    the images and the host times (start, after sampling, end), each taken
    after a synchronise."""
    import torch
    from dgq_tpu_torch.pipeline.sampler import sd_sample
    from dgq_tpu_torch.pipeline.vae import vae_decode

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat = sd_sample(model["params"], model["latents"], model["ehs_t"], model["ehs_u"],
                    num_inference_steps=steps, guidance_scale=7.5, qstate=qstate, cfg=cfg,
                    time_aware=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    images = vae_decode(model["vae"], lat)
    torch.cuda.synchronize()
    return lat, images, (t0, t1, time.perf_counter())


def drive_path(model, label, qstate, cfg, steps, expect, tag):
    """Warm up, set every launch count to 0, drive the path once, read the
    counts, and check them (`expect`: name -> exact count, or None for at
    least one) and the images."""
    import torch

    sample_and_decode(model, qstate, cfg, 1)  # warm-up (allocator, library handles)
    _reset_launch_counts()
    lat, images, (t0, t1, t2) = sample_and_decode(model, qstate, cfg, steps)
    launches = _launch_counts()
    for name, want in expect.items():
        got = launches[name]
        if (want is None and got < 1) or (want is not None and got != want):
            raise AssertionError(f"{label}: {name} ran {got} times, expected "
                                 f"{'at least once' if want is None else want}")
    if tuple(images.shape) != (IMAGES, 512, 512, 3) or not bool(images.isfinite().all()):
        raise AssertionError(f"{label}: bad images {tuple(images.shape)}")
    if not bool(lat.isfinite().all()) or float(images.float().std()) == 0.0:
        raise AssertionError(f"{label}: degenerate output")
    shown = {n: c for n, c in launches.items() if c}
    print(f"{label}: {IMAGES} images 512px, {steps} DDIM steps CFG 7.5 bf16: sampling "
          f"{t1 - t0:.4f} s ({(t1 - t0) / steps:.4f} s per step = one UNet forward at batch "
          f"{2 * IMAGES}), VAE decode {t2 - t1:.4f} s, {(t2 - t0) / IMAGES:.4f} s per image; "
          f"launches {shown} | {tag}", flush=True)
    return launches


def main_paths(tag):
    """Phase 4: the g=1 path, the g=8 flagship path and the short static-log2
    configuration, at full width on one model. Returns each kernel's launch
    count from the main-path run that drives it."""
    import torch
    from dgq_tpu_torch.calib.act_calib import softmax_qpoint_names
    from dgq_tpu_torch.models.qconfig import QConfig
    from dgq_tpu_torch.utils.synthetic import synthetic_group_qstate, synthetic_pertensor_qstate

    bf = torch.bfloat16
    model = build_model(tag)
    spec = model["spec"]
    n_attn = 32

    # 4a: g=1
    cfg = QConfig(w_bits=4, a_bits=8, softmax_bits=8, use_wq=True, use_aq=True,
                  use_pallas_attention=True)
    qstate = synthetic_pertensor_qstate(spec, STEPS_G1, True, bf)
    if not all(n in qstate["a"] for n in softmax_qpoint_names(spec)):
        raise AssertionError("every attention needs a uniform A8 aqtizer_w")
    g1 = drive_path(model, "g=1 path", qstate, cfg, STEPS_G1,
                    {"static_uniform_attention": n_attn * STEPS_G1, "flash_attention": None,
                     "rt_stats": 0, "quant_accum": 0, "static_quant_attention": 0,
                     "group_quant_conv": 0}, tag)

    # 4b: g=8 flagship, the fused group conv
    qstate, group_layers = synthetic_group_qstate(spec, STEPS_G8, True, bf)
    stride = {n: m[3] for n, k, m in spec if k == "conv"}
    n_fused = sum(stride[n] == 1 for n in group_layers)
    n_taps = len(group_layers) - n_fused
    print(f"g=8 path: {len(group_layers)} group convs per forward; group_conv_impl='fused' "
          f"sends {n_fused} (stride 1) to the kernel and {n_taps} (stride 2) to the taps path "
          f"| {tag}", flush=True)
    cfg = QConfig(w_bits=4, a_bits=8, **_g8_kwargs(group_layers, "fused"))
    g8 = drive_path(model, "g=8 path (fused group conv)", qstate, cfg, STEPS_G8,
                    {"rt_stats": n_attn * STEPS_G8, "quant_accum": n_attn * STEPS_G8,
                     "group_quant_conv": n_fused * STEPS_G8, "static_uniform_attention": 0,
                     "static_quant_attention": 0, "flash_attention": None}, tag)
    # for the record: the same step through the taps path (library matmuls)
    drive_path(model, "g=8 path (taps, for the record)", qstate,
               cfg.replace(group_conv_impl="taps"), 1,
               {"rt_stats": n_attn, "quant_accum": n_attn, "group_quant_conv": 0}, tag)

    # 4c: the static log2 configuration (delta pinned to 1, no calibrated state)
    k4 = drive_path(model, "static log2 path (log_max_1)", qstate,
                    cfg.replace(t2i_real_time=False, log_max_1=True), 1,
                    {"static_quant_attention": n_attn, "rt_stats": 0, "quant_accum": 0,
                     "static_uniform_attention": 0, "group_quant_conv": n_fused}, tag)
    return {"static_uniform_attention": g1["static_uniform_attention"],
            "flash_attention": g8["flash_attention"], "rt_stats": g8["rt_stats"],
            "quant_accum": g8["quant_accum"], "group_quant_conv": g8["group_quant_conv"],
            "static_quant_attention": k4["static_quant_attention"]}


def print_build_report(paths, tag):
    """Registers and spills of every kernel instance, from `-Xptxas -v`."""
    modes = {"0": "K2 flash", "1": "K1 uniform", "2": "K3b rt_stats", "3": "K3b quant_accum",
             "4": "K4 static_quant"}
    for path in paths.values():
        log = path.with_suffix(".log").read_text() if path.with_suffix(".log").exists() else ""
        for m in re.finditer(r"Compiling entry function '(\w+)'.*?\n.*?\n\s*(\d+) bytes stack "
                             r"frame, (\d+) bytes spill stores.*?\n.*?Used (\d+) registers", log):
            sym = m.group(1)
            dtype = "bf16" if "bfloat16" in sym else "f32"
            a = re.search(r"attention_kernelI\w+?Li(\d+)ELi(\d+)ELi(\d)E", sym)
            kname = (f"{modes[a.group(3)]} DP={a.group(1)} RM={a.group(2)}" if a
                     else "K5 group_conv")
            print(f"  ptxas {kname} {dtype}: {m.group(4)} registers, {m.group(3)} bytes "
                  f"spilled | {tag}")


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
    paths = build.build_kernels()
    build.load_kernels()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(p.name for p in paths.values())}) | {tag}", flush=True)
    print_build_report(paths, tag)

    summary = _Summary()
    compare_attention(tag, summary)
    compare_group_conv(tag, summary)
    small_input_check(tag)
    launches = main_paths(tag)

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], **{k: v for k, v in summary[name].items() if k != "at"}}
        for name, (source, replaces) in KERNELS.items()]}
    print("kernels: max_abs_err (and mismatch_share) are the largest over the shapes above; "
          "ms, plain_ms, bound_ms, library_ms at "
          + ", ".join(f"{n}: {summary[n]['at']}" for n in KERNELS) + f" | {tag}")
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
