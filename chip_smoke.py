#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`dgq_tpu_torch`) once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (any failure raises, so the exit code is non-zero):
  1. build the hand-written CUDA kernels from dgq_tpu_torch/csrc/ (nvcc, sm_90a,
     one compiler process per source);
  2. hold each kernel against its plain PyTorch version at the main paths'
     shapes, with the tolerance stated in `_check` / `_check_flash` /
     `_check_share` / `_check_conv` / `compare_int8`, and time both (and the
     one library call that computes the same function, where there is one),
     the host time of the flash, group-conv and int8 matmul wrappers, and for
     the flash, group-conv, int8 matmul and bf16 quantizing attention kernels
     (K1, rt_stats, quant_accum, K4 and their packed entries), whose calls can
     be as short as their wrapper's host time, the device-only time as well
     (`_device_ms`); K6's lines name the split plan and load form it ran.
     Each bf16 attention line names the kernel form it ran (`flash_form`,
     `quant_form`), and each tensor-core kernel's element-load form is held
     bit for bit against its 16-byte-copy form at one shape. The packed
     head-slot attention entries are also held bit for bit against their
     unpacked kernels, over output memory that holds NaN;
  3. a small-input check: the tiny UNets on the card against the same models
     on the CPU (plain versions): SD fp, W8A8 g=1, g=1 with the int8 path,
     the g=8 configuration and the static-log2 configuration; SDXL fp and
     the SDXL-turbo policy with the int8 path; and with packed attention
     (`pack_attention_heads` + `QConfig(packed_attention=True)`) SD fp at slot
     64 and 128, g=1, g=8 and static log2, SDXL fp and real-time log2;
  4. the main paths at full width (random weights from a seed, W4 minmax
     fold, 2 images, bf16, VAE decode). SD v1.4 at 512px, DDIM with CFG 7.5,
     each of 4a to 4c first unpacked, then with packed attention:
     4a the g=1 path (time-aware per-tensor A8 + uniform A8 softmax);
     4b the g=8 flagship path (time-aware group-quantized k x k convs through
        the fused kernel, log2 real_time softmax with start_peak), and one
        unpacked step with group_conv_impl="taps" for the record;
     4c one step of the static-log2 (`log_max_1`) configuration, and one
        unquantized (fp) step;
     4d the g=1 path with the int8 deploy path on (`use_int8_matmul`): every
        linear and 1x1 conv through the int8 matmul kernel.
     SDXL-turbo at 1024px, 4 Euler steps, guidance 0, decoded at 1024px:
     4e W4A8 with log2 real_time softmax, start_peak and the int8 deploy path;
     4f the same with the int8 path off, unpacked and then with packed
        attention (the JAX bench's `--model sdxl` default).
     The kernels' launch counts over each run are checked.
The last two lines are the kernels' JSON record and the result line
{"ok": true, "device": {...}}. The first line is the card's name and power
limit as nvidia-smi gives them; every number printed after it was measured
in this run on that card, and its line says so (`| card: ...`). Each phase
prints the seconds it took.
"""
import json
import re
import statistics
import subprocess
import threading
import time

STEPS_G1 = 10
STEPS_G8 = 4
STEPS_INT8 = 4
STEPS_SDXL = 4
IMAGES = 2
ATTN_SRC = "dgq_tpu_torch/csrc/attention.cu"
CONV_SRC = "dgq_tpu_torch/csrc/group_conv.cu"
INT8_SRC = "dgq_tpu_torch/csrc/int8_matmul.cu"
# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "static_uniform_attention": (ATTN_SRC, "dgq_tpu/ops/pallas/attention.py:256"),
    "flash_attention": (ATTN_SRC, "dgq_tpu/ops/pallas/attention.py:464"),
    "rt_stats": (ATTN_SRC, "dgq_tpu/ops/pallas/attention.py:352"),
    "quant_accum": (ATTN_SRC, "dgq_tpu/ops/pallas/attention.py:373"),
    "static_quant_attention": (ATTN_SRC, "dgq_tpu/ops/pallas/attention.py:215"),
    "group_quant_conv": (CONV_SRC, "dgq_tpu/ops/pallas/group_conv.py:74"),
    "int8_matmul": (INT8_SRC, "dgq_tpu/ops/pallas/int8_matmul.py:36"),
    # the packed head-slot entries: the pallas_calls of _fused_attention_packed
    "static_uniform_attention_packed": (ATTN_SRC, "dgq_tpu/ops/pallas/attention.py:899"),
    "flash_attention_packed": (ATTN_SRC, "dgq_tpu/ops/pallas/attention.py:877"),
    "rt_stats_packed": (ATTN_SRC, "dgq_tpu/ops/pallas/attention.py:945"),
    "quant_accum_packed": (ATTN_SRC, "dgq_tpu/ops/pallas/attention.py:945"),
    "static_quant_attention_packed": (ATTN_SRC, "dgq_tpu/ops/pallas/attention.py:916"),
}
CLASSIC_ATTENTION = ("static_uniform_attention", "rt_stats", "quant_accum",
                     "static_quant_attention")
# the card's published peaks (NVIDIA H100 SXM data sheet): bf16 and int8
# tensor-core rates and device-memory rate, for the least time a kernel's work
# could take
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
# the special-function unit: 16 exponentials a clock on each of 132 SMs at the
# 1.98 GHz boost clock (H100 SXM), the floor of the kernels that take one
# exponential per score (K1 two passes, rt_stats one)
PEAK_EXP_PER_S = 16 * 132 * 1.98e9


def _median_ms(fn, reps=10, warmup=2):
    """Median milliseconds of one call between two CUDA events. A call that
    takes under 2 ms is queued several times back to back between the events,
    so that a wrapper's host time hides under the device time of the call
    before it: the reading is the larger of one call's device time and its
    host time, not their sum."""
    import torch

    def timed(batch):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / batch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    single = timed(1)
    batch = 1 if single >= 2.0 else max(2, min(16, int(4.0 / max(single, 0.05))))
    return statistics.median(timed(batch) for _ in range(reps))


def _device_ms(fn, calls=16, reps=5):
    """Median milliseconds the card works on one call, the host's share left
    out: a spin kernel holds the stream while the host queues `calls` calls
    behind it, so the events around them see the kernels run back to back. A
    reading whose queueing outlasted the spin is taken again with a longer one."""
    import torch

    fn()
    spin, readings = 40_000_000, []  # cycles: 20 to 30 ms at the card's clocks
    while len(readings) < reps:
        s0, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        torch.cuda.synchronize()
        s0.record()
        torch.cuda._sleep(spin)
        t0 = time.perf_counter()
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        queued_ms = 1e3 * (time.perf_counter() - t0)
        b.synchronize()
        if queued_ms < 0.8 * s0.elapsed_time(a):
            readings.append(a.elapsed_time(b) / calls)
        elif spin > 2_000_000_000:
            raise AssertionError(f"the host took {queued_ms:.1f} ms to queue {calls} calls")
        else:
            spin *= 2
    return statistics.median(readings)


def _host_us(fn, reps=50):
    """Host microseconds one call takes to return (the device is not waited
    for until all `reps` calls are queued)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / reps


def _bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    """The least time (ms) the card could take: the larger of the operations
    over the peak rate for their type (bf16 unless given) and the bytes (each
    input read once, each output written once) over the memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _exp_floor(n):
    """The least time (ms) the exponent unit needs for n exponentials."""
    return 1e3 * n / PEAK_EXP_PER_S


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


def _flash_f32(q, k, v, scale):
    """The plain flash result in f32, unrounded, and P |V| (P the plain softmax),
    which scales the absolute part of `_check_flash`'s bound."""
    import torch

    p = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale, dim=-1)
    return torch.matmul(p, v.float()), torch.matmul(p, v.float().abs())


def _check_flash(out, ref32, pav):
    """The bf16 flash kernel (K2, K2p) against the f32 plain result. Q K^T of
    bf16 inputs is exact per product on the tensor cores, but P is rounded to
    bf16 before P V (as the library's kernel does), so each product p v carries
    a relative error of at most 2^-9 and the sum an absolute error that does not
    shrink where the output cancels; the output is rounded to bf16 once more:
    |err| <= 2^-7 |ref| + 2^-8 (P |V|). The mean lies far below it."""
    out = out.float()
    if out.shape != ref32.shape or not bool(out.isfinite().all()):
        raise AssertionError(f"bad kernel output: shape {tuple(out.shape)}, finite "
                             f"{bool(out.isfinite().all())}")
    err = (out - ref32).abs()
    bound = 2.0 ** -7 * ref32.abs() + 2.0 ** -8 * pav
    if not bool((err <= bound).all()):
        raise AssertionError(f"error exceeds the bound by {float((err - bound).max())}")
    return float(err.max()), float(err.mean())


def _check_f32(out, ref, v, delta=None):
    """`_check` for f32 tensors: 1e-4 (f32 reassociation of the online against
    the materialized softmax) in place of the bf16 rounding term."""
    if out.shape != ref.shape or not bool(out.isfinite().all()):
        raise AssertionError(f"bad kernel output: shape {tuple(out.shape)}")
    err = (out - ref).abs()
    vmax = float(v.abs().max())
    bound = 1e-4 + (2.0 * delta * vmax if delta is not None else 0.0)
    if delta is not None and float(err.mean()) > 2.0 ** -8 * float(ref.abs().mean()) + 0.01 * delta * vmax:
        raise AssertionError(f"mean error {float(err.mean())} too large")
    if float(err.max()) > bound:
        raise AssertionError(f"error {float(err.max())} exceeds the bound {bound}")
    return float(err.max()), float(err.mean())


def _check_share(out, ref, bf16=True):
    """The log2 quantizers (K3b, K4): a code flips at a half-integer exponent
    and changes that probability by a factor of 2, so an error's size is not
    bounded but the share of outputs with one is: under 5e-4 may be off by
    more than 2e-3 + 2^-7 |ref| (2e-3 as the JAX package's kernel tests; the
    second term is each side's one rounding to bf16 and is left out for f32
    tensors)."""
    out, ref = out.float(), ref.float()
    if out.shape != ref.shape or not bool(out.isfinite().all()):
        raise AssertionError(f"bad kernel output: shape {tuple(out.shape)}")
    err = (out - ref).abs()
    share = float((err > 2e-3 + (2.0 ** -7 * ref.abs() if bf16 else 0.0)).float().mean())
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


def _misaligned(x):
    """A copy of x one element off a 16-byte boundary: the tensor-core kernels
    read it with element loads."""
    import torch

    return torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)[1:].view_as(x).copy_(x)


class _Summary(dict):
    """Per kernel: the largest max_abs_err (and mismatch share) over its
    cases, and the timings of its first case, its largest main-path shape.
    `device_ms` (`_device_ms`) is taken for the kernels whose `ms` at some
    shape is as short as their wrapper's host time (every kernel here)."""

    def add(self, name, label, mx, ms, plain_ms, bound, library_ms=None, share=None,
            device_ms=None):
        rec = self.setdefault(name, {"max_abs_err": 0.0})
        rec["max_abs_err"] = max(rec["max_abs_err"], mx)
        if share is not None:
            rec["mismatch_share"] = max(rec.get("mismatch_share", 0.0), share)
        if "ms" not in rec:
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                       library_ms=library_ms, device_ms=device_ms, at=label)


def compare_attention(tag, summary):
    """Phase 2, attention: each kernel against its plain version at the main
    paths' shapes (SD 512px: CFG batch 2 x IMAGES, 8 heads, head dims 40 to
    160; SDXL 1024px: batch IMAGES, 10 or 20 heads of 64; VAE: one head of
    512, at 512px and 1024px). Work per call: Q K^T and P V are 2*BH*T*S*D flops each (rt_stats
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
    # SDXL at 1024px: head dim 64 everywhere, 10 heads at 64px and 20 at 32px
    for px, t, heads in [(64, 4096, 10), (32, 1024, 20)]:
        xbh = IMAGES * heads
        cases.append(("static_uniform_attention", f"SDXL {px}px self", xbh, t, t, 64, {}))
        cases.append(("static_uniform_attention", f"SDXL {px}px cross", xbh, t, 77, 64, {}))
        cases.append(("rt", f"SDXL {px}px self", xbh, t, t, 64, {"sp": False}))
        cases.append(("rt", f"SDXL {px}px cross start_peak", xbh, t, 77, 64, {"sp": True}))
        for mode, sp in (("log2", False), ("log2", True), ("uniform", True)):
            cases.append(("static_quant_attention",
                          f"SDXL {px}px self {mode}" + (" start_peak" if sp else ""), xbh, t, t,
                          64, {"mode": mode, "sp": sp}))
        cases.append(("static_quant_attention", f"SDXL {px}px cross log2 start_peak", xbh, t, 77,
                      64, {"mode": "log2", "sp": True}))
    cases.append(("flash_attention", "VAE mid-block at 1024px", 1, 16384, 16384, 512, {}))

    first_of = {}  # kernel -> the label of its first case, where the load forms are compared
    for name, label, bh_, t, s, d, opt in cases:
        # scores of spread 4 at every head dim but the VAE's 1024px shape, where
        # 16384 keys at that spread would collapse the softmax onto one key
        amp = 0.5 if t == 16384 else 2.0
        q = (amp * torch.randn(bh_, t, d, generator=g, device="cuda")).to(bf)
        k = (amp * torch.randn(bh_, s, d, generator=g, device="cuda")).to(bf)
        v = torch.randn(bh_, s, d, generator=g, device="cuda").to(bf)
        scale = d ** -0.5
        shape = f"(BH={bh_}, T={t}, S={s}, D={d}, bf16)"
        qk_flops = 2.0 * bh_ * t * s * d
        io_bytes = 2.0 * (2 * q.numel() + k.numel() + v.numel())
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
        form = A.quant_form(bf, d, ptrs, (t * d, d, s * d, d, s * d, d))
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
            odd_note = ""
            if first_of.setdefault("rt", label) == label:
                # misaligned q: the element-load form, same z, scalar and output
                odd = _misaligned(q)
                zo, redo = A.rt_stats(odd, k, scale, sp)
                if not (torch.equal(zo, z) and torch.equal(redo, red)):
                    raise AssertionError(f"rt_stats {label}: the element-load form differs")
                odd_note = "; misaligned q (element loads) equal bit for bit"
                del odd, zo, redo
            ms = _median_ms(lambda: A.rt_stats(q, k, scale, sp))
            dev = _device_ms(lambda: A.rt_stats(q, k, scale, sp))
            plain_ms = _median_ms(lambda: A.rt_stats_reference(q, k, scale, sp))
            bound = _bound(qk_flops, 2.0 * (q.numel() + k.numel()) + 4.0 * z.numel())
            summary.add("rt_stats", label, z_err, ms, plain_ms, bound, device_ms=dev)
            print(f"rt_stats {label} {shape}, form {form}: max_abs_err(z) {z_err:.3g} reduction "
                  f"rel err {red_rel:.3g}{odd_note}; median ms kernel {ms:.4f} device-only "
                  f"{dev:.4f} ({dev / bound[0]:.2f}x its bound) plain {plain_ms:.4f} bound "
                  f"{bound[0]:.4f} ({bound[1]}), exponent-unit floor "
                  f"{_exp_floor(bh_ * t * s):.4f} | {tag}", flush=True)

            delta = A.rt_delta(red, sp)
            out = A.quant_accum(q, k, v, z, red, scale, 8, sp)
            ref = A.attention_reference(q, k, v, scale, "log2", 8, delta, sp)
            torch.cuda.synchronize()
            mx, share = _check_share(out, ref)
            if odd_note:
                odd = _misaligned(v)
                if not torch.equal(A.quant_accum(q, k, odd, z, red, scale, 8, sp), out):
                    raise AssertionError(f"quant_accum {label}: the element-load form differs")
                del odd
                odd_note = "; misaligned v (element loads) equal bit for bit"
            ms = _median_ms(lambda: A.quant_accum(q, k, v, z, red, scale, 8, sp))
            dev = _device_ms(lambda: A.quant_accum(q, k, v, z, red, scale, 8, sp))
            plain_ms = _median_ms(
                lambda: A.attention_reference(q, k, v, scale, "log2", 8, delta, sp))
            bound = _bound(2 * qk_flops, io_bytes + 4.0 * z.numel())
            summary.add("quant_accum", label, mx, ms, plain_ms, bound, share=share,
                        device_ms=dev)
            print(f"quant_accum {label} {shape}, form {form}: max_abs_err {mx:.6g} mismatch "
                  f"share {share:.3g}{odd_note}; median ms kernel {ms:.4f} device-only "
                  f"{dev:.4f} ({dev / bound[0]:.2f}x its bound) plain {plain_ms:.4f} bound "
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
            note = f"mismatch share {share:.3g}; form {form}"
            if first_of.setdefault((name, mode, sp), label) == label:
                # the element-load form of each quantizer, on a misaligned q
                odd = _misaligned(q)
                got = A.fused_attention(odd, k, v, scale, sm_mode=mode, sm_delta=dl,
                                        start_peak=sp)
                if form != "wgmma_async" or not torch.equal(got, out):
                    raise AssertionError(f"{name} {label}: the element-load form differs")
                note += "; misaligned q (element loads) equal bit for bit"
                del odd, got
        elif name == "flash_attention":
            # the kernel and the one PyTorch call that computes K2's function
            # (timed here, used nowhere), each against the f32 plain result
            ref32, pav = _flash_f32(q, k, v, scale)
            mx, mean = _check_flash(out, ref32, pav)
            lib = F.scaled_dot_product_attention(q, k, v, scale=scale)
            lib_err = (lib.float() - ref32).abs()
            note = (f"mean_abs_err {mean:.3g} (vs the f32 plain result, bound 2^-7|ref| + "
                    f"2^-8 P|V|; scaled_dot_product_attention vs the same: max "
                    f"{float(lib_err.max()):.6g} mean {float(lib_err.mean()):.3g})")
            # a contiguous view that starts one element off a 16-byte boundary
            # takes the element-load form of the kernel: same bits
            odd = _misaligned(q)
            forms = (A.flash_form(bf, d, (q.data_ptr(), k.data_ptr(), v.data_ptr()), (d,)),
                     A.flash_form(bf, d, (odd.data_ptr(), k.data_ptr(), v.data_ptr()), (d,)))
            if forms != ("wgmma_async", "wgmma_plain"):
                raise AssertionError(f"{label}: kernel forms {forms}")
            if not torch.equal(A.fused_attention(odd, k, v, scale), out):
                raise AssertionError(f"{label}: the element-load form differs from the "
                                     f"asynchronous-copy form")
            if A.LAUNCHES[name] != before[name] + 2:
                raise AssertionError(f"{label}: the misaligned view did not launch {name}")
            odd_ms = _median_ms(lambda: A.fused_attention(odd, k, v, scale))
            note += f"; misaligned q (element loads) equal bit for bit, ms {odd_ms:.4f}"
            del ref32, pav, lib, lib_err, odd
        else:
            mx, mean = _check(out, ref, v, float(delta_u) if mode == "uniform" else None)
            note = f"mean_abs_err {mean:.3g}"
            if name == "static_uniform_attention":
                note += f"; form {form}"
                if first_of.setdefault(name, label) == label:
                    odd = _misaligned(k)
                    got = A.fused_attention(q, odd, v, scale, sm_mode=mode, sm_delta=dl)
                    if form != "wgmma_async" or not torch.equal(got, out):
                        raise AssertionError(f"{name} {label}: the element-load form differs")
                    note += "; misaligned k (element loads) equal bit for bit"
                    del odd, got
                    # what skipping pass 2's exponentials for a warp's fragment
                    # (16 rows x 64 keys) whose codes are all 0 could save
                    codes = torch.round(torch.softmax(torch.matmul(
                        q.float(), k.float().transpose(-1, -2)) * scale, -1) / float(dl))
                    zero = codes.reshape(bh_, t // 16, 16, s // 64, 64).amax(dim=(2, 4)) == 0
                    note += (f"; share of 16 x 64 fragments whose codes are all 0 "
                             f"{float(zero.float().mean()):.3g}")
                    del codes, zero
        ms, plain_ms = _median_ms(kernel), _median_ms(plain)
        bound = _bound(2 * qk_flops, io_bytes)
        device_ms = None
        if name in ("static_uniform_attention", "static_quant_attention"):
            device_ms = _device_ms(kernel)
            note += (f"; device-only ms {device_ms:.4f} ({device_ms / bound[0]:.2f}x its bound; "
                     f"exponent-unit floor {_exp_floor(2 * bh_ * t * s):.4f})")
        if name == "flash_attention":
            library_ms = _median_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
            device_ms = _device_ms(kernel)
            lib_dev = _device_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
            note += (f"; library (scaled_dot_product_attention) ms {library_ms:.4f}; device-only "
                     f"ms kernel {device_ms:.4f} ({device_ms / bound[0]:.2f}x its bound) library "
                     f"{lib_dev:.4f}")
        summary.add(name, label, mx, ms, plain_ms, bound, library_ms, share, device_ms)
        print(f"{name} {label} {shape}: max_abs_err {mx:.6g} {note}; median ms kernel {ms:.4f} "
              f"plain {plain_ms:.4f} bound {bound[0]:.4f} ({bound[1]}) | {tag}", flush=True)
        del q, k, v, out, ref
    torch.cuda.empty_cache()


def compare_attention_packed(tag, summary):
    """Phase 2, the packed head-slot entries (K1p to K4p) at the main paths'
    shapes: SD 512px (CFG batch 2 x IMAGES, 8 heads; head dim 40 in a slot of
    64 at 64px, 80 in 128 at 32px, 160 in 256 at 16px) and SDXL 1024px (batch
    IMAGES, 10 or 20 heads of 64, slot 64), self and cross (S = 77, with
    start_peak where the mode has it), f32 and bf16. Each output is written
    over memory that holds NaN and must equal the unpacked kernel's bit for
    bit, with zeros in the padding lanes, and agree with the plain version
    within the unpacked kernel's tolerance. Timed in bf16: the packed entry,
    its plain version, the unpacked route as `models.layers.attention` walks
    it (three permute copies in, the kernel, one permute copy out), and for
    K2p `scaled_dot_product_attention` on the same strided views. Work per
    call: as the unpacked kernel's on the true head dim; bytes are the true
    lanes of q, k, v once and the whole slots of the output once."""
    import torch
    import torch.nn.functional as F
    from dgq_tpu_torch.ops import attention as A

    g = torch.Generator(device="cuda").manual_seed(3)
    bf = torch.bfloat16
    sd_b, sd_h = 2 * IMAGES, 8
    sd = [(64, 4096, 40, 64), (32, 1024, 80, 128), (16, 256, 160, 256)]
    xl = [(64, 4096, 10), (32, 1024, 20)]
    cases = []  # name, label, b, h, t, s, d, dp, mode, start_peak
    for px, t, d, dp in sd:
        for kind, s in (("self", t), ("cross", 77)):
            cases.append(("static_uniform_attention_packed", f"{px}px {kind}", sd_b, sd_h, t, s,
                          d, dp, "uniform", False))
    for px, t, d, dp in sd:
        cases.append(("flash_attention_packed", f"{px}px self (fp UNet)", sd_b, sd_h, t, t, d, dp,
                      "none", False))
    cases.append(("flash_attention_packed", "64px cross (fp UNet)", sd_b, sd_h, 4096, 77, 40, 64,
                  "none", False))
    for px, t, d, dp in sd:
        cases.append(("rt", f"{px}px self", sd_b, sd_h, t, t, d, dp, "log2_real_time", False))
        cases.append(("rt", f"{px}px cross start_peak", sd_b, sd_h, t, 77, d, dp,
                      "log2_real_time", True))
    for kind, s in (("self", 4096), ("cross", 77)):
        for mode, sp in (("log2", False), ("log2", True), ("uniform", True)):
            cases.append(("static_quant_attention_packed",
                          f"64px {kind} {mode}" + (" start_peak" if sp else ""), sd_b, sd_h, 4096,
                          s, 40, 64, mode, sp))
    for px, t, heads in xl:
        cases.append(("rt", f"SDXL {px}px self", IMAGES, heads, t, t, 64, 64, "log2_real_time",
                      False))
        cases.append(("rt", f"SDXL {px}px cross start_peak", IMAGES, heads, t, 77, 64, 64,
                      "log2_real_time", True))
        cases.append(("flash_attention_packed", f"SDXL {px}px self", IMAGES, heads, t, t, 64, 64,
                      "none", False))
        for mode, sp in (("log2", False), ("log2", True), ("uniform", True)):
            cases.append(("static_quant_attention_packed",
                          f"SDXL {px}px self {mode}" + (" start_peak" if sp else ""), IMAGES,
                          heads, t, t, 64, 64, mode, sp))
        cases.append(("static_quant_attention_packed", f"SDXL {px}px cross log2 start_peak",
                      IMAGES, heads, t, 77, 64, 64, "log2", True))
        cases.append(("static_uniform_attention_packed", f"SDXL {px}px self", IMAGES, heads, t, t,
                      64, 64, "uniform", False))

    first_of = {}  # kernel -> the label of its first case, where the load forms are compared
    for name, label, b, h, t, s, d, dp, mode, sp in cases:
        scale = d ** -0.5
        shape = f"(B={b}, H={h}, T={t}, S={s}, d={d} in slots of {dp})"
        worst = {}
        for dtype in (torch.float32, bf):
            q = (2.0 * torch.randn(b * h, t, d, generator=g, device="cuda")).to(dtype)
            k = (2.0 * torch.randn(b * h, s, d, generator=g, device="cuda")).to(dtype)
            v = torch.randn(b * h, s, d, generator=g, device="cuda").to(dtype)
            qp, kp, vp = (A.repack_heads(x, h, dp) for x in (q, k, v))
            dl = {"uniform": torch.tensor(1.0 / 255.0, device="cuda", dtype=dtype),
                  "log2": torch.ones((), device="cuda", dtype=dtype)}.get(mode)
            kw = dict(sm_mode=mode, sm_bits=8, sm_delta=dl, start_peak=sp)
            before = dict(A.LAUNCHES)
            buf = torch.full((b, t, h * dp), float("nan"), device="cuda", dtype=dtype)
            out = A.fused_attention(qp, kp, vp, scale, num_heads=h, head_dim=d, out=buf, **kw)
            unpacked = A.fused_attention(q, k, v, scale, **kw)
            ref = A.packed_attention_reference(qp, kp, vp, scale, h, d, mode, 8, dl, sp)
            torch.cuda.synchronize()
            mine = ("rt_stats_packed", "quant_accum_packed") if name == "rt" else (name,)
            if any(A.LAUNCHES[n] != before[n] + 1 for n in mine):
                raise AssertionError(f"{label} did not launch {mine}")
            if not bool((out.reshape(b, t, h, dp)[..., d:] == 0).all()):
                raise AssertionError(f"{name} {label} {dtype}: padding lanes are not zeros")
            vs_unpacked = float((A.unpack_heads(out, h, d).float() - unpacked.float()).abs().max())
            if vs_unpacked != 0.0 or not torch.equal(A.unpack_heads(out, h, d), unpacked):
                raise AssertionError(f"{name} {label} {dtype}: differs from the unpacked kernel "
                                     f"by {vs_unpacked}")
            if mode == "none" and dtype == bf:
                ref32, pav = _flash_f32(q, k, v, scale)
                mx, _ = _check_flash(A.unpack_heads(out, h, d), ref32, pav)
                share = None
                # a view one element off any 16-byte boundary: the element-load
                # form of the kernel, counted under the same name, same bits
                odd = _misaligned(qp)
                if A.flash_form(bf, d, (odd.data_ptr(),), (h * dp,), dp) != "wgmma_plain":
                    raise AssertionError(f"{label}: a misaligned view chose the 16-byte copies")
                got = A.fused_attention(odd, kp, vp, scale, num_heads=h, head_dim=d, **kw)
                if not torch.equal(got, out) or A.LAUNCHES[name] != before[name] + 2:
                    raise AssertionError(f"{name} {label}: the element-load form differs")
                del ref32, pav, odd, got
            elif mode == "none" or (mode == "uniform" and not sp):
                tol = _check if dtype == bf else _check_f32
                mx, _ = tol(out, ref, v, float(dl) if mode == "uniform" else None)
                share = None
            else:
                mx, share = _check_share(out, ref, bf16=dtype == bf)
            worst[dtype] = (mx, share)
            if name == "rt":  # the first launch on its own: same z and scalar as unpacked
                z, red = A.rt_stats_packed(qp, kp, scale, h, d, sp)
                z0, red0 = A.rt_stats(q, k, scale, sp)
                z_ref, red_ref = A.rt_stats_reference(q, k, scale, sp)
                z_err = float((z - z_ref).abs().max())
                if not (torch.equal(z, z0) and torch.equal(red, red0) and z_err <= 1e-4
                        and float(((red - red_ref) / red_ref).abs()) <= 1e-4):
                    raise AssertionError(f"rt_stats_packed {label} {dtype}: z err {z_err}")
                worst[dtype] += (z_err,)
        # timing, bf16 (the last dtype of the loop)
        qk_flops = 2.0 * b * h * t * s * d
        valid = 2.0 * (q.numel() + k.numel() + v.numel())
        note = (f"max_abs_err vs unpacked kernel 0 (f32, bf16), padding lanes zero over NaN; vs "
                f"plain f32 {worst[torch.float32][0]:.3g} bf16 {worst[bf][0]:.6g}")
        if worst[bf][1] is not None:
            note += f" mismatch share {max(worst[torch.float32][1], worst[bf][1]):.3g}"
        form = (A.flash_form if mode == "none" else A.quant_form)(
            bf, d, (qp.data_ptr(), kp.data_ptr(), vp.data_ptr()),
            (t * h * dp, h * dp, s * h * dp, h * dp, s * h * dp, h * dp), dp)
        note += f"; form {form}"
        odd_note = ""
        if (name in ("static_uniform_attention_packed", "rt", "static_quant_attention_packed")
                and first_of.setdefault((name, mode, sp), label) == label):
            # the element-load form of the packed entries, on a misaligned q
            odd = _misaligned(qp)
            kw = dict(sm_mode=mode, sm_bits=8, sm_delta=dl, start_peak=sp)
            got = A.fused_attention(odd, kp, vp, scale, num_heads=h, head_dim=d, **kw)
            want = A.fused_attention(qp, kp, vp, scale, num_heads=h, head_dim=d, **kw)
            same = torch.equal(got, want)
            if name == "rt":
                same = same and all(torch.equal(x, y) for x, y in zip(
                    A.rt_stats_packed(odd, kp, scale, h, d, sp),
                    A.rt_stats_packed(qp, kp, scale, h, d, sp)))
            if not same:
                raise AssertionError(f"{name} {label}: the element-load form differs")
            odd_note = "; misaligned q (element loads) equal bit for bit"
            del odd, got, want
        if name == "rt":
            ms = _median_ms(lambda: A.rt_stats_packed(qp, kp, scale, h, d, sp))
            dev = _device_ms(lambda: A.rt_stats_packed(qp, kp, scale, h, d, sp))
            plain_ms = _median_ms(lambda: A.rt_stats_reference(q, k, scale, sp))
            unp_ms = _median_ms(lambda: A.rt_stats(q, k, scale, sp))
            bound = _bound(qk_flops, 2.0 * (q.numel() + k.numel()) + 4.0 * b * h * t)
            summary.add("rt_stats_packed", label, max(worst[torch.float32][2], worst[bf][2]), ms,
                        plain_ms, bound, device_ms=dev)
            print(f"rt_stats_packed {label} {shape}, form {form}: z and scalar equal the "
                  f"unpacked kernel's{odd_note}; median ms kernel {ms:.4f} device-only {dev:.4f} "
                  f"({dev / bound[0]:.2f}x its bound) unpacked kernel {unp_ms:.4f} plain "
                  f"{plain_ms:.4f} bound {bound[0]:.4f} ({bound[1]}), exponent-unit floor "
                  f"{_exp_floor(b * h * t * s):.4f} | {tag}", flush=True)
            z, red = A.rt_stats_packed(qp, kp, scale, h, d, sp)
            delta = A.rt_delta(red, sp)
            ms = _median_ms(lambda: A.quant_accum_packed(qp, kp, vp, z, red, scale, h, d, 8, sp))
            dev = _device_ms(lambda: A.quant_accum_packed(qp, kp, vp, z, red, scale, h, d, 8, sp))
            plain_ms = _median_ms(lambda: A.packed_attention_reference(
                qp, kp, vp, scale, h, d, "log2", 8, delta, sp))
            z0, red0 = A.rt_stats(q, k, scale, sp)
            unp_ms = _median_ms(lambda: A.quant_accum(q, k, v, z0, red0, scale, 8, sp))
            bound = _bound(2 * qk_flops, valid + 2.0 * b * t * h * dp + 4.0 * b * h * t)
            summary.add("quant_accum_packed", label, worst[bf][0], ms, plain_ms, bound,
                        share=max(worst[torch.float32][1], worst[bf][1]), device_ms=dev)
            print(f"quant_accum_packed {label} {shape}: {note}{odd_note}; median ms kernel "
                  f"{ms:.4f} device-only {dev:.4f} ({dev / bound[0]:.2f}x its bound) unpacked "
                  f"kernel {unp_ms:.4f} plain {plain_ms:.4f} bound {bound[0]:.4f} "
                  f"({bound[1]}) | {tag}", flush=True)
            pname = "log2_real_time_attention_packed (both launches)"
        else:
            pname = name

        def packed_route():
            return A.fused_attention(qp, kp, vp, scale, num_heads=h, head_dim=d, **kw)

        # the unpacked route of models.layers.attention from the same projections'
        # outputs: q, k, v (B, T, H*d) -> three permute copies, the kernel, one back
        q3, k3, v3 = (A.unpack_heads(x, h, d).reshape(b, h, -1, d).permute(0, 2, 1, 3)
                      .reshape(b, -1, h * d) for x in (qp, kp, vp))

        def unpacked_route():
            qq, kk, vv = (x.reshape(b, -1, h, d).permute(0, 2, 1, 3).reshape(b * h, -1, d)
                          for x in (q3, k3, v3))
            o = A.fused_attention(qq, kk, vv, scale, **kw)
            return o.reshape(b, h, t, d).permute(0, 2, 1, 3).reshape(b, t, h * d)

        ms, route_ms = _median_ms(packed_route), _median_ms(unpacked_route)
        line = (f"{pname} {label} {shape}: {note}{odd_note}; median ms packed entry {ms:.4f}, "
                f"unpacked route with its four permute copies {route_ms:.4f}")
        if name != "rt":
            plain_ms = _median_ms(lambda: A.packed_attention_reference(
                qp, kp, vp, scale, h, d, mode, 8, dl, sp))
            library_ms = device_ms = None
            if name in ("static_uniform_attention_packed", "static_quant_attention_packed"):
                device_ms = _device_ms(packed_route)
                line += (f", device-only packed entry {device_ms:.4f} (exponent-unit floor "
                         f"{_exp_floor(2 * b * h * t * s):.4f})")
            if name == "flash_attention_packed":
                # the one PyTorch call for K2p's function, on the same strided head views
                q4, k4, v4 = (x.reshape(b, -1, h, dp)[..., :d].transpose(1, 2)
                              for x in (qp, kp, vp))
                library_ms = _median_ms(
                    lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale))
                device_ms = _device_ms(packed_route)
                lib_dev = _device_ms(
                    lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale))
                line += (f", library (scaled_dot_product_attention) {library_ms:.4f}, "
                         f"device-only packed entry {device_ms:.4f} library {lib_dev:.4f}")
            bound = _bound(2 * qk_flops, valid + 2.0 * b * t * h * dp)
            summary.add(name, label, worst[bf][0], ms, plain_ms, bound, library_ms,
                        None if worst[bf][1] is None
                        else max(worst[torch.float32][1], worst[bf][1]), device_ms)
            line += f", plain {plain_ms:.4f}, bound {bound[0]:.4f} ({bound[1]})"
            if device_ms is not None:
                line += f", device-only {device_ms / bound[0]:.2f}x its bound"
        print(f"{line} | {tag}", flush=True)
        del q, k, v, qp, kp, vp, q3, k3, v3, out, ref, unpacked, buf
    torch.cuda.empty_cache()


# K5's shapes: the four resolutions of the g=8 path, conv_in (4 channels: the
# CUDA-core body) and the widest up-block input. label, H = W, C, O
CONV_SHAPES = [
    ("64px 320->320", 64, 320, 320),
    ("32px 640->640", 32, 640, 640),
    ("16px 1280->1280", 16, 1280, 1280),
    ("8px 2560->1280", 8, 2560, 1280),
    ("64px 4->320 (conv_in)", 64, 4, 320),
    ("16px 2560->1280", 16, 2560, 1280),
]


def compare_group_conv(tag, summary):
    """Phase 2, K5 at `CONV_SHAPES` (3x3, stride 1, CFG batch 2 x IMAGES, bf16;
    the weights OIHW seen as HWIO, as the model passes them; synthetic scales
    spread around the qstate's 0.05 / 128 so that every (tap, channel)
    differs). The fold kernel's w_t, rd and z must equal `_fold`'s bit for
    bit. Work per call: 2*M*9*C*O flops; bytes are x, w, dm, zm, bias and the
    output once each. The wrapper's time is the fold launch, the conv and,
    where K is split, the pass that adds the partial sums; the fold is timed
    on its own too. Split K adds its f32 partial tiles in split order, so the
    result does not vary from run to run."""
    import torch
    from dgq_tpu_torch.ops import group_conv as G

    g = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16
    b = 2 * IMAGES
    for label, h, c, o in CONV_SHAPES:
        x = (2.0 * torch.randn(b, h, h, c, generator=g, device="cuda")).to(bf)
        w = (torch.randn(o, c, 3, 3, generator=g, device="cuda") / (9 * c) ** 0.5).to(bf)
        w = w.permute(2, 3, 1, 0)
        dm = 0.03 + 0.04 * torch.rand(9, c, generator=g, device="cuda")
        zm = 100.0 + 56.0 * torch.rand(9, c, generator=g, device="cuda")
        dl, zl = torch.ones(1, device="cuda"), torch.zeros(1, device="cuda")
        bias = 0.1 * torch.randn(o, generator=g, device="cuda")
        args = (x, w, dm, zm, dl, zl, bias)
        folded = G.fold_weights(bf, w, dm, zm, dl, zl, 3, 3)
        if not all(torch.equal(mine, ref) for mine, ref in
                   zip(folded, G._fold(x, w, dm, zm, dl, zl, 3, 3))):
            raise AssertionError(f"group conv fold {label}: w_t, rd or z differ from _fold's")
        before = G.LAUNCHES["group_quant_conv"]
        out = G.group_quant_conv(*args)
        ref = G.group_quant_conv_reference(*args)
        torch.cuda.synchronize()
        if G.LAUNCHES["group_quant_conv"] != before + 1:
            raise AssertionError("group_quant_conv did not launch its kernel")
        mx = _check_conv(out, ref)
        if not torch.equal(out, G.group_quant_conv(*args)):
            raise AssertionError(f"group_quant_conv {label}: two runs differ")
        ms = _median_ms(lambda: G.group_quant_conv(*args))
        plain_ms = _median_ms(lambda: G.group_quant_conv_reference(*args))
        fold_ms = _median_ms(lambda: G.fold_weights(bf, w, dm, zm, dl, zl, 3, 3))
        old_fold_ms = _median_ms(lambda: G._fold(x, w, dm, zm, dl, zl, 3, 3))
        device_ms = _device_ms(lambda: G.group_quant_conv(*args))
        fold_dev = _device_ms(lambda: G.fold_weights(bf, w, dm, zm, dl, zl, 3, 3))
        nbytes = 2.0 * (x.numel() + w.numel() + out.numel()) + 4.0 * (2 * dm.numel() + o)
        bound = _bound(2.0 * b * h * h * 9 * c * o, nbytes)
        form = G.conv_form(bf, c, o, x.data_ptr())
        plan = G.conv_plan(b * h * h, c, o, 9)
        how = (f"{form} body" if form == "cuda_core" else
               f"{form} body, {plan.m_tiles} x {plan.n_tiles} tiles, {plan.steps} K steps in "
               f"{plan.splits} split(s) of {plan.steps_per_split}")
        summary.add("group_quant_conv", label, mx, ms, plain_ms, bound, device_ms=device_ms)
        print(f"group_quant_conv {label} (B={b}, H=W={h}, C={c}, O={o}, 3x3, bf16; {how}): w_t, "
              f"rd, z equal _fold's; max_abs_err {mx:.6g}; median ms fold+conv {ms:.4f} (fold "
              f"kernel alone {fold_ms:.4f}; _fold's torch passes {old_fold_ms:.4f}) plain "
              f"{plain_ms:.4f} bound {bound[0]:.4f} ({bound[1]}); device-only ms fold+conv "
              f"{device_ms:.4f} ({device_ms / bound[0]:.2f}x its bound), fold kernel alone "
              f"{fold_dev:.4f} | {tag}", flush=True)
        del x, w, out, ref, folded
    torch.cuda.empty_cache()


# K6's shapes on the main paths (batch IMAGES, SD with CFG): label, M, K, N;
# then two ragged ones that no path runs: M and K off the tiles (K % 16 = 8:
# the element-load form), and every edge odd
INT8_SHAPES = [
    ("SD 64px FF-in", 16384, 320, 2560),
    ("SD 8px FF-out", 256, 5120, 1280),
    ("SD cross to_k", 308, 768, 320),
    ("SD time embedding", 4, 320, 1280),
    ("SDXL 32px FF-in", 2048, 1280, 10240),
    ("SDXL add_embedding.linear_1", 2, 2816, 1280),
    ("ragged M and K", 333, 1000, 640),
    ("ragged, odd K", 77, 1001, 200),
]


def wrapper_host_cost(tag):
    """Host time of the flash and group-conv wrappers at their smallest
    main-path shapes (SD 16px cross-attention, the 8px conv): these calls sit
    on host-bound paths, where what a wrapper does before its launch (checks,
    the choice of kernel form, allocations) is what a step pays for it."""
    import torch
    from dgq_tpu_torch.ops import attention as A
    from dgq_tpu_torch.ops import group_conv as G

    g = torch.Generator(device="cuda").manual_seed(11)
    bf = torch.bfloat16
    b, h, t, s, d, dp = 2 * IMAGES, 8, 256, 77, 160, 256
    q = torch.randn(b * h, t, d, generator=g, device="cuda").to(bf)
    k = torch.randn(b * h, s, d, generator=g, device="cuda").to(bf)
    v = torch.randn(b * h, s, d, generator=g, device="cuda").to(bf)
    qp, kp, vp = (A.repack_heads(x, h, dp) for x in (q, k, v))
    scale = d ** -0.5
    classic = _host_us(lambda: A.fused_attention(q, k, v, scale))
    packed = _host_us(lambda: A.fused_attention(qp, kp, vp, scale, num_heads=h, head_dim=d))
    x = torch.randn(b, 8, 8, 2560, generator=g, device="cuda").to(bf)
    w = (torch.randn(1280, 2560, 3, 3, generator=g, device="cuda") / 150.0).to(bf)
    w = w.permute(2, 3, 1, 0)
    dm = 0.03 + 0.04 * torch.rand(9, 2560, generator=g, device="cuda")
    zm = 100.0 + 56.0 * torch.rand(9, 2560, generator=g, device="cuda")
    dl, zl = torch.ones(1, device="cuda"), torch.zeros(1, device="cuda")
    bias = torch.zeros(1280, device="cuda")
    conv = _host_us(lambda: G.group_quant_conv(x, w, dm, zm, dl, zl, bias))
    print(f"wrapper host cost, microseconds a call: flash_attention 16px cross (BH={b * h}, "
          f"T={t}, S={s}, D={d}) {classic:.1f}; flash_attention_packed 16px cross (slots of "
          f"{dp}) {packed:.1f}; group_quant_conv 8px 2560->1280 {conv:.1f} | {tag}", flush=True)


def compare_int8(tag, summary):
    """Phase 2, K6 at its main-path shapes and two ragged ones: f32 and bf16,
    A8 with W4 and W8 codes and A6 with W4, against the plain version. The
    integer product is exact (split K adds s32 partials) and the f32 epilogue
    is the plain version's, operation for operation, so the bound is tight:
    f32 outputs within 1e-5 of the output's largest magnitude, bf16 outputs
    within one bf16 ulp (2^-7 |ref|); the codes the kernel builds (and their
    row sums, `return_codes`) equal `quantize_int`'s bit for bit. Where the
    plan splits K, the unsplit plan gives the same bits. Timed in bf16, A8 x
    W4, with the qstate's delta 0.05 and zero point 128 and a bf16 bias, as
    the int8 path calls it: the event reading, the device-only time and the
    wrapper's host time. Work per call: 2*M*N*K integer operations; bytes are
    x, the codes, the four (N,) vectors and the output once each. The
    library time is the `int8_impl="xla"` route on the same inputs (quantize
    with torch ops, `torch._int_mm`, epilogue), which wants more than 16
    rows and K and N multiples of 8."""
    import torch
    from dgq_tpu_torch.models.layers import _int8_matmul_xla
    from dgq_tpu_torch.models.qconfig import QConfig
    from dgq_tpu_torch.ops import int8_matmul as M8
    from dgq_tpu_torch.quant.affine import QParams, quantize_int

    g = torch.Generator(device="cuda").manual_seed(2)
    for label, m, k, n in INT8_SHAPES:
        worst = 0.0
        for dtype in (torch.float32, torch.bfloat16):
            for a_bits, w_bits, dxv, zpv in ((8, 4, 0.05, 120.0), (8, 8, 0.05, 131.0),
                                             (6, 4, 0.2, 30.0)):
                x = (2.0 * torch.randn(m, k, generator=g, device="cuda")).to(dtype)
                lo = 2 ** (w_bits - 1)
                wq = torch.randint(-lo, lo, (n, k), generator=g, device="cuda",
                                   dtype=torch.int32).to(torch.int8)
                dw = (0.02 + 0.02 * torch.rand(n, generator=g, device="cuda")) / lo
                zw = torch.round(0.1 * lo * torch.randn(n, generator=g, device="cuda"))
                bias = torch.randn(n, generator=g, device="cuda").to(dtype)
                ksum = wq.sum(dim=1, dtype=torch.int32).float()
                dx = torch.tensor(dxv, device="cuda")
                zp = torch.tensor(zpv, device="cuda")
                zx = zp - 2 ** (a_bits - 1)
                before = M8.LAUNCHES["int8_matmul"]
                out, codes, xsum = M8.quantized_matmul(x, wq, dw, zw, dx, zx, bias, ksum,
                                                       a_bits=a_bits, return_codes=True)
                ref = M8.quantized_matmul_reference(x, wq, dw, zw, dx, zx, bias, ksum,
                                                    a_bits=a_bits)
                torch.cuda.synchronize()
                if M8.LAUNCHES["int8_matmul"] != before + 1:
                    raise AssertionError(f"{label} did not launch int8_matmul")
                want = quantize_int(x.float(), QParams(dx, zp), a_bits)
                if not (torch.equal(codes, want) and torch.equal(xsum, want.float().sum(dim=1))):
                    raise AssertionError(f"int8_matmul {label}: the kernel's codes are not "
                                         f"quantize_int's (A{a_bits})")
                if out.shape != ref.shape or not bool(out.isfinite().all()):
                    raise AssertionError(f"int8_matmul {label}: bad output")
                err = (out.float() - ref.float()).abs()
                bound = (1e-5 * ref.float().abs().max() if dtype == torch.float32
                         else 2.0 ** -7 * ref.float().abs())
                if not bool((err <= bound).all()):
                    raise AssertionError(f"int8_matmul {label} {dtype} A{a_bits}W{w_bits}: error "
                                         f"{float(err.max())} exceeds the bound")
                worst = max(worst, float(err.max()))
                plan = M8.int8_plan(m, n, k)
                if plan.splits > 1:
                    whole = M8.Int8Plan(*plan[:3], 1, plan.steps)
                    one = M8.quantized_matmul(x, wq, dw, zw, dx, zx, bias, ksum, a_bits=a_bits,
                                              plan=whole)
                    if not torch.equal(one, out):
                        raise AssertionError(f"int8_matmul {label}: the unsplit plan differs")
        # timing: bf16, A8 x W4, the synthetic qstate's scalars
        x = (2.0 * torch.randn(m, k, generator=g, device="cuda")).bfloat16()
        wq = torch.randint(-8, 8, (n, k), generator=g, device="cuda",
                           dtype=torch.int32).to(torch.int8)
        p = {"w_q8": wq, "w_d": 0.003 + 0.002 * torch.rand(n, generator=g, device="cuda"),
             "w_z": torch.round(torch.randn(n, generator=g, device="cuda")),
             "w_ksum": wq.sum(dim=1, dtype=torch.int32).float(),
             "b": torch.randn(n, generator=g, device="cuda").bfloat16()}
        dx, zx = torch.tensor(0.05, device="cuda"), torch.tensor(0.0, device="cuda")
        args = (x, wq, p["w_d"], p["w_z"], dx, zx, p["b"], p["w_ksum"])
        ms = _median_ms(lambda: M8.quantized_matmul(*args))
        dev = _device_ms(lambda: M8.quantized_matmul(*args))
        host_us = _host_us(lambda: M8.quantized_matmul(*args))
        plain_ms = _median_ms(lambda: M8.quantized_matmul_reference(*args))
        plan = M8.int8_plan(m, n, k)
        form = M8.int8_form(k, x.data_ptr(), wq.data_ptr())
        library_ms = None
        if m > 16 and k % 8 == 0 and n % 8 == 0:  # what torch._int_mm takes
            qp = QParams(dx, torch.tensor(128.0, device="cuda"))
            cfg = QConfig(a_bits=8, use_aq=True, use_int8_matmul=True, int8_impl="xla")
            lib = _int8_matmul_xla(p, x, qp, cfg)
            ref = M8.quantized_matmul_reference(*args)
            if not bool(((lib.float() - ref.float()).abs() <= 2.0 ** -7 * ref.float().abs()).all()):
                raise AssertionError(f"the library route disagrees at {label}")
            library_ms = _median_ms(lambda: _int8_matmul_xla(p, x, qp, cfg))
        nbytes = 2.0 * m * k + 1.0 * n * k + 2.0 * m * n + 4.0 * 4 * n
        bound = _bound(2.0 * m * n * k, nbytes, PEAK_INT8_OPS)
        summary.add("int8_matmul", label, worst, ms, plain_ms, bound, library_ms,
                    device_ms=dev)
        lib_note = ("none (torch._int_mm wants M > 16, K and N multiples of 8)"
                    if library_ms is None else f"{library_ms:.4f}")
        split = ("unsplit" if plan.splits == 1 else
                 f"K split {plan.splits} ways, {plan.steps_per_split} of {plan.steps} steps each"
                 ", same bits as unsplit")
        print(f"int8_matmul {label} (M={m}, K={k}, N={n}; {plan.m_tiles} x {plan.n_tiles} tiles, "
              f"{split}; form {form}): f32/bf16 x A8W4/A8W8/A6W4 max_abs_err {worst:.6g}, codes "
              f"and row sums equal quantize_int; bf16 A8W4 median ms kernel {ms:.4f} device-only "
              f"{dev:.4f} ({dev / bound[0]:.2f}x its bound) wrapper host {host_us:.1f} us plain "
              f"{plain_ms:.4f} library (quantize + torch._int_mm + epilogue) {lib_note} bound "
              f"{bound[0]:.4f} ({bound[1]}) | {tag}", flush=True)
    torch.cuda.empty_cache()


def _launch_counts():
    from dgq_tpu_torch.ops import attention as A, group_conv as G, int8_matmul as M8

    return {**A.LAUNCHES, **G.LAUNCHES, **M8.LAUNCHES}


def _reset_launch_counts():
    from dgq_tpu_torch.ops import attention as A, group_conv as G, int8_matmul as M8

    A.reset_launch_counts()
    G.reset_launch_counts()
    M8.reset_launch_counts()


def _g8_kwargs(group_layers, impl):
    """The flagship policy of the JAX bench's --group 8 run."""
    return dict(use_wq=True, use_aq=True, softmax_bits=8, t2i_log_quant=True,
                t2i_real_time=True, t2i_start_peak=True, use_pallas_attention=True,
                group_conv_layers=group_layers, group_conv_impl=impl)


def _to_cuda(tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_to_cuda(v) for v in tree))
    if hasattr(tree, "delta_mid"):
        return type(tree)(*(_to_cuda(v) for v in (tree.delta_mid, tree.zp_mid, tree.delta_last,
                                                  tree.zp_last)))
    return None if tree is None else tree.cuda()


def small_input_reference():
    """Phase 3, the CPU side (needs no card and no kernel, so it runs while
    the compilers do): the tiny UNets (base 32) with their weights and
    inputs, each configuration's output on the CPU (plain versions) and its
    chaos, the CPU net's largest output change (in the maximum and in the
    mean) under sixteen input perturbations. fp nets take no perturbation.
    The packed configurations run the same nets with `pack_attention_heads`
    weights (the tiny SD heads are 4 to 16 wide in slots of 64 or 128, the
    tiny SDXL heads 32 wide in slots of 64) and `packed_attention=True`.
    Returns the input and, per configuration, (label, forward, params,
    qstate, cfg, kernels that must launch, perturbation size, CPU output,
    chaos, chaos of the mean)."""
    import torch
    from dgq_tpu_torch.calib.weight_calib import pack_attention_heads, quantize_model_weights
    from dgq_tpu_torch.models.qconfig import QConfig
    from dgq_tpu_torch.models.unet_sd import init_unet_sd, sd_unet_spec, unet_sd_apply
    from dgq_tpu_torch.models.unet_sdxl import sdxl_unet_spec, unet_sdxl_apply
    from dgq_tpu_torch.utils.synthetic import synthetic_group_qstate, synthetic_pertensor_qstate

    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 16, 16, 4, generator=g)
    ehs = torch.randn(2, 77, 64, generator=g)
    t = torch.tensor([500, 500], dtype=torch.int32)
    draws = [torch.randn(x.shape, generator=g) for _ in range(16)]

    kw = dict(w_bits=8, a_bits=8, softmax_bits=8, use_wq=True, use_aq=True,
              use_pallas_attention=True)
    int8 = QConfig(**kw, use_int8_matmul=True)
    spec = sd_unet_spec(base=32, cross=64)
    params = init_unet_sd(g, "cpu", spec=spec)
    params_q, _ = quantize_model_weights(params, spec, int8)
    qs_g1 = synthetic_pertensor_qstate(spec, 0, False, torch.float32, device="cpu")
    qs_g8, group_layers = synthetic_group_qstate(spec, 0, False, torch.float32, device="cpu")
    g8 = QConfig(w_bits=8, a_bits=8, **_g8_kwargs(group_layers, "fused"))

    xspec = sdxl_unet_spec(base=32, cross=64, add_ch=8, depths=(1, 2))
    xparams = init_unet_sd(g, "cpu", spec=xspec)
    xint8 = QConfig(**kw, t2i_log_quant=True, t2i_real_time=True, t2i_start_peak=True,
                    use_int8_matmul=True)
    xparams_q, _ = quantize_model_weights(xparams, xspec, xint8)
    xqs = synthetic_pertensor_qstate(xspec, 0, False, torch.float32, device="cpu")
    te = torch.randn(2, 128, generator=g)
    tid = torch.tensor([[128.0, 128.0, 0.0, 0.0, 128.0, 128.0]]).repeat(2, 1)

    def sd(p, xx, qs, cfg, dev):
        return unet_sd_apply(p, xx.to(dev), t.to(dev), ehs.to(dev), qstate=qs, cfg=cfg)

    def sdxl(p, xx, qs, cfg, dev):
        return unet_sdxl_apply(p, xx.to(dev), t.to(dev), ehs.to(dev), te.to(dev), tid.to(dev),
                               qstate=qs, cfg=cfg)

    # label, forward, params, qstate, cfg, kernels that must launch, perturbation size
    configs = [
        ("SD fp", sd, params, None, QConfig(use_pallas_attention=True), ("flash_attention",),
         None),
        ("SD W8A8 g=1", sd, params_q, qs_g1, QConfig(**kw), ("static_uniform_attention",), 1e-6),
        ("SD W8A8 g=1 int8", sd, params_q, qs_g1, int8,
         ("static_uniform_attention", "int8_matmul"), 1e-6),
        ("SD W8A8 g=8 fused", sd, params_q, qs_g8, g8,
         ("rt_stats", "quant_accum", "group_quant_conv"), 1e-6),
        ("SD W8A8 g=8 static log2", sd, params_q, qs_g8,
         g8.replace(t2i_real_time=False, log_max_1=True), ("static_quant_attention",), 1e-6),
        ("SDXL fp", sdxl, xparams, None, QConfig(use_pallas_attention=True),
         ("flash_attention",), None),
        ("SDXL W8A8 log2 real_time int8", sdxl, xparams_q, xqs, xint8,
         ("rt_stats", "quant_accum", "int8_matmul"), 1e-5),
    ]
    # the same nets with packed attention
    fp_p = QConfig(use_pallas_attention=True, packed_attention=True)
    pk64 = pack_attention_heads(params, spec, 8, slot=64)
    pk128 = pack_attention_heads(params, spec, 8, slot=128)
    pkq = pack_attention_heads(params_q, spec, 8)
    g8p = g8.replace(packed_attention=True)
    xheads = lambda o: o // 32  # noqa: E731  (the tiny SDXL net's heads are 32 wide)
    xrt = xint8.replace(use_int8_matmul=False, packed_attention=True)
    configs += [
        ("SD fp packed slot 64", sd, pk64, None, fp_p, ("flash_attention_packed",), None),
        ("SD fp packed slot 128", sd, pk128, None, fp_p, ("flash_attention_packed",), None),
        ("SD W8A8 g=1 packed", sd, pkq, qs_g1, QConfig(**kw, packed_attention=True),
         ("static_uniform_attention_packed",), 1e-6),
        ("SD W8A8 g=8 fused packed", sd, pkq, qs_g8, g8p,
         ("rt_stats_packed", "quant_accum_packed", "group_quant_conv"), 1e-6),
        ("SD W8A8 g=8 static log2 packed", sd, pkq, qs_g8,
         g8p.replace(t2i_real_time=False, log_max_1=True),
         ("static_quant_attention_packed",), 1e-6),
        ("SDXL fp packed", sdxl, pack_attention_heads(xparams, xspec, xheads), None, fp_p,
         ("flash_attention_packed",), None),
        ("SDXL W8A8 log2 real_time packed", sdxl, pack_attention_heads(xparams_q, xspec, xheads),
         xqs, xrt, ("rt_stats_packed", "quant_accum_packed"), 1e-5),
    ]
    prepared = []
    with torch.no_grad():
        for label, fwd, p, qs, cfg, must_launch, amp in configs:
            ref = fwd(p, x, qs, cfg, "cpu")
            chaos = chaos_mean = None
            if amp is not None:
                changes = [(fwd(p, x + amp * n, qs, cfg, "cpu") - ref).abs() for n in draws]
                chaos = max(float(c.max()) for c in changes)
                chaos_mean = max(float(c.mean()) for c in changes)
            prepared.append((label, fwd, p, qs, cfg, must_launch, amp, ref, chaos, chaos_mean))
    return x, prepared


def small_input_check(x, prepared, tag):
    """Phase 3, the card's side: each tiny UNet of `small_input_reference` on
    the card (kernels) against its CPU output, f32 with TF32 off. fp: atol
    1e-4 (summation order). Quantized SD configurations: the chaos bound of
    the JAX package's tests, err <= max(5 * chaos, 1e-4), under perturbations
    of 1e-6 (the change is heavy-tailed: most draws flip no quantizer bin and
    move nothing, one in three moves the output by 0.03 to 0.06). The tiny
    SDXL net under the real-time softmax answers a perturbation with no
    change or with one of about half its output's size (one flipped maximum
    rescales a whole attention), and the card is a perturbation of the CPU of
    the fp check's size, not of 1e-6: its sixteen draws are of size 1e-5, and
    the card must be within 2 * chaos in the largest and in the mean error.
    With packed attention every attention on the card must go through a
    packed entry and none through an unpacked kernel."""
    import torch

    saved_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        for label, fwd, p, qs, cfg, must_launch, amp, ref, chaos, chaos_mean in prepared:
            _reset_launch_counts()
            out = fwd(_to_cuda(p), x, _to_cuda(qs), cfg, "cuda").cpu()
            launched = {n: c for n, c in _launch_counts().items() if c}
            err = (out - ref).abs()
            ok = bool(out.isfinite().all())
            if amp is None:
                note = "bound 1e-4"
                ok = ok and float(err.max()) <= 1e-4
            elif amp == 1e-6:
                note = f"bound {max(5 * chaos, 1e-4):.6g}"
                ok = ok and float(err.max()) <= max(5 * chaos, 1e-4)
            else:
                note = (f"bound {max(2 * chaos, 1e-4):.6g}; mean_abs_err {float(err.mean()):.6g}"
                        f", bound {max(2 * chaos_mean, 1e-5):.6g}")
                ok = (ok and float(err.max()) <= max(2 * chaos, 1e-4)
                      and float(err.mean()) <= max(2 * chaos_mean, 1e-5))
            print(f"tiny UNet {label}: card vs CPU max_abs_err {float(err.max()):.6g} ({note}); "
                  f"kernel launches {launched} | {tag}", flush=True)
            if not ok:
                raise AssertionError(f"tiny UNet {label}: card and CPU disagree ({note})")
            if not launched or any(n not in launched for n in must_launch):
                raise AssertionError(f"tiny UNet {label} launched {launched}, "
                                     f"expected {must_launch}")
            if cfg.packed_attention and any(n in launched for n in CLASSIC_ATTENTION
                                            + ("flash_attention",)):
                raise AssertionError(f"tiny UNet {label}: an attention left the packed path: "
                                     f"{launched}")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved_tf32


def _fold_w4_bf16(params, spec, num_heads):
    """W4 minmax fold with the int8 codes beside it, then the attention heads
    packed into slots (the order of the JAX bench: fold, pack, cast), then the
    float weights in bf16; the int8 entries keep their codes and f32 scales.
    Returns the unpacked and the packed parameters, which share every layer
    that packing does not touch."""
    import torch
    from dgq_tpu_torch.calib.weight_calib import pack_attention_heads, quantize_model_weights
    from dgq_tpu_torch.models.qconfig import QConfig

    def bf16(p):
        return {k: v.to(torch.bfloat16) if v is not None and k in ("w", "b", "scale", "bias")
                else v for k, v in p.items()}

    params_q, _ = quantize_model_weights(params, spec, QConfig(w_bits=4, use_wq=True,
                                                               use_int8_matmul=True))
    packed_q = pack_attention_heads(params_q, spec, num_heads)
    cast = {n: bf16(p) for n, p in params_q.items()}
    packed = {n: cast[n] if p is params_q[n] else bf16(p) for n, p in packed_q.items()}
    return cast, packed


def _n_int8_layers(params, qstate, time_aware):
    """Layers a forward sends to the int8 matmul kernel: packed weights and a
    per-tensor activation scale (a 0-d delta, or one per time slot)."""
    lead = 1 if time_aware else 0
    return sum("w_q8" in p and hasattr(qstate["a"].get(n), "delta")
               and qstate["a"][n].delta.dim() == lead for n, p in params.items())


def build_model(tag):
    """SD v1.4 at full width with W4-folded bf16 weights (and their packed
    int8 codes), the VAE decoder and the sampler's inputs, all drawn on the
    card from one seed."""
    import torch
    from dgq_tpu_torch.calib.act_calib import attention_prefixes
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
    params_q, packed = _fold_w4_bf16(params, spec, 8)
    del params
    n_repacked = sum(packed[n] is not params_q[n] for n in packed)
    if n_repacked != 4 * n_attn:
        raise AssertionError(f"{n_repacked} repacked projections, expected {4 * n_attn}")
    model = {
        "spec": spec, "params": params_q, "params_packed": packed,
        "vae": init_vae_decoder(g, "cuda", dtype=bf),
        "latents": torch.randn(IMAGES, 64, 64, 4, generator=g, device="cuda").to(bf),
        "ehs_t": torch.randn(IMAGES, 77, 768, generator=g, device="cuda").to(bf),
        "ehs_u": torch.randn(IMAGES, 77, 768, generator=g, device="cuda").to(bf),
    }
    torch.cuda.synchronize()
    print(f"SD v1.4: {n_params / 1e6:.2f}M params, {n_quant} quant layers, {n_attn} "
          f"attentions; init + W4 fold + head packing ({n_repacked} projections into slots of "
          f"64, 128 and 256) {time.perf_counter() - t0:.2f} s | {tag}", flush=True)
    return model


def sample_and_decode(model, qstate, cfg, steps):
    """One run of the path: sd_sample then vae_decode, on the packed
    parameters when the policy says packed_attention. Returns the latents,
    the images and the host times (start, after sampling, end), each taken
    after a synchronise."""
    import torch
    from dgq_tpu_torch.pipeline.sampler import sd_sample
    from dgq_tpu_torch.pipeline.vae import vae_decode

    params = model["params_packed" if cfg.packed_attention else "params"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat = sd_sample(params, model["latents"], model["ehs_t"], model["ehs_u"],
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
    least one; a kernel it does not name must not have run) and the images.
    Returns the counts, with the seconds per step and per image under "s"."""
    import torch

    sample_and_decode(model, qstate, cfg, 1)  # warm-up (allocator, library handles)
    _reset_launch_counts()
    lat, images, (t0, t1, t2) = sample_and_decode(model, qstate, cfg, steps)
    launches = _launch_counts()
    for name, got in launches.items():
        want = expect.get(name, 0)
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
    launches["s"] = ((t1 - t0) / steps, (t2 - t0) / IMAGES)
    return launches


def _beside(label, steps, packed, unpacked, tag):
    """The packed path's times beside the unpacked path's of the same run."""
    print(f"{label}, {steps} steps: packed attention {packed['s'][0]:.4f} s per step, "
          f"{packed['s'][1]:.4f} s per image; unpacked {unpacked['s'][0]:.4f} s per step, "
          f"{unpacked['s'][1]:.4f} s per image | {tag}", flush=True)


def main_paths(tag):
    """Phase 4a to 4d: the SD v1.4 paths at full width on one model, each of
    g=1, g=8, static log2 and fp first unpacked and then with packed
    attention. Returns each kernel's launch count from the main-path run that
    drives it. The VAE's one attention is K2 (unpacked: one head of 512)."""
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
                    {"static_uniform_attention": n_attn * STEPS_G1, "flash_attention": 1}, tag)
    g1p = drive_path(model, "g=1 path, packed attention", qstate,
                     cfg.replace(packed_attention=True), STEPS_G1,
                     {"static_uniform_attention_packed": n_attn * STEPS_G1, "flash_attention": 1},
                     tag)
    _beside("g=1 path", STEPS_G1, g1p, g1, tag)

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
                     "group_quant_conv": n_fused * STEPS_G8, "flash_attention": 1}, tag)
    g8p = drive_path(model, "g=8 path (fused group conv), packed attention", qstate,
                     cfg.replace(packed_attention=True), STEPS_G8,
                     {"rt_stats_packed": n_attn * STEPS_G8, "quant_accum_packed": n_attn * STEPS_G8,
                      "group_quant_conv": n_fused * STEPS_G8, "flash_attention": 1}, tag)
    _beside("g=8 path (fused group conv)", STEPS_G8, g8p, g8, tag)
    # for the record: the same step through the taps path (library matmuls)
    drive_path(model, "g=8 path (taps, for the record)", qstate,
               cfg.replace(group_conv_impl="taps"), 1,
               {"rt_stats": n_attn, "quant_accum": n_attn, "flash_attention": 1}, tag)

    # 4c: the static log2 configuration (delta pinned to 1, no calibrated
    # state), and the unquantized model
    log2 = cfg.replace(t2i_real_time=False, log_max_1=True)
    k4 = drive_path(model, "static log2 path (log_max_1)", qstate, log2, 1,
                    {"static_quant_attention": n_attn, "group_quant_conv": n_fused,
                     "flash_attention": 1}, tag)
    k4p = drive_path(model, "static log2 path (log_max_1), packed attention", qstate,
                     log2.replace(packed_attention=True), 1,
                     {"static_quant_attention_packed": n_attn, "group_quant_conv": n_fused,
                      "flash_attention": 1}, tag)
    _beside("static log2 path", 1, k4p, k4, tag)
    fp = QConfig(use_pallas_attention=True)
    k2 = drive_path(model, "fp path (W4 weights, no activation quantizer)", None, fp, 1,
                    {"flash_attention": n_attn + 1}, tag)
    k2p = drive_path(model, "fp path, packed attention", None, fp.replace(packed_attention=True),
                     1, {"flash_attention_packed": n_attn, "flash_attention": 1}, tag)
    _beside("fp path", 1, k2p, k2, tag)

    # 4d: the g=1 path with the int8 deploy path on
    qstate = synthetic_pertensor_qstate(spec, STEPS_INT8, True, bf)
    n_int8 = _n_int8_layers(model["params"], qstate, True)
    n_lin = sum(k == "linear" or (k == "conv" and m[2] == 1) for _, k, m in spec)
    print(f"g=1 int8 path: {n_int8} of the {n_lin} linears and 1x1 convs per forward have "
          f"packed codes and a per-tensor scale | {tag}", flush=True)
    if n_int8 != n_lin:
        raise AssertionError(f"{n_int8} int8 layers, expected every linear and 1x1 conv: {n_lin}")
    cfg = QConfig(w_bits=4, a_bits=8, softmax_bits=8, use_wq=True, use_aq=True,
                  use_pallas_attention=True, use_int8_matmul=True, int8_impl="pallas")
    drive_path(model, "g=1 int8 path (use_int8_matmul)", qstate, cfg, STEPS_INT8,
               {"int8_matmul": n_int8 * STEPS_INT8,
                "static_uniform_attention": n_attn * STEPS_INT8, "flash_attention": 1}, tag)
    return {"static_uniform_attention": g1["static_uniform_attention"],
            "flash_attention": k2["flash_attention"], "rt_stats": g8["rt_stats"],
            "quant_accum": g8["quant_accum"], "group_quant_conv": g8["group_quant_conv"],
            "static_quant_attention": k4["static_quant_attention"],
            "static_uniform_attention_packed": g1p["static_uniform_attention_packed"],
            "flash_attention_packed": k2p["flash_attention_packed"],
            "rt_stats_packed": g8p["rt_stats_packed"],
            "quant_accum_packed": g8p["quant_accum_packed"],
            "static_quant_attention_packed": k4p["static_quant_attention_packed"]}


def build_sdxl_model(tag):
    """SDXL-turbo at full width with W4-folded bf16 weights and packed int8
    codes, the VAE decoder and the sampler's inputs at 1024px, all drawn on
    the card from one seed. The f32 copy (10 GB) and the fold's (10 GB more)
    are freed before anything is sampled."""
    import torch
    from dgq_tpu_torch.calib.act_calib import attention_prefixes
    from dgq_tpu_torch.models.unet_sd import quantizable_layers
    from dgq_tpu_torch.models.unet_sdxl import init_unet_sdxl, sdxl_unet_spec
    from dgq_tpu_torch.pipeline.vae import init_vae_decoder

    bf = torch.bfloat16
    spec = sdxl_unet_spec()
    g = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = init_unet_sdxl(g, "cuda")
    n_params = sum(v.numel() for p in params.values() for v in p.values() if v is not None)
    n_quant = len(quantizable_layers(spec))
    n_attn = len(attention_prefixes(spec))
    if n_params != 2_567_463_684 or n_quant != 794 or n_attn != 140:
        raise AssertionError(f"SDXL-turbo has {n_params} params / {n_quant} quant layers / "
                             f"{n_attn} attentions")
    params_q, packed = _fold_w4_bf16(params, spec, lambda o: o // 64)
    del params
    torch.cuda.empty_cache()
    if any(packed[n] is not params_q[n] for n in packed):
        raise AssertionError("SDXL's heads are 64 wide: packing must leave every layer alone")
    model = {
        "spec": spec, "params": params_q, "n_attn": n_attn,
        "vae": init_vae_decoder(g, "cuda", dtype=bf),
        "latents": torch.randn(IMAGES, 128, 128, 4, generator=g, device="cuda").to(bf),
        "ehs": torch.randn(IMAGES, 77, 2048, generator=g, device="cuda").to(bf),
        "text_embeds": torch.randn(IMAGES, 1280, generator=g, device="cuda").to(bf),
        "time_ids": torch.tensor([[1024.0, 1024.0, 0.0, 0.0, 1024.0, 1024.0]], device="cuda",
                                 dtype=bf).repeat(IMAGES, 1),
    }
    torch.cuda.synchronize()
    print(f"SDXL-turbo: {n_params} params ({n_params / 1e9:.3f}B), {n_quant} quant layers, "
          f"{n_attn} attentions; init + W4 fold + int8 pack {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB held | {tag}", flush=True)
    return model


def sdxl_sample_and_decode(model, qstate, cfg, steps, decode=True):
    """sdxl_turbo_sample then vae_decode at the SDXL scale. Returns the
    latents, the images (None without decode) and the host times (start,
    after sampling, end), each taken after a synchronise."""
    import torch
    from dgq_tpu_torch.models.unet_sdxl import unet_sdxl_apply
    from dgq_tpu_torch.pipeline.sampler import sdxl_turbo_sample
    from dgq_tpu_torch.pipeline.vae import SDXL_VAE_SCALE, vae_decode

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat = sdxl_turbo_sample(model["params"], model["latents"], model["ehs"],
                            model["text_embeds"], model["time_ids"], unet_sdxl_apply,
                            num_inference_steps=steps, qstate=qstate, cfg=cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    images = vae_decode(model["vae"], lat, scale=SDXL_VAE_SCALE) if decode else None
    torch.cuda.synchronize()
    return lat, images, (t0, t1, time.perf_counter())


def drive_sdxl(model, label, qstate, cfg, expect, tag):
    """Warm up, set every launch count to 0, run STEPS_SDXL Euler steps and
    the 1024px decode, read the counts and check them (a kernel `expect` does
    not name must not have run) and the images. Returns the counts, with the
    seconds per step and per image under "s"."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    sdxl_sample_and_decode(model, qstate, cfg, 1)  # warm-up
    _reset_launch_counts()
    lat, images, (t0, t1, t2) = sdxl_sample_and_decode(model, qstate, cfg, STEPS_SDXL)
    launches = _launch_counts()
    for name, got in launches.items():
        if got != expect.get(name, 0):
            raise AssertionError(f"{label}: {name} ran {got} times, expected "
                                 f"{expect.get(name, 0)}")
    if tuple(images.shape) != (IMAGES, 1024, 1024, 3) or not bool(images.isfinite().all()):
        raise AssertionError(f"{label}: bad images {tuple(images.shape)}")
    if not bool(lat.isfinite().all()) or float(images.float().std()) == 0.0:
        raise AssertionError(f"{label}: degenerate output")
    print(f"{label}: {IMAGES} images 1024px, {STEPS_SDXL} Euler steps guidance 0 bf16 W4A8, "
          f"{model['n_attn']} attentions per forward: sampling {t1 - t0:.4f} s "
          f"({(t1 - t0) / STEPS_SDXL:.4f} s per step = one UNet forward at batch {IMAGES}), VAE "
          f"decode at 1024px {t2 - t1:.4f} s, {(t2 - t0) / IMAGES:.4f} s per image; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches "
          f"{ {n: c for n, c in launches.items() if c} } | {tag}", flush=True)
    launches["s"] = ((t1 - t0) / STEPS_SDXL, (t2 - t0) / IMAGES)
    return launches


def sdxl_path(tag):
    """Phase 4e and 4f: SDXL-turbo W4A8 at 1024px, the JAX bench's SDXL policy
    (log2 real_time softmax with start_peak, fused attention) with a
    non-time-aware per-tensor qstate: with the int8 deploy path on; with it
    off; and with it off and packed attention, the bench's default. SDXL's
    heads are 64 wide, so the packed run uses the same weights. Returns the
    launch counts of the int8 run."""
    import torch
    from dgq_tpu_torch.models.qconfig import QConfig
    from dgq_tpu_torch.utils.synthetic import synthetic_pertensor_qstate

    model = build_sdxl_model(tag)
    spec, n_attn = model["spec"], model["n_attn"]
    qstate = synthetic_pertensor_qstate(spec, 0, False, torch.bfloat16)
    n_int8 = _n_int8_layers(model["params"], qstate, False)
    n_lin = sum(k == "linear" or (k == "conv" and m[2] == 1) for _, k, m in spec)
    if n_int8 != n_lin:
        raise AssertionError(f"{n_int8} int8 layers, expected every linear and 1x1 conv: {n_lin}")
    cfg = QConfig(w_bits=4, a_bits=8, softmax_bits=8, use_wq=True, use_aq=True,
                  t2i_log_quant=True, t2i_real_time=True, t2i_start_peak=True,
                  use_pallas_attention=True, use_int8_matmul=True, int8_impl="pallas")
    rt = {"rt_stats": n_attn * STEPS_SDXL, "quant_accum": n_attn * STEPS_SDXL,
          "flash_attention": 1}
    int8 = drive_sdxl(model, f"SDXL-turbo int8 path ({n_int8} int8 layers per forward)", qstate,
                      cfg, {**rt, "int8_matmul": n_int8 * STEPS_SDXL}, tag)
    off = cfg.replace(use_int8_matmul=False)
    unpacked = drive_sdxl(model, "SDXL-turbo, int8 path off", qstate, off, rt, tag)
    packed = drive_sdxl(model, "SDXL-turbo, int8 path off, packed attention", qstate,
                        off.replace(packed_attention=True),
                        {"rt_stats_packed": n_attn * STEPS_SDXL,
                         "quant_accum_packed": n_attn * STEPS_SDXL, "flash_attention": 1}, tag)
    _beside("SDXL-turbo, int8 path off", STEPS_SDXL, packed, unpacked, tag)
    return int8


def print_build_report(paths, tag):
    """Registers and spills of every kernel instance, from `-Xptxas -v`."""
    modes = {"0": "K2/K2p flash", "1": "K1/K1p uniform", "2": "K3b/K3p rt_stats",
             "3": "K3b/K3p quant_accum", "4": "K4/K4p static_quant"}
    spilled = []
    for path in paths.values():
        log = path.with_suffix(".log").read_text() if path.with_suffix(".log").exists() else ""
        for m in re.finditer(r"Compiling entry function '(\w+)'.*?\n.*?\n\s*(\d+) bytes stack "
                             r"frame, (\d+) bytes spill stores.*?\n.*?Used (\d+) registers", log):
            sym = m.group(1)
            dtype = "bf16" if "bfloat16" in sym else "f32"
            a = re.search(r"attention_kernelI\w+?Li(\d+)ELi(\d+)ELi(\d)E", sym)
            f = re.search(r"flash_tc_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb([01])ELb([01])E", sym)
            qt = re.search(r"quant_tc_kernelILi(\d)ELi(\d+)ELi(\d+)ELb([01])E", sym)
            if qt:
                dtype = "bf16"
                kname = (f"{modes[qt.group(1)]} wgmma D<={16 * int(qt.group(3))}"
                         + (" cp.async" if qt.group(4) == "1" else " element loads"))
            elif a:
                kname = f"{modes[a.group(3)]} DP={a.group(1)} RM={a.group(2)}"
            elif f:
                dtype = "bf16"
                kname = (f"K2/K2p flash wgmma D<={16 * int(f.group(2))} BK={f.group(3)}"
                         + (" split columns" if f.group(4) == "1" else "")
                         + (" cp.async" if f.group(5) == "1" else " element loads"))
            elif "int8_wgmma_kernel" in sym:
                dtype = "bf16" if "bfloat16" in sym else "f32"
                kname = ("K6 int8_matmul wgmma s8"
                         + (" cp.async" if "Lb1E" in sym else " element loads"))
            elif "group_conv_tc_kernel" in sym:
                dtype = "bf16"
                kname = "K5 group_conv wgmma" + (" split K" if "ILb1E" in sym else "")
            elif "fold_oihw_kernel" in sym:
                dtype = "bf16"
                kname = ("K5 weight fold (OIHW, in registers), scales "
                         + ("f32" if "fold_oihw_kernelIfE" in sym else "bf16"))
            elif "fold_kernel" in sym:
                t = re.search(r"fold_kernelI(f|13__nv_bfloat16)(f|13__nv_bfloat16|S\d*_)E", sym)
                dtype = "bf16" if t and t.group(1) != "f" else "f32"
                kname = ("K5 weight fold, scales "
                         + ("bf16" if t and t.group(2) != "f" else "f32"))
            elif "finish_kernel" in sym:
                dtype = "bf16"
                kname = "K5 split-K finish"
            else:
                kname = "K5 group_conv CUDA cores"
            print(f"  ptxas {kname} {dtype}: {m.group(4)} registers, {m.group(3)} bytes "
                  f"spilled | {tag}")
            if int(m.group(3)):
                spilled.append(f"{kname} {dtype}")
    print(f"ptxas: instances that spill: {', '.join(spilled) or 'none'} | {tag}")


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

    # the compilers run (one process per source) while this process computes
    # the small-input check's CPU side, which needs neither them nor the card
    t0 = time.perf_counter()
    built = {}

    def build_all():
        try:
            built["paths"] = build.build_kernels()
        except BaseException as exc:  # handed to the main thread, which raises it
            built["error"] = exc
        built["seconds"] = time.perf_counter() - t0

    compiling = threading.Thread(target=build_all)
    compiling.start()
    try:
        tiny_x, tiny_nets = small_input_reference()
        cpu_seconds = time.perf_counter() - t0
    finally:
        compiling.join()
    if "error" in built:
        raise built["error"]
    paths = built["paths"]
    build.load_kernels()
    print(f"build: {built['seconds']:.2f} s beside {cpu_seconds:.2f} s of the tiny nets' CPU "
          f"references ({', '.join(p.name for p in paths.values())}) | {tag}", flush=True)
    print_build_report(paths, tag)

    def phase(fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        print(f"phase {fn.__name__}: {time.perf_counter() - t0:.1f} s | {tag}", flush=True)
        return result

    summary = _Summary()
    phase(compare_attention, tag, summary)
    phase(compare_attention_packed, tag, summary)
    phase(compare_group_conv, tag, summary)
    phase(wrapper_host_cost, tag)
    phase(compare_int8, tag, summary)
    phase(small_input_check, tiny_x, tiny_nets, tag)
    launches = phase(main_paths, tag)
    torch.cuda.empty_cache()  # the SD model is gone; SDXL needs 20 GB while it folds
    launches["int8_matmul"] = phase(sdxl_path, tag)["int8_matmul"]

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], **{k: v for k, v in summary[name].items() if k != "at"}}
        for name, (source, replaces) in KERNELS.items()]}
    print("kernels: max_abs_err (and mismatch_share) are the largest over the shapes above; "
          "ms, plain_ms, bound_ms, library_ms, device_ms at "
          + ", ".join(f"{n}: {summary[n]['at']}" for n in KERNELS) + f" | {tag}")
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
