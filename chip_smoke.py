#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`dgq_tpu_torch`) once on one NVIDIA GPU.

    python3 chip_smoke.py               # from the repository root; needs one CUDA card
    python3 chip_smoke.py --fake-quant  # the build and phase 2a's fake quantizer rows alone
    python3 chip_smoke.py --linear-gemm # the build and phase 2b's f32 linear rows alone
    python3 chip_smoke.py --k3b         # the build and `k3b_bodies`' K3b f32 rows alone

Phases (any failure raises, so the exit code is non-zero):
  1. build the hand-written CUDA kernels from dgq_tpu_torch/csrc/ (nvcc, sm_90a,
     one compiler process per source), while a process of its own computes
     the tiny nets' CPU references on the cores the compilers leave;
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
  2a. `compare_fake_quant`: the one-launch activation fake quantizer
     (`ops.fake_quant`) bit for bit against the plain chain it replaces, at
     the GEGLU output and the 64px q and k (start row) of SD v1.4 at CFG
     batch 8: device-only ms of both, the bytes bound, host us a call, and
     the library's one-pass `torch.fake_quantize_per_tensor_affine` (other
     bits) as a yardstick. Every path below counts the kernel's launches and
     the card's quantizers left on the chain (`_check_fake_quant`);
  2b. `compare_linear_gemm`: the 3xTF32 GEMM of the f32 linears
     (`ops.linear_gemm`) at every f32 linear shape of the benchmark's
     generation cells (`LINEAR_SHAPES`): its error against f64 within twice
     the library f32 product's, against the plain version, device-only ms
     beside its 3xTF32 bound, `F.linear`'s time (`library_ms`) and the plain
     version's; every path below prints its GEMM launches and the f32
     linears it left to the library;
  2c. `int8_conv`: the s8 conv of `use_int8_conv` (a library route: codes,
     an unfold from strided views, `torch._int_mm`, the f32 correction; no
     hand-written kernel) at SD's and SDXL's k x k shapes, A8 and A6, f32
     and bf16: the card's codes, s32 accumulator and window sums equal the
     CPU port's bit for bit, its output within one f32 ulp; its device time
     beside the cuDNN fake-quant conv it replaces;
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
        linear and 1x1 conv through the int8 matmul kernel; then the same
        with `use_int8_conv` too (50 s8 convs a forward, counted), s a step
        beside 4d's.
     SDXL-turbo at 1024px, 4 Euler steps, guidance 0, decoded at 1024px:
     4e W4A8 with log2 real_time softmax, start_peak and the int8 deploy path,
        then with `use_int8_conv` too (38 s8 convs a forward);
     4f the same with the int8 path off, unpacked and then with packed
        attention (the JAX bench's `--model sdxl` default).
  5. `cli_path`, after dp_path: the inference entry point from local
     files. Full-width SD v1.4 checkpoints (g=8, g=1 joined by `ckpt_tools
     merge`, static log2) and an HF-named VAE written through the port's
     writers and read back bit for bit, then `dgq_tpu_torch.cli.infer.main`
     in this process four ways (the README's command; with --pallas_attn
     --group_impl fused; g=1; static log2), f32 activations with bf16
     weights (--fp16), STEPS_CLI PNDM steps, with exact launch counts, and
     three witnesses of the gap between the first two (the first on
     initial latents moved by 1e-6, whose change bounds the kernel runs'
     first UNet forward, and each kernel flag alone); the
     f32 kernel bodies these runs take against their plain versions
     (`f32_bodies`: K2/K2p, K5, K1, K3b and K4 on the tensor cores, three
     TF32 products a product, P V of the quantizing modes two; K5, K1 and
     K4 beside the CUDA-core bodies they replace at these shapes);
     `k3b_bodies`: K3b's f32 pair on body (f) bit for bit against body (e)
     at the generation cells' shapes, both timed beside the 3xTF32 bound;
     then the CLIP-L and bigG text encoders at full width, card against CPU.
     The kernels' launch counts over each run are checked.
  6. `calib_path`, after 4d: calibration without reconstruction from
     the port alone at full width (SD v1.4, 512px, f32, random weights from
     seed 42, CALI_PROMPTS prompts and CALI_STEPS PNDM steps): the MSE
     weight scales and the tiny net's g=2 calibration on the card against
     the CPU; `cli.quantize_weight.main --cali --no_recon --use_aq
     --pallas_attn` (g=1, K1 / K2), `cli.quantize_act.main --group_num 8`
     with the t2i flags and --pallas_attn (K3b), every checkpoint read back
     bit for bit; `cli.ckpt_tools merge` and `cli.infer.main` on the result
     (K3b, K5). Seconds, peak memory and exact launch counts of each run.
  7. `recon_path`, while tp_path's ranks run: weight reconstruction (AdaRound /
     BRECQ) at full width from the port alone (SD v1.4, 512px, f32, seed 42,
     the same calibration cuts, RECON_ITERS Adam steps a unit): the tiny
     net's walks on the card against the CPU at the CPU tests' limits (each
     step's loss, the share of offsets within 1e-4); `cli.quantize_weight.main`'s
     default path with --partial_dir over the units as far as
     up_blocks.3.resnets.0, reconstructing one of each kind and place
     (RECON_WALK) and resuming the others from saves of their nearest
     rounding, two of those units walked again with their captures in
     pinned host memory (and once more on the card) bit for bit, the
     same command resumed bit for bit, the temporal block
     with the Fisher-weighted loss (the whole UNet's backward at batch 8),
     no kernel launched in any of them; `cli.infer.main --pallas_attn` on
     the reconstructed W4 file (K2 in every UNet attention). Seconds a unit
     and an Adam step by unit kind (`_ReconProbe` times the walk from
     outside it), peak memory, the largest unit's captures a sample, the
     hours a 20000-step run would take.
  8. `eval_path`, while dp_path's ranks run: the evaluation path at full width
     from the port alone: `cli.gen4eval.main` for SD v1.4 at 512px (--fp,
     and W4A8 g=8 from calib_path's merged file with --pallas_attn
     --group_impl fused) and for SDXL-turbo at 1024px (minmax W4), with
     exact launch counts; `cli.eval_scores.main` (FID, IS) through a random
     pytorch-fid-named Inception checkpoint; the open_clip ViT-g-14 and
     ImageReward encoders at their published widths on random weights; each
     scorer card against CPU, s an image and s per 100 images.
  9. `dp_path`, after `calib_path`: data parallelism over torch.distributed.
     (o) a world of one over NCCL; then one `torchrun --standalone
     --nproc_per_node 2` launch of this script (`--dp-rank SPEC`, whose two
     ranks share the card over gloo): (p) `cli.quantize_weight --dp 2` over
     the first DP_UNITS units against `--dp 1` (each step's loss within 5e-5
     relative, > 0.9 of the offsets within 1e-4, the ranks' offsets equal,
     each rank's captures half of dp 1's; peak, capture bytes and ms an Adam
     step a rank), (q) `cli.gen4eval --dp 2` (--fp, and W4A8 g=8 with the
     kernels, exact launches a rank) against `--dp 1` (the same files; fp
     images within DP_FP_LEVELS); (r) one g=1 step under
     `utils.profiler.device_trace` (the trace names quant_tc_kernel) and
     `spec_roofline`'s SOL beside 4a's and, after sdxl_path, 4e's forward.
 10. `tp_path`, after `dp_path`: channel parallelism. One `torchrun
     --standalone --nproc_per_node 2` launch of this script (`--tp-rank
     SPEC`; the ranks share the card over gloo), each run against the same
     command at `--tp 1`: (s) `cli.quantize_weight --tp 2` over the first
     TP_UNITS units against dp_path's `--dp 1` run (each step's loss within
     5e-5 relative, > 0.9 of the gathered offsets within 1e-4, each rank's
     rows of the written file equal to its shards; bytes held, peak and ms
     an Adam step a rank); (t) `--tp 2 --fast --no_recon --use_aq
     --pallas_attn` (the weight-only file bit for bit, K1 and K2 launches
     a rank equal to `--tp 1`'s, the activation state finite and positive);
     (u) SDXL-turbo at 1024px, `--tp 2 --fast --no_recon` (the file bit for
     bit; peak a rank, build + shard + scale-init seconds).
 11. `sdxl_cli_path`, the last (after 4e and 4f): the SDXL-turbo CLIs at
     full width in a user's order, each through its `main(argv)`: (v) `quantize_weight
     --model sdxl --wq 4 --cali` with reconstruction over SDXL_RECON_UNITS
     units (learned rounding within 1.5x nearest on every unit, the file
     and its offsets bit for bit) and resumed bit for bit; (v') `cli.infer
     --pallas_attn` on its weight-only file (K2 in every UNet attention and
     the 1024px decodes); (w) `--resume_w`
     on (v)'s file with `--use_aq --pallas_attn` and the t2i flags (K3b);
     (x) `quantize_act --group_num 8` (K3b, the host k-means timed); (y)
     the merge and `cli.infer --pallas_attn --group_impl fused` (K3b, K5,
     K2 in the 1024px decodes), (y') plain attention and taps, and again on
     latents moved by 1e-6, which bounds (y)'s first forward. Exact
     forwards and launches, every file read back bit for bit, seconds and
     peak memory of each run.
The last two lines are the kernels' JSON record and the result line
{"ok": true, "device": {...}}. The first line is the card's name and power
limit as nvidia-smi gives them; every number printed after it was measured
in this run on that card, and its line says so (`| card: ...`). Each phase
prints the seconds it took. The order: 1 to 4d, 6, 9 with 8 beside its
launch, 5, its f32 kernel bodies and text encoders, 10 with 7 beside its
launch, 4e and 4f, 11 (the two-rank launches are bound by the host, and a
phase in this process keeps the card busy meanwhile; every line of that
phase says it ran beside the launch, whose ranks share the card and the
host with it).

    python3 chip_smoke.py --recon-fit   # the calibration CLIs at the default data size

runs `recon_fit` alone instead: SD v1.4's and SDXL-turbo's largest
reconstruction unit (SD's captures in pinned host memory) and SD's
activation calibration, each at the CLI's default data size.
"""
import concurrent.futures
import functools
import json
import multiprocessing
import os
import re
import statistics
import subprocess
import sys
import threading
import time

STEPS_G1 = 10
STEPS_G8 = 4
STEPS_INT8 = 4
STEPS_SDXL = 4
STEPS_CLI = 5  # divides 1000, as a time-aware run needs; cut from 10 for the time limit
IMAGES = 2
ATTN_SRC = "dgq_tpu_torch/csrc/attention.cu"
CONV_SRC = "dgq_tpu_torch/csrc/group_conv.cu"
INT8_SRC = "dgq_tpu_torch/csrc/int8_matmul.cu"
FQ_SRC = "dgq_tpu_torch/csrc/fake_quant.cu"
LG_SRC = "dgq_tpu_torch/csrc/linear_gemm.cu"
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
    # replaces no TPU kernel: XLA fuses the JAX package's chain into one pass
    "fake_quant": (FQ_SRC, "none (XLA fuses dgq_tpu/quant/affine.py:49 fake_quant)"),
    # replaces no TPU kernel: the JAX package's linears are XLA's dot
    "linear_gemm": (LG_SRC, "none (XLA's dot: dgq_tpu/models/layers.py linear)"),
}
CLASSIC_ATTENTION = ("static_uniform_attention", "rt_stats", "quant_accum",
                     "static_quant_attention")
# the card's published peaks (NVIDIA H100 SXM data sheet): bf16 and int8
# tensor-core rates and device-memory rate, for the least time a kernel's work
# could take
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12
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


def _check_conv(out, ref, bf16=True):
    """K5: the codes and folded weights are the same numbers on both sides, so
    only the f32 summation order and each side's one rounding to bf16 differ:
    |err| <= 2e-3 + 2^-7 |ref| (the second term left out for f32 tensors)."""
    out, ref = out.float(), ref.float()
    if out.shape != ref.shape or not bool(out.isfinite().all()):
        raise AssertionError(f"bad kernel output: shape {tuple(out.shape)}")
    err = (out - ref).abs()
    bound = 2e-3 + (2.0 ** -7 * ref.abs() if bf16 else 0.0)
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


# The fake quantizer's rows: the largest activation `aq_apply` quantizes in an
# SD v1.4 UNet call at CFG batch 8 (the GEGLU output into ff.net.2 at 64px),
# and a 64px q as the unpacked attention quantizes it, (b, t, h*d) seen as
# (b, h, t, d) with heads of 40; then that view as k with its start-peak row;
# then a 64px linear input under a group quantizer's factors over its rows
# (tokens) and over its columns (channels), as `quantize_act --group_num`
# calibrates them. label, (b, t, c), heads (None: as it is), start rows,
# group factors (None, "rows" or "columns")
FAKE_QUANT_SHAPES = [
    ("64px GEGLU output", (8, 4096, 1280), None, 0, None),
    ("64px q, heads of 40", (8, 4096, 320), 8, 0, None),
    ("64px k, heads of 40, start row", (8, 4096, 320), 8, 1, None),
    ("64px linear input, group factors over the rows", (8, 4096, 320), None, 0, "rows"),
    ("64px linear input, group factors over the columns", (8, 4096, 320), None, 0, "columns"),
]


def compare_fake_quant(tag, summary):
    """`ops.fake_quant`'s kernel at `FAKE_QUANT_SHAPES` (f32, a time slot's
    0-d delta and zero point, as the benchmark's cell has them) against the
    plain chain it replaces (`fused_fake_quant_reference`: `quant.affine.
    fake_quant`'s eight launches, and `torch.cat` for the start row): the
    bits must be equal. Device-only ms of both (`_device_ms`), the bytes
    bound (the input read once and the f32 output written once, over 3.35
    TB/s) and its share, and the host us a call of the wrapper against the
    chain's. The library's one-pass quantize-dequantize,
    `torch.fake_quantize_per_tensor_affine`, is timed beside them as a
    yardstick alone: it multiplies by the reciprocal of the scale and takes
    an integer zero point, so its bits are not the chain's (its output keeps
    the input's strides, and it passes no start row through); under group
    factors its per-channel form, `torch.fake_quantize_per_channel_affine`,
    over the grouped axis with the factors' products."""
    import torch
    from dgq_tpu_torch.ops import fake_quant as FQ

    g = torch.Generator(device="cuda").manual_seed(21)
    delta = (0.05 * torch.exp(0.6 * (torch.rand(25, generator=g, device="cuda") - 0.5)))[12]
    zp = torch.full((25,), 128.0, device="cuda")[12]
    scale, zero = float(delta), int(zp)  # the library takes them from the host
    one, nil = torch.ones(1, device="cuda"), torch.zeros(1, device="cuda")
    for label, (b, t, c), heads, rows, group in FAKE_QUANT_SHAPES:
        x = 0.5 * torch.randn(b, t, c, generator=g, device="cuda")
        if heads:
            x = x.reshape(b, t, heads, c // heads).permute(0, 2, 1, 3)
        d, z, mid = delta, zp, None
        if group:  # DGQ's factors over one axis, the other's 1 and 0
            n = t if group == "rows" else c
            f = 1.0 + 0.5 * torch.rand(n, generator=g, device="cuda")
            fz = torch.round(16.0 * torch.rand(n, generator=g, device="cuda") - 8.0)
            d, z, mid = (one, nil, (f * delta, fz + zp)) if group == "rows" else (
                f * delta, fz + zp, (one, nil))
            axis, scales, zeros = ((1, mid[0], mid[1]) if group == "rows" else (2, d, z))

        def kernel():
            return FQ.fused_fake_quant(x, d, z, 8, rows, mid)

        def plain():
            return FQ.fused_fake_quant_reference(x, d, z, 8, rows, mid)

        def library():
            if group:
                return torch.fake_quantize_per_channel_affine(
                    x, scales, zeros.int(), axis, 0, 255)
            return torch.fake_quantize_per_tensor_affine(x, scale, zero, 0, 255)

        before = FQ.LAUNCHES["fake_quant"]
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        if FQ.LAUNCHES["fake_quant"] != before + 1 or not out.is_contiguous():
            raise AssertionError(f"fake_quant {label}: no launch, or a strided output")
        if not torch.equal(out.view(torch.int32), ref.contiguous().view(torch.int32)):
            raise AssertionError(f"fake_quant {label}: the bits differ from the chain's")
        lib_share = float((library() != ref).float().mean())
        del out, ref
        ms, plain_ms, library_ms = _median_ms(kernel), _median_ms(plain), _median_ms(library)
        dev, plain_dev = _device_ms(kernel), _device_ms(plain)
        # the per-channel form reads its zero points on the host (a sync a
        # call), so the host cannot queue it ahead: its event ms stands
        lib_dev = library_ms if group else _device_ms(library)
        host, plain_host = _host_us(kernel), _host_us(plain)
        bound = _bound(0, 2 * 4 * x.numel())
        summary.add("fake_quant", label, 0.0, ms, plain_ms, bound, library_ms, device_ms=dev)
        print(f"fake_quant {label} ({tuple(x.shape)} f32, strides {x.stride()}, "
              f"{4 * x.numel() / 1e6:.1f} MB): bits equal the chain's; device-only ms {dev:.4f}, "
              f"bytes bound {bound[0]:.4f} ({100 * bound[0] / dev:.1f}% of it); plain chain "
              f"{plain_dev:.4f} ({plain_dev / dev:.2f}x); library "
              f"(fake_quantize_per_{'channel' if group else 'tensor'}_affine, other bits: "
              f"{lib_share:.3g} of its values differ{', event ms: it syncs' if group else ''}) "
              f"{lib_dev:.4f} ({lib_dev / dev:.2f}x); median ms kernel {ms:.4f} plain "
              f"{plain_ms:.4f} library {library_ms:.4f}; host us a call {host:.1f}, plain chain "
              f"{plain_host:.1f} | {tag}", flush=True)
        del x
    torch.cuda.empty_cache()


# Every f32 linear of the benchmark's generation cells that `layers.linear`
# sends to the kernel (at least MIN_ROWS rows): label, M, K, N, bias. SD3
# medium at CFG batch 4 (4096 image and 333 text tokens a sample), SDXL-turbo
# at batch 4 (1024px: 4096 and 1024 tokens, 77 text tokens), SD v1.4 at CFG
# batch 8 (512px: 4096 to 64 tokens), and the VAEs' mid-block attention.
# Ragged M: 1332, 616, 308 rows. Then two shapes no cell runs, every edge
# ragged, one with no bias.
LINEAR_SHAPES = [
    ("SD3 image q, k, v, out", 16384, 1536, 1536, True),
    ("SD3 image FF in", 16384, 1536, 6144, True),
    ("SD3 image FF out", 16384, 6144, 1536, True),
    ("SD3 proj_out", 16384, 1536, 64, True),
    ("SD3 text q, k, v, out", 1332, 1536, 1536, True),
    ("SD3 text FF in", 1332, 1536, 6144, True),
    ("SD3 text FF out", 1332, 6144, 1536, True),
    ("SD3 context_embedder", 1332, 4096, 1536, True),
    ("SDXL 64px q, k, v (no bias)", 16384, 640, 640, False),
    ("SDXL 64px out, proj_in, proj_out", 16384, 640, 640, True),
    ("SDXL 64px GEGLU in", 16384, 640, 5120, True),
    ("SDXL 64px FF out", 16384, 2560, 640, True),
    ("SDXL 32px q, k, v (no bias)", 4096, 1280, 1280, False),
    ("SDXL 32px GEGLU in", 4096, 1280, 10240, True),
    ("SDXL 32px FF out", 4096, 5120, 1280, True),
    ("SDXL cross k, v at 640 (no bias)", 308, 2048, 640, False),
    ("SDXL cross k, v at 1280 (no bias)", 308, 2048, 1280, False),
    ("SD 64px q, k, v (no bias)", 32768, 320, 320, False),
    ("SD 64px GEGLU in", 32768, 320, 2560, True),
    ("SD 64px FF out", 32768, 1280, 320, True),
    ("SD 32px GEGLU in", 8192, 640, 5120, True),
    ("SD 16px GEGLU in", 2048, 1280, 10240, True),
    ("SD 8px q, k, v (no bias)", 512, 1280, 1280, False),
    ("SD 8px GEGLU in", 512, 1280, 10240, True),
    ("SD 8px FF out", 512, 5120, 1280, True),
    ("SD cross k, v at 320 (no bias)", 616, 768, 320, False),
    ("SD cross k, v at 1280 (no bias)", 616, 768, 1280, False),
    ("VAE 512px mid attention", 16384, 512, 512, True),
    ("VAE 1024px mid attention, SD3", 32768, 512, 512, True),
    ("VAE 1024px mid attention, SDXL", 65536, 512, 512, True),
    ("ragged M, N and K", 1001, 1004, 300, True),
    ("ragged, no bias", 129, 36, 100, False),
]


def _w4_folded(n, k, g):
    """An (n, k) f32 weight as the cells hold one: N(0, 1/k), then W4 minmax
    per output channel, folded (the dequantized values)."""
    import torch

    w = torch.randn(n, k, generator=g, device="cuda") / k ** 0.5
    lo, hi = w.amin(1, keepdim=True), w.amax(1, keepdim=True)
    delta = (hi - lo) / 15
    zp = torch.round(-lo / delta)
    return (torch.clamp(torch.round(w / delta) + zp, 0, 15) - zp) * delta


def compare_linear_gemm(tag, summary):
    """`ops.linear_gemm`'s kernel at `LINEAR_SHAPES` (x N(0, 1), W4-folded
    weights, f32 bias N(0, 1)): its error and `F.linear`'s (TF32 off, as the
    cells run it) against the f64 product, the kernel's at most twice the
    library's; its output against the plain version (`linear_gemm_reference`,
    the three TF32 products in f32), within four times the library's error.
    Device-only ms of the kernel and of `F.linear` and the bias add it
    replaces (`library_ms`), the plain version's median ms, the 3xTF32 bound
    (2 M N K operations, three times, at 495 TFLOP/s) and the kernel's share
    of it, the f32 cores' bound (67 TFLOP/s), host us a call, and the plan."""
    import torch
    import torch.nn.functional as F
    from dgq_tpu_torch.ops import linear_gemm as LG

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for f32 products: the library yardstick would not be f32")
    g = torch.Generator(device="cuda").manual_seed(23)
    for label, m, k, n, has_bias in LINEAR_SHAPES:
        x = torch.randn(m, k, generator=g, device="cuda")
        w = _w4_folded(n, k, g)
        b = torch.randn(n, generator=g, device="cuda") if has_bias else None

        def kernel():
            return LG.linear_gemm(x, w, b)

        def library():
            y = F.linear(x, w)
            return y if b is None else y + b

        def plain():
            return LG.linear_gemm_reference(x, w, b)

        before = LG.LAUNCHES["linear_gemm"]
        out, lib, ref = kernel(), library(), plain()
        torch.cuda.synchronize()
        if LG.LAUNCHES["linear_gemm"] != before + 1 or not out.is_contiguous():
            raise AssertionError(f"linear_gemm {label}: no launch, or a strided output")
        exact = x.double() @ w.double().T + (0 if b is None else b.double())
        err, lib_err = (float((t.double() - exact).abs().max()) for t in (out, lib))
        plain_gap = float((out - ref).abs().max())
        # the rows no cell runs have K as short as 36, where the library adds
        # few terms and the kernel's rounding-toward-zero chain (12 adds) is
        # what is left: there 16 f32 ulps of the largest output bound it too
        room = 2 * lib_err
        if label.startswith("ragged"):
            room = max(room, 16 * 2.0 ** -23 * float(exact.abs().max()))
        if not bool(out.isfinite().all()) or err > room or plain_gap > 2 * room:
            raise AssertionError(f"linear_gemm {label}: error {err:.3g} against f64 (library "
                                 f"{lib_err:.3g}), {plain_gap:.3g} against the plain version")
        del out, exact, lib, ref
        ms, plain_ms = _median_ms(kernel), _median_ms(plain)
        dev, lib_dev = _device_ms(kernel), _device_ms(library)
        host, lib_host = _host_us(kernel), _host_us(library)
        flops = 2.0 * m * n * k
        bound = (1e3 * 3 * flops / PEAK_TF32_FLOPS, "operations")
        summary.add("linear_gemm", label, err, ms, plain_ms, bound, lib_dev, device_ms=dev)
        print(f"linear_gemm {label} (M {m}, K {k}, N {n}, {'bias' if b is not None else 'no bias'}"
              f", plan {tuple(LG.gemm_plan(m, n))}, `layers.linear` takes the kernel: "
              f"{LG.kernel_takes(x, w, b)}): max_abs_err against f64 {err:.3e}, library "
              f"{lib_err:.3e} ({err / lib_err:.2f}x), against the plain version {plain_gap:.3e}; "
              f"device-only ms {dev:.4f}, 3xTF32 bound {bound[0]:.4f} ({100 * bound[0] / dev:.1f}% "
              f"of it, {flops / dev / 1e9:.1f} TFLOP/s), f32 cores' bound "
              f"{1e3 * flops / PEAK_F32_FLOPS:.4f}; library (F.linear{' + b' if b is not None else ''}"
              f", TF32 off) {lib_dev:.4f} ({lib_dev / dev:.2f}x); plain median ms {plain_ms:.4f}; "
              f"median ms kernel {ms:.4f}; host us a call {host:.1f}, library {lib_host:.1f} | "
              f"{tag}", flush=True)
        del x, w, b
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


# the k x k convs of the int8_conv phase: (label, batch, height, C, O, stride);
# SD at its CFG batch 2 * IMAGES, SDXL-turbo at IMAGES
INT8_CONV_SHAPES = (
    ("SD 64px 320->320", 2 * IMAGES, 64, 320, 320, 1),
    ("SD down 64->32 320", 2 * IMAGES, 64, 320, 320, 2),
    ("SD down 32->16 640", 2 * IMAGES, 32, 640, 640, 2),
    ("SD down 16->8 1280", 2 * IMAGES, 16, 1280, 1280, 2),
    ("SD 8px 2560->1280", 2 * IMAGES, 8, 2560, 1280, 1),
    ("SDXL 128px 320->320", IMAGES, 128, 320, 320, 1),
    ("SDXL down 128->64 320", IMAGES, 128, 320, 320, 2),
    ("SDXL down 64->32 640", IMAGES, 64, 640, 640, 2),
)


def int8_conv(tag):
    """Phase 2c, the s8 conv (`use_int8_conv`, `models.layers._int8_conv`: the
    codes, an unfold from strided views and `torch._int_mm`, the f32
    correction; no hand-written kernel) at SD's and SDXL's k x k shapes, W4
    minmax codes, A8 in f32 and bf16 and A6 in f32 at the first two shapes.
    On the first image of each batch the card's codes, s32 accumulator and
    window sums equal the CPU port's (an exact float64 product) bit for bit,
    and its output is within one f32 ulp of the CPU's (bf16: one bf16 ulp).
    Timed in bf16 A8 at the full batch, device-only: the whole s8 conv, its
    unfold and product alone, and the fake-quant conv it replaces (the A8
    quantizer, then cuDNN's bf16 conv)."""
    import torch
    from dgq_tpu_torch.calib.weight_calib import quantize_model_weights
    from dgq_tpu_torch.models import layers as TL
    from dgq_tpu_torch.models.qconfig import QConfig
    from dgq_tpu_torch.quant.affine import QParams

    g = torch.Generator(device="cuda").manual_seed(11)

    def ulp(t):
        a = t.abs()
        return torch.nextafter(a, torch.full_like(a, float("inf"))) - a

    for i, (label, b, h, c, o, stride) in enumerate(INT8_CONV_SHAPES):
        spec = [("C", "conv", (c, o, 3, stride, 1))]
        params = {"C": {"w": 0.05 * torch.randn(o, c, 3, 3, generator=g, device="cuda"),
                        "b": torch.randn(o, generator=g, device="cuda")}}
        base = QConfig(w_bits=4, a_bits=8, use_wq=True, use_aq=True, use_int8_conv=True)
        pq, _ = quantize_model_weights(params, spec, base)
        x32 = torch.randn(b, h, h, c, generator=g, device="cuda")
        runs = [(8, torch.float32), (8, torch.bfloat16)] + ([(6, torch.float32)] if i < 2 else [])
        for a_bits, dtype in runs:
            cfg = base.replace(a_bits=a_bits)
            x = x32.to(dtype)
            lo, hi = float(x.float().min()), float(x.float().max())
            d = (hi - lo) / (2 ** a_bits - 1)
            qp = QParams(torch.tensor(d, device="cuda"),
                         torch.tensor(round(-lo / d), device="cuda"))
            p = {k: (v.to(dtype) if k in ("w", "b") else v) for k, v in pq["C"].items()}
            state = {"a": {"C": qp}, "sm": {}}
            codes, _ = TL.int8_conv_codes(x[:1], qp, a_bits, 1)
            acc, xsum = TL.int8_conv_acc(codes, p["w_q8c"], stride)
            out = TL.quant_conv2d(p, x[:1], "C", state, cfg, stride, 1)
            cpu = {k: v.cpu() for k, v in p.items()}
            qp_cpu = QParams(qp.delta.cpu(), qp.zero_point.cpu())
            codes_c, _ = TL.int8_conv_codes(x[:1].cpu(), qp_cpu, a_bits, 1)
            acc_c, xsum_c = TL.int8_conv_acc(codes_c, cpu["w_q8c"], stride)
            out_c = TL.quant_conv2d(cpu, x[:1].cpu(), "C", {"a": {"C": qp_cpu}, "sm": {}}, cfg,
                                    stride, 1)
            if not (torch.equal(codes.cpu(), codes_c) and torch.equal(acc.cpu(), acc_c)
                    and torch.equal(xsum.cpu(), xsum_c)):
                raise AssertionError(f"int8_conv {label} A{a_bits} {dtype}: the card's codes or "
                                     f"s32 accumulator differ from the CPU's")
            err = (out.cpu().float() - out_c.float()).abs()
            tol = ulp(out_c.float()) if dtype == torch.float32 else 2.0 ** -7 * out_c.float().abs()
            if out.dtype != dtype or not bool((err <= tol).all()):
                raise AssertionError(f"int8_conv {label} A{a_bits} {dtype}: output off by "
                                     f"{float(err.max())}")
        # timing at the full batch, bf16 A8
        x = x32.bfloat16()
        p = {k: (v.bfloat16() if k in ("w", "b") else v) for k, v in pq["C"].items()}
        lo, hi = float(x.float().min()), float(x.float().max())
        d = (hi - lo) / 255
        state = {"a": {"C": QParams(torch.tensor(d, device="cuda"),
                                    torch.tensor(round(-lo / d), device="cuda"))}, "sm": {}}
        on, off = base, base.replace(use_int8_conv=False)
        codes, _ = TL.int8_conv_codes(x, state["a"]["C"], 8, 1)
        y_on = TL.quant_conv2d(p, x, "C", state, on, stride, 1)
        y_off = TL.quant_conv2d(p, x, "C", state, off, stride, 1)
        # the fake-quant conv runs in bf16: the two agree to its rounding
        rel = float((y_on.float() - y_off.float()).norm() / y_off.float().norm())
        if not rel < 1e-2:
            raise AssertionError(f"int8_conv {label}: {rel} from the fake-quant conv")
        ms_on = _device_ms(lambda: TL.quant_conv2d(p, x, "C", state, on, stride, 1))
        ms_mm = _device_ms(lambda: TL.int8_conv_acc(codes, p["w_q8c"], stride))
        ms_off = _device_ms(lambda: TL.quant_conv2d(p, x, "C", state, off, stride, 1))
        ho = (h + 2 - 3) // stride + 1
        ops = 2.0 * b * ho * ho * o * 9 * c
        nbytes = 2.0 * b * h * h * c + 9.0 * c * o + 2.0 * b * ho * ho * o  # x, codes, y once
        bound = _bound(ops, nbytes, PEAK_INT8_OPS)
        print(f"int8_conv {label} (B={b}, {h}x{h}, C={c}, O={o}, stride {stride}; M={b * ho * ho} "
              f"K={9 * c} N={o}): card against CPU, first image: codes, s32 accumulator and "
              f"window sums equal; output within one f32 ulp (bf16: one bf16 ulp) at A8 f32, A8 "
              f"bf16{', A6 f32' if i < 2 else ''}; bf16 A8 against the bf16 fake-quant conv "
              f"{rel:.3g} relative; device ms: s8 conv {ms_on:.4f} (unfold + torch._int_mm "
              f"{ms_mm:.4f}), fake-quant conv (quantizer + cuDNN bf16) {ms_off:.4f}; bound of "
              f"the int8 conv {bound[0]:.4f} ({bound[1]}) | {tag}", flush=True)
    torch.cuda.empty_cache()


# calls of the s8 conv (`models.layers._int8_conv`, a library product, no
# hand-written kernel), counted beside the kernels' launches under this key by
# `_count_int8_convs`; it is no kernel of the `kernels` record
INT8_CONV_CALLS = {"int8_conv": 0}


def _count_int8_convs():
    """Wrap `models.layers._int8_conv` so that each call adds one to
    INT8_CONV_CALLS (quant_conv2d looks the name up at each call)."""
    from dgq_tpu_torch.models import layers

    real = layers._int8_conv

    def counted(*args, **kwargs):
        INT8_CONV_CALLS["int8_conv"] += 1
        return real(*args, **kwargs)
    layers._int8_conv = counted


def _launch_counts():
    from dgq_tpu_torch.ops import attention as A, fake_quant as FQ, group_conv as G
    from dgq_tpu_torch.ops import int8_matmul as M8, linear_gemm as LG

    return {**A.LAUNCHES, **G.LAUNCHES, **M8.LAUNCHES, **FQ.LAUNCHES, **LG.LAUNCHES,
            **INT8_CONV_CALLS}


def _reset_launch_counts():
    from dgq_tpu_torch.ops import attention as A, fake_quant as FQ, group_conv as G
    from dgq_tpu_torch.ops import int8_matmul as M8, linear_gemm as LG

    A.reset_launch_counts()
    G.reset_launch_counts()
    M8.reset_launch_counts()
    FQ.reset_launch_counts()
    LG.reset_launch_counts()
    INT8_CONV_CALLS["int8_conv"] = 0


# the activation fake quantizer's counts in `_launch_counts`: its kernel's
# launches, and the card's quantizers `aq_apply` sent to the plain chain
FQ_COUNTS = ("fake_quant", "fake_quant_plain")
# the f32 linears' counts: the GEMM's launches, and the card's f32 linears
# `layers.linear` left to the library (printed with every path's launches;
# how many a path runs follows its shapes, not a kernel flag)
LINEAR_COUNTS = ("linear_gemm", "linear_library")


# K3b's launches that ran body (f) (also counted under rt_stats and
# quant_accum): how many a path runs follows its shapes, printed as a share
K3B_COUNTS = ("k3b_tma",)


def _kernels_only(launches):
    """`launches` without the fake quantizer's counts, which
    `_check_fake_quant` holds apart, the f32 linears' and body (f)'s."""
    return {n: c for n, c in launches.items()
            if n not in FQ_COUNTS + LINEAR_COUNTS + K3B_COUNTS}


def _k3b_share(launches):
    """Body (f)'s share of the classic K3b launches in `launches`."""
    k3b = launches.get("rt_stats", 0) + launches.get("quant_accum", 0)
    return (f"body (f) {launches.get('k3b_tma', 0)} of {k3b} K3b launches"
            + (f" ({launches.get('k3b_tma', 0) / k3b:.3f})" if k3b else ""))


def _param_dtype(qstate):
    """The dtype of the activation quantizers' deltas in `qstate` (f32 where
    it has none)."""
    import torch
    from dgq_tpu_torch.quant.affine import QParams

    a = (qstate or {}).get("a", {})
    return next((p.delta.dtype for p in a.values() if isinstance(p, QParams)), torch.float32)


def _check_fake_quant(label, launches, param_dtype):
    """The fake quantizer's counts on a path that takes no gradient: with f32
    parameters every `aq_apply` quantizer on the card launches the kernel and
    none takes the chain; `ops.fake_quant.kernel_rule` refuses bf16
    parameters (the bf16 deploy form's synthetic state), so there the
    kernel must not run."""
    import torch

    kernel, chain = (launches.get(n, 0) for n in FQ_COUNTS)
    if chain if param_dtype == torch.float32 else kernel:
        raise AssertionError(f"{label}: {kernel} fake_quant launches, {chain} quantizers on the "
                             f"chain under {param_dtype} parameters")


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


def _tiny_forward(apply, inputs, p, xx, qs, cfg, dev):
    """A tiny UNet forward of small_input_reference: `apply` on latents xx
    and the fixed `inputs` after them, on `dev`."""
    return apply(p, xx.to(dev), *(v.to(dev) for v in inputs), qstate=qs, cfg=cfg)


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

    # module-level forwards with their inputs bound: the references are
    # computed in a process of their own and sent back
    sd = functools.partial(_tiny_forward, unet_sd_apply, (t, ehs))
    sdxl = functools.partial(_tiny_forward, unet_sdxl_apply, (t, ehs, te, tid))

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
            _check_fake_quant(f"tiny UNet {label}", launched, _param_dtype(qs))
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
    """W4 minmax fold with the int8 codes beside it (the matmul's 'w_q8' and the
    k x k convs' 'w_q8c'), then the attention heads
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
                                                               use_int8_matmul=True,
                                                               use_int8_conv=True))
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


def _n_int8_convs(spec):
    """k x k convs a forward sends to the s8 conv: every one but conv_in and
    conv_out (excluded under disable_out_quant), none of them a group conv:
    50 of SD v1.4's 52 and 38 of SDXL-turbo's 40."""
    return sum(k == "conv" and m[2] > 1 and n not in ("conv_in", "conv_out") for n, k, m in spec)


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
    for name, got in _kernels_only(launches).items():
        want = expect.get(name, 0)
        if (want is None and got < 1) or (want is not None and got != want):
            raise AssertionError(f"{label}: {name} ran {got} times, expected "
                                 f"{'at least once' if want is None else want}")
    _check_fake_quant(label, launches, _param_dtype(qstate))
    if tuple(images.shape) != (IMAGES, 512, 512, 3) or not bool(images.isfinite().all()):
        raise AssertionError(f"{label}: bad images {tuple(images.shape)}")
    if not bool(lat.isfinite().all()) or float(images.float().std()) == 0.0:
        raise AssertionError(f"{label}: degenerate output")
    shown = {n: c for n, c in launches.items() if c}
    print(f"{label}: {IMAGES} images 512px, {steps} DDIM steps CFG 7.5 bf16: sampling "
          f"{t1 - t0:.4f} s ({(t1 - t0) / steps:.4f} s per step = one UNet forward at batch "
          f"{2 * IMAGES}), VAE decode {t2 - t1:.4f} s, {(t2 - t0) / IMAGES:.4f} s per image; "
          f"launches {shown}; a UNet forward: fake_quant {launches['fake_quant'] / steps:g}, "
          f"fake_quant_plain {launches['fake_quant_plain'] / steps:g}; {_k3b_share(launches)} "
          f"| {tag}", flush=True)
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
    want = {"int8_matmul": n_int8 * STEPS_INT8, "static_uniform_attention": n_attn * STEPS_INT8,
            "flash_attention": 1}
    i8 = drive_path(model, "g=1 int8 path (use_int8_matmul)", qstate, cfg, STEPS_INT8, want, tag)
    # 4d': and every k x k conv in real int8 (use_int8_conv, the library s8 conv)
    n_conv = _n_int8_convs(spec)
    if n_conv != 50 or sum("w_q8c" in p for p in model["params"].values()) != n_conv:
        raise AssertionError(f"SD v1.4: {n_conv} k x k int8 convs a forward, expected 50")
    i8c = drive_path(model, f"int8_conv: g=1 int8 path + use_int8_conv ({n_conv} s8 convs a "
                     f"forward)", qstate, cfg.replace(use_int8_conv=True), STEPS_INT8,
                     {**want, "int8_conv": n_conv * STEPS_INT8}, tag)
    print(f"int8_conv: SD v1.4 g=1 int8 path, {STEPS_INT8} steps: use_int8_conv on "
          f"{i8c['s'][0]:.4f} s per step, {i8c['s'][1]:.4f} s per image; off {i8['s'][0]:.4f} s "
          f"per step, {i8['s'][1]:.4f} s per image | {tag}", flush=True)
    return {"s_4a": g1["s"][0],  # s a forward of 4a's g=1 path, for dp_path (r)
            "static_uniform_attention": g1["static_uniform_attention"],
            "flash_attention": k2["flash_attention"], "rt_stats": g8["rt_stats"],
            "quant_accum": g8["quant_accum"], "group_quant_conv": g8["group_quant_conv"],
            "static_quant_attention": k4["static_quant_attention"],
            "static_uniform_attention_packed": g1p["static_uniform_attention_packed"],
            "flash_attention_packed": k2p["flash_attention_packed"],
            "rt_stats_packed": g8p["rt_stats_packed"],
            "quant_accum_packed": g8p["quant_accum_packed"],
            "static_quant_attention_packed": k4p["static_quant_attention_packed"]}


def _expect_launches(label, expect, param_dtype=None):
    """Check the launch counts since the last reset and return them:
    `expect` maps a kernel to its exact count; a kernel it does not name
    must not have run. The fake quantizer's counts are held by
    `_check_fake_quant` under `param_dtype` (f32 unless given)."""
    import torch

    launches = _launch_counts()
    for name, got in _kernels_only(launches).items():
        if got != expect.get(name, 0):
            raise AssertionError(f"{label}: {name} ran {got} times, expected "
                                 f"{expect.get(name, 0)}")
    _check_fake_quant(label, launches, param_dtype or torch.float32)
    return launches


def _scaled_slots(qstate, t_slots):
    """act_0 ... act_{T-1}: `qstate` with every delta scaled by 1 + t/T in
    slot t, so that a slot read back in the wrong place shows."""
    import torch
    from dgq_tpu_torch.models.qconfig import GroupQParams
    from dgq_tpu_torch.quant.affine import QParams

    def leaf(v, s):
        if isinstance(v, GroupQParams):
            return GroupQParams(v.delta_mid * s, v.zp_mid, v.delta_last, v.zp_last)
        if isinstance(v, QParams):
            return QParams(v.delta * s, v.zero_point)
        return torch.clamp(v * s, max=1.0)  # a log2 delta: at most 1
    return {f"act_{t}": {k: {n: leaf(v, 1.0 + t / t_slots) for n, v in sub.items()}
                         for k, sub in qstate.items()} for t in range(t_slots)}


def _assert_round_trip(label, path, spec, params, wqp, per_t, group_layers, tag, alphas=None):
    """load_merged of `path` on the card gives `params`, `wqp` (None for an
    activation checkpoint), the learned offsets `alphas` (none in the file
    when None) and every slot's qstate bit for bit, and the group layers.
    Returns its seconds."""
    import os

    import torch
    from dgq_tpu_torch.io.dgq_ckpt import load_merged

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p2, w2, al2, pt2, gl2 = load_merged(path, spec, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    alphas, al2 = alphas or {}, al2 or {}
    same = (set(al2) == set(alphas) and all(torch.equal(a, al2[n]) for n, a in alphas.items())
            and gl2 == tuple(group_layers) and set(pt2) == set(per_t))
    if params is None:  # an activation checkpoint: no weights in it
        same = same and p2 is None and w2 is None
        params = wqp = p2 = w2 = {}
    same = same and set(w2) == set(wqp) and set(p2) == set(params)
    same = same and all(torch.equal(a, p2[n][k]) for n, p in params.items()
                        for k, a in p.items() if a is not None)
    same = same and all(torch.equal(qp.delta, w2[n].delta)
                        and torch.equal(qp.zero_point, w2[n].zero_point) for n, qp in wqp.items())
    for key, qs in per_t.items():
        for sub in ("a", "sm"):
            same = same and set(qs[sub]) == set(pt2[key][sub])
            for n, v in qs[sub].items():
                got = pt2[key][sub][n]
                fields = (("delta_mid", "zp_mid", "delta_last", "zp_last") if hasattr(
                    v, "delta_mid") else ("delta", "zero_point") if hasattr(v, "delta") else ())
                same = same and (all(torch.equal(getattr(v, f).float(), getattr(got, f))
                                     for f in fields) if fields else torch.equal(v.float(), got))
    del p2, w2, al2, pt2
    if not same:
        raise AssertionError(f"{label}: load_merged of {path} is not what was written")
    print(f"{label}: load_merged of {os.path.getsize(path) / 1e9:.3f} GB on the card {seconds:.2f} "
          f"s, params, wqp, {len(alphas)} layers' offsets and {len(per_t)} slots "
          f"bit for bit, {len(group_layers)} group layers | {tag}", flush=True)
    return seconds


# K2 in f32 at the CLIs' shapes: label, BH, T = S, D (SD v1.4 at 512px with
# CFG batch 4 x 8 heads, SDXL-turbo at 1024px with batch IMAGES x 10 / 20 heads,
# the VAE decoder's one head at 512px and 1024px)
F32_FLASH_SHAPES = [
    ("VAE mid-block 512px", IMAGES, 4096, 512),
    ("VAE mid-block 1024px", 1, 16384, 512),
    ("SD 64px self", 2 * IMAGES * 8, 4096, 40),
    ("SD 32px self", 2 * IMAGES * 8, 1024, 80),
    ("SD 16px self", 2 * IMAGES * 8, 256, 160),
    ("SDXL 64px self", IMAGES * 10, 4096, 64),
    ("SDXL 32px self", IMAGES * 20, 1024, 64),
]
# the quantizing modes' f32 shapes: label, BH, T, S, D (cross-attention takes start_peak)
F32_QUANT_SHAPES = [
    ("SD 64px self", 2 * IMAGES * 8, 4096, 4096, 40),
    ("SDXL 64px self", IMAGES * 10, 4096, 4096, 64),
    ("SD 16px self", 2 * IMAGES * 8, 256, 256, 160),
    ("SD 64px cross", 2 * IMAGES * 8, 4096, 77, 40),
]
PEAK_TF32_FLOPS = 495e12  # dense TF32 on the tensor cores (H100 SXM data sheet)


def _tf32_bound(flops, nbytes):
    """The least time (ms) of an f32 product formed from three TF32 products:
    three times the operations at the TF32 rate, or the bytes."""
    return _bound(3.0 * flops, nbytes, peak=PEAK_TF32_FLOPS)


def f32_bodies(tag):
    """The f32 kernel bodies that `cli_path`'s runs take (f32 activations),
    each against its plain version on the same inputs and timed device-only
    (`_device_ms`) beside the plain version's time. K2 / K2p and K5 run on the
    tensor cores as three TF32 products a product: K2 at `F32_FLASH_SHAPES`
    within `_check_f32`'s 1e-4, the packed entry bit for bit against it with
    zeros in its padding lanes, K5 at every shape of `CONV_SHAPES` within
    `_check_conv(bf16=False)` with the fold kernel's panels, rd and z equal
    to `fold_panels(_fold(...))`'s bit for bit; each line names its form,
    the bound at the TF32 rate (three products) and at the f32 rate outside
    the tensor cores, for K5, K1 and K4 the device ms of the first version's
    CUDA-core body (form 0, kept for their wider heads and longer codes) on
    the same inputs, and for K2 and K2p (SD and SDXL heads in slots of 64)
    `scaled_dot_product_attention` in f32 with TF32 off (a yardstick the port
    never calls). K1, K3b and K4 (log2, and uniform with
    start_peak) run on the tensor cores too, three TF32 products for Q K^T
    and two for P V, through their public wrappers at `F32_QUANT_SHAPES`, each
    launch checked to take that form: K1 within `_check_f32` with delta,
    quant_accum and K4 within `_check_share(bf16=False)`, rt_stats' z within
    1e-4 and its scalar within 1e-5 relative of the plain version's; at the
    first shape each packed entry over NaN and the element-load form on a
    misaligned q equal the unpacked 16-byte-load form bit for bit. Returns
    {case: device ms}."""
    import torch
    import torch.nn.functional as F
    from dgq_tpu_torch.ops import attention as A, group_conv as G
    from dgq_tpu_torch.ops.build import load_kernels

    lib = load_kernels()
    stream = lambda: torch.cuda.current_stream().cuda_stream
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(2)
    out = {}

    def line(name, label, form, err, dev, old_dev, plain_ms, flops, nbytes, extra=""):
        """old_dev: the CUDA-core body's device ms, None where it has none."""
        tf32, cores = _tf32_bound(flops, nbytes), _bound(flops, nbytes, peak=PEAK_F32_FLOPS)
        out[f"{name} {label}"] = dev
        old = "" if old_dev is None else f" (the CUDA-core body's {old_dev:.4f})"
        print(f"f32 {name} {label}, form {form}: max_abs_err {err:.4g}; device-only ms {dev:.4f}"
              f"{old}; bound {tf32[0]:.4f} at the TF32 rate, three products ({tf32[1]}; "
              f"{dev / tf32[0]:.2f}x), {cores[0]:.4f} at the f32 rate ({cores[1]}); plain "
              f"{plain_ms:.4f}{extra} | {tag}", flush=True)

    for label, bh, t, d in F32_FLASH_SHAPES:
        # scores of spread 4, but of spread 1/4 at 16384 keys (the softmax would
        # collapse onto one key)
        amp = 0.5 if t == 16384 else 2.0
        q, k = (amp * torch.randn(bh, t, d, generator=g, device="cuda") for _ in range(2))
        v = torch.randn(bh, t, d, generator=g, device="cuda")
        scale = d ** -0.5
        kernel = lambda: A.flash_attention(q, k, v, scale)
        plain = lambda: A.attention_reference(q, k, v, scale)
        form = A.flash_form(torch.float32, d, (q.data_ptr(), k.data_ptr(), v.data_ptr()),
                            (t * d, d) * 3)
        before = A.LAUNCHES["flash_attention"]
        got = kernel()
        torch.cuda.synchronize()
        if A.LAUNCHES["flash_attention"] != before + 1 or form != "tf32x3_vector":
            raise AssertionError(f"f32 flash_attention {label}: form {form}, no launch")
        err = _check_f32(got, plain(), v)[0]
        lib_err = float((F.scaled_dot_product_attention(q, k, v, scale=scale) - plain()).abs().max())
        extra = ""
        if d in (40, 64):
            # K2p: the same body over packed head slots of 64 lanes, bit for bit
            heads = 8 if d == 40 else 10 if t == 4096 else 20
            packed = [A.repack_heads(x, heads, 64) for x in (q, k, v)]
            buf = torch.full(packed[0].shape, float("nan"), device="cuda")
            got_p = A.flash_attention_packed(*packed, scale, heads, d, out=buf)
            torch.cuda.synchronize()
            if not (torch.equal(A.unpack_heads(got_p, heads, d), got)
                    and bool((got_p.reshape(*got_p.shape[:2], heads, 64)[..., d:] == 0).all())):
                raise AssertionError(f"f32 flash_attention_packed {label}: not K2's bits, or "
                                     f"padding lanes not zero")
            # K2p's time and the one PyTorch call for its function on the same strided views
            q4, k4, v4 = (x.reshape(bh // heads, t, heads, 64)[..., :d].transpose(1, 2)
                          for x in packed)
            p_dev = _device_ms(lambda: A.flash_attention_packed(*packed, scale, heads, d, out=buf))
            p_lib = _device_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale))
            extra += (f"; K2p (slots of 64, over NaN) equal bit for bit, zero padding lanes, "
                      f"device-only ms {p_dev:.4f}, scaled_dot_product_attention (f32, TF32 off) "
                      f"on the same strided views {p_lib:.4f}")
            del packed, buf, got_p, q4, k4, v4
        if label == "SD 64px self":
            odd = _misaligned(q)
            if not torch.equal(A.flash_attention(odd, k, v, scale), got):
                raise AssertionError(f"f32 flash_attention {label}: the element-load form differs")
            extra += "; misaligned q (tf32x3_plain) equal bit for bit"
            del odd
        flops = 4.0 * bh * t * t * d
        nbytes = 4.0 * 4 * q.numel()
        slow = t == 16384
        dev = _device_ms(kernel, calls=4 if slow else 16, reps=3 if slow else 5)
        lib_dev = _device_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                             calls=4 if slow else 16, reps=3 if slow else 5)
        plain_ms = _median_ms(plain, reps=3)
        extra += (f"; scaled_dot_product_attention (f32, TF32 off) device-only ms {lib_dev:.4f}, "
                  f"max_abs_err {lib_err:.4g}")
        line("flash_attention", label + f" (BH={bh}, T=S={t}, D={d})", form, err, dev, None,
             plain_ms, flops, nbytes, extra)
        del q, k, v, got
        torch.cuda.empty_cache()

    one, zero = torch.ones(1, device="cuda"), torch.zeros(1, device="cuda")
    b = 2 * IMAGES
    for label, h, c, o in CONV_SHAPES:  # inputs drawn as compare_group_conv draws them
        x = 2.0 * torch.randn(b, h, h, c, generator=g, device="cuda")
        w = (torch.randn(o, c, 3, 3, generator=g, device="cuda") / (9 * c) ** 0.5).permute(
            2, 3, 1, 0)
        dm = 0.03 + 0.04 * torch.rand(9, c, generator=g, device="cuda")
        zm = 100.0 + 56.0 * torch.rand(9, c, generator=g, device="cuda")
        bias = 0.1 * torch.randn(o, generator=g, device="cuda")
        conv = (x, w, dm, zm, one, zero, bias)
        form = G.conv_form(torch.float32, c, o, x.data_ptr())
        w_t, rd, z = G._fold(x, w, dm, zm, one, zero, 3, 3)
        if form == "tf32x3":
            got_f = G.fold_weights(torch.float32, w, dm, zm, one, zero, 3, 3, panels=True)
            want_f = (G.fold_panels(w_t), rd, z)
            what = "the fold kernel's panels, rd, z"
        else:
            got_f = G.fold_weights(torch.float32, w, dm, zm, one, zero, 3, 3)
            want_f = (w_t, rd, z)
            what = "the fold kernel's w_t, rd, z"
        if not all(torch.equal(mine, ref) for mine, ref in zip(got_f, want_f)):
            raise AssertionError(f"f32 group conv fold {label}: {what} differ from the plain fold")
        before = G.LAUNCHES["group_quant_conv"]
        got = G.group_quant_conv(*conv)
        torch.cuda.synchronize()
        if G.LAUNCHES["group_quant_conv"] != before + 1:
            raise AssertionError("f32 group_quant_conv did not launch its kernel")
        err = _check_conv(got, G.group_quant_conv_reference(*conv), bf16=False)
        if not torch.equal(got, G.group_quant_conv(*conv)):
            raise AssertionError(f"f32 group_quant_conv {label}: two runs differ")
        old_out = torch.empty_like(got)

        def old(conv=conv, old_out=old_out):  # the fold to w_t and body (b), form 0
            wt, r, zz = G.fold_weights(torch.float32, *conv[1:6], 3, 3)
            rc = lib.dgq_group_quant_conv(
                conv[0].data_ptr(), wt.data_ptr(), r.data_ptr(), zz.data_ptr(),
                conv[6].data_ptr(), old_out.data_ptr(), None, b, h, h, c, o, 3, 3, 1, 8, 0, 0, 1,
                1, stream())
            if rc:
                raise RuntimeError(f"the CUDA-core conv body failed: CUDA error {rc}")
        old()
        old_err = float((old_out - got).abs().max())
        plan = G.conv_plan(b * h * h, c, o, 9, torch.float32)
        how = (f"{form}" if form == "cuda_core" else
               f"{form}, {plan.m_tiles} x {plan.n_tiles} tiles, {plan.steps} K steps in "
               f"{plan.splits} split(s) of {plan.steps_per_split}")
        dev = _device_ms(lambda conv=conv: G.group_quant_conv(*conv))
        old_dev = _device_ms(old, calls=4, reps=3)
        plain_ms = _median_ms(lambda conv=conv: G.group_quant_conv_reference(*conv), reps=3)
        line("group_quant_conv", f"{label} (B={b}, H=W={h}, C={c}, O={o}, 3x3)", how, err, dev,
             old_dev, plain_ms, 2.0 * b * h * h * 9 * c * o,
             4.0 * (x.numel() + w.numel() + 2 * dm.numel() + o + b * h * h * o),
             f"; {what} equal bit for bit; the CUDA-core body's max |d| {old_err:.4g}; "
             f"library: none")
        del x, w, got, old_out, w_t

    # the quantizing modes on body (e) (3xTF32), each through its public wrapper; K1 and K4
    # beside body (b), form 0 of the same C entry, on the same inputs
    delta_u, half = torch.tensor(1.0 / 255.0, device="cuda"), torch.tensor(0.5, device="cuda")
    for label, bh, t, s, d in F32_QUANT_SHAPES:
        q = 2.0 * torch.randn(bh, t, d, generator=g, device="cuda")
        k = 2.0 * torch.randn(bh, s, d, generator=g, device="cuda")
        v = torch.randn(bh, s, d, generator=g, device="cuda")
        scale, qk = d ** -0.5, 2.0 * bh * t * s * d
        io = 4.0 * (2 * q.numel() + k.numel() + v.numel())
        sp = s == 77  # cross-attention takes start_peak, as the g=8 path does
        shape = f"{label} (BH={bh}, T={t}, S={s}, D={d})"
        form = A.quant_form(torch.float32, d, (q.data_ptr(), k.data_ptr(), v.data_ptr()),
                            (t * d, d, s * d, d, s * d, d))
        if form != "tf32x3_vector":
            raise AssertionError(f"f32 quantizing kernels {shape}: form {form}")
        z, red = A.rt_stats(q, k, scale, sp)
        buf_o = torch.empty_like(q)

        def c_call(name, *, static=None):  # body (b), form 0 of the same C entry (K1, K4)
            p = (q.data_ptr(), k.data_ptr())
            if name == "static_uniform_attention":
                rc = lib.dgq_uniform_attention(*p, v.data_ptr(), buf_o.data_ptr(), bh, t, s, d,
                                               scale, delta_u.data_ptr(), 8, 0, 0, stream())
            else:
                uni = static == "uniform"  # uniform codes go with start_peak
                rc = lib.dgq_static_quant_attention(*p, v.data_ptr(), buf_o.data_ptr(), bh, t, s,
                                                    d, scale, (delta_u if uni else half).data_ptr(),
                                                    8, int(uni), int(sp or uni), 0, 0, stream())
            if rc:
                raise RuntimeError(f"the CUDA-core {name} body failed: CUDA error {rc}")

        def rt_check(got, want):
            z_err = float((got[0] - want[0]).abs().max())
            red_rel = float(((got[1] - want[1]) / want[1]).abs())
            if not (z_err <= 1e-4 and red_rel <= 1e-5):
                raise AssertionError(f"f32 rt_stats {shape}: z err {z_err}, scalar rel {red_rel}")
            return z_err, f"; the scalar within {red_rel:.3g} relative"

        uni_sp = "uniform start_peak"
        cases = [  # name, quantizer, kernel, plain version, check -> (err, note), flops, bytes
            ("static_uniform_attention", "uniform", lambda: A.static_uniform_attention(
                q, k, v, scale, delta_u), lambda: A.attention_reference(
                q, k, v, scale, "uniform", 8, delta_u),
             lambda o, r: (_check_f32(o, r, v, 1 / 255)[0], ""), 2 * qk, io),
            ("rt_stats", "log2_real_time", lambda: A.rt_stats(q, k, scale, sp),
             lambda: A.rt_stats_reference(q, k, scale, sp), rt_check, qk,
             4.0 * (q.numel() + k.numel() + bh * t)),
            ("quant_accum", "log2_real_time", lambda: A.quant_accum(q, k, v, z, red, scale, 8, sp),
             lambda: A.attention_reference(q, k, v, scale, "log2", 8, A.rt_delta(red, sp), sp),
             lambda o, r: (_check_share(o, r, bf16=False)[0], ""), 2 * qk, io + 4.0 * bh * t),
            ("static_quant_attention", "log2", lambda: A.static_quant_attention(
                q, k, v, scale, "log2", half, 8, sp), lambda: A.attention_reference(
                q, k, v, scale, "log2", 8, half, sp),
             lambda o, r: (_check_share(o, r, bf16=False)[0], ""), 2 * qk, io),
            ("static_quant_attention", uni_sp, lambda: A.static_quant_attention(
                q, k, v, scale, "uniform", delta_u, 8, True), lambda: A.attention_reference(
                q, k, v, scale, "uniform", 8, delta_u, True),
             lambda o, r: (_check_share(o, r, bf16=False)[0], ""), 2 * qk, io),
        ]
        for name, quant, fn, plain, check, flops, nbytes in cases:
            before = A.LAUNCHES[name]
            got = fn()
            torch.cuda.synchronize()
            if A.LAUNCHES[name] != before + 1:
                raise AssertionError(f"f32 {name} {shape}: no launch")
            err, note = check(got, plain())
            static = {"log2": "log2", uni_sp: "uniform"}.get(quant)
            old = None  # K3b has no CUDA-core body
            if name in ("static_uniform_attention", "static_quant_attention"):
                old = lambda name=name, static=static: c_call(name, static=static)
                old()
                torch.cuda.synchronize()
                note += f"; the CUDA-core body's max |d| {float((buf_o - got).abs().max()):.4g}"
            if name != "rt_stats" and label == F32_QUANT_SHAPES[0][0]:
                # K1p to K4p: the packed entry over slots of 64 holding NaN, and the
                # element-load form on a misaligned q, bit for bit
                heads = 8
                qp, kp, vp = (A.repack_heads(x, heads, 64) for x in (q, k, v))
                kw = dict(sm_mode={"static_uniform_attention": "uniform",
                                   "quant_accum": "log2_real_time"}.get(name, static),
                          sm_bits=8, sm_delta=delta_u if static != "log2" else half,
                          start_peak=sp or static == "uniform")
                whole = A.fused_attention(q, k, v, scale, **kw)
                buf = torch.full(qp.shape, float("nan"), device="cuda")
                packed = A.fused_attention(qp, kp, vp, scale, num_heads=heads, head_dim=d,
                                           out=buf, **kw)
                odd = _misaligned(q)
                if A.quant_form(torch.float32, d, (odd.data_ptr(),), (t * d, d)) != "tf32x3_plain":
                    raise AssertionError(f"f32 {name} {shape}: a misaligned q took 16-byte loads")
                if not (torch.equal(A.unpack_heads(packed, heads, d), whole)
                        and bool((packed.reshape(bh // heads, t, heads, 64)[..., d:] == 0).all())
                        and torch.equal(A.fused_attention(odd, k, v, scale, **kw), whole)):
                    raise AssertionError(f"f32 {name} {quant} {shape}: the packed entry or the "
                                         f"element-load form differs")
                note += ("; packed entry (slots of 64, over NaN) and misaligned q (tf32x3_plain) "
                         "equal bit for bit")
                del qp, kp, vp, buf, packed, odd, whole
            if name == "rt_stats" and label == F32_QUANT_SHAPES[0][0]:
                odd = _misaligned(q)
                zp, redp = A.rt_stats_packed(*(A.repack_heads(x, 8, 64) for x in (q, k)), scale,
                                             8, d, sp)
                if not all(torch.equal(a, b) for a, b in zip(A.rt_stats(odd, k, scale, sp), got)):
                    raise AssertionError(f"f32 rt_stats {shape}: the element-load form differs")
                if not (torch.equal(zp, got[0]) and torch.equal(redp, got[1])):
                    raise AssertionError(f"f32 rt_stats_packed {shape}: differs from rt_stats")
                note += "; packed entry and misaligned q (tf32x3_plain) equal bit for bit"
                del odd, zp, redp
            dev = _device_ms(fn)
            old_dev = None if old is None else _device_ms(old, calls=4, reps=3)
            plain_ms = _median_ms(plain, reps=3)
            exps = {"rt_stats": 1, "quant_accum": 0}.get(name, 2) * bh * t * s  # a score each pass
            extra = f"{note}; exponent-unit floor {_exp_floor(exps):.4f}; library: none"
            line(name, f"{quant} {shape}", form, err, dev, old_dev, plain_ms, flops, nbytes, extra)
        del q, k, v, z, red, buf_o
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = saved
    return out


# K3b's shapes in the generation cells (label, BH, T = S, D): SD3's joint
# attention (a call's 96 heads), SDXL-turbo's 32px and 64px self-attention at
# batch 4, SD's 64px self-attention at CFG batch 8
K3B_TMA_SHAPES = [
    ("SD3 joint", 96, 4429, 64),
    ("SDXL 32px self", 80, 1024, 64),
    ("SDXL 64px self", 40, 4096, 64),
    ("SD 64px self", 64, 4096, 40),
]


def k3b_bodies(tag):
    """K3b's f32 pair (rt_stats + quant_accum under start_peak, as the cells
    run it) at `K3B_TMA_SHAPES` through the same C entries: body (f) (form 5,
    where `k3b_form` routes these calls) against body (e) (form 3), bit for
    bit (z, the call's scalar, the output); each body's device-only ms a
    launch; the pair's share of its 3xTF32 bound (16 BH T S D operations at
    495 TFLOP/s: Q K^T as three TF32 products in each launch, P V as two) and
    of the model's bound that `k3b_roofline` counts (4 BH T S D); the plain
    version's median ms (`rt_stats_reference`, then the log2
    `attention_reference`, eight heads at a time). Returns {label: (body (e)
    ms, body (f) ms)} for the pair."""
    import torch
    from dgq_tpu_torch.ops import attention as A
    from dgq_tpu_torch.ops.build import load_kernels

    lib = load_kernels()
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(25)
    out = {}
    for label, bh, t, d in K3B_TMA_SHAPES:
        q = 2.0 * torch.randn(bh, t, d, generator=g, device="cuda")
        k = 2.0 * torch.randn(bh, t, d, generator=g, device="cuda")
        v = torch.randn(bh, t, d, generator=g, device="cuda")
        scale = d ** -0.5
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
        if A.k3b_form(torch.float32, d, t, ptrs, (t * d, d) * 3) != "tf32x3_tma":
            raise AssertionError(f"K3b {label}: not routed to body (f)")
        z, red, o = torch.empty(bh, t, device="cuda"), torch.zeros(1, device="cuda"), torch.empty_like(q)

        def stats(form):
            red.zero_()  # under start_peak the scalar folds a max from 0
            rc = lib.dgq_rt_stats(q.data_ptr(), k.data_ptr(), z.data_ptr(), red.data_ptr(), bh, t,
                                  t, d, scale, 1, 0, form, stream)
            if rc:
                raise RuntimeError(f"rt_stats form {form}: CUDA error {rc}")

        def accum(form):
            rc = lib.dgq_quant_accum(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                     z.data_ptr(), red.data_ptr(), bh, t, t, d, scale, 8, 1, 0,
                                     form, stream)
            if rc:
                raise RuntimeError(f"quant_accum form {form}: CUDA error {rc}")

        got = {}
        for form in (3, 5):
            stats(form)
            zr = (z.clone(), red.clone())
            accum(form)
            torch.cuda.synchronize()
            got[form] = (*zr, o.clone())
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got[3], got[5])):
            raise AssertionError(f"K3b {label}: body (f) differs from body (e)")
        del got

        def plain():
            for i in range(0, bh, 8):
                _, r = A.rt_stats_reference(q[i:i + 8], k[i:i + 8], scale, True)
                A.attention_reference(q[i:i + 8], k[i:i + 8], v[i:i + 8], scale, "log2", 8,
                                      A.rt_delta(r, True), True)

        ms = {(form, fn.__name__): _device_ms(lambda fn=fn, form=form: fn(form), calls=4, reps=3)
              for form in (3, 5) for fn in (stats, accum)}
        e, f = (ms[(form, "stats")] + ms[(form, "accum")] for form in (3, 5))
        plain_ms = _median_ms(plain, reps=3)
        flops = 4.0 * bh * t * t * d
        tf32 = 1e3 * 4 * flops / PEAK_TF32_FLOPS
        model = 1e3 * flops / PEAK_TF32_FLOPS
        out[label] = (e, f)
        print(f"K3b f32 pair {label} (BH={bh}, T=S={t}, D={d}, start_peak): body (e) rt_stats "
              f"{ms[(3, 'stats')]:.4f} + quant_accum {ms[(3, 'accum')]:.4f} = {e:.4f} device-only "
              f"ms; body (f) {ms[(5, 'stats')]:.4f} + {ms[(5, 'accum')]:.4f} = {f:.4f} ({e / f:.2f}x)"
              f", its bits; 3xTF32 bound {tf32:.4f} (body (e) {100 * tf32 / e:.1f}%, body (f) "
              f"{100 * tf32 / f:.1f}%); model bound {model:.4f} (body (f) {100 * model / f:.2f}%, "
              f"body (e) {100 * model / e:.2f}%); plain {plain_ms:.4f} | {tag}", flush=True)
        del q, k, v, z, red, o
        torch.cuda.empty_cache()
    return out


def text_encoders_full_width(tag):
    """The CLIP text encoders at full width, card against CPU in f32 (TF32
    off): CLIP-L (12 layers, 768 wide) through clip_text_encode, the bigG
    WithProjection (32 layers, 1280 wide, proj 1280) through clip_text_pooled,
    and both through sdxl_encode_prompt, on seeded token ids where one row
    holds an EOS id and the other none (the argmax fallback). Bound:
    1e-4 * max|ref|."""
    import numpy as np
    import torch
    from dgq_tpu_torch.pipeline.text_encoder import (clip_text_encode, clip_text_pooled,
                                                     init_clip_text, sdxl_encode_prompt)

    eos = 49407
    g = torch.Generator(device="cuda").manual_seed(0)
    enc_l = init_clip_text(g, "cuda")
    enc_g = init_clip_text(g, "cuda", width=1280, layers=32, proj_dim=1280)
    sizes = [sum(v.numel() for x in p.values() for v in (x.values() if isinstance(x, dict)
                                                         else [x])) for p in (enc_l, enc_g)]
    rng = np.random.RandomState(0)
    ids = rng.randint(0, eos, size=(2, 77))
    ids[0, 12:] = eos  # a prompt of 11 tokens padded with EOS; row 1 has none
    ids = torch.from_numpy(ids)
    cpu_l = {k: _to_cpu(v) for k, v in enc_l.items()}
    cpu_g = {k: _to_cpu(v) for k, v in enc_g.items()}
    runs = {
        "CLIP-L clip_text_encode": lambda p_l, p_g, i: clip_text_encode(p_l, i),
        "bigG clip_text_pooled": lambda p_l, p_g, i: clip_text_pooled(
            p_g, i, num_layers=32, num_heads=20, eos_id=eos),
        "sdxl_encode_prompt": lambda p_l, p_g, i: torch.cat([t.reshape(2, -1) for t in (
            sdxl_encode_prompt(p_l, p_g, i, i, layers_g=32, heads_g=20, eos_id=eos))], 1),
    }
    saved_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for label, fn in runs.items():
            fn(enc_l, enc_g, ids.cuda())  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(enc_l, enc_g, ids.cuda())
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            ref = fn(cpu_l, cpu_g, ids)
            err = float((out.cpu() - ref).abs().max())
            bound = 1e-4 * float(ref.abs().max())
            print(f"text encoders {label} {tuple(out.shape)}: card {seconds:.4f} s, card vs CPU "
                  f"max_abs_err {err:.6g} (bound {bound:.6g}) | {tag}", flush=True)
            if not (err <= bound and bool(out.isfinite().all())):
                raise AssertionError(f"text encoders {label}: card and CPU disagree")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved_tf32
    print(f"text encoders: CLIP-L {sizes[0]} params, bigG with projection {sizes[1]} params "
          f"| {tag}", flush=True)


def _to_cpu(v):
    return {k: x.cpu() for k, x in v.items()} if isinstance(v, dict) else v.cpu()


def cli_path(tag):
    """Phase 5: the inference entry point from local files at full width.
    SD v1.4 f32 weights, minmax W4 qparams, STEPS_CLI slots of g=8 group,
    g=1 per-tensor (uniform softmax) and static-log2 (delta-only `sm`)
    activation states, and an HF-named VAE decoder state dict, all drawn on
    the card from seed 0 and written through the port's writers into a
    temporary directory under build/ (the g=1 file by `ckpt_tools merge` as a
    command); each file read back bit for bit, then `cli.infer.main` in this
    process on it (--fp16: bf16 weights under f32 activations, as the JAX CLI
    runs): (a) the README's command, (b) (a) with --pallas_attn --group_impl
    fused, (c) g=1 with --pallas_attn, (d) static log2 with --pallas_attn.
    Between (b) and (c), three witnesses of the gap between (a)'s and (b)'s
    quantized latents: (a') (a) on initial latents moved by 1e-6 (the chaos
    of the trajectory), (b1) only --pallas_attn, (b2) only --group_impl
    fused; the gap of each to (a) is printed for the first UNet forward
    (same inputs) and the final latents, and the kernel runs' first forward
    must stay within 5x (a')'s. Each run's kernel launches are exact (the
    f32 kernel bodies these runs take are timed apart, `f32_bodies`).
    Returns the launch counts of the runs, by run."""
    import os
    import shutil
    import sys
    import tempfile

    import numpy as np
    import torch
    from dgq_tpu_torch.calib.act_calib import attention_prefixes, softmax_qpoint_names
    from dgq_tpu_torch.calib.weight_calib import init_weight_qparams
    from dgq_tpu_torch.cli import infer
    from dgq_tpu_torch.io import dgq_ckpt
    from dgq_tpu_torch.io.convert import params_to_torch_unet
    from dgq_tpu_torch.models.unet_sd import init_unet_sd, quantizable_layers, sd_unet_spec
    from dgq_tpu_torch.ops.attention import flash_form, quant_form
    from dgq_tpu_torch.ops.group_conv import conv_form
    from dgq_tpu_torch.pipeline import sd_pipeline
    from dgq_tpu_torch.pipeline.schedulers import make_pndm
    from dgq_tpu_torch.pipeline.vae import init_vae_decoder, vae_decoder_spec
    from dgq_tpu_torch.utils.synthetic import synthetic_group_qstate, synthetic_pertensor_qstate

    f32 = torch.float32
    spec = sd_unet_spec()
    g = torch.Generator(device="cuda").manual_seed(0)
    params = init_unet_sd(g, "cuda", f32, spec)
    n_params = sum(v.numel() for p in params.values() for v in p.values() if v is not None)
    n_attn = len(attention_prefixes(spec))
    if n_params != 859_520_964 or len(quantizable_layers(spec)) != 282 or n_attn != 32:
        raise AssertionError(f"SD v1.4 has {n_params} params")
    wqp = init_weight_qparams(params, spec, 4)
    g8, group_layers = synthetic_group_qstate(spec, 0, False, f32, device="cuda")
    g8 = _scaled_slots(g8, STEPS_CLI)
    g1 = _scaled_slots(synthetic_pertensor_qstate(spec, 0, False, f32, device="cuda"), STEPS_CLI)
    sm_names = softmax_qpoint_names(spec)
    log2 = synthetic_pertensor_qstate(spec, 0, False, f32, device="cuda")
    log2 = _scaled_slots({"a": {n: v for n, v in log2["a"].items() if n not in sm_names},
                          "sm": {n: torch.tensor(0.5, device="cuda") for n in sm_names}},
                         STEPS_CLI)
    stride = {n: m[3] for n, k, m in spec if k == "conv"}
    n_fused = sum(stride[n] == 1 for n in group_layers)
    forwards = len(make_pndm(STEPS_CLI).timesteps)  # PNDM: one more UNet call than steps

    # the checkpoints go under the checkout's build/ (gitignored), which holds
    # two full-width f32 files at once
    tmp_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(tmp_root, exist_ok=True)
    print(f"cli_path: {shutil.disk_usage(tmp_root).free / 2 ** 30:.1f} GiB free under "
          f"{tmp_root} | {tag}", flush=True)
    taps = []
    real_sample = sd_pipeline.sd_sample
    real_latents = sd_pipeline.SDPipeline._initial_latents

    def tapped_sample(*args, **kwargs):  # keeps the final latents, the first eps, the time
        apply, first = kwargs["unet_apply"], []

        def first_eps(*a, **k):
            eps = apply(*a, **k)
            if not first:
                first.append(eps.clone())
            return eps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = real_sample(*args, **{**kwargs, "unet_apply": first_eps})
        torch.cuda.synchronize()
        taps.append((x.clone(), time.perf_counter() - t0, first[0]))
        return x

    def perturbed_latents(self, *args):  # the chaos witness: 1e-6 noise on the initial latents
        x = real_latents(self, *args)
        gp = torch.Generator(device=x.device).manual_seed(1)
        return x + 1e-6 * torch.randn(x.shape, generator=gp, device=x.device)

    def timed(label, fn, path):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        seconds = time.perf_counter() - t0
        print(f"{label}: {seconds:.2f} s, {os.path.getsize(path) / 1e9:.3f} GB | {tag}",
              flush=True)

    results = {}
    with tempfile.TemporaryDirectory(dir=tmp_root) as tmp:
        vae_dir = os.path.join(tmp, "vae")
        os.makedirs(vae_dir)
        vae_path = os.path.join(vae_dir, "diffusion_pytorch_model.bin")
        vae = init_vae_decoder(g, "cuda")
        timed("write the VAE decoder (HF names, OIHW)", lambda: torch.save(
            params_to_torch_unet(vae, vae_decoder_spec()), vae_path), vae_path)
        del vae
        common = ["--model", "sd", "--fp16", "--vae_weights", vae_dir, "--num_inference_steps",
                  str(STEPS_CLI), "--time_aware_aqtizer", "--use_aq", "--outdir", tmp]
        readme = ["--use_group", "--t2i_log_quant", "--t2i_real_time", "--t2i_start_peak"]
        k3b = {"rt_stats": n_attn * forwards, "quant_accum": n_attn * forwards}
        k5 = {"group_quant_conv": n_fused * forwards}
        witness = "(a') (a) on initial latents moved by 1e-6"
        runs = [
            ("g8", "(a) the README's command", readme, {"flash_attention": 2}),
            ("g8", "(b) README + --pallas_attn --group_impl fused",
             readme + ["--pallas_attn", "--group_impl", "fused"],
             {"flash_attention": 2, **k3b, **k5}),
            # witnesses of the (a)/(b) gap: the chaos of (a), and each kernel alone
            ("g8", witness, readme, {"flash_attention": 2}),
            ("g8", "(b1) README + --pallas_attn", readme + ["--pallas_attn"],
             {"flash_attention": 2, **k3b}),
            ("g8", "(b2) README + --group_impl fused", readme + ["--group_impl", "fused"],
             {"flash_attention": 2, **k5}),
            ("g1", "(c) g=1 --pallas_attn", ["--pallas_attn"],
             {"flash_attention": 2, "static_uniform_attention": n_attn * forwards}),
            ("log2", "(d) static log2 --t2i_log_quant --pallas_attn",
             ["--t2i_log_quant", "--pallas_attn"],
             {"flash_attention": 2, "static_quant_attention": n_attn * forwards}),
        ]
        files = {}
        sd_pipeline.sd_sample = tapped_sample
        try:
            for state, label, flags, expect in runs:
                if state not in files:
                    for old in files.values():
                        os.remove(old)
                    files.clear()
                    if state == "g8":
                        path = os.path.join(tmp, "sd_w4a8g8.pth")
                        per_t, gl = g8, group_layers
                        timed("write the g=8 merged checkpoint (save_merged)",
                              lambda: dgq_ckpt.save_merged(path, params, wqp, spec, per_t), path)
                    elif state == "g1":
                        path = os.path.join(tmp, "sd_w4a8g1.pth")
                        per_t, gl = g1, ()
                        wpath = os.path.join(tmp, "cali_ckpt.pth_weight_only")
                        apath = os.path.join(tmp, "cali_ckpt_activation_w4a8g1.pth")
                        timed("write the weight-only checkpoint (save_weight_only)",
                              lambda: dgq_ckpt.save_weight_only(wpath, params, wqp, spec), wpath)
                        timed("write the g=1 activation checkpoint (save_act_ckpt)",
                              lambda: dgq_ckpt.save_act_ckpt(apath, per_t, spec), apath)
                        timed("python -m dgq_tpu_torch.cli.ckpt_tools merge", lambda: subprocess.run(
                            [sys.executable, "-m", "dgq_tpu_torch.cli.ckpt_tools", "merge", wpath,
                             apath, path], check=True, capture_output=True,
                            cwd=os.path.dirname(os.path.abspath(__file__))), path)
                        os.remove(wpath)
                    else:
                        path = os.path.join(tmp, "sd_w4a8g1_log2.pth")
                        per_t, gl = log2, ()
                        timed("write the static-log2 merged checkpoint (save_merged)",
                              lambda: dgq_ckpt.save_merged(path, params, wqp, spec, per_t), path)
                    files[state] = path
                    _assert_round_trip(f"{state} checkpoint", path, spec, params, wqp, per_t, gl,
                                       tag)
                    torch.cuda.empty_cache()
                for f in os.listdir(tmp):
                    if f.endswith((".npy", ".png")):
                        os.remove(os.path.join(tmp, f))
                taps.clear()
                sd_pipeline.SDPipeline._initial_latents = (perturbed_latents if label == witness
                                                           else real_latents)
                _reset_launch_counts()
                res = infer.main(common + ["--cali_ckpt", files[state]] + flags)
                shown = {n: c for n, c in _expect_launches(f"cli_path {label}", expect).items()
                         if c}
                images = {os.path.basename(o): np.load(o) for o in res["outputs"]}
                if len(images) != 4 or any(a.shape != (512, 512, 3) or a.dtype != np.uint8
                                           or a.std() == 0 for a in images.values()):
                    raise AssertionError(f"cli_path {label}: bad images "
                                         f"{[(n, a.shape, a.dtype) for n, a in images.items()]}")
                (_, fp_s, _), (q_lat, q_s, q_eps) = taps
                qtag = next(t for t in res["run_s"] if t != "fp")
                results[label] = {"images": images, "q_latents": q_lat, "q_eps": q_eps,
                                  "launches": shown}
                print(f"cli_path {label}: {sorted(images)}; load + fold {res['load_fold_s']:.2f} "
                      f"s; " + "; ".join(
                          f"{t}: {s / STEPS_CLI:.4f} s per step ({forwards} UNet forwards at "
                          f"batch 4 in {s:.2f} s), {res['run_s'][t] / 2:.4f} s per image"
                          for t, s in (("fp", fp_s), (qtag, q_s)))
                      + f"; launches {shown}; a quantized UNet forward: fake_quant "
                      f"{shown.get('fake_quant', 0) / forwards:g}, fake_quant_plain "
                      f"{shown.get('fake_quant_plain', 0) / forwards:g} | {tag}", flush=True)
        finally:
            sd_pipeline.sd_sample = real_sample
            sd_pipeline.SDPipeline._initial_latents = real_latents
    del params, wqp, g8, g1, log2
    torch.cuda.empty_cache()

    a, b = results[runs[0][1]], results[runs[1][1]]
    fp_names = sorted(n for n in a["images"] if n.endswith("_fp.npy"))
    off = np.mean([np.abs(a["images"][n].astype(int) - b["images"][n].astype(int)) > 1
                   for n in fp_names])
    print(f"cli_path: the fp images of (a) and (b) (the same fp run: the flags change only the "
          f"quantized one) differ by more than one level on a share {off:.6g} of their values "
          f"(bound 0.01) | {tag}", flush=True)
    if not off <= 0.01:
        raise AssertionError("cli_path: the fp run of the CLI is not deterministic")
    print(f"cli_path: (a)'s quantized run: mean |eps| of the first UNet forward "
          f"{float(a['q_eps'].abs().mean()):.6g}, mean |final latents| "
          f"{float(a['q_latents'].abs().mean()):.6g} | {tag}", flush=True)
    # the kernel runs' first UNet forward (the same inputs as (a)'s) must stay
    # within 5x (a')'s chaos, in the largest and in the mean change, as the
    # JAX package's tests bound a quantized net; the final latents are read
    chaos = (results[witness]["q_eps"] - a["q_eps"]).abs()
    for label in (r[1] for r in runs[1:5]):
        r = results[label]
        d1, d = (r["q_eps"] - a["q_eps"]).abs(), (r["q_latents"] - a["q_latents"]).abs()
        print(f"cli_path: {label} against (a), quantized run: first UNet forward's eps max |d| "
              f"{float(d1.max()):.6g}, mean |d| {float(d1.mean()):.6g}; final latents max |d| "
              f"{float(d.max()):.6g}, mean |d| {float(d.mean()):.6g} | {tag}", flush=True)
        if label != witness and not (float(d1.max()) <= 5 * float(chaos.max())
                                     and float(d1.mean()) <= 5 * float(chaos.mean())):
            raise AssertionError(f"cli_path {label}: the first UNet forward differs from (a)'s by "
                                 f"more than 5x the chaos of (a)")
    print(f"cli_path: f32 activations with bf16 weights: attention forms quant_form "
          f"{quant_form(f32, 40, (0, 0, 0), (8, 8))} (K1, K3b, K4), flash_form "
          f"{flash_form(f32, 512, (0, 0, 0), (8, 8))} (K2: the VAE at head dim 512, the UNet's "
          f"40 {flash_form(f32, 40, (0, 0, 0), (8, 8))}), K5 conv_form "
          f"{conv_form(f32, 320, 320)} (conv_in {conv_form(f32, 4, 320)}) | {tag}", flush=True)
    return {label: r["launches"] for label, r in results.items()}


# ------------------------------------------------------------ calib_path ----
CALI_PROMPTS = 2  # the CLIs' --cali_prompt_data_n, 64 in the scripts
CALI_STEPS = 4    # the CLIs' --step_size, 25 for SD in the scripts: 5 PNDM calls
CALI_TINY_DRAWS = 8
CALI_BATCH = 8    # the CLIs' calibration batch for SD (cut to the slot's interval)
TINY_RTOL = 1e-5  # a leaf no perturbation moved: zero points equal, deltas this close


def _tiny_runs(params_q, spec, cali, device):
    """The tiny SD net's two calibrations on `device` (one slot of two
    samples), each -> (per_t, group layers, {kernel: launches}):
      "full": `calibrate_activations`, g=2, W8A8 with the t2i flags and the
          fused attention (K3b in every forward): what the CLI runs, and
          chaotic (the live quantizers turn any change of the input into
          other ranges, k-means partitions and axes);
      "stage": `init_act_qstate` in one chunk and `group_calibrate_qstate`
          from an empty state, W8A8 without the t2i flags: no quantizer is
          live, so a change of 1e-6 moves no zero point and no axis (the
          attention runs K2), and the card must give the CPU's groups."""
    from dgq_tpu_torch.calib.act_calib import (
        calibrate_activations,
        group_calibrate_qstate,
        init_act_qstate,
    )
    from dgq_tpu_torch.models.qconfig import QConfig

    if device == "cuda":
        params_q, cali = _to_cuda(params_q), tuple(c.cuda() for c in cali)
    base = dict(w_bits=8, a_bits=8, softmax_bits=8, use_wq=True, use_aq=True,
                use_pallas_attention=True)
    full = QConfig(**base, t2i_log_quant=True, t2i_real_time=True, t2i_start_peak=True)
    stage = QConfig(**base)
    out = {}
    _reset_launch_counts()
    out["full"] = calibrate_activations(params_q, spec, full, cali, interval=2, group_num=2,
                                        batch_size=2, init_chunk=500) + (_launch_counts(),)
    _reset_launch_counts()
    init, _ = init_act_qstate(params_q, cali, spec, stage, chunk=500)
    grouped, gl = group_calibrate_qstate(params_q, {"a": {}, "sm": {}}, [cali], stage, spec, 2)
    out["stage"] = ({"init": init, "group": grouped}, gl, _launch_counts())
    return out


def calib_reference():
    """calib_path's CPU side (no card, no kernel; it runs while the compilers
    do): the tiny net (base 32, weights and data from seed 3), both its
    calibrations on the CPU on its latents and on CALI_TINY_DRAWS copies
    moved by 1e-6; its tap order under (e)'s and (f)'s flags (the names and
    order of the full-width net, whose spec has the same layers); and the MSE
    weight scales of one full-width SD weight (down_blocks.0.resnets.0.conv1,
    320 x 2880) on the CPU."""
    import torch
    from dgq_tpu_torch.calib.act_calib import tap_execution_order
    from dgq_tpu_torch.calib.weight_calib import quantize_model_weights
    from dgq_tpu_torch.models.qconfig import QConfig
    from dgq_tpu_torch.models.unet_sd import init_unet_sd, sd_unet_spec
    from dgq_tpu_torch.quant.scalers import init_scale_channelwise

    g = torch.Generator().manual_seed(3)
    spec = sd_unet_spec(base=32, cross=64)
    params = init_unet_sd(g, "cpu", spec=spec)
    cali = (torch.randn(2, 16, 16, 4, generator=g), torch.tensor([801, 801], dtype=torch.int32),
            torch.randn(2, 77, 64, generator=g))
    params_q, _ = quantize_model_weights(params, spec, QConfig(w_bits=8, use_wq=True))
    ref = _tiny_runs(params_q, spec, cali, "cpu")
    gp = torch.Generator().manual_seed(4)
    moved = [_tiny_runs(params_q, spec, (cali[0] + 1e-6 * torch.randn(cali[0].shape, generator=gp),)
                        + cali[1:], "cpu") for _ in range(CALI_TINY_DRAWS)]
    t2i = dict(t2i_log_quant=True, t2i_real_time=True, t2i_start_peak=True)
    order = {lbl: tap_execution_order(params, tuple(c[:1] for c in cali),
                                      QConfig(use_aq=True, use_pallas_attention=True, **kw))
             for lbl, kw in (("e", {}), ("f", t2i))}
    w = torch.randn(320, 320, 3, 3, generator=torch.Generator().manual_seed(5)) / 2880 ** 0.5
    return {"tiny": (params_q, spec, cali), "ref": ref, "moved": moved, "order": order,
            "tiny_names": [n for n, _, _ in spec], "w": w,
            "w_qp": init_scale_channelwise(w, 4, "mse")}


def _tiny_check(tag, ref):
    """calib_path (0), the tiny net: both calibrations on the card against
    the CPU. Every leaf that none of the CPU's CALI_TINY_DRAWS perturbations
    moved must be the CPU's (zero points equal, deltas within TINY_RTOL
    relative), and so must every group layer. "stage" is not chaotic: nine
    in ten leaves at least must be stable there, and every axis equal.
    "full" is: the perturbations move most leaves, so its deltas and zero
    points are held only to 5x their largest change and its differing axes
    to 5x the most one perturbation flips, and an axis may differ only on a
    point whose grid they moved (each such axis is printed as its
    witness)."""
    import torch
    from dgq_tpu_torch.calib.act_calib import group_axes, moved_leaves, state_gap, state_leaves

    saved_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        card = _tiny_runs(*ref["tiny"], "cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved_tf32
    failed = []
    for run, kernels in (("full", ("rt_stats", "quant_accum")), ("stage", ("flash_attention",))):
        cpu, cpu_gl, _ = ref["ref"][run]
        got, got_gl, launched = card[run]
        perturbed = [m[run][0] for m in ref["moved"]]
        leaves = set(state_leaves(cpu))
        moved = set().union(*(moved_leaves(cpu, m, TINY_RTOL) for m in perturbed))
        stable = leaves - moved
        off = sorted(moved_leaves(cpu, got, TINY_RTOL) & stable)
        ca, ka = group_axes(cpu), group_axes(got)
        differ = sorted(k for k in ca if ca[k] != ka.get(k))
        unexplained = [k for k in differ if k not in {(s, n) for s, _, n in moved}]
        err_d, err_z = state_gap(cpu, got)
        chaos_d = max(state_gap(cpu, m)[0] for m in perturbed)
        chaos_z = max(state_gap(cpu, m)[1] for m in perturbed)
        flips = max(sum(v != ca[k] for k, v in group_axes(m).items()) for m in perturbed)
        launched = {n: c for n, c in launched.items() if c}
        print(f"calib_path: tiny SD {run} calibration, card against CPU: {len(stable)} of "
              f"{len(leaves)} leaves no perturbation moved, {len(off)} of them off the CPU's "
              f"(zero points equal, deltas within {TINY_RTOL:g} relative)"
              f"{': ' + str(off[:3]) if off else ''}; "
              f"delta max |d| {err_d:.6g} (the perturbations' {chaos_d:.6g}), zero point max "
              f"|d| {err_z:.6g} (theirs {chaos_z:.6g}); group layers "
              f"{len(got_gl)} (CPU {len(cpu_gl)}, {'equal' if got_gl == cpu_gl else 'DIFFERENT'}); "
              f"group axes: {len(differ)} of {len(ca)} (point, slot) choices differ, "
              f"{len(unexplained)} on points no perturbation moved (a perturbation flips up to "
              f"{flips}); launches {launched} | {tag}",
              flush=True)
        for k in differ:
            flipped = sum(group_axes(m).get(k) != ca[k] for m in perturbed)
            print(f"calib_path:   witness {run} {k[1]} ({k[0]}): CPU groups the "
                  f"{'last' if ca[k] else 'mid'} axis, the card the {'last' if ka[k] else 'mid'}; "
                  f"{flipped} of {len(perturbed)} perturbations flip it | {tag}", flush=True)
        if off or got_gl != cpu_gl or unexplained or any(not launched.get(k) for k in kernels):
            failed.append(run)
        if run == "full" and (err_d > max(5 * chaos_d, 1e-6) or err_z > max(5 * chaos_z, 1e-6)
                              or len(differ) > 5 * flips):
            failed.append(run)
        if run == "stage" and (differ or len(stable) < 0.9 * len(leaves)):
            failed.append("stage: an axis differs, or the CPU's perturbations moved over a tenth "
                          "of its leaves")
    if failed:
        raise AssertionError(f"calib_path: the tiny net's calibration on the card is not the "
                             f"CPU's: {failed}")


def _counting_unet(counts, real):
    """The UNet forward `real` (SD's `unet_sd_apply` or SDXL-turbo's
    `unet_sdxl_apply`) counting its forwards into `counts`: all of them, and
    those whose flags send attention to the kernels."""

    def apply(params, *args, qstate=None, cfg=None, **kw):
        counts["forwards"] += 1
        if cfg is not None and cfg.use_pallas_attention:
            counts["kernel_forwards"] += 1
        return real(params, *args, qstate=qstate, cfg=cfg, **kw)
    return apply


def _run_cli(phase, label, fn, argv, forwards, want, tag):
    """fn(argv) with its UNet forwards counted (the CLIs take each family's
    forward from `models.families.FAMILIES`); its seconds, peak memory and
    launches printed, the forwards that reach the kernels held to `forwards`
    and the launches to want(those forwards)."""
    import dataclasses

    import torch
    from dgq_tpu_torch.models.families import FAMILIES

    counts = {"forwards": 0, "kernel_forwards": 0}
    real = {n: FAMILIES[n] for n in ("sd", "sdxl")}
    FAMILIES.update({n: dataclasses.replace(f, apply=_counting_unet(counts, f.apply))
                     for n, f in real.items()})
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    try:
        t0 = time.perf_counter()
        res = fn(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        FAMILIES.update(real)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launched = _launch_counts()
    got = {n: c for n, c in _kernels_only(launched).items() if c}
    fq = {n: launched[n] for n in FQ_COUNTS}
    want = {n: c for n, c in want(counts["kernel_forwards"]).items() if c}
    s = res.get("seconds", {})
    print(f"{phase} {label}: {seconds:.2f} s, peak {peak:.2f} GiB allocated; "
          + (f"MSE weight-scale init {s['weight_init']:.2f} s; " if "weight_init" in s else "")
          + (f"calibration data {s['cali_data']:.2f} s; " if "cali_data" in s else "")
          + (f"reconstruction {s['recon']:.2f} s; " if "recon" in s else "")
          + (f"activation calibration per time slot "
             f"{', '.join(f'{v:.2f}' for v in s['act_slots'])} s; " if "act_slots" in s else "")
          + f"{counts['forwards']} UNet forwards, {counts['kernel_forwards']} with the "
          f"kernels' attention (expected {forwards}); launches {got} (expected {want}); "
          f"{fq}; {_k3b_share(launched)} | {tag}", flush=True)
    if counts["kernel_forwards"] != forwards or got != want:
        raise AssertionError(f"{phase} {label}: {counts['kernel_forwards']} forwards, "
                             f"launches {got}; expected {forwards} and {want}")
    # the inference CLIs take no gradient and hold f32 states: no quantizer on the chain
    if fn.__module__ in ("dgq_tpu_torch.cli.infer", "dgq_tpu_torch.cli.gen4eval"):
        _check_fake_quant(f"{phase} {label}", fq, torch.float32)
    return res


def _check_calibrated(label, per_t, spec, tag):
    """Every activation quantizer has a state in every slot, every delta is
    finite and positive. Prints the group-quantized points' axes."""
    import numpy as np
    from dgq_tpu_torch.calib.act_calib import act_qpoint_names, group_axes, state_leaves

    names = act_qpoint_names(spec)
    for slot, qs in per_t.items():
        missing = [n for n in names if n not in qs["a"]]
        if missing:
            raise AssertionError(f"{label} {slot}: no state for {missing[:4]}")
    bad = [k for k, (d, _) in state_leaves(per_t).items()
           if not (np.isfinite(d).all() and (d > 0).all())]
    if bad:
        raise AssertionError(f"{label}: deltas not finite and positive at {bad[:4]}")
    axes = group_axes(per_t)
    layers = sorted({n for _, n in axes})
    mixed = [n for n in layers if len({axes[(s, n)] for s in per_t}) > 1]
    last = sum(v for v in axes.values())
    print(f"{label}: {len(per_t)} slots, {len(per_t['act_0']['a'])} activation quantizers a "
          f"slot, every delta finite and > 0; {len(layers)} group-quantized points, "
          f"{len(axes) - last} (point, slot) choices of the mid axis and {last} of the last "
          f"axis, {len(mixed)} points mixed across slots | {tag}", flush=True)


def _act_plan(order, slots, batches, n_att):
    """(forwards, K1 launches) of an activation calibration run over
    `slots` time slots of `batches` batches, from its tap order and the
    chunk of 32 taps: per slot one forward for the order, one a chunk and
    one a batch (the EMA pass of calib_path (e), the group statistics of
    (f)). Under (e)'s flags an attention runs K1 once its softmax quantizer
    has a scale, from the chunk after the one holding its aqtizer_w."""
    chunks = range(0, len(order), 32)
    k1 = sum(sum(n.endswith(".aqtizer_w") for n in order[:c]) for c in chunks)
    return slots * (1 + len(chunks) + batches), slots * (k1 + batches * n_att)


def calib_path(tag, ref, keep):
    """Phase 6: calibration without reconstruction at full width, from the
    port alone (random SD v1.4 weights from seed 42, f32 as the JAX CLIs
    run, 512px, the calibration cut to CALI_PROMPTS prompts and CALI_STEPS
    PNDM steps: 5 time slots of 4 samples, batch 4):
      (0) the card against the CPU: MSE weight scales of one full-width
          weight; the tiny net's g=2 calibration (fused attention, t2i
          flags), within 5x the largest change of the CPU run under
          CALI_TINY_DRAWS perturbations of 1e-6 (deltas, zero points, and
          the count of group-axis choices that differ: this random-weight
          net's quantized forward is chaotic, and a perturbation of 1e-6
          flips a few axes), with the same group layers;
      (e) `cli.quantize_weight.main`: --wq 4 --cali --no_recon --use_aq
          --pallas_attn (MSE scales over 859.52M parameters, g=1 activation
          calibration through K1 / K2);
      (f) `cli.quantize_act.main` on (e)'s weight-only file: --group_num 8,
          the four t2i flags, --pallas_attn (K3b in every forward);
      (g) `cli.ckpt_tools merge`, then `cli.infer.main` on the merged file
          (--use_aq --use_group, the t2i flags, --pallas_attn --group_impl
          fused, CALI_STEPS PNDM steps, 2 images through an HF-named VAE).
    Each checkpoint is read back bit for bit, each run's kernel launches are
    exact, and the first quantized forward's relative error with the
    calibrated g=8 state is printed beside that of `synthetic_group_qstate`.
    (g)'s merged file and VAE stay in `keep` for `eval_path`, and the return
    value names them: {'merged', 'vae_dir', 'k5_convs'}."""
    import os
    import tempfile

    import numpy as np
    import torch
    from dgq_tpu_torch.calib.act_calib import attention_prefixes, conv_meta_by_name, group_axes
    from dgq_tpu_torch.calib.weight_calib import fold_weight_quant
    from dgq_tpu_torch.cli import ckpt_tools, infer, quantize_act, quantize_weight
    from dgq_tpu_torch.io import dgq_ckpt
    from dgq_tpu_torch.io.convert import params_to_torch_unet
    from dgq_tpu_torch.models import unet_sd
    from dgq_tpu_torch.models.qconfig import QConfig
    from dgq_tpu_torch.pipeline.schedulers import make_pndm
    from dgq_tpu_torch.pipeline.vae import init_vae_decoder, vae_decoder_spec
    from dgq_tpu_torch.quant.scalers import init_scale_channelwise, lp_loss
    from dgq_tpu_torch.utils.synthetic import synthetic_group_qstate

    print(f"calib_path: cuts: --cali_prompt_data_n 64 -> {CALI_PROMPTS}, --step_size 25 -> "
          f"{CALI_STEPS} ({CALI_STEPS + 1} time slots, interval {2 * CALI_PROMPTS}, so the "
          f"calibration batch is {2 * CALI_PROMPTS}, not 8); widths, depth and 512px not cut "
          f"| {tag}", flush=True)

    # (0) the card against the CPU
    w_card = init_scale_channelwise(ref["w"].cuda(), 4, "mse")
    d_cpu, d_card = ref["w_qp"].delta.reshape(-1), w_card.delta.cpu().reshape(-1)
    z_cpu, z_card = ref["w_qp"].zero_point.reshape(-1), w_card.zero_point.cpu().reshape(-1)
    rows = ((d_cpu - d_card).abs() > 1e-6 * d_cpu.abs()) | (z_cpu != z_card)
    flat = ref["w"].reshape(320, -1).double()

    def loss(d, z):
        q = torch.clamp(torch.round(flat / d[:, None]) + z[:, None], 0, 15)
        return lp_loss(d[:, None] * (q - z[:, None]), flat, p=2.4, dim=1)
    tie = (loss(d_cpu.double(), z_cpu.double()) - loss(d_card.double(), z_card.double())).abs()
    tie_ok = bool((tie[rows] <= 1e-6 * loss(d_cpu.double(), z_cpu.double())[rows]).all())
    print(f"calib_path: MSE scales of down_blocks.0.resnets.0.conv1 (320 x 2880, W4), card "
          f"against CPU: {int(rows.sum())} of 320 rows on another grid point (their losses "
          f"equal within 1e-6: {tie_ok}), the rest within 1e-6 relative | {tag}", flush=True)
    if not tie_ok:
        raise AssertionError("calib_path: the card's MSE scales differ from the CPU's")
    _tiny_check(tag, ref)

    spec = unet_sd.sd_unet_spec()
    n_att = len(attention_prefixes(spec))
    if ref["tiny_names"] != [n for n, _, _ in spec]:
        raise AssertionError("calib_path: the tiny net's layers are not SD v1.4's")
    # The expected launches, from the tap order (the tiny net's, whose layers
    # are SD v1.4's), the chunk of 32 taps and the batches of a slot: per
    # slot one forward for the order, one a chunk and one a batch (the EMA
    # pass of (e), the group statistics of (f)). In (e) an attention runs K1
    # once its softmax quantizer has a scale, from the chunk after the one
    # holding its aqtizer_w, and K2 before; in (f) every attention runs K3b.
    slots = CALI_STEPS + 1
    batches = -(-2 * CALI_PROMPTS // min(CALI_BATCH, 2 * CALI_PROMPTS))

    fwd_e, k1_e = _act_plan(ref["order"]["e"], slots, batches, n_att)
    fwd_f, _ = _act_plan(ref["order"]["f"], slots, batches, n_att)
    tmp_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(tmp_root, exist_ok=True)
    real_apply = unet_sd.unet_sd_apply

    def run_cli(label, fn, argv, forwards, want):
        return _run_cli("calib_path", label, fn, argv, forwards, want, tag)

    with tempfile.TemporaryDirectory(dir=tmp_root) as tmp:
        common = ["--model", "sd", "--wq", "4", "--cali_prompt_data_n", str(CALI_PROMPTS),
                  "--step_size", str(CALI_STEPS), "--outdir", os.path.join(tmp, "results"),
                  "--cali_data_path", os.path.join(tmp, "cali"), "--pallas_attn"]
        t2i = ["--t2i_log_quant", "--t2i_real_time", "--t2i_start_peak", "--time_aware_aqtizer"]
        w = run_cli("(e) quantize_weight", quantize_weight.main,
                    common + ["--cali", "--no_recon", "--use_aq"], fwd_e,
                    lambda f: {"static_uniform_attention": k1_e, "flash_attention": n_att * f - k1_e})
        _check_calibrated("calib_path (e) g=1", w["per_t"], spec, tag)
        _assert_round_trip("calib_path (e) weight-only", w["weight_only"], spec, w["params"],
                           w["wqp"], {}, (), tag)
        _assert_round_trip("calib_path (e) merged g=1", w["merged"], spec, w["params"], w["wqp"],
                           w["per_t"], (), tag)
        weight_only = w["weight_only"]
        del w
        a = run_cli("(f) quantize_act", quantize_act.main,
                    common + ["--cali_ckpt", weight_only, "--aq", "8", "--softmax_a_bit", "8",
                              "--group_num", "8"] + t2i, fwd_f,
                    lambda f: {"rt_stats": n_att * f, "quant_accum": n_att * f})
        _check_calibrated("calib_path (f) g=8", a["per_t"], spec, tag)
        if not a["group_layers"]:
            raise AssertionError("calib_path (f): no group layers")
        _assert_round_trip("calib_path (f) activations g=8", a["act_ckpt"], spec, None, None,
                           a["per_t"], a["group_layers"], tag)

        # the first quantized forward against the fp one: the calibrated g=8
        # state (slot 0) beside synthetic_group_qstate
        params, wqp, _ = dgq_ckpt.load_weight_only(weight_only, spec)
        g = torch.Generator(device="cuda").manual_seed(7)
        x = torch.randn(2, 64, 64, 4, generator=g, device="cuda")
        ehs = torch.randn(2, 77, 768, generator=g, device="cuda")
        t = torch.full((2,), int(make_pndm(CALI_STEPS).timesteps[0]), dtype=torch.int32,
                       device="cuda")
        syn, syn_gl = synthetic_group_qstate(spec, 0, False, torch.float32, device="cuda")
        cfg = QConfig(w_bits=4, a_bits=8, **_g8_kwargs(tuple(a["group_layers"]), "fused"))
        rel = {}
        with torch.no_grad():
            params_q = fold_weight_quant(params, wqp, spec, cfg)
            eps = real_apply(params, x, t, ehs)
            for lbl, qs, gl in (("calibrated", a["per_t"]["act_0"], a["group_layers"]),
                                ("synthetic_group_qstate", syn, syn_gl)):
                e = real_apply(params_q, x, t, ehs, qstate=qs,
                               cfg=cfg.replace(group_conv_layers=tuple(gl)))
                rel[lbl] = float((e - eps).norm() / eps.norm())
        del params, wqp, params_q, syn, eps, e
        print(f"calib_path: first quantized forward, ||eps_q - eps_fp|| / ||eps_fp|| at t = "
              f"{int(t[0])}: calibrated g=8 state (slot 0) {rel['calibrated']:.6g}, "
              f"synthetic_group_qstate {rel['synthetic_group_qstate']:.6g} | {tag}", flush=True)

        # (g) merge, then the inference CLI on the merged file
        merged = os.path.join(keep, "sd_w4a8g8_merged.pth")
        if ckpt_tools.main(["merge", weight_only, a["act_ckpt"], merged]) != 0:
            raise AssertionError("calib_path (g): ckpt_tools merge failed")
        vae_dir = os.path.join(keep, "vae")
        os.makedirs(vae_dir)
        torch.save(params_to_torch_unet(init_vae_decoder(g, "cuda"), vae_decoder_spec()),
                   os.path.join(vae_dir, "diffusion_pytorch_model.bin"))
        # K5 takes a group conv of stride 1 whose groups lie on the mid
        # (C·kh·kw) axis in every slot: a point whose axis differs across
        # slots stacks a full-length last axis everywhere and runs the taps
        meta = conv_meta_by_name(spec)
        axes = group_axes(a["per_t"])
        k5_convs = sum(meta[n][3] == 1 and not any(axes[(s, n)] for s in a["per_t"])
                       for n in a["group_layers"])
        del a
        res = run_cli("(g) infer", infer.main,
                      ["--model", "sd", "--cali_ckpt", merged, "--use_aq", "--use_group",
                       "--num_inference_steps", str(CALI_STEPS), "--vae_weights", vae_dir,
                       "--outdir", tmp, "--pallas_attn", "--group_impl", "fused"] + t2i,
                      CALI_STEPS + 1,  # one batched forward a PNDM call
                      lambda f: {"flash_attention": 2,  # the VAE's attention, two decodes
                                 "rt_stats": n_att * f, "quant_accum": n_att * f,
                                 "group_quant_conv": k5_convs * f})
        images = [np.load(o) for o in res["outputs"]]
        print(f"calib_path (g) infer: {[os.path.basename(o) for o in res['outputs']]}, load + "
              f"fold {res['load_fold_s']:.2f} s, runs {res['run_s']} s; K5 on {k5_convs} convs "
              f"a forward, the others on taps (last-axis or mixed-axis groups, stride 2) | "
              f"{tag}", flush=True)
        if len(images) != 4 or any(i.shape != (512, 512, 3) or i.dtype != np.uint8 for i in images):
            raise AssertionError("calib_path (g): not four uint8 images of 512px")
    torch.cuda.empty_cache()
    return {"merged": merged, "vae_dir": vae_dir, "k5_convs": k5_convs}


EVAL_PROMPTS = 20  # gen4eval's SD prompts: two images in each of IS's ten splits
EVAL_BATCH = 10
SCORER_IMAGES = 100  # the scorers' timed batch, "s per 100 images"


def _rand_tree(shapes, g, std=0.02):
    """Random f32 weights on the card under checkpoint names: LayerNorm
    weights 1 and biases 0, everything else N(0, std^2)."""
    import torch

    out = {}
    for k, shape in shapes.items():
        if ("ln" in k or "norm" in k or "LayerNorm" in k) and k.endswith((".weight", ".bias")):
            out[k] = (torch.ones if k.endswith(".weight") else torch.zeros)(shape, device="cuda")
        else:
            out[k] = std * torch.randn(shape, generator=g, device="cuda")
    return out


def _open_clip_shapes(prefix, width, depth, mlp):
    shapes = {}
    for i in range(depth):
        b = f"{prefix}transformer.resblocks.{i}"
        shapes.update({f"{b}.ln_1.weight": (width,), f"{b}.ln_1.bias": (width,),
                       f"{b}.attn.in_proj_weight": (3 * width, width),
                       f"{b}.attn.in_proj_bias": (3 * width,),
                       f"{b}.attn.out_proj.weight": (width, width),
                       f"{b}.attn.out_proj.bias": (width,), f"{b}.ln_2.weight": (width,),
                       f"{b}.ln_2.bias": (width,), f"{b}.mlp.c_fc.weight": (mlp, width),
                       f"{b}.mlp.c_fc.bias": (mlp,), f"{b}.mlp.c_proj.weight": (width, mlp),
                       f"{b}.mlp.c_proj.bias": (width,)})
    return shapes


def vit_g14_params(g):
    """open_clip ViT-g-14 (laion2b_s34b_b88k) at its published widths: vision
    1408 wide, 40 blocks, MLP 6144, 14px patches at 224px; text 1024 wide, 24
    blocks, MLP 4096, 49408 tokens, 77 positions; 1024-d embeddings."""
    vis = {"conv1.weight": (1408, 3, 14, 14), "class_embedding": (1408,),
           "positional_embedding": (257, 1408), "ln_pre.weight": (1408,), "ln_pre.bias": (1408,),
           "ln_post.weight": (1408,), "ln_post.bias": (1408,), "proj": (1408, 1024),
           **_open_clip_shapes("", 1408, 40, 6144)}
    txt = {"token_embedding.weight": (49408, 1024), "positional_embedding": (77, 1024),
           "ln_final.weight": (1024,), "ln_final.bias": (1024,),
           "text_projection": (1024, 1024), **_open_clip_shapes("", 1024, 24, 4096)}
    return {"visual": _rand_tree(vis, g), "text": _rand_tree(txt, g)}


def image_reward_params(g):
    """ImageReward-v1.0 at its published widths: BLIP ViT-L/16 (1024 wide, 24
    blocks, MLP 4096, 224px), BERT-base with cross-attention (768 wide, 12
    layers, 3072, 30524 tokens, 512 positions, keys / values from 1024) and the
    768 -> 1024 -> 128 -> 64 -> 16 -> 1 head at Sequential indices 0 to 8."""
    vis = {"patch_embed.proj.weight": (1024, 3, 16, 16), "patch_embed.proj.bias": (1024,),
           "cls_token": (1, 1, 1024), "pos_embed": (1, 197, 1024), "norm.weight": (1024,),
           "norm.bias": (1024,)}
    for i in range(24):
        b = f"blocks.{i}"
        vis.update({f"{b}.norm1.weight": (1024,), f"{b}.norm1.bias": (1024,),
                    f"{b}.attn.qkv.weight": (3072, 1024), f"{b}.attn.qkv.bias": (3072,),
                    f"{b}.attn.proj.weight": (1024, 1024), f"{b}.attn.proj.bias": (1024,),
                    f"{b}.norm2.weight": (1024,), f"{b}.norm2.bias": (1024,),
                    f"{b}.mlp.fc1.weight": (4096, 1024), f"{b}.mlp.fc1.bias": (4096,),
                    f"{b}.mlp.fc2.weight": (1024, 4096), f"{b}.mlp.fc2.bias": (1024,)})
    txt = {"embeddings.word_embeddings.weight": (30524, 768),
           "embeddings.position_embeddings.weight": (512, 768),
           "embeddings.LayerNorm.weight": (768,), "embeddings.LayerNorm.bias": (768,)}
    for i in range(12):
        b = f"encoder.layer.{i}"
        for att, kv in (("attention", 768), ("crossattention", 1024)):
            txt.update({f"{b}.{att}.self.query.weight": (768, 768),
                        f"{b}.{att}.self.query.bias": (768,),
                        f"{b}.{att}.self.key.weight": (768, kv), f"{b}.{att}.self.key.bias": (768,),
                        f"{b}.{att}.self.value.weight": (768, kv),
                        f"{b}.{att}.self.value.bias": (768,),
                        f"{b}.{att}.output.dense.weight": (768, 768),
                        f"{b}.{att}.output.dense.bias": (768,),
                        f"{b}.{att}.output.LayerNorm.weight": (768,),
                        f"{b}.{att}.output.LayerNorm.bias": (768,)})
        txt.update({f"{b}.intermediate.dense.weight": (3072, 768),
                    f"{b}.intermediate.dense.bias": (3072,),
                    f"{b}.output.dense.weight": (768, 3072), f"{b}.output.dense.bias": (768,),
                    f"{b}.output.LayerNorm.weight": (768,), f"{b}.output.LayerNorm.bias": (768,)})
    head = {}
    for i, (a, b) in zip((0, 2, 4, 6, 8), ((768, 1024), (1024, 128), (128, 64), (64, 16),
                                           (16, 1))):
        head.update({f"{i}.weight": (b, a), f"{i}.bias": (b,)})
    return {"visual": _rand_tree(vis, g), "text": _rand_tree(txt, g), "mlp": _rand_tree(head, g)}


def _cut_depth(tree, depth):
    """The first `depth` blocks of a tower (and every other leaf), on the CPU."""
    def keep(k):
        m = re.match(r"(?:transformer\.resblocks|blocks|encoder\.layer)\.(\d+)\.", k)
        return m is None or int(m.group(1)) < depth
    return {k: v.cpu() for k, v in tree.items() if keep(k)}


def _pt_inception_state(g):
    """A random InceptionV3 state dict under pytorch-fid's names (BN running
    statistics and the 1008-class fc included), on the CPU for torch.save."""
    import torch
    from dgq_tpu_torch.eval.inception import inception_spec

    state = {}
    for name, ci, co, k, _, _ in inception_spec():
        w = torch.randn(co, ci, *k, generator=g, device="cuda") * (2.0 / (ci * k[0] * k[1])) ** 0.5
        state[f"{name}.conv.weight"] = w.cpu()
        state[f"{name}.bn.weight"] = (0.5 + torch.rand(co, generator=g, device="cuda")).cpu()
        state[f"{name}.bn.bias"] = (0.1 * torch.randn(co, generator=g, device="cuda")).cpu()
        state[f"{name}.bn.running_mean"] = (0.1 * torch.randn(co, generator=g, device="cuda")).cpu()
        state[f"{name}.bn.running_var"] = (0.5 + torch.rand(co, generator=g, device="cuda")).cpu()
    state["fc.weight"] = (0.05 * torch.randn(1008, 2048, generator=g, device="cuda")).cpu()
    state["fc.bias"] = torch.zeros(1008)
    return state


def _per_100(fn, n):
    """Seconds `fn` takes (after a warm-up call), scaled to 100 images of `n`."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 100.0 * (time.perf_counter() - t0) / n, out


def eval_path(tag, calib):
    """Phase 8, the evaluation path at full width, from the port alone, in a
    temporary directory under build/:
      (l) `cli.gen4eval.main` for SD v1.4 at 512px on EVAL_PROMPTS prompts of a
          csv written here, CALI_STEPS PNDM steps, batch EVAL_BATCH, through
          calib_path's HF-named VAE: once --fp, once from calib_path's merged
          W4A8 g=8 checkpoint with --use_aq --use_group, the t2i flags and
          --pallas_attn --group_impl fused (K3b, K5 and K2 in the VAE);
      (m) `cli.gen4eval.main` for SDXL-turbo at 1024px, 4 Euler steps, 2
          images: --wq 4 --aq 8 --use_aq, the minmax W4 fold without a
          checkpoint (so no activation state: the JAX CLI's behaviour);
      (n) `cli.eval_scores.main`: FID of (l)'s quantized images against its fp
          images (--ref_dir) and IS (--isc) through a random Inception
          checkpoint under pytorch-fid's names, fc included
          (`load_pt_inception`); FID again against a --ref_stats file of the
          fp images' features, which must give the same number; the
          extractor's features and probabilities on the card within 1e-4 of
          the largest on the CPU; then the open_clip ViT-g-14 and ImageReward
          encoders at their published widths with random weights made on
          the card and synthetic token ids: at two blocks a tower, card
          against CPU within 2e-5 (embeddings, image tokens, text states,
          rewards), and at full depth on the card for the time.
    The scorers run in float32 (`eval.common.strict_f32`: no TF32). Exact
    launch counts for (l) and (m); none in (n). Prints s an image for each
    gen4eval run and s per 100 images for each scorer."""
    import json
    import os
    import tempfile

    import numpy as np
    import torch
    from dgq_tpu_torch.calib.act_calib import attention_prefixes
    from dgq_tpu_torch.cli import eval_scores, gen4eval
    from dgq_tpu_torch.eval import image_reward as IR, inception as INC, open_clip as OC
    from dgq_tpu_torch.eval.scores import frechet_distance, gaussian_stats
    from dgq_tpu_torch.models.unet_sd import sd_unet_spec

    n_att = len(attention_prefixes(sd_unet_spec()))
    t2i = ["--t2i_log_quant", "--t2i_real_time", "--t2i_start_peak", "--time_aware_aqtizer"]
    tmp_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    g = torch.Generator(device="cuda").manual_seed(5)
    batches = -(-EVAL_PROMPTS // EVAL_BATCH)

    def run_cli(label, fn, argv, forwards, want):
        return _run_cli("eval_path", label, fn, argv, forwards, want, tag)

    with tempfile.TemporaryDirectory(dir=tmp_root) as tmp:
        csv = os.path.join(tmp, "prompts.csv")
        with open(csv, "w") as f:
            f.write("caption\n" + "".join(f"prompt number {i}\n" for i in range(EVAL_PROMPTS)))
        # (l) SD v1.4, fp and quantized
        fp_dir, q_dir = os.path.join(tmp, "sd_fp"), os.path.join(tmp, "sd_w4a8g8")
        common = ["--model", "sd", "--prompts", csv, "--batch", str(EVAL_BATCH), "--steps",
                  str(CALI_STEPS), "--vae_weights", calib["vae_dir"]]
        fp = run_cli("(l) gen4eval --fp", gen4eval.main, common + ["--fp", "--outdir", fp_dir],
                     0, lambda f: {"flash_attention": batches})
        q = run_cli("(l) gen4eval W4A8 g=8", gen4eval.main,
                    common + ["--cali_ckpt", calib["merged"], "--use_aq", "--use_group",
                              "--pallas_attn", "--group_impl", "fused", "--outdir", q_dir] + t2i,
                    batches * (CALI_STEPS + 1),
                    lambda f: {"flash_attention": batches, "rt_stats": n_att * f,
                               "quant_accum": n_att * f, "group_quant_conv": calib["k5_convs"] * f})
        names = [f"{i}_0.png" for i in range(EVAL_PROMPTS)]
        for label, res, d in (("fp", fp, fp_dir), ("W4A8 g=8", q, q_dir)):
            if sorted(os.listdir(d)) != sorted(names) or res["images"] != EVAL_PROMPTS:
                raise AssertionError(f"eval_path (l) {label}: wrote {sorted(os.listdir(d))}")
            print(f"eval_path (l) gen4eval SD v1.4 {label}: {res['images']} images 512px, "
                  f"{CALI_STEPS} PNDM steps CFG 7.5 f32, batch {EVAL_BATCH}: "
                  f"{res['generate_s'] / res['images']:.4f} s per image (generation "
                  f"{res['generate_s']:.2f} s, model load + fold {res['load_fold_s']:.2f} s) "
                  f"| {tag}",
                  flush=True)
        gen = eval_scores.load_images(q_dir)
        if gen.shape != (EVAL_PROMPTS, 512, 512, 3) or float(gen.std()) == 0.0:
            raise AssertionError(f"eval_path (l): bad images {gen.shape}")
        torch.cuda.empty_cache()

        # (m) SDXL-turbo at 1024px through the CLI
        csv2 = os.path.join(tmp, "prompts2.csv")
        with open(csv2, "w") as f:
            f.write("caption\nan astronaut\na lighthouse\n")
        xl_dir = os.path.join(tmp, "sdxl")
        xl = run_cli("(m) gen4eval SDXL-turbo W4 minmax", gen4eval.main,
                     ["--model", "sdxl", "--prompts", csv2, "--batch", "2", "--steps",
                      str(STEPS_SDXL), "--wq", "4", "--aq", "8", "--use_aq", "--vae_weights",
                      calib["vae_dir"], "--outdir", xl_dir], 0, lambda f: {"flash_attention": 1})
        xl_imgs = eval_scores.load_images(xl_dir)
        if sorted(os.listdir(xl_dir)) != ["0_0.png", "1_0.png"] or xl_imgs.shape != (2, 1024, 1024,
                                                                                      3):
            raise AssertionError(f"eval_path (m): wrote {sorted(os.listdir(xl_dir))}")
        print(f"eval_path (m) gen4eval SDXL-turbo W4 minmax: 2 images 1024px, {STEPS_SDXL} Euler "
              f"steps f32: {xl['generate_s'] / xl['images']:.4f} s per image (generation "
              f"{xl['generate_s']:.2f} s, model init + fold {xl['load_fold_s']:.2f} s) | {tag}",
              flush=True)
        del xl_imgs
        torch.cuda.empty_cache()

        # (n) eval_scores: FID and IS through a pytorch-fid checkpoint
        ck = os.path.join(tmp, "pt_inception-random.pth")
        torch.save(_pt_inception_state(g), ck)
        out = os.path.join(tmp, "scores.json")
        res = run_cli("(n) eval_scores FID + IS", eval_scores.main,
                      ["--gen_dir", q_dir, "--ref_dir", fp_dir, "--inception_ckpt", ck, "--isc",
                       "--out", out], 0, lambda f: {})
        if set(res) != {"fid", "inception_score", "inception_score_std"} or json.load(
                open(out)) != res or not all(np.isfinite(v) for v in res.values()):
            raise AssertionError(f"eval_path (n): eval_scores gave {res}")
        params = INC.load_pt_inception(ck)
        ref_imgs = eval_scores.load_images(fp_dir)
        t_feat, f_ref = _per_100(lambda: INC.fid_features(params, np.concatenate(
            [ref_imgs] * (SCORER_IMAGES // EVAL_PROMPTS)), batch_size=32), SCORER_IMAGES)
        stats = os.path.join(tmp, "fp_stats.npz")
        np.savez(stats, **dict(zip(("mu", "sigma"), gaussian_stats(f_ref[:EVAL_PROMPTS]))))
        res2 = eval_scores.main(["--gen_dir", q_dir, "--ref_stats", stats, "--inception_ckpt", ck])
        if abs(res2["fid"] - res["fid"]) > 1e-4 * max(abs(res["fid"]), 1.0):
            raise AssertionError(f"eval_path (n): --ref_stats FID {res2['fid']}, --ref_dir "
                                 f"{res['fid']}")
        feats = INC.fid_features(params, gen)
        t_probs, probs = _per_100(lambda: INC.inception_probs(params, np.concatenate(
            [gen] * (SCORER_IMAGES // EVAL_PROMPTS)), batch_size=32), SCORER_IMAGES)
        cpu = INC.load_pt_inception(ck, "cpu")
        f_cpu, p_cpu = INC.fid_features(cpu, gen), INC.inception_probs(cpu, gen)
        e_f = float(np.abs(feats - f_cpu).max() / np.abs(f_cpu).max())
        e_p = float(np.abs(probs[:EVAL_PROMPTS] - p_cpu).max() / np.abs(p_cpu).max())
        t_sqrtm = time.perf_counter()
        frechet_distance(*gaussian_stats(feats), *gaussian_stats(f_ref[:EVAL_PROMPTS]))
        t_sqrtm = time.perf_counter() - t_sqrtm
        print(f"eval_path (n) eval_scores: {res} (FID of {EVAL_PROMPTS} W4A8 g=8 images against "
              f"the fp images through a random extractor: relative only); --ref_stats gives "
              f"{res2['fid']}; Inception features card against CPU {e_f:.3g}, probabilities "
              f"{e_p:.3g} of the largest (f32, no TF32); Inception {t_feat:.4f} s per 100 images "
              f"(features), {t_probs:.4f} (probabilities); frechet_distance at 2048 features "
              f"{t_sqrtm:.2f} s on the host | {tag}", flush=True)
        if not (e_f <= 1e-4 and e_p <= 1e-4):
            raise AssertionError(f"eval_path (n): Inception card against CPU {e_f}, {e_p}")
        del params, cpu
        torch.cuda.empty_cache()

    # (n) the open_clip ViT-g-14 encoders
    _reset_launch_counts()
    imgs = np.concatenate([gen] * (SCORER_IMAGES // EVAL_PROMPTS))
    oc = vit_g14_params(g)
    pre = OC.preprocess_images(gen[:4], 224, "cuda")
    pre_cpu = OC.preprocess_images(gen[:4], 224, "cpu")
    e_pre = float((pre.cpu() - pre_cpu).abs().max())
    ids = torch.zeros(SCORER_IMAGES, 77, dtype=torch.long)
    ids[:, 0] = 49406
    ids[:, 1:9] = torch.randint(1, 49000, (SCORER_IMAGES, 8), generator=torch.Generator()
                                .manual_seed(0))
    ids[:, 9] = 49407  # EOT, the largest id
    cut = {t: _cut_depth(oc[t], 2) for t in ("visual", "text")}
    cut_card = {t: {k: v.cuda() for k, v in cut[t].items()} for t in cut}
    e_img = float((OC.encode_image(cut_card, pre).cpu() - OC.encode_image(cut, pre_cpu))
                  .abs().max())
    e_txt = float((OC.encode_text(cut_card, ids[:4].cuda()).cpu() - OC.encode_text(cut, ids[:4]))
                  .abs().max())
    del cut, cut_card

    def oc_score():
        sims = []
        for i in range(0, SCORER_IMAGES, 25):
            ie = OC.encode_image(oc, OC.preprocess_images(imgs[i:i + 25], 224, "cuda"))
            te = OC.encode_text(oc, ids[i:i + 25].cuda())
            sims.append((ie * te).sum(-1))
        return float(torch.cat(sims).mean())
    t_oc, score = _per_100(oc_score, SCORER_IMAGES)
    print(f"eval_path (n) open_clip ViT-g-14 (vision 1408 x 40 blocks, text 1024 x 24, random "
          f"weights): preprocessing card against CPU {e_pre:.3g}; at 2 blocks a tower "
          f"embeddings card against CPU {e_img:.3g} (image), {e_txt:.3g} (text); full depth "
          f"{t_oc:.4f} s per 100 images (preprocess + image + text towers, batch 25), mean "
          f"cosine {score:.6g} | {tag}", flush=True)
    if not (e_pre <= 1e-4 and e_img <= 2e-5 and e_txt <= 2e-5 and np.isfinite(score)):
        raise AssertionError(f"eval_path (n): open_clip card against CPU {e_pre} {e_img} {e_txt}")
    del oc
    torch.cuda.empty_cache()

    # (n) ImageReward: BLIP ViT-L/16 + BERT-base with cross-attention + head
    ir = image_reward_params(g)
    tok = torch.zeros(SCORER_IMAGES, 35, dtype=torch.long)
    mask = torch.zeros(SCORER_IMAGES, 35, dtype=torch.long)
    tok[:, 0], tok[:, 1:12], tok[:, 12] = 101, torch.randint(
        1000, 30000, (SCORER_IMAGES, 11), generator=torch.Generator().manual_seed(1)), 102
    mask[:, :13] = 1
    cut = {t: _cut_depth(ir[t], 2) for t in ("visual", "text")}
    cut["mlp"] = {k: v.cpu() for k, v in ir["mlp"].items()}
    cut_card = {t: {k: v.cuda() for k, v in cut[t].items()} for t in cut}
    v_card = IR.encode_vision(cut_card["visual"], pre)
    v_cpu = IR.encode_vision(cut["visual"], pre_cpu)
    t_card = IR.encode_text_cross(cut_card["text"], tok[:4], mask[:4], v_card)
    t_cpu = IR.encode_text_cross(cut["text"], tok[:4], mask[:4], v_cpu)
    r_card = IR.reward_head(cut_card["mlp"], t_card[:, 0])
    r_cpu = IR.reward_head(cut["mlp"], t_cpu[:, 0])
    e_v = float((v_card.cpu() - v_cpu).abs().max())
    e_t = float((t_card.cpu() - t_cpu).abs().max())
    e_r = float((r_card.cpu() - r_cpu).abs().max())
    del cut, cut_card

    def ir_score():
        out = []
        for i in range(0, SCORER_IMAGES, 25):
            out.append(IR.image_reward_scores(ir, OC.preprocess_images(imgs[i:i + 25], 224, "cuda"),
                                              tok[i:i + 25], mask[i:i + 25]))
        return float(torch.cat(out).mean())
    t_ir, reward = _per_100(ir_score, SCORER_IMAGES)
    print(f"eval_path (n) ImageReward (BLIP ViT-L/16 1024 x 24, BERT-base 768 x 12 with "
          f"cross-attention, random weights): at 2 blocks a tower card against CPU {e_v:.3g} "
          f"(image tokens), {e_t:.3g} (text states), {e_r:.3g} (rewards); full depth "
          f"{t_ir:.4f} s per 100 images (batch 25), mean reward {reward:.6g} | {tag}", flush=True)
    if not (e_v <= 2e-5 and e_t <= 2e-5 and e_r <= 2e-5 and np.isfinite(reward)):
        raise AssertionError(f"eval_path (n): ImageReward card against CPU {e_v} {e_t} {e_r}")
    _expect_launches("eval_path (n) scorers", {})
    del ir
    torch.cuda.empty_cache()


RECON_ITERS = 20        # the CLI's --iters, 20000 by default
RECON_LR = 1e-3         # reconstruct_unit's Adam rate
RECON_FISHER_UNITS = 7  # (j)'s --max_units: the 7th unit is the first transformer
RECON_UNITS_SD = 78     # reconstruction units of SD v1.4
# (h) reconstructs one unit of each kind and place, the others of its walk
# resumed from partial saves of their nearest rounding (`_NearestPartials`),
# for the script's time limit: a lone layer, a resnet, a transformer at
# 64px, the downsampler, the mid block's transformer at 8px, an up resnet on
# skip-concatenated inputs, an upsampler, and up_blocks.3.resnets.0, whose
# captures are the walk's largest
RECON_WALK = ("time_embedding.linear_1", "down_blocks.0.resnets.0",
              "down_blocks.0.attentions.0.transformer_blocks.0",
              "down_blocks.0.downsamplers.0.conv", "mid_block.attentions.0.transformer_blocks.0",
              "up_blocks.0.resnets.0", "up_blocks.2.upsamplers.0.conv", "up_blocks.3.resnets.0")


RECON_DEFAULT_SAMPLES = 4 * 64 * 26 // 2  # the CLI's default data size: 64 prompts, 25 steps
# (h-host) walks these two of RECON_WALK again with their captures in pinned
# host memory: the transformer with the widest rows (64px) and the resnet
# whose captures are the walk's largest
RECON_HOST_UNITS = ("down_blocks.0.attentions.0.transformer_blocks.0", "up_blocks.3.resnets.0")


class _ReconProbe:
    """Times and records a reconstruction walk from outside it: while open,
    the functions `calibrate_weights` calls in `calib.reconstruction` are
    wrapped. `units` gets one dict a reconstructed unit, in order: 'name',
    'kind', the seconds of its captures, folds, Fisher gradients and Adam
    loop (the card synchronised around each call), of allocating (and, in
    host memory on a card, page-locking) the tensors that hold its captures
    ('store_s'), 'iters', 'losses' (a
    list), the bytes a sample of the captures its Adam loop holds, the form
    they were held in ('placement': "device" or "host"), and for a unit (not
    the temporal block) 'err_learned' / 'err_nearest' from `unit_error` on
    its cached data. 'captures' counts the capture calls. extra(real,
    args, kw), where given, is called after each unit's Adam loop with the
    real `reconstruct_unit` and the call's arguments, and its dict joins
    the unit's record."""

    NAMES = ("capture_unit_io", "fold_weight_quant", "capture_unit_grad", "reconstruct_unit",
             "reconstruct_tib")

    def __init__(self, extra=None):
        self.units, self.captures, self.extra = [], 0, extra
        self._by_name, self._current, self._saved = {}, None, {}

    def _unit(self, name, kind=None):
        if name not in self._by_name:
            self._by_name[name] = {"name": name, "kind": kind, "capture_s": 0.0, "fold_s": 0.0,
                                   "grad_s": 0.0, "adam_s": 0.0, "store_s": 0.0}
            self.units.append(self._by_name[name])
        self._current = self._by_name[name]
        if kind is not None:
            self._current["kind"] = kind
        return self._current

    @staticmethod
    def _timed(fn, *args, **kw):
        import torch

        sync = torch.cuda.synchronize if torch.cuda.is_initialized() else (lambda: None)
        sync()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        sync()
        return out, time.perf_counter() - t0

    def __enter__(self):
        from dgq_tpu_torch.calib import reconstruction as TR

        real = {n: getattr(TR, n) for n in self.NAMES}
        self._saved = real
        self._empty = real_empty = TR._Captures.empty

        def empty(store, *args, **kw):
            out, s = self._timed(real_empty, store, *args, **kw)
            self._current["store_s"] += s
            return out
        TR._Captures.empty = empty

        def capture(params, batch, unit_name, *args, **kw):
            out, s = self._timed(real["capture_unit_io"], params, batch, unit_name, *args, **kw)
            self.captures += 1
            self._unit(unit_name)["capture_s"] += s
            return out

        def fold(*args, **kw):
            out, s = self._timed(real["fold_weight_quant"], *args, **kw)
            self._current["fold_s"] += s
            return out

        def grad(params_fp, params_q, batch, unit_name, *args, **kw):
            out, s = self._timed(real["capture_unit_grad"], params_fp, params_q, batch,
                                 unit_name, *args, **kw)
            self._unit(unit_name)["grad_s"] += s
            return out

        def unit(key, u, params, wqp, inputs, outputs, cfg, **kw):
            (alphas, losses), s = self._timed(real["reconstruct_unit"], key, u, params, wqp,
                                              inputs, outputs, cfg, **kw)
            held = sum(x.nbytes for x in inputs) + outputs.nbytes
            if kw.get("cached_grads") is not None:
                held += kw["cached_grads"].nbytes
            r = self._unit(u.name, u.kind)
            r.update(adam_s=s, iters=kw["iters"], losses=losses.tolist(),
                     bytes_a_sample=held / outputs.shape[0], held_bytes=held,
                     alpha_bytes=sum(a.nbytes for a in alphas.values()),
                     placement=kw.get("captures", "device"))
            if self.extra is not None:
                r.update(self.extra(real["reconstruct_unit"],
                                    (key, u, params, wqp, inputs, outputs, cfg), kw))
            r["err_learned"], r["err_nearest"] = TR.unit_error(u, params, wqp, alphas, inputs,
                                                               outputs, cfg)
            return alphas, losses

        def tib(key, params, spec, *args, **kw):
            (alphas, losses), s = self._timed(real["reconstruct_tib"], key, params, spec,
                                              *args, **kw)
            self._unit("time_embedding", "tib").update(adam_s=s, iters=kw["iters"],
                                                       losses=losses.tolist(), bytes_a_sample=0)
            return alphas, losses

        for n, fn in zip(self.NAMES, (capture, fold, grad, unit, tib)):
            setattr(TR, n, fn)
        return self

    def __exit__(self, *exc):
        from dgq_tpu_torch.calib import reconstruction as TR

        for n, fn in self._saved.items():
            setattr(TR, n, fn)
        TR._Captures.empty = self._empty


class _NearestPartials:
    """While open, `calibrate_weights` first writes a partial save of the
    nearest rounding (the offsets' initial value, whose hard rounding is
    nearest) of every unit of its walk not in `keep` that has none, from
    the weights and scales it was given: so that a walk under --partial_dir
    resumes those units and reconstructs only `keep`, exactly as if an
    earlier run had left those saves. `written` counts the saves, `seconds`
    their time, `placed` the walk's placement lines ("captures: ..."),
    `available` the host's MemAvailable bytes at the last of them, and
    `call` the last call's arguments (args, keywords)."""

    def __init__(self, keep):
        self.keep, self.written, self.seconds = set(keep), 0, 0.0
        self.call, self.placed, self.available = None, [], None
        self._real = None

    def __enter__(self):
        import torch
        from dgq_tpu_torch.calib import reconstruction as TR

        real = self._real = TR.calibrate_weights

        def calibrate(params, spec, cfg, wqp, cali_data, **kw):
            t0 = time.perf_counter()
            units = TR.recon_units(spec)[:kw.get("max_units")]
            if not self.keep <= {u.name for u in units}:
                raise AssertionError(f"_NearestPartials: {sorted(self.keep)} not all in the "
                                     f"walk of {len(units)} units")
            for u in units:
                path = os.path.join(kw["partial_dir"], f"{u.name}.pth")
                if u.name not in self.keep and not os.path.exists(path):
                    with torch.no_grad():
                        TR._save_partial(kw["partial_dir"], u, {
                            n: a.detach() for n, a in TR._init_alphas(params, wqp,
                                                                      u.layers).items()})
                    self.written += 1
            self.seconds += time.perf_counter() - t0
            self.call = ((params, spec, cfg, wqp, cali_data), dict(kw))
            progress = kw.get("progress")

            def placed(line):
                if line.startswith("captures: "):
                    self.placed.append(line)
                    self.available = TR.host_memory().get("MemAvailable")
                if progress:
                    progress(line)
            return real(params, spec, cfg, wqp, cali_data, **{**kw, "progress": placed})
        TR.calibrate_weights = calibrate
        return self

    def __exit__(self, *exc):
        from dgq_tpu_torch.calib import reconstruction as TR

        TR.calibrate_weights = self._real


def _tiny_recon(params, spec, cali, device):
    """The tiny SD net's reconstruction walks on `device`, W4 minmax scales,
    RECON_FISHER_UNITS units, RECON_ITERS Adam steps at batch 2, one capture
    chunk: "mse" (asym) and "tib fisher_diag" -> {label: (offsets on the
    CPU, the probe's unit records)}."""
    from dgq_tpu_torch.calib.reconstruction import calibrate_weights
    from dgq_tpu_torch.calib.weight_calib import init_weight_qparams
    from dgq_tpu_torch.models.qconfig import QConfig

    if device == "cuda":
        params, cali = _to_cuda(params), tuple(c.cuda() for c in cali)
    wqp = init_weight_qparams(params, spec, 4)
    out = {}
    for label, kw in (("mse", {}), ("tib fisher_diag", {"tib_recon": True,
                                                         "opt_mode": "fisher_diag"})):
        with _ReconProbe() as probe:
            alphas = calibrate_weights(params, spec, QConfig(w_bits=4, use_wq=True), wqp, cali,
                                       iters=RECON_ITERS, batch_size=2, capture_batch=4, seed=0,
                                       max_units=RECON_FISHER_UNITS, **kw)
        out[label] = ({n: a.cpu() for n, a in alphas.items()}, probe.units)
    return out


def recon_reference():
    """recon_path's CPU side (it runs while the compilers do): the tiny SD
    net (base 32, cross 64; weights and 4 samples at 16x16 from seed 11),
    both walks of `_tiny_recon` on the CPU."""
    import torch
    from dgq_tpu_torch.models.unet_sd import init_unet_sd, sd_unet_spec

    g = torch.Generator().manual_seed(11)
    spec = sd_unet_spec(base=32, cross=64)
    params = init_unet_sd(g, "cpu", spec=spec)
    cali = (torch.randn(4, 16, 16, 4, generator=g),
            torch.tensor([1, 250, 501, 999], dtype=torch.int32),
            torch.randn(4, 77, 64, generator=g))
    return {"tiny": (params, spec, cali), "ref": _tiny_recon(params, spec, cali, "cpu")}


# the CPU tests' tolerances (tests/test_torch_recon_loops.py): each step's loss
# within this relative gap, and more than RECON_NEAR_SHARE of the offsets
# within 1e-4. The walk with the temporal block gets 1e-4, as the tests give
# the temporal block: its sinusoidal input near 1000 rad differs by about
# 1e-4 between two libms.
RECON_LOSS_RTOL = {"mse": 5e-5, "tib fisher_diag": 1e-4}
RECON_NEAR_SHARE = 0.9


def _tiny_recon_check(tag, ref):
    """recon_path (0): the tiny walks on the card (TF32 off) against the CPU,
    with the CPU tests' tolerances: every step's loss of every unit within
    RECON_LOSS_RTOL relative, more than RECON_NEAR_SHARE of the offsets within
    1e-4, the same units walked, and as an outer bound every offset within
    2 lr K (Adam moves an offset by at most about lr a step, so two runs of K
    steps cannot part further) and the hard rounding equal wherever
    |alpha_cpu| exceeds it."""
    import torch

    saved_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        card = _tiny_recon(*ref["tiny"], "cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved_tf32
    bound = 2 * RECON_LR * RECON_ITERS
    failed = []
    for label, (got, got_units) in card.items():
        cpu, cpu_units = ref["ref"][label]
        worst, flips, near, total = 0.0, 0, 0, 0
        for name in cpu:
            d = (got[name] - cpu[name]).abs()
            firm = cpu[name].abs() > bound
            worst = max(worst, float(d.max()))
            flips += int(((got[name] >= 0) != (cpu[name] >= 0))[firm].sum())
            near += int((d <= 1e-4).sum())
            total += d.numel()
        same_walk = [u["name"] for u in got_units] == [u["name"] for u in cpu_units]
        loss_gap = max(abs(a - b) / abs(b) for gu, cu in zip(got_units, cpu_units)
                       for a, b in zip(gu["losses"], cu["losses"]))
        steps = sum(len(u["losses"]) for u in cpu_units)
        print(f"recon_path: tiny SD {label} walk ({len(cpu_units)} units, {len(cpu)} layers), "
              f"card against CPU: every step's loss within {loss_gap:.3g} relative over "
              f"{steps} steps (limit {RECON_LOSS_RTOL[label]:g}); {near / total:.6f} of the "
              f"offsets within 1e-4 (limit > {RECON_NEAR_SHARE}); offsets max |d| {worst:.6g} "
              f"(outer bound 2 lr K = {bound:g}), {flips} hard roundings differ where "
              f"|alpha_cpu| > it | {tag}", flush=True)
        if (set(got) != set(cpu) or not same_walk or loss_gap > RECON_LOSS_RTOL[label]
                or not near / total > RECON_NEAR_SHARE or worst > bound or flips):
            failed.append(label)
    if failed:
        raise AssertionError(f"recon_path: the tiny reconstruction on the card is not the "
                             f"CPU's: {failed}")


def _check_recon(label, units, want, tag, phase="recon_path", batch=8,
                 default_samples=RECON_DEFAULT_SAMPLES, kind_of=None):
    """A reconstruction run's probe records (`_ReconProbe.units`): `want`
    units, every loss finite, the learned hard rounding no worse than 1.5x
    nearest rounding on each unit's cached data (tests/test_calibration.py's
    bound); prints, by kind (`kind_of(record)`, the record's kind by
    default), the seconds a unit, ms an Adam step at `batch` and the largest
    captures a sample, then the largest unit's captures a sample and at the
    CLI's default data size, and the hours a 20000-step run of these units
    would take at this data size. Returns {kind: the kind's mean seconds of
    a unit's captures, folds and gradients, and of an Adam step}."""
    import math

    kind_of = kind_of or (lambda r: r["kind"])
    if len(units) != want:
        raise AssertionError(f"{phase} {label}: {len(units)} units, expected {want}")
    bad = [r["name"] for r in units if not all(math.isfinite(v) for v in r["losses"])]
    worse = [r["name"] for r in units if "err_learned" in r
             and not r["err_learned"] <= 1.5 * r["err_nearest"]]
    hours, rates = 0.0, {}
    for kind in sorted({kind_of(r) for r in units}):
        rs = [r for r in units if kind_of(r) == kind]

        def mean(key):
            return sum(r[key] for r in rs) / len(rs)
        ratios = [r["err_learned"] / r["err_nearest"] for r in rs if "err_learned" in r]
        big = max(rs, key=lambda r: r["bytes_a_sample"])
        print(f"{phase} {label}: {len(rs)} {kind} units, s a unit: captures "
              f"{mean('capture_s'):.3f}, folds {mean('fold_s'):.3f}, Fisher gradients "
              f"{mean('grad_s'):.3f}, Adam loop {mean('adam_s'):.3f} "
              f"({1e3 * mean('adam_s') / mean('iters'):.2f} ms a step at batch {batch}); "
              f"captures {big['bytes_a_sample'] / 2 ** 20:.2f} MiB a sample at most "
              f"({big['name']}); last loss "
              f"{min(r['losses'][-1] for r in rs):.6g} to {max(r['losses'][-1] for r in rs):.6g}"
              + (f"; unit error learned / nearest rounding {min(ratios):.4f} to "
                 f"{max(ratios):.4f}" if ratios else "") + f" | {tag}", flush=True)
        hours += sum(r["capture_s"] + r["fold_s"] + r["grad_s"]
                     + r["adam_s"] / r["iters"] * 20000 for r in rs) / 3600
        rates[kind] = (mean("capture_s") + mean("fold_s") + mean("grad_s"),
                       sum(r["adam_s"] / r["iters"] for r in rs) / len(rs))
    big = max(units, key=lambda r: r["bytes_a_sample"])
    print(f"{phase} {label}: the largest captures an Adam loop holds are {big['name']}'s, "
          f"{big['bytes_a_sample'] / 2 ** 20:.2f} MiB a sample: "
          f"{big['bytes_a_sample'] * default_samples / 2 ** 30:.2f} GiB at the CLI's "
          f"default {default_samples} samples | {tag}", flush=True)
    print(f"{phase} {label}: a 20000-step run of these {len(units)} units at this data size "
          f"would take {hours:.2f} h | {tag}", flush=True)
    if bad or worse:
        raise AssertionError(f"{phase} {label}: losses not finite at {bad[:4]}, learned "
                             f"rounding worse than 1.5x nearest at {worse[:4]}")
    return rates


def _host_walk_check(tmp, call, h_units, h_alphas, tag):
    """recon_path (h-host): (h)'s `calibrate_weights` call (`call`, kept by
    `_NearestPartials`) again on a copy of (h)'s partial saves without those
    of RECON_HOST_UNITS, so that the walk resumes every other unit and
    reconstructs these two, first with captures="host" (pinned host memory,
    each Adam step's rows copied to the card ahead of the step on a side
    stream), then with captures="device". Every step's loss and every offset
    of the two units must be (h)'s bit for bit in both forms, and the
    placement logged as forced. Prints ms an Adam step of (h) and of each
    form side by side."""
    import shutil

    import torch
    from dgq_tpu_torch.calib import reconstruction as TR

    args, kw = call
    want = {r["name"]: r for r in h_units if r["name"] in RECON_HOST_UNITS}
    layers = [l for u in TR.recon_units(args[1]) if u.name in RECON_HOST_UNITS for l in u.layers]
    card = args[0]["conv_in"]["w"].is_cuda
    runs, failed = {}, []
    for form in ("host", "device"):
        parts = os.path.join(tmp, f"parts_{form}")
        shutil.copytree(os.path.join(tmp, "parts"), parts)
        for name in RECON_HOST_UNITS:
            os.remove(os.path.join(parts, f"{name}.pth"))
        lines = []
        with _ReconProbe() as probe:
            alphas = TR.calibrate_weights(*args, **{**kw, "partial_dir": parts, "captures": form,
                                                    "progress": lines.append})
        shutil.rmtree(parts)
        got = {r["name"]: r for r in probe.units}
        placed = [l for l in lines if l.startswith("captures: ")]
        where = (("in pinned host memory" if card else "in host memory") if form == "host"
                 else ("on the card" if card else "on the CPU"))
        same_losses = set(got) == set(want) and all(
            got[n]["losses"] == want[n]["losses"] and got[n]["placement"] == form for n in want)
        same_offsets = all(torch.equal(alphas[l], h_alphas[l]) for l in layers)
        placed_ok = len(placed) == 2 and all(f'{where} (captures="{form}")' in l for l in placed)
        runs[form] = got
        print(f"recon_path (h-host) captures={form}: {sorted(got)} reconstructed, the other "
              f"units resumed; every step's loss bit for bit (h)'s: {same_losses}; the "
              f"{len(layers)} layers' offsets bit for bit (h)'s: {same_offsets}; placement "
              f"{placed} | {tag}", flush=True)
        if not (same_losses and same_offsets and placed_ok):
            failed.append(form)
        del alphas
    for name in RECON_HOST_UNITS:
        ms = {lbl: 1e3 * r["adam_s"] / r["iters"] for lbl, r in (
            ("(h)", want[name]), ("host", runs["host"].get(name)),
            ("device", runs["device"].get(name))) if r}
        print(f"recon_path (h-host) {name}: ms an Adam step at batch 8, "
              f"{want[name]['iters']} steps, the ring's first fill included: (h) on the card "
              f"{ms.get('(h)', 0):.2f}, "
              f"captures in pinned host memory {ms.get('host', 0):.2f}, on the card again "
              f"{ms.get('device', 0):.2f}; captures "
              f"{want[name]['bytes_a_sample'] / 2 ** 20:.2f} MiB a sample | {tag}", flush=True)
    if failed:
        raise AssertionError(f"recon_path (h-host): the walk with captures={failed} is not "
                             f"(h)'s bit for bit")


def recon_path(tag, ref):
    """Phase 7: weight reconstruction (AdaRound / BRECQ) at full width, from
    the port alone: SD v1.4, f32, 512px, random weights from seed 42, the
    calibration data cut as calib_path cuts it (CALI_PROMPTS prompts,
    CALI_STEPS PNDM steps: 20 samples), RECON_ITERS Adam steps a unit:
      (0) the tiny net's walks, card against CPU (`_tiny_recon_check`);
      (h) `cli.quantize_weight.main --wq 4 --cali --iters RECON_ITERS
          --max_units N --partial_dir D`, mse, asym, N the walk as far as
          the last of RECON_WALK: the units of RECON_WALK (every kind and
          place: a lone layer, a resnet, transformers at 64px and 8px, the
          downsampler, an up resnet on skip-concatenated inputs, an
          upsampler, up_blocks.3.resnets.0) reconstructed, each on the
          captures of its quantized prefix, the other units resumed from
          saves of their nearest rounding (`_NearestPartials`);
      (h-host) (h)'s walk again from a copy of D without the saves of
          RECON_HOST_UNITS (a transformer at 64px, up_blocks.3.resnets.0),
          with captures="host" and then "device": their losses and offsets
          bit for bit (h)'s (`_host_walk_check`);
      (i) the same command again on D: every unit resumed, the offsets bit
          for bit (h)'s;
      (j) --recon_loss fisher_diag --tib_recon --max_units RECON_FISHER_UNITS:
          the temporal block, then a resnet, lone layers and a transformer
          at 64px, each with the full-width Fisher gradient (the whole UNet's
          backward at batch 8);
      (k) `cli.infer.main --pallas_attn` on (h)'s weight-only file: W4 with
          no activation state, so every UNet attention runs K2, exact launch
          counts, four finite uint8 images.
    (h) to (j) differentiate the plain layers: no kernel may launch there."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    from dgq_tpu_torch.calib.act_calib import attention_prefixes
    from dgq_tpu_torch.calib.reconstruction import recon_units, tib_unit
    from dgq_tpu_torch.cli import infer, quantize_weight
    from dgq_tpu_torch.io.convert import params_to_torch_unet
    from dgq_tpu_torch.models import unet_sd
    from dgq_tpu_torch.pipeline.vae import init_vae_decoder, vae_decoder_spec

    spec = unet_sd.sd_unet_spec()
    names = [u.name for u in recon_units(spec)]
    walk_units = 1 + max(names.index(n) for n in RECON_WALK)
    print(f"recon_path: cuts: --cali_prompt_data_n 64 -> {CALI_PROMPTS}, --step_size 25 -> "
          f"{CALI_STEPS} ({4 * CALI_PROMPTS * (CALI_STEPS + 1) // 2} samples), --iters 20000 -> "
          f"{RECON_ITERS}; (j) --max_units {RECON_FISHER_UNITS} (the first transformer is the "
          f"7th unit); (h) reconstructs {len(RECON_WALK)} of its walk's {walk_units} units "
          f"(of {RECON_UNITS_SD}), the others resumed from saves of their nearest rounding; "
          f"widths, 512px and batch 8 not cut | {tag}", flush=True)
    _tiny_recon_check(tag, ref)

    n_att = len(attention_prefixes(spec))
    tmp_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(tmp_root, exist_ok=True)
    no_kernel = lambda f: {}  # noqa: E731

    def cli(label, argv, forwards=0, want=no_kernel):
        with _ReconProbe() as probe:
            res = _run_cli("recon_path", label, quantize_weight.main, argv, forwards, want, tag)
        return res, probe

    with tempfile.TemporaryDirectory(dir=tmp_root) as tmp:
        common = ["--model", "sd", "--wq", "4", "--cali", "--cali_prompt_data_n",
                  str(CALI_PROMPTS), "--step_size", str(CALI_STEPS), "--iters",
                  str(RECON_ITERS), "--cali_data_path", os.path.join(tmp, "cali")]
        walk = common + ["--max_units", str(walk_units), "--partial_dir",
                         os.path.join(tmp, "parts")]
        with _NearestPartials(RECON_WALK) as nearest:
            h, probe = cli("(h) quantize_weight", walk + ["--outdir", os.path.join(tmp, "h")])
        print(f"recon_path (h): {nearest.written} units resumed from saves of their nearest "
              f"rounding, written in {nearest.seconds:.2f} s; reconstructed "
              f"{[r['name'] for r in probe.units]} | {tag}", flush=True)
        if [r["name"] for r in probe.units] != [n for n in names if n in RECON_WALK] or (
                nearest.written != walk_units - len(RECON_WALK)):
            raise AssertionError("recon_path (h): the walk did not reconstruct RECON_WALK alone")
        _check_recon("(h)", probe.units, len(RECON_WALK), tag)
        alphas, weight_only = h["alphas"], h["weight_only"]
        del h
        _host_walk_check(tmp, nearest.call, probe.units, alphas, tag)
        nearest.call = None
        i, probe = cli("(i) quantize_weight, resumed",
                       walk + ["--outdir", os.path.join(tmp, "i")])
        saves = len(os.listdir(os.path.join(tmp, "parts")))
        same = set(i["alphas"]) == set(alphas) and all(
            torch.equal(i["alphas"][n], a) for n, a in alphas.items())
        print(f"recon_path (i): {saves} partial saves, {len(probe.units)} units reconstructed "
              f"and {probe.captures} captures made, {len(alphas)} layers' offsets bit for bit "
              f"(h)'s: {same} | {tag}", flush=True)
        if saves != walk_units or probe.units or probe.captures or not same:
            raise AssertionError("recon_path (i): the resumed run is not (h)'s")
        del i, alphas
        shutil.rmtree(os.path.join(tmp, "i"))  # the machine's disk: keep only what is read later
        j, probe = cli("(j) quantize_weight, tib + fisher_diag",
                       common + ["--outdir", os.path.join(tmp, "j"), "--recon_loss",
                                 "fisher_diag", "--tib_recon", "--max_units",
                                 str(RECON_FISHER_UNITS)])
        tib = set(tib_unit(spec).layers)  # its record first, then the units it leaves
        _check_recon("(j)", probe.units, 1 + sum(
            bool(set(u.layers) - tib) for u in recon_units(spec)[:RECON_FISHER_UNITS]), tag)
        kinds = [r["kind"] for r in probe.units]
        if (kinds[0] != "tib" or "transformer" not in kinds or "resnet" not in kinds
                or not all(r["grad_s"] > 0 for r in probe.units[1:])):
            raise AssertionError(f"recon_path (j): the walk is {kinds}, or a unit had no "
                                 f"Fisher gradient")
        del j
        shutil.rmtree(os.path.join(tmp, "j"))

        vae_dir = os.path.join(tmp, "vae")
        os.makedirs(vae_dir)
        g = torch.Generator(device="cuda").manual_seed(7)
        torch.save(params_to_torch_unet(init_vae_decoder(g, "cuda"), vae_decoder_spec()),
                   os.path.join(vae_dir, "diffusion_pytorch_model.bin"))
        res = _run_cli("recon_path", "(k) infer", infer.main,
                       ["--model", "sd", "--cali_ckpt", weight_only, "--num_inference_steps",
                        str(CALI_STEPS), "--vae_weights", vae_dir, "--outdir", tmp,
                        "--pallas_attn"],
                       CALI_STEPS + 1,  # one batched forward a PNDM call
                       lambda f: {"flash_attention": n_att * f + 2}, tag)  # + the two decodes
        images = [np.load(o) for o in res["outputs"]]
        print(f"recon_path (k) infer: {[os.path.basename(o) for o in res['outputs']]}, load + "
              f"fold {res['load_fold_s']:.2f} s, runs {res['run_s']} s | {tag}", flush=True)
        if len(images) != 4 or any(im.shape != (512, 512, 3) or im.dtype != np.uint8
                                   for im in images):
            raise AssertionError("recon_path (k): not four uint8 images of 512px")
    torch.cuda.empty_cache()


DP_UNITS = 7    # (p)'s --max_units: lone layers, resnets, projections, the first transformer
TP_UNITS = 3    # tp_path (s)'s --max_units, the first of (p)'s units: lone layers and a resnet
DP_PROMPTS = 4  # (q)'s prompts: one batch of 4, 2 rows a rank
DP_FP_LEVELS = 8  # (q) --fp: the largest |d| of a --dp 2 image from --dp 1's, of 255
DP_RED_RTOL = 1e-3  # (q) one step: the first reduced real-time statistic against --dp 1's
DP_LATENT_TOL = 2e-2  # (q) one step: the largest |d| of --dp 2's latents, of their largest |x|


class _RealTimeProbe:
    """While open, records each real-time softmax reduction of the fused
    attention (`ops.attention.batch_reduce_`, between `rt_stats` and
    `quant_accum`): `pairs` gets [the rank's own value, the value after the
    reduction] (one value twice outside a data-parallel split)."""

    def __enter__(self):
        from dgq_tpu_torch.ops import attention

        self._real, self._held = attention.batch_reduce_, []

        def probe(t, op):
            own = t.clone()
            self._held.append((own, self._real(t, op).clone()))
            return t
        attention.batch_reduce_ = probe
        return self

    def __exit__(self, *exc):
        from dgq_tpu_torch.ops import attention

        attention.batch_reduce_ = self._real
        self.pairs = [[float(a), float(b)] for a, b in self._held]
        return False


def _torchrun(flag, spec_path, log_path, timeout, beside=None):
    """One `python -m torch.distributed.run --standalone --nproc_per_node 2`
    launch of this script's `flag` (--dp-rank / --tp-rank) on `spec_path`,
    its output into `log_path`, in a session of its own; `beside()`, if
    given, runs in this process while the ranks do. Waits for the launch
    (the timeout counts from its start) and stops every process of its
    session if it outlives that or `beside` raises. Returns (exit code,
    seconds from the start to the end of the launch, the log)."""
    import signal

    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        launch = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
             "2", os.path.abspath(__file__), flag, spec_path], stdout=log,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
        ended = []  # when the launch ended, which `beside` may outlast
        watch = threading.Thread(target=lambda: ended.append((launch.wait(),
                                                              time.perf_counter())))
        watch.start()
        try:
            if beside is not None:
                beside()
            watch.join(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
        finally:
            if launch.poll() is None:
                os.killpg(launch.pid, signal.SIGTERM)
                try:
                    launch.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    os.killpg(launch.pid, signal.SIGKILL)
                    launch.wait()
            watch.join()
    seconds = ended[0][1] - t0
    with open(log_path) as log:
        return launch.returncode, seconds, log.read()


def dp_rank(spec_path):
    """One rank of dp_path's torchrun launch (`python3 chip_smoke.py --dp-rank
    SPEC`): each run of the spec's list calls the CLI's `main(argv)` with
    the launch counts set to 0 just before it, and the rank writes
    rank<r>.json into the spec's directory: per run its seconds, peak memory
    and launch counts, for `quantize_weight` the probe's unit records
    (`_ReconProbe`; its offsets go to alphas_rank<r>.pt), for `gen4eval` the
    files it wrote and its real-time reductions (`_RealTimeProbe`). A run
    with "tf32": false turns TF32 off for its matmuls and convolutions, as
    `_tiny_recon_check` does."""
    import torch
    import torch.distributed as dist
    from dgq_tpu_torch.cli import gen4eval, quantize_weight
    from dgq_tpu_torch.ops import build
    from dgq_tpu_torch.parallel.mesh import leave_multihost

    with open(spec_path) as f:
        spec = json.load(f)
    build.load_kernels()  # the parent built them: the libraries load as they are
    rank = int(os.environ["RANK"])
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    results = {}
    for run in spec["runs"]:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = (
            tf32 if run["tf32"] else (False, False))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()
        t0 = time.perf_counter()
        if run["cli"] == "quantize_weight":
            with _ReconProbe() as probe:
                res = quantize_weight.main(run["argv"])
            torch.save({n: a.cpu() for n, a in res["alphas"].items()},
                       os.path.join(spec["out"], f"alphas_rank{rank}.pt"))
            extra = {"weight_only": res["weight_only"], "units": [
                {k: u[k] for k in ("name", "kind", "losses", "held_bytes", "adam_s", "iters")}
                for u in probe.units]}
        else:
            with _RealTimeProbe() as probe:
                res = gen4eval.main(run["argv"])
            extra = {"files": sorted(os.path.basename(f) for f in res["files"]),
                     "reductions": probe.pairs}
        torch.cuda.synchronize()
        results[run["label"]] = {"seconds": time.perf_counter() - t0,
                                 "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                                 "launches": {n: c for n, c in _launch_counts().items() if c},
                                 **extra}
    results["rank"] = [dist.get_rank(), dist.get_world_size(), dist.get_backend(),
                       f"cuda:{torch.cuda.current_device()}"]
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    leave_multihost()


def _nccl_world_of_one(tag):
    """dp_path (o): a world of one over NCCL from torchrun's environment
    variables: `init_multihost`, whose backend rule must pick nccl for one
    rank with a card of its own, `sync_mean` on a tree on
    the card (the identity), one all_reduce and one `all_reduce_sum_` on
    the card; then the group is destroyed and the environment restored."""
    import socket

    import torch
    import torch.distributed as dist
    from dgq_tpu_torch.parallel.mesh import all_reduce_sum_, init_multihost, make_mesh, sync_mean

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "RANK": "0",
           "WORLD_SIZE": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        if not init_multihost(device="cuda"):  # one rank, one card: the rule picks nccl
            raise AssertionError("dp_path (o): init_multihost found no rendezvous")
        mesh = make_mesh(dp=1, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(3)
        tree = {"delta": torch.rand(320, generator=g, device="cuda"), "zp": 128.0}
        synced = sync_mean(mesh, tree)
        t = torch.arange(1 << 20, dtype=torch.float32, device="cuda")
        want = t.clone()
        dist.all_reduce(t)
        u = [want.clone(), torch.ones(7, device="cuda")]
        all_reduce_sum_(mesh, u)
        torch.cuda.synchronize()
        ok = (dist.get_backend() == "nccl" and synced is tree and torch.equal(t, want)
              and torch.equal(u[0], want) and mesh.world == 1)
        print(f"dp_path (o): a world of one over {dist.get_backend()} (MASTER_ADDR localhost, "
              f"port {port}), device {mesh.device}: sync_mean the identity, all_reduce and "
              f"all_reduce_sum_ of 4 MiB on the card unchanged: {ok} | {tag}", flush=True)
        if not ok:
            raise AssertionError("dp_path (o): the NCCL world of one is not the identity")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _dp_recon_check(dp1, dp1_peak, dp2, alphas1, root, tag):
    """dp_path (p): both ranks' walks against the --dp 1 walk, with the
    limits of `_tiny_recon_check`; the ranks' offsets equal and their
    captures half of dp 1's."""
    import hashlib

    import torch

    a0, a1 = (torch.load(os.path.join(root, f"alphas_rank{r}.pt")) for r in range(2))
    sums = [hashlib.sha256(b"".join(a[n].numpy().tobytes() for n in sorted(a))).hexdigest()[:16]
            for a in (a0, a1)]
    ranks_equal = set(a0) == set(a1) and all(torch.equal(a0[n], a1[n]) for n in a0)
    near = total = 0
    worst = 0.0
    for n, a in alphas1.items():
        d = (a0[n] - a.cpu()).abs()
        worst = max(worst, float(d.max()))
        near += int((d <= 1e-4).sum())
        total += d.numel()
    names = [u["name"] for u in dp1]
    same_walk = all([u["name"] for u in r["units"]] == names for r in dp2)
    gap = max(abs(a - b) / abs(b) for r in dp2 for u2, u1 in zip(r["units"], dp1)
              for a, b in zip(u2["losses"], u1["losses"]))
    held1 = sum(u["held_bytes"] for u in dp1)
    halves = all(2 * u2["held_bytes"] == u1["held_bytes"] for r in dp2
                 for u2, u1 in zip(r["units"], dp1))
    step1 = sum(u["adam_s"] / u["iters"] for u in dp1) / len(dp1)
    print(f"dp_path (p): quantize_weight --dp 2 against --dp 1 ({len(names)} units: "
          f"{', '.join(sorted({u['kind'] for u in dp1}))}): every step's loss within {gap:.3g} "
          f"relative over {sum(len(u['losses']) for u in dp1)} steps (limit "
          f"{RECON_LOSS_RTOL['mse']:g}); {near / total:.6f} of the offsets within 1e-4 (limit > "
          f"{RECON_NEAR_SHARE}), max |d| {worst:.6g}; the ranks' offsets equal: {ranks_equal} "
          f"(sha256 {sums[0]}, {sums[1]}) | {tag}", flush=True)
    print(f"dp_path (p) --dp 1: peak {dp1_peak:.2f} GiB allocated, captures {held1 / 2 ** 20:.2f} "
          f"MiB over the walk's units ({max(u['held_bytes'] for u in dp1) / 2 ** 20:.2f} MiB the "
          f"largest), {1e3 * step1:.2f} ms an Adam step (mean over units) | {tag}", flush=True)
    for r, res in enumerate(dp2):
        held = sum(u["held_bytes"] for u in res["units"])
        step = sum(u["adam_s"] / u["iters"] for u in res["units"]) / len(res["units"])
        print(f"dp_path (p) --dp 2 rank {r}: peak {res['peak_gib']:.2f} GiB allocated, captures "
              f"{held / 2 ** 20:.2f} MiB ({held / held1:.4f} of dp 1's; the largest unit "
              f"{max(u['held_bytes'] for u in res['units']) / 2 ** 20:.2f} MiB), "
              f"{1e3 * step:.2f} ms an Adam step (two ranks on one card, gradients summed over "
              f"gloo), run {res['seconds']:.2f} s | {tag}", flush=True)
    if (not same_walk or gap > RECON_LOSS_RTOL["mse"] or not near / total > RECON_NEAR_SHARE
            or not ranks_equal or not halves or set(a0) != set(alphas1)):
        raise AssertionError(f"dp_path (p): --dp 2 is not --dp 1 (walk {same_walk}, loss gap "
                             f"{gap:.3g}, near {near / total:.4f}, ranks equal {ranks_equal}, "
                             f"half captures {halves})")


def _dp_one_step_check(ranks, reds1, want, tmp, tag):
    """dp_path (q), one step of W4A8 g=8: the real-time statistic of every
    attention call, reduced over both ranks, against --dp 1's (each rank's
    own, unreduced value beside it: what a rank without the reduction would
    quantize with), the first call held to DP_RED_RTOL; and the latents
    against --dp 1's."""
    import numpy as np

    pairs = [r["q one step"]["reductions"] for r in ranks]
    if not len(pairs[0]) == len(pairs[1]) == len(reds1) == want["rt_stats"]:
        raise AssertionError(f"dp_path (q one step): {[len(p) for p in pairs]} reductions a "
                             f"rank, {len(reds1)} at --dp 1, {want['rt_stats']} expected")
    ranks_equal = all(a[1] == b[1] for a, b in zip(*pairs))
    # relative gaps a call, the larger of the two ranks': [0] a rank's own
    # value, [1] the reduced one; only the first call sees inputs that the
    # chaotic forward has not yet parted
    gaps = [[max(abs(p[i][k] - w) / abs(w) for p in pairs) for k in (0, 1)]
            for i, w in enumerate(reds1)]
    own, reduced = ([g[k] for g in gaps] for k in (0, 1))
    files = sorted(sum((r["q one step"]["files"] for r in ranks), []))
    dp1_files = sorted(os.listdir(os.path.join(tmp, "s1")))
    worst = scale = 0.0
    for name in dp1_files:
        a = np.load(os.path.join(tmp, "s2", name))
        b = np.load(os.path.join(tmp, "s1", name))
        if a.shape != (64, 64, 4) or not np.isfinite(a).all():
            raise AssertionError(f"dp_path (q one step): {name} is {a.shape} or not finite")
        worst, scale = max(worst, float(np.abs(a - b).max())), max(scale, float(np.abs(b).max()))
    counts = [_kernels_only(r["q one step"]["launches"]) for r in ranks]
    print(f"dp_path (q one step) gen4eval W4A8 g=8, one PNDM step, latents: {len(reds1)} "
          f"real-time reductions a rank, equal on both ranks: {ranks_equal}; against --dp 1's, "
          f"relative, reduced over the ranks: first call {reduced[0]:.3g} (limit "
          f"{DP_RED_RTOL:g}), median {np.median(reduced):.3g}, max {max(reduced):.3g}; a rank's "
          f"own value (no reduction): first call {own[0]:.3g}, median {np.median(own):.3g}, max "
          f"{max(own):.3g}; latents max |d| {worst:.6g} of max |x| {scale:.6g} "
          f"({worst / scale:.3g}, limit {DP_LATENT_TOL:g}); the same files "
          f"{files == dp1_files}; launches {counts} (expected {want} each) | {tag}", flush=True)
    if (not ranks_equal or reduced[0] > DP_RED_RTOL or worst > DP_LATENT_TOL * scale
            or files != dp1_files or any(c != want for c in counts)):
        raise AssertionError(f"dp_path (q one step): --dp 2 is not --dp 1 (ranks equal "
                             f"{ranks_equal}, reduced gap at the first call {reduced[0]:.3g}, "
                             f"latents {worst:.3g} of {scale:.3g}, files {files}, launches "
                             f"{counts})")


def dp_path(tag, calib, s_4a, beside=None):
    """Phase 9, after recon_path: data parallelism over torch.distributed, in
    a temporary directory under build/ (SD v1.4 at full width, random weights
    from seed 42):
      (o) a world of one over NCCL (`_nccl_world_of_one`);
      (p) `cli.quantize_weight --dp 2`: two ranks of one torchrun launch
          (`python -m torch.distributed.run --standalone --nproc_per_node 2`)
          share the card over gloo; f32, minmax W4, recon_path's 24
          samples and RECON_ITERS Adam steps over the first DP_UNITS units, TF32
          off; against the same command with --dp 1 in this process: each
          step's loss within 5e-5 relative, more than 0.9 of the offsets
          within 1e-4, every rank's offsets equal, each rank's captures half
          of dp 1's; rank 0 writes the one checkpoint;
      (q) in the same launch, `cli.gen4eval --dp 2` at 512px, DP_PROMPTS
          prompts, CALI_STEPS PNDM steps, through calib_path's VAE: --fp, and
          W4A8 g=8 from calib_path's merged file with --pallas_attn
          --group_impl fused (K3b, K5 and K2 in each rank, exact launch
          counts); against --dp 1 in this process: the same files, and the fp
          images within DP_FP_LEVELS levels of 255; then one W4A8 step with
          its latents written (`_dp_one_step_check`): the first real-time
          statistic, reduced over the ranks between rt_stats and
          quant_accum, within DP_RED_RTOL of --dp 1's (every call's gap
          printed), and the latents within DP_LATENT_TOL of their largest
          value;
      (r) one SD v1.4 g=1 DDIM step (K1) under `utils.profiler.device_trace`:
          the trace names quant_tc_kernel; the kernels' busy share of the
          step; `spec_roofline`'s SOL ms at batch 4 beside 4a's s a forward
          (SDXL-turbo's beside 4e's is printed after sdxl_path).
    Any rank's failure fails the launch and the phase. Returns (p)'s --dp 1
    walk for tp_path (s): {'alphas' (on the CPU), 'units', 'peak', 'held',
    'argv'}."""
    import tempfile

    import numpy as np
    import torch
    from PIL import Image
    from dgq_tpu_torch.calib.act_calib import attention_prefixes
    from dgq_tpu_torch.calib.reconstruction import recon_units
    from dgq_tpu_torch.cli import gen4eval, quantize_weight
    from dgq_tpu_torch.models.unet_sd import sd_unet_spec

    _nccl_world_of_one(tag)
    n_att = len(attention_prefixes(sd_unet_spec()))
    tmp_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    t2i = ["--t2i_log_quant", "--t2i_real_time", "--t2i_start_peak", "--time_aware_aqtizer"]
    forwards = CALI_STEPS + 1  # a PNDM call is one forward of the CFG-doubled batch
    q8 = {"flash_attention": 1, "rt_stats": n_att * forwards, "quant_accum": n_att * forwards,
          "group_quant_conv": calib["k5_convs"] * forwards}
    # one PNDM step (one forward), the latents written as they are: no VAE
    q1 = {"rt_stats": n_att, "quant_accum": n_att, "group_quant_conv": calib["k5_convs"]}
    with tempfile.TemporaryDirectory(dir=tmp_root) as tmp:
        csv = os.path.join(tmp, "prompts.csv")
        with open(csv, "w") as f:
            f.write("caption\n" + "".join(f"prompt number {i}\n" for i in range(DP_PROMPTS)))
        qw = ["--model", "sd", "--wq", "4", "--cali_prompt_data_n", str(CALI_PROMPTS),
              "--step_size", str(CALI_STEPS), "--iters", str(RECON_ITERS), "--max_units",
              str(DP_UNITS), "--cali_data_path", os.path.join(os.path.dirname(calib["merged"]),
                                                               "dp_cali")]
        gen = ["--model", "sd", "--prompts", csv, "--batch", str(DP_PROMPTS), "--steps",
               str(CALI_STEPS), "--vae_weights", calib["vae_dir"]]
        gen1 = ["--model", "sd", "--prompts", csv, "--batch", str(DP_PROMPTS), "--steps", "1"]
        gen_q = ["--cali_ckpt", calib["merged"], "--use_aq", "--use_group", "--pallas_attn",
                 "--group_impl", "fused"] + t2i

        # --dp 1 in this process (TF32 off for the walk, as in the ranks)
        saved_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            with _ReconProbe() as probe:
                res = _run_cli("dp_path", "(p) quantize_weight --dp 1", quantize_weight.main,
                               qw + ["--outdir", os.path.join(tmp, "qw1")], 0, lambda f: {}, tag)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved_tf32
        dp1_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        alphas1, dp1_units = res["alphas"], probe.units
        # tp_path (s) walks the first TP_UNITS of these units: a unit's walk
        # depends on the units before it alone, so its part of this run is
        # its --tp 1 reference
        tp_layers = {n for u in recon_units(sd_unet_spec())[:TP_UNITS] for n in u.layers}
        tp_alphas = {n: a for n, a in alphas1.items() if n in tp_layers}
        tp1 = {"alphas": {n: a.cpu() for n, a in tp_alphas.items()},
               "units": dp1_units[:TP_UNITS], "peak": dp1_peak,
               "held": _held_bytes(res["params"], tp_alphas, dp1_units[:TP_UNITS]),
               "argv": qw + ["--max_units", str(TP_UNITS)]}  # the cache stays in `keep`
        del res
        _run_cli("dp_path", "(q) gen4eval --fp --dp 1", gen4eval.main,
                 gen + ["--fp", "--outdir", os.path.join(tmp, "fp1")], 0,
                 lambda f: {"flash_attention": 1}, tag)
        _run_cli("dp_path", "(q) gen4eval W4A8 g=8 --dp 1", gen4eval.main,
                 gen + gen_q + ["--outdir", os.path.join(tmp, "q1")], forwards, lambda f: q8,
                 tag)
        with _RealTimeProbe() as probe:
            _run_cli("dp_path", "(q) gen4eval W4A8 g=8 one step --dp 1", gen4eval.main,
                     gen1 + gen_q + ["--outdir", os.path.join(tmp, "s1")], 1, lambda f: q1, tag)
        reds1 = [b for _, b in probe.pairs]

        # --dp 2: one torchrun launch, two ranks on the card
        spec = {"out": tmp, "runs": [
            {"label": "p", "cli": "quantize_weight", "tf32": False,
             "argv": qw + ["--dp", "2", "--outdir", os.path.join(tmp, "qw2")]},
            {"label": "q fp", "cli": "gen4eval", "tf32": True,
             "argv": gen + ["--fp", "--dp", "2", "--outdir", os.path.join(tmp, "fp2")]},
            {"label": "q w4a8g8", "cli": "gen4eval", "tf32": True,
             "argv": gen + gen_q + ["--dp", "2", "--outdir", os.path.join(tmp, "q2")]},
            {"label": "q one step", "cli": "gen4eval", "tf32": True,
             "argv": gen1 + gen_q + ["--dp", "2", "--outdir", os.path.join(tmp, "s2")]}]}
        spec_path = os.path.join(tmp, "dp_spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        torch.cuda.empty_cache()
        code, seconds, out = _torchrun("--dp-rank", spec_path, os.path.join(tmp, "launch.log"),
                                       600, beside)
        if code != 0:
            raise AssertionError(f"dp_path: the --dp 2 launch exited {code}:\n{out[-9000:]}")
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        named = [f"rank {r} of 2: backend gloo, device cuda:0" in out for r in range(2)]
        print(f"dp_path: torchrun --standalone --nproc_per_node 2, {seconds:.2f} s for the launch "
              f"(start-up, the three runs, exit); ranks {[r['rank'] for r in ranks]}; each "
              f"rank's first line names its backend and device: {all(named)} | {tag}",
              flush=True)
        if not all(named) or [r["rank"][:3] for r in ranks] != [[0, 2, "gloo"], [1, 2, "gloo"]]:
            raise AssertionError("dp_path: the ranks are not two gloo ranks of one group")

        # (p)
        run_dirs = os.listdir(os.path.join(tmp, "qw2"))
        wrote = [r["p"]["weight_only"] for r in ranks]
        if len(run_dirs) != 1 or wrote[1] is not None or not os.path.exists(wrote[0]):
            raise AssertionError(f"dp_path (p): run directories {run_dirs}, checkpoints {wrote}")
        _dp_recon_check(dp1_units, dp1_peak, [r["p"] for r in ranks], alphas1, tmp, tag)

        # (q)
        for label, dp1_dir, dp2_dir, want in (("q fp", "fp1", "fp2", {"flash_attention": 1}),
                                              ("q w4a8g8", "q1", "q2", q8)):
            files = [r[label]["files"] for r in ranks]
            dp1_files = sorted(os.listdir(os.path.join(tmp, dp1_dir)))
            counts = [_kernels_only(r[label]["launches"]) for r in ranks]
            diffs = []
            for name in dp1_files:
                a = np.asarray(Image.open(os.path.join(tmp, dp2_dir, name)), dtype=np.int16)
                b = np.asarray(Image.open(os.path.join(tmp, dp1_dir, name)), dtype=np.int16)
                if a.shape != (512, 512, 3) or a.std() == 0:
                    raise AssertionError(f"dp_path ({label}): {name} is {a.shape}, degenerate")
                diffs.append(np.abs(a - b))
            worst = max(int(d.max()) for d in diffs)
            mean = float(np.mean([d.mean() for d in diffs]))
            print(f"dp_path ({label}) gen4eval --dp 2: rank files {files}, launches per rank "
                  f"{counts} (expected {want} each), peak "
                  f"{[round(r[label]['peak_gib'], 2) for r in ranks]} GiB, "
                  f"{[round(r[label]['seconds'], 2) for r in ranks]} s; against --dp 1: "
                  f"the same files {sorted(sum(files, [])) == dp1_files}, max |d| {worst} of 255, "
                  f"mean |d| {mean:.4f} | {tag}", flush=True)
            if sorted(sum(files, [])) != dp1_files or len(dp1_files) != DP_PROMPTS or any(
                    c != want for c in counts):
                raise AssertionError(f"dp_path ({label}): files {files} / {dp1_files}, "
                                     f"launches {counts}")
            if label == "q fp" and worst > DP_FP_LEVELS:
                raise AssertionError(f"dp_path (q fp): --dp 2 images differ from --dp 1's by "
                                     f"{worst} levels (limit {DP_FP_LEVELS})")
        _dp_one_step_check(ranks, reds1, q1, tmp, tag)

        # (r)
        _profiled_step(tmp, s_4a, tag)
    torch.cuda.empty_cache()
    return tp1


def _profiled_step(tmp, s_4a, tag):
    """dp_path (r): one SD v1.4 g=1 DDIM step (K1 in every attention, batch
    4) on main_paths' model, after a warm-up step, under `device_trace`;
    then `spec_roofline`'s SOL beside 4a's measured s a forward."""
    import torch
    from dgq_tpu_torch.models.qconfig import QConfig
    from dgq_tpu_torch.pipeline.sampler import sd_sample
    from dgq_tpu_torch.utils.flops import spec_roofline
    from dgq_tpu_torch.utils.profiler import device_trace
    from dgq_tpu_torch.utils.synthetic import synthetic_pertensor_qstate

    model = build_model(tag)
    cfg = QConfig(w_bits=4, a_bits=8, softmax_bits=8, use_wq=True, use_aq=True,
                  use_pallas_attention=True)
    qstate = synthetic_pertensor_qstate(model["spec"], 1, True, torch.bfloat16)

    def step():
        out = sd_sample(model["params"], model["latents"], model["ehs_t"], model["ehs_u"],
                        num_inference_steps=1, guidance_scale=7.5, qstate=qstate, cfg=cfg,
                        time_aware=True)
        torch.cuda.synchronize()
        return out
    step()
    _reset_launch_counts()
    t0 = time.perf_counter()
    with device_trace(os.path.join(tmp, "trace")) as prof:
        step()
    wall = time.perf_counter() - t0
    launches = {n: c for n, c in _launch_counts().items() if c}
    with open(prof.trace_path) as f:
        text = f.read()
    events = json.loads(text)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    busy_us = sum(e.get("dur", 0) for e in kernels)
    k1 = [e for e in kernels if "quant_tc_kernel" in e.get("name", "")]
    span_us = (max(e["ts"] + e.get("dur", 0) for e in kernels) - min(e["ts"] for e in kernels)
               if kernels else 0.0)
    print(f"dp_path (r): one g=1 DDIM step (batch 4) under device_trace: {wall:.4f} s with the "
          f"profiler on; {os.path.getsize(prof.trace_path) / 2 ** 20:.2f} MiB trace, "
          f"{len(kernels)} kernel events, {len(k1)} of quant_tc_kernel "
          f"({sum(e.get('dur', 0) for e in k1) / 1e3:.3f} ms); kernels busy "
          f"{busy_us / 1e3:.3f} ms of the {span_us / 1e3:.3f} ms from the first kernel's start "
          f"to the last one's end ({busy_us / max(span_us, 1e-9):.4f}); launches {launches} | "
          f"{tag}", flush=True)
    if ("quant_tc_kernel" not in text
            or _kernels_only(launches) != {"static_uniform_attention": 32}):
        raise AssertionError(f"dp_path (r): the trace does not name quant_tc_kernel, or the "
                             f"launches are {launches}")
    sol = spec_roofline(model["spec"], latent_hw=64, batch=2 * IMAGES)
    print(f"dp_path (r): spec_roofline SD v1.4 at batch {2 * IMAGES} (989 TF/s, 3350 GB/s): SOL "
          f"{sol['sol_s'] * 1e3:.3f} ms (compute {sol['compute_s'] * 1e3:.3f}, memory "
          f"{sol['memory_s'] * 1e3:.3f}); 4a's g=1 forward {s_4a * 1e3:.3f} ms: SOL is "
          f"{sol['sol_s'] / s_4a:.4f} of it | {tag}", flush=True)
    del model


TP_ADAM_RTOL = RECON_LOSS_RTOL["mse"]  # (s): every step's loss against --tp 1's
TP_LAUNCH_TIMEOUT = 900  # s, the --tp 2 launch
# (t)'s calibration cut, from calib_path's 2 prompts x 5 PNDM steps: two
# ranks that share the card gather every cut layer's output through the host
# over gloo, 3.5 s a forward at batch 4 against 0.19 at --tp 1 (an H100 at 700 W),
# and an activation calibration makes 15 forwards a time slot
TP_CALI_PROMPTS = 1
TP_CALI_STEPS = 1


def _held_bytes(params, alphas, units):
    """The bytes a rank holds of the weights (its shards and the replicated
    leaves, `cut` the shards alone), of the offsets of every reconstructed
    layer, and of the Adam moments of the largest unit (two a offset; one
    unit's loop is alive at a time): {'weights', 'cut', 'offsets',
    'moments'}."""
    import torch

    weights = cut = 0
    for p in params.values():
        for k, v in p.items():
            if torch.is_tensor(v):
                weights += v.nbytes
                cut += v.nbytes if "tp" in p else 0
    return {"weights": weights, "cut": cut,
            "offsets": sum(a.nbytes for a in (alphas or {}).values()),
            "moments": 2 * max((u.get("alpha_bytes", 0) for u in units), default=0)}


def _rows_of_file(path, params, wqp, alphas):
    """Whether each of a rank's tensors equals its rows of the weight-only
    file at `path` bit for bit (the whole tensor for a replicated layer):
    (all equal, tensors compared)."""
    import torch
    from dgq_tpu_torch.io.dgq_ckpt import PREFIX

    state = torch.load(path, map_location="cpu", mmap=True, weights_only=False)["weight"]
    ok, n = True, 0
    for name, p in params.items():
        rows = p["tp"].rows if "tp" in p else slice(None)
        mine = {"w": p.get("w"), "b": p.get("b"), "weight": p.get("scale"),
                "bias": p.get("bias")}
        if name in wqp:
            mine["wqtizer.delta"], mine["wqtizer.zero_point"] = wqp[name]
        if alphas and name in alphas:
            mine["wqtizer.alpha"] = alphas[name]
        for key, v in mine.items():
            if v is None:
                continue
            whole = state[f"{PREFIX}{name}.{key}"]
            part = whole[rows] if key not in ("weight", "bias") else whole
            ok = ok and torch.equal(part.reshape(v.shape), v.detach().cpu())
            n += 1
    return ok, n


def _same_files(a, b):
    """(every tensor of two weight-only files equal bit for bit, tensors,
    bytes), read through mmap."""
    import torch

    x = torch.load(a, map_location="cpu", mmap=True, weights_only=False)["weight"]
    y = torch.load(b, map_location="cpu", mmap=True, weights_only=False)["weight"]
    same = set(x) == set(y) and all(torch.equal(x[k], y[k]) for k in x)
    return same, len(x), sum(v.nbytes for v in x.values())


def tp_rank(spec_path):
    """One rank of tp_path's torchrun launch (`python3 chip_smoke.py --tp-rank
    SPEC`): each run of the spec's list calls `cli.quantize_weight.main(argv)`
    with the launch counts set to 0 just before it; after a barrier (rank 0
    has written), a run with "rows" holds the rank's shards against their
    rows of the written file. The rank writes rank<r>.json into the spec's
    directory: per run its seconds (and the CLI's), peak memory, launch
    counts, bytes held (`_held_bytes`), the probe's unit records; its offset
    shards and their rows go to alphas_<label>_rank<r>.pt, and rank 0 writes
    each activation state to per_t_<label>.pt. A run with "tf32": false
    turns TF32 off, as dp_rank does."""
    import torch
    import torch.distributed as dist
    from dgq_tpu_torch.cli import quantize_weight
    from dgq_tpu_torch.ops import build
    from dgq_tpu_torch.parallel.mesh import leave_multihost

    with open(spec_path) as f:
        spec = json.load(f)
    build.load_kernels()
    rank = int(os.environ["RANK"])
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    results = {}
    for run in spec["runs"]:
        label = run["label"]
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = (
            tf32 if run["tf32"] else (False, False))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()
        t0 = time.perf_counter()
        with _ReconProbe() as probe:
            res = quantize_weight.main(run["argv"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        out = {"seconds": seconds, "cli_seconds": res["seconds"],
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "launches": {n: c for n, c in _launch_counts().items() if c},
               "held": _held_bytes(res["params"], res["alphas"], probe.units),
               "weight_only": res["weight_only"], "units": [
                   {k: u[k] for k in ("name", "kind", "losses", "held_bytes", "adam_s", "iters")}
                   for u in probe.units]}
        dist.barrier()
        if run.get("rows"):
            written = [os.path.join(run["outdir"], d, "cali_ckpt.pth_weight_only")
                       for d in os.listdir(run["outdir"])]
            out["rows_equal"] = _rows_of_file(written[0], res["params"], res["wqp"],
                                              res["alphas"])
        if res["alphas"]:
            marks = {n: res["params"][n].get("tp") for n in res["alphas"]}
            torch.save({n: (a.cpu(), marks[n] and marks[n].rows.start)
                        for n, a in res["alphas"].items()},
                       os.path.join(spec["out"], f"alphas_{label}_rank{rank}.pt"))
        if res["per_t"] is not None and rank == 0:
            torch.save(_to_cpu_tree(res["per_t"]), os.path.join(spec["out"], f"per_t_{label}.pt"))
        results[label] = out
        del res
    results["rank"] = [dist.get_rank(), dist.get_world_size(), dist.get_backend(),
                       f"cuda:{torch.cuda.current_device()}"]
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    leave_multihost()


def _to_cpu_tree(tree):
    """A state tree (dicts, QParams) with every tensor on the host."""
    import torch

    if isinstance(tree, dict):
        return {k: _to_cpu_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_to_cpu_tree(v) for v in tree))
    return tree.cpu() if torch.is_tensor(tree) else tree


def _state_gap(a, b):
    """Two activation states side by side: (the deltas' largest relative
    gap, zero points that differ, zero points)."""
    import numpy as np
    from dgq_tpu_torch.calib.act_calib import state_leaves

    la, lb = state_leaves(a), state_leaves(b)
    if set(la) != set(lb):
        raise AssertionError("tp_path (t): the activation states name other leaves")
    gap, moved, zps = 0.0, 0, 0
    for k, (d, z) in la.items():
        d2, z2 = lb[k]
        gap = max(gap, float(np.max(np.abs(d - d2) / np.maximum(np.abs(d2), 1e-30))))
        moved += int(np.sum(z != z2))
        zps += int(np.size(z))
    return gap, moved, zps


def _gathered(root, label):
    """The offsets of both ranks' shards of run `label`, put together by
    their rows, on the CPU."""
    import torch

    parts = [torch.load(os.path.join(root, f"alphas_{label}_rank{r}.pt")) for r in range(2)]
    out = {}
    for name, (a0, start) in parts[0].items():
        if start is None:  # a replicated layer: each rank holds it whole
            out[name] = a0
        else:
            out[name] = torch.cat([a for _, a in sorted(
                (p[name][1], p[name][0]) for p in parts)])
    return out


def _tp_walk_check(tp1, ranks, root, tag):
    """tp_path (s): both ranks' walks against --tp 1's (its --dp 1 run in
    dp_path, the same command): every step's loss within TP_ADAM_RTOL,
    more than RECON_NEAR_SHARE of the gathered offsets within 1e-4, each
    rank's rows of the written file equal to its shards; bytes held, peak
    and ms an Adam step a rank beside tp 1's."""
    gathered = _gathered(root, "s")
    near = total = 0
    worst = 0.0
    for n, a in tp1["alphas"].items():
        d = (gathered[n] - a).abs()
        worst = max(worst, float(d.max()))
        near += int((d <= 1e-4).sum())
        total += d.numel()
    names = [u["name"] for u in tp1["units"]]
    runs = [r["s"] for r in ranks]
    same_walk = all([u["name"] for u in r["units"]] == names for r in runs)
    gap = max(abs(a - b) / abs(b) for r in runs for u2, u1 in zip(r["units"], tp1["units"])
              for a, b in zip(u2["losses"], u1["losses"]))
    ranks_equal = all(u0["losses"] == u1["losses"]
                      for u0, u1 in zip(runs[0]["units"], runs[1]["units"]))
    rows = [r["rows_equal"] for r in runs]
    step1 = sum(u["adam_s"] / u["iters"] for u in tp1["units"]) / len(tp1["units"])
    h1 = tp1["held"]
    total1 = h1["weights"] + h1["offsets"] + h1["moments"]
    steps = sum(len(u["losses"]) for u in tp1["units"])
    print(f"tp_path (s): quantize_weight --tp 2 against --tp 1 ({len(names)} units): every "
          f"step's loss within {gap:.3g} relative over {steps} steps (limit "
          f"{TP_ADAM_RTOL:g}); {near / total:.6f} of the gathered offsets within "
          f"1e-4 (limit > {RECON_NEAR_SHARE}), max |d| {worst:.6g}; the ranks' losses equal: "
          f"{ranks_equal}; each rank's rows of the written file equal its shards: {rows} | {tag}",
          flush=True)
    print(f"tp_path (s) --tp 1: peak {tp1['peak']:.2f} GiB allocated over {DP_UNITS} units; "
          f"held over {len(tp1['units'])}: weights "
          f"{h1['weights'] / 2 ** 20:.2f} MiB, offsets {h1['offsets'] / 2 ** 20:.2f} MiB, Adam "
          f"moments {h1['moments'] / 2 ** 20:.2f} MiB (the largest unit's); {1e3 * step1:.2f} ms "
          f"an Adam step (mean over units) | {tag}", flush=True)
    for r, run in enumerate(runs):
        h = run["held"]
        step = sum(u["adam_s"] / u["iters"] for u in run["units"]) / len(run["units"])
        cut1 = h1["weights"] - (h["weights"] - h["cut"])  # tp 1's bytes of the cut leaves
        print(f"tp_path (s) --tp 2 rank {r}: peak {run['peak_gib']:.2f} GiB allocated "
              f"({run['peak_gib'] / tp1['peak']:.4f} of the tp 1 walk's over {DP_UNITS} units); "
              f"held: weights "
              f"{h['weights'] / 2 ** 20:.2f} MiB ({h['weights'] / h1['weights']:.4f} of tp 1's; "
              f"the cut leaves {h['cut'] / cut1:.4f}), offsets {h['offsets'] / 2 ** 20:.2f} MiB "
              f"({h['offsets'] / h1['offsets']:.4f}), Adam moments {h['moments'] / 2 ** 20:.2f} "
              f"MiB ({h['moments'] / h1['moments']:.4f}); weights + offsets + moments "
              f"{(h['weights'] + h['offsets'] + h['moments']) / total1:.4f} of tp 1's; "
              f"{1e3 * step:.2f} ms an Adam step (two ranks on one card, every cut "
              f"layer's gather over gloo), run {run['seconds']:.2f} s | {tag}", flush=True)
    if (not same_walk or gap > TP_ADAM_RTOL or not near / total > RECON_NEAR_SHARE
            or not all(ok for ok, _ in rows) or set(gathered) != set(tp1["alphas"])):
        raise AssertionError(f"tp_path (s): --tp 2 is not --tp 1 (walk {same_walk}, loss gap "
                             f"{gap:.3g}, near {near / total:.4f}, rows {rows})")


def tp_path(tag, tp1, beside=None):
    """Phase 10, after dp_path: channel parallelism (`--tp`, the weights cut
    over two ranks by `shard_params_tp`, each cut layer gathering its out
    channels over the tp group), in a temporary directory under build/. One
    torchrun launch (`python -m torch.distributed.run --standalone
    --nproc_per_node 2`, `--tp-rank`) whose two ranks share the card over
    gloo, each run against the same command at --tp 1 in this process:
      (s) SD v1.4 at full width, `quantize_weight --tp 2` over the first
          TP_UNITS units (20 samples, RECON_ITERS Adam steps, TF32 off)
          against those units of dp_path's --dp 1 run, the same command
          over DP_UNITS units, whose calibration cache it reads
          (`_tp_walk_check`);
      (t) SD v1.4, `--tp 2 --fast --no_recon --use_aq --pallas_attn`,
          TP_CALI_PROMPTS prompt x TP_CALI_STEPS PNDM step (one time slot,
          15 forwards at batch 2; its calibration data built by both ranks
          on their shards):
          the weight-only file equal to --tp 1's bit for bit (minmax scales
          are exact per channel), each rank's K1 and K2 launches equal to
          --tp 1's (attention runs replicated), the activation state finite
          and positive; its largest relative gap to --tp 1's printed (the
          quantized trajectory is chaotic, so no gate);
      (u) SDXL-turbo at 1024px, `--tp 2 --fast --no_recon`: the weight-only
          file equal to --tp 1's bit for bit; the weights built on the host,
          each rank moving its shards to the card: peak GiB a rank beside
          --tp 1's, and the seconds of build + shard + scale init.
    Any rank's failure fails the launch and the phase. The launch is
    bound by the host (every cut layer's gather crosses it): `beside()`,
    if given, runs on the card in this process while the ranks do."""
    import shutil
    import tempfile

    import torch
    from dgq_tpu_torch.cli import quantize_weight
    from dgq_tpu_torch.models.unet_sd import sd_unet_spec

    tmp_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    with tempfile.TemporaryDirectory(dir=tmp_root) as tmp:
        cali_t = ["--model", "sd", "--wq", "4", "--cali_prompt_data_n", str(TP_CALI_PROMPTS),
                  "--step_size", str(TP_CALI_STEPS), "--fast", "--no_recon", "--use_aq",
                  "--pallas_attn", "--cali_data_path", os.path.join(tmp, "cali_t")]
        sdxl_u = ["--model", "sdxl", "--wq", "4", "--fast", "--no_recon"]
        refs = {}
        for label, argv in (("t", cali_t), ("u", sdxl_u)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            _reset_launch_counts()
            t0 = time.perf_counter()
            res = quantize_weight.main(argv + ["--outdir", os.path.join(tmp, f"{label}1")])
            torch.cuda.synchronize()
            refs[label] = {"seconds": time.perf_counter() - t0, "cli_seconds": res["seconds"],
                           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                           "launches": {n: c for n, c in _launch_counts().items() if c},
                           "weight_only": res["weight_only"], "per_t": res["per_t"]}
            del res
        torch.cuda.empty_cache()

        runs = [
            {"label": "s", "tf32": False, "rows": True, "outdir": os.path.join(tmp, "s2"),
             "argv": tp1["argv"] + ["--tp", "2", "--outdir", os.path.join(tmp, "s2")]},
            {"label": "t", "tf32": True, "outdir": os.path.join(tmp, "t2"),
             "argv": cali_t + ["--tp", "2", "--outdir", os.path.join(tmp, "t2")]},
            {"label": "u", "tf32": True, "outdir": os.path.join(tmp, "u2"),
             "argv": sdxl_u + ["--tp", "2", "--outdir", os.path.join(tmp, "u2")]}]
        spec_path = os.path.join(tmp, "tp_spec.json")
        with open(spec_path, "w") as f:
            json.dump({"out": tmp, "runs": runs}, f)
        code, seconds, out = _torchrun("--tp-rank", spec_path, os.path.join(tmp, "launch.log"),
                                       TP_LAUNCH_TIMEOUT, beside)
        if code != 0:
            raise AssertionError(f"tp_path: the --tp 2 launch exited {code}:\n{out[-9000:]}")
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        print(f"tp_path: torchrun --standalone --nproc_per_node 2, {seconds:.2f} s for the launch "
              f"(start-up, the three runs, exit); ranks {[r['rank'] for r in ranks]}; run s "
              f"{[round(r['s']['seconds'], 2) for r in ranks]} s, t "
              f"{[round(r['t']['seconds'], 2) for r in ranks]} s, u "
              f"{[round(r['u']['seconds'], 2) for r in ranks]} s | {tag}", flush=True)
        if [r["rank"][:3] for r in ranks] != [[0, 2, "gloo"], [1, 2, "gloo"]]:
            raise AssertionError("tp_path: the ranks are not two gloo ranks of one group")

        # (s)
        _tp_walk_check(tp1, ranks, tmp, tag)

        # (t)
        ref = refs["t"]
        wrote = [r["t"]["weight_only"] for r in ranks]
        same, n_t, _ = _same_files(wrote[0], ref["weight_only"])
        per_t = torch.load(os.path.join(tmp, "per_t_t.pt"), weights_only=False)
        _check_calibrated("tp_path (t) --tp 2", per_t, sd_unet_spec(), tag)
        gap, moved, zps = _state_gap(per_t, _to_cpu_tree(ref["per_t"]))
        want = {n: ref["launches"].get(n, 0) for n in ("static_uniform_attention",
                                                       "flash_attention")}
        got = [{n: r["t"]["launches"].get(n, 0) for n in want} for r in ranks]
        peaks, secs = ([round(r["t"][k], 2) for r in ranks] for k in ("peak_gib", "seconds"))
        print(f"tp_path (t) quantize_weight --tp 2 --fast --no_recon --use_aq --pallas_attn: the "
              f"weight-only file equals --tp 1's bit for bit: {same} ({n_t} tensors; rank 1 wrote "
              f"{wrote[1]}); launches a rank {got} (--tp 1: {want}); activation state against "
              f"--tp 1's: deltas within {gap:.6g} relative, {moved} of {zps} zero points moved "
              f"(a reading: the quantized trajectory is chaotic); peak {peaks} GiB a rank, --tp 1 "
              f"{ref['peak_gib']:.2f}; {secs} s a rank, --tp 1 {ref['seconds']:.2f} s | {tag}",
              flush=True)
        if (not same or wrote[1] is not None or any(g != want for g in got)
                or not all(want.values())):
            raise AssertionError(f"tp_path (t): file equal {same}, launches {got} / {want}")
        shutil.rmtree(os.path.join(tmp, "t1"))
        shutil.rmtree(os.path.join(tmp, "t2"))

        # (u)
        ref = refs["u"]
        same, n_u, nbytes = _same_files(ranks[0]["u"]["weight_only"], ref["weight_only"])

        def setup_s(cli):
            return cli["build"] + cli.get("shard", 0.0) + cli["weight_init"]
        u = [r["u"] for r in ranks]
        print(f"tp_path (u) SDXL-turbo quantize_weight --tp 2 --fast --no_recon: the weight-only "
              f"file ({n_u} tensors, {nbytes / 2 ** 30:.2f} GiB) equals --tp 1's bit for bit: "
              f"{same}; peak {[round(x['peak_gib'], 2) for x in u]} GiB a rank against --tp 1's "
              f"{ref['peak_gib']:.2f} ({[round(x['peak_gib'] / ref['peak_gib'], 4) for x in u]}); "
              f"build + shard + scale init {[round(setup_s(x['cli_seconds']), 2) for x in u]} s a "
              f"rank (build {[round(x['cli_seconds']['build'], 2) for x in u]}, shard "
              f"{[round(x['cli_seconds']['shard'], 2) for x in u]}), --tp 1 "
              f"{setup_s(ref['cli_seconds']):.2f} s; run {[round(x['seconds'], 2) for x in u]} s "
              f"a rank, --tp 1 {ref['seconds']:.2f} s | {tag}", flush=True)
        if not same:
            raise AssertionError("tp_path (u): the SDXL-turbo file differs from --tp 1's")
    torch.cuda.empty_cache()


def sdxl_roofline(s_4e, tag):
    """dp_path (r), SDXL-turbo: `spec_roofline` at batch IMAGES beside 4e's
    measured s a forward (sdxl_path runs after dp_path)."""
    from dgq_tpu_torch.models.unet_sdxl import sdxl_unet_spec
    from dgq_tpu_torch.utils.flops import spec_roofline

    sol = spec_roofline(sdxl_unet_spec(), latent_hw=128, batch=IMAGES, attn_head_dim=64)
    print(f"dp_path (r): spec_roofline SDXL-turbo at batch {IMAGES} (989 TF/s, 3350 GB/s): SOL "
          f"{sol['sol_s'] * 1e3:.3f} ms (compute {sol['compute_s'] * 1e3:.3f}, memory "
          f"{sol['memory_s'] * 1e3:.3f}); 4e's forward {s_4e * 1e3:.3f} ms: SOL is "
          f"{sol['sol_s'] / s_4e:.4f} of it | {tag}", flush=True)


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
    launches = _expect_launches(label, expect, _param_dtype(qstate))
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
    n_conv = _n_int8_convs(spec)
    if n_conv != 38 or sum("w_q8c" in p for p in model["params"].values()) != n_conv:
        raise AssertionError(f"SDXL-turbo: {n_conv} k x k int8 convs a forward, expected 38")
    conv = drive_sdxl(model, f"int8_conv: SDXL-turbo int8 path + use_int8_conv ({n_conv} s8 "
                      f"convs a forward)", qstate, cfg.replace(use_int8_conv=True),
                      {**rt, "int8_matmul": n_int8 * STEPS_SDXL, "int8_conv": n_conv * STEPS_SDXL},
                      tag)
    print(f"int8_conv: SDXL-turbo int8 path, {STEPS_SDXL} steps: use_int8_conv on "
          f"{conv['s'][0]:.4f} s per step, {conv['s'][1]:.4f} s per image; off {int8['s'][0]:.4f} "
          f"s per step, {int8['s'][1]:.4f} s per image | {tag}", flush=True)
    off = cfg.replace(use_int8_matmul=False)
    unpacked = drive_sdxl(model, "SDXL-turbo, int8 path off", qstate, off, rt, tag)
    packed = drive_sdxl(model, "SDXL-turbo, int8 path off, packed attention", qstate,
                        off.replace(packed_attention=True),
                        {"rt_stats_packed": n_attn * STEPS_SDXL,
                         "quant_accum_packed": n_attn * STEPS_SDXL, "flash_attention": 1}, tag)
    _beside("SDXL-turbo, int8 path off", STEPS_SDXL, packed, unpacked, tag)
    return int8


# -------------------------------------------------------- sdxl_cli_path ----
SDXL_CALI_PROMPTS = 2  # the CLIs' --cali_prompt_data_n, 64 in the scripts: 8 samples at 4 steps
# (v)'s --max_units: 4 lone layers, resnets at 128px, 64px and 32px, the
# 2-block transformers of down_blocks.1 at 64px, and the first block of a
# 10-block transformer at 32px (down_blocks.2.attentions.0)
SDXL_RECON_UNITS = 23
SDXL_RECON_BATCH = 4  # quantize_weight's reconstruction batch for sdxl
SDXL_DEFAULT_SAMPLES = 64 * 4  # the CLI's default data: 64 prompts x 4 Euler steps, no CFG pair


def sdxl_cli_reference():
    """sdxl_cli_path's CPU side (no card; it runs while the compilers do):
    the tap order of a tiny SDXL-turbo (base 32, cross 64, depths (2, 10):
    the full net's layer names, checked) under (w)'s and (x)'s flags
    (--use_aq --pallas_attn and the t2i flags), from which the expected
    forwards and launches of the calibration runs follow."""
    import torch
    from dgq_tpu_torch.calib.act_calib import tap_execution_order
    from dgq_tpu_torch.models.qconfig import QConfig
    from dgq_tpu_torch.models.unet_sd import init_unet_sd
    from dgq_tpu_torch.models.unet_sdxl import sdxl_unet_spec, unet_sdxl_apply

    g = torch.Generator().manual_seed(3)
    spec = sdxl_unet_spec(32, 64, 8, (2, 10))
    params = init_unet_sd(g, "cpu", spec=spec)
    batch = (torch.randn(1, 16, 16, 4, generator=g), torch.tensor([999], dtype=torch.int32),
             torch.randn(1, 77, 64, generator=g), torch.randn(1, 128, generator=g),
             torch.tensor([[128.0, 128.0, 0.0, 0.0, 128.0, 128.0]]))
    cfg = QConfig(use_aq=True, use_pallas_attention=True, t2i_log_quant=True,
                  t2i_real_time=True, t2i_start_peak=True)
    return {"names": [n for n, _, _ in spec],
            "order": tap_execution_order(params, batch, cfg, unet_sdxl_apply)}


def sdxl_cli_path(tag, ref):
    """Phase 11, the last: the SDXL-turbo CLIs at full width, from the port
    alone, each through its `main(argv)` in this process, in the order a
    user runs them (depths (2, 10), f32 weights drawn on the card from seed
    0, synthetic SDXL embeddings: text 2048 wide, pooled 1280; calibration
    cut to SDXL_CALI_PROMPTS prompts x 4 Euler steps at guidance 0, 8
    samples in 4 time slots; everything under build/):
      (v) `quantize_weight --model sdxl --wq 4 --cali --iters RECON_ITERS
          --max_units SDXL_RECON_UNITS --partial_dir D`: MSE scales over the
          794 layers, then the mse reconstruction walk (lone layers, resnets
          at 128px, 64px and 32px, 2-block transformers at 64px, the first
          block of a 10-block one at 32px): learned rounding within 1.5x
          nearest on every unit, finite losses, the file read back bit for
          bit with its offsets; then the same command resumed on D: no unit
          reconstructed, the offsets and the file bit for bit. Prints each
          unit's captures a sample, s a unit and ms an Adam step by kind,
          and the hours a 20000-step walk of the 117 units would take;
      (v') `cli.infer --fp16 --pallas_attn` on (v)'s weight-only file: W4
          with no activation state, so every UNet attention of the quantized
          run takes K2 (head dim 64, at 64px and 32px), 2 images at 1024px;
      (w) `quantize_weight --resume_w` (v)'s file `--use_aq --pallas_attn`
          with the t2i flags (the activation phase after a reconstruction):
          g=1 activation states, every attention of every calibration
          forward on K3b (the real-time quantizer leaves no attention to K2,
          and the calibration data's forwards run plain attention, as the
          JAX CLI's do), the merged file read back with (v)'s offsets;
      (x) `quantize_act --group_num 8` with the t2i flags on (v)'s file:
          K3b in every forward, the k-means on the host (its seconds
          printed apart from the forwards');
      (y) `ckpt_tools merge` of (v) and (x), then `cli.infer --fp16
          --use_aq --use_group`, t2i flags, `--pallas_attn --group_impl
          fused` (the README's W4A8 g=8 command for sdxl): 2 images at
          1024px, 4 Euler steps: K3b, K5 on the stride-1 group convs, K2 in
          the two 1024px decodes;
      (y') the same without `--pallas_attn --group_impl fused` (plain
          attention, taps), and again on initial latents moved by 1e-6 (the
          chaos witness): (y)'s first quantized UNet forward must stay
          within 5x the witness's change of (y')'s, as cli_path holds SD.
    Each run's kernel launches and forwards are exact (from the tiny net's
    tap order: per slot one forward for the order, one a chunk of 32 taps,
    one a batch), every activation delta finite and positive, every file
    read back bit for bit; each run prints its seconds and peak memory."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    from dgq_tpu_torch.calib import act_calib
    from dgq_tpu_torch.calib.act_calib import attention_prefixes, conv_meta_by_name, group_axes
    from dgq_tpu_torch.calib.reconstruction import recon_units
    from dgq_tpu_torch.cli import ckpt_tools, infer, quantize_act, quantize_weight
    from dgq_tpu_torch.io.convert import params_to_torch_unet
    from dgq_tpu_torch.models.unet_sd import quantizable_layers
    from dgq_tpu_torch.models.unet_sdxl import sdxl_unet_spec
    from dgq_tpu_torch.pipeline import sd_pipeline
    from dgq_tpu_torch.pipeline.vae import init_vae_decoder, vae_decoder_spec

    spec = sdxl_unet_spec()
    n_att = len(attention_prefixes(spec))
    if ref["names"] != [n for n, _, _ in spec] or n_att != 140 or len(
            quantizable_layers(spec)) != 794:
        raise AssertionError("sdxl_cli_path: the tiny net's layers are not SDXL-turbo's")
    units = recon_units(spec)
    slots = STEPS_SDXL
    # per slot: the tap order's forward, one a chunk of 32 taps, one a batch
    # (the EMA pass of (w), the group statistics of (x)); the interval of 2
    # samples is one batch
    fwd = slots * (1 + -(-len(ref["order"]) // 32) + 1)
    k3b = lambda f: {"rt_stats": n_att * f, "quant_accum": n_att * f}  # noqa: E731
    no_kernel = lambda f: {}  # noqa: E731
    t2i = ["--t2i_log_quant", "--t2i_real_time", "--t2i_start_peak", "--time_aware_aqtizer"]
    print(f"sdxl_cli_path: cuts: --cali_prompt_data_n 64 -> {SDXL_CALI_PROMPTS} "
          f"({SDXL_CALI_PROMPTS * slots} samples in {slots} time slots), --iters 20000 -> "
          f"{RECON_ITERS}, (v) --max_units {SDXL_RECON_UNITS} of {len(units)} units; widths, "
          f"depths (2, 10), 1024px, 4 Euler steps and the batches not cut; {len(ref['order'])} "
          f"activation taps a forward, {fwd} calibration forwards a run | {tag}", flush=True)

    def depth(name):  # the blocks of the transformer a unit sits in
        head = name.split(".transformer_blocks.")[0] + ".transformer_blocks."
        return len({u.name for u in units if u.name.startswith(head)})

    def kind_of(r):
        if r["kind"] != "transformer":
            return r["kind"]
        return f"transformer (depth {depth(r['name'])})"

    tmp_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(tmp_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=tmp_root) as tmp:
        print(f"sdxl_cli_path: {shutil.disk_usage(tmp).free / 2 ** 30:.1f} GiB free under "
              f"{tmp_root} | {tag}", flush=True)
        common = ["--model", "sdxl", "--seed", "0", "--wq", "4", "--cali_prompt_data_n",
                  str(SDXL_CALI_PROMPTS), "--cali_data_path", os.path.join(tmp, "cali")]

        def run_cli(label, fn, argv, forwards, want):
            return _run_cli("sdxl_cli_path", label, fn, argv, forwards, want, tag)

        # (v) the reconstruction walk, then resumed
        parts = os.path.join(tmp, "parts")
        walk = common + ["--cali", "--iters", str(RECON_ITERS), "--max_units",
                         str(SDXL_RECON_UNITS), "--partial_dir", parts]
        with _ReconProbe() as probe:
            v = run_cli("(v) quantize_weight", quantize_weight.main,
                        walk + ["--outdir", os.path.join(tmp, "v")], 0, no_kernel)
        rates = _check_recon("(v)", probe.units, SDXL_RECON_UNITS, tag, phase="sdxl_cli_path",
                             batch=SDXL_RECON_BATCH, default_samples=SDXL_DEFAULT_SAMPLES,
                             kind_of=kind_of)
        print("sdxl_cli_path (v): each unit's captures a sample (MiB) and Adam loop (s): "
              + ", ".join(f"{r['name']} {r['bytes_a_sample'] / 2 ** 20:.2f} {r['adam_s']:.3f}"
                          for r in probe.units) + f" | {tag}", flush=True)
        hours = sum(rates[kind_of({"kind": u.kind, "name": u.name})][0]
                    + 20000 * rates[kind_of({"kind": u.kind, "name": u.name})][1]
                    for u in units) / 3600
        print(f"sdxl_cli_path (v): a 20000-step walk of all {len(units)} units (" + ", ".join(
            f"{sum(kind_of({'kind': u.kind, 'name': u.name}) == k for u in units)} {k}"
            for k in sorted(rates)) + f") at these rates a kind and this data size would take "
              f"{hours:.2f} h | {tag}", flush=True)
        _assert_round_trip("sdxl_cli_path (v) weight-only", v["weight_only"], spec, v["params"],
                           v["wqp"], {}, (), tag, alphas=v["alphas"])
        params, wqp, alphas, weight_only = v["params"], v["wqp"], v["alphas"], v["weight_only"]
        del v
        with _ReconProbe() as probe:
            vi = run_cli("(v) quantize_weight, resumed", quantize_weight.main,
                         walk + ["--outdir", os.path.join(tmp, "vi")], 0, no_kernel)
        saves = len(os.listdir(parts))
        same = set(vi["alphas"]) == set(alphas) and all(
            torch.equal(vi["alphas"][n], a) for n, a in alphas.items())
        same_file, n_file, nbytes = _same_files(vi["weight_only"], weight_only)
        print(f"sdxl_cli_path (v) resumed: {saves} partial saves, {len(probe.units)} units "
              f"reconstructed and {probe.captures} captures made, {len(alphas)} layers' offsets "
              f"bit for bit (v)'s: {same}; the weight-only file ({n_file} tensors, "
              f"{nbytes / 2 ** 30:.2f} GiB) bit for bit (v)'s: {same_file} | {tag}", flush=True)
        if saves != SDXL_RECON_UNITS or probe.units or probe.captures or not (same and same_file):
            raise AssertionError("sdxl_cli_path (v): the resumed run is not (v)'s")
        del vi
        shutil.rmtree(os.path.join(tmp, "vi"))
        torch.cuda.empty_cache()

        # (v') the weight-only file through the inference CLI: W4 with no
        # activation state, so every UNet attention of the quantized run
        # takes K2 (head dim 64), and each 1024px decode once
        vae_dir = os.path.join(tmp, "vae")
        os.makedirs(vae_dir)
        torch.save(params_to_torch_unet(init_vae_decoder(torch.Generator(device="cuda")
                                                         .manual_seed(0), "cuda"),
                                        vae_decoder_spec()),
                   os.path.join(vae_dir, "diffusion_pytorch_model.bin"))
        res = run_cli("(v') infer --pallas_attn on (v)'s weight-only file", infer.main,
                      ["--model", "sdxl", "--cali_ckpt", weight_only, "--fp16", "--vae_weights",
                       vae_dir, "--outdir", tmp, "--pallas_attn"], STEPS_SDXL,
                      lambda f: {"flash_attention": n_att * f + 2})  # + the two decodes
        images = [np.load(o) for o in res["outputs"]]
        print(f"sdxl_cli_path (v') infer: {sorted(os.path.basename(o) for o in res['outputs'])}; "
              f"load + fold {res['load_fold_s']:.2f} s; " + ", ".join(
                  f"{t} {s / IMAGES:.4f} s an image ({STEPS_SDXL} steps and the 1024px decode)"
                  for t, s in res["run_s"].items()) + f" | {tag}", flush=True)
        if len(images) != 2 * IMAGES or any(im.shape != (1024, 1024, 3) or im.dtype != np.uint8
                                            or im.std() == 0 for im in images):
            raise AssertionError("sdxl_cli_path (v'): not four uint8 images of 1024px")
        del res, images
        torch.cuda.empty_cache()

        # (w) --use_aq on (v)'s reconstructed weights: g=1 activation states,
        # K3b in every calibration forward
        w = run_cli("(w) quantize_weight --resume_w (v) --use_aq --pallas_attn",
                    quantize_weight.main, common + ["--resume_w", weight_only, "--use_aq",
                                                    "--pallas_attn"] + t2i
                    + ["--outdir", os.path.join(tmp, "w")], fwd, k3b)
        _check_calibrated("sdxl_cli_path (w) g=1", w["per_t"], spec, tag)
        _assert_round_trip("sdxl_cli_path (w) merged g=1", w["merged"], spec, params, wqp,
                           w["per_t"], (), tag, alphas=alphas)
        os.remove(w["merged"])
        del w
        torch.cuda.empty_cache()

        # (x) group calibration on (w)'s file, the k-means timed on the host
        real_kmeans, kmeans = act_calib.kmeans_group_qparams, {"s": 0.0, "calls": 0}

        def timed_kmeans(*args, **kw):
            t0 = time.perf_counter()
            out = real_kmeans(*args, **kw)
            kmeans["s"] += time.perf_counter() - t0
            kmeans["calls"] += 1
            return out
        act_calib.kmeans_group_qparams = timed_kmeans
        try:
            x = run_cli("(x) quantize_act --group_num 8", quantize_act.main,
                        common + ["--cali_ckpt", weight_only, "--aq", "8", "--softmax_a_bit", "8",
                                  "--group_num", "8", "--pallas_attn"] + t2i
                        + ["--outdir", os.path.join(tmp, "x")], fwd, k3b)
        finally:
            act_calib.kmeans_group_qparams = real_kmeans
        slot_s = sum(x["seconds"]["act_slots"])
        print(f"sdxl_cli_path (x): the k-means on the host {kmeans['s']:.2f} s over "
              f"{kmeans['calls']} calls ({kmeans['calls'] // slots} group points a slot), the "
              f"rest of the {slots} slots' {slot_s:.2f} s (their forwards, statistics and init) "
              f"{slot_s - kmeans['s']:.2f} s | {tag}", flush=True)
        _check_calibrated("sdxl_cli_path (x) g=8", x["per_t"], spec, tag)
        if not x["group_layers"]:
            raise AssertionError("sdxl_cli_path (x): no group layers")
        _assert_round_trip("sdxl_cli_path (x) activations g=8", x["act_ckpt"], spec, None, None,
                           x["per_t"], x["group_layers"], tag)

        # (y) merge, then the inference CLI three ways
        merged = os.path.join(tmp, "sdxl_w4a8g8_merged.pth")
        if ckpt_tools.main(["merge", weight_only, x["act_ckpt"], merged]) != 0:
            raise AssertionError("sdxl_cli_path (y): ckpt_tools merge failed")
        _assert_round_trip("sdxl_cli_path (y) merged g=8", merged, spec, params, wqp,
                           x["per_t"], x["group_layers"], tag, alphas=alphas)
        meta = conv_meta_by_name(spec)
        axes = group_axes(x["per_t"])
        k5 = sum(meta[n][3] == 1 and not any(axes[(s, n)] for s in x["per_t"])
                 for n in x["group_layers"])
        n_group = len(x["group_layers"])
        del x, params, wqp, alphas
        shutil.rmtree(os.path.join(tmp, "v"))
        torch.cuda.empty_cache()

        taps = []
        real_sample = sd_pipeline.sdxl_turbo_sample
        real_latents = sd_pipeline.SDXLTurboPipeline._initial_latents

        def tapped_sample(*args, **kwargs):  # the final latents, the first eps, the time
            apply, first = kwargs["unet_apply"], []

            def first_eps(*a, **k):
                eps = apply(*a, **k)
                if not first:
                    first.append(eps.clone())
                return eps
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_sample(*args, **{**kwargs, "unet_apply": first_eps})
            torch.cuda.synchronize()
            taps.append((out.clone(), time.perf_counter() - t0, first[0]))
            return out

        def perturbed_latents(self, *args):  # the chaos witness
            lat = real_latents(self, *args)
            gp = torch.Generator(device=lat.device).manual_seed(1)
            return lat + 1e-6 * torch.randn(lat.shape, generator=gp, device=lat.device)

        readme = ["--model", "sdxl", "--cali_ckpt", merged, "--fp16", "--use_aq", "--use_group",
                  "--vae_weights", vae_dir, "--outdir", tmp] + t2i
        kernels = ["--pallas_attn", "--group_impl", "fused"]
        witness = "(y'') (y') on initial latents moved by 1e-6"
        runs = [("(y) infer --pallas_attn --group_impl fused", kernels, STEPS_SDXL,
                 lambda f: {"flash_attention": 2, **k3b(f),
                            "group_quant_conv": k5 * f}),
                ("(y') infer, plain attention, taps", [], 0, lambda f: {"flash_attention": 2}),
                (witness, [], 0, lambda f: {"flash_attention": 2})]
        results = {}
        sd_pipeline.sdxl_turbo_sample = tapped_sample
        try:
            for label, flags, forwards, want in runs:
                for f in os.listdir(tmp):
                    if f.endswith((".npy", ".png")):
                        os.remove(os.path.join(tmp, f))
                taps.clear()
                sd_pipeline.SDXLTurboPipeline._initial_latents = (
                    perturbed_latents if label == witness else real_latents)
                res = run_cli(label, infer.main, readme + flags, forwards, want)
                images = {os.path.basename(o): np.load(o) for o in res["outputs"]}
                (_, fp_s, _), (q_lat, q_s, q_eps) = taps
                if len(images) != 2 * IMAGES or any(
                        a.shape != (1024, 1024, 3) or a.dtype != np.uint8 or a.std() == 0
                        for a in images.values()) or not bool(q_lat.isfinite().all()):
                    raise AssertionError(f"sdxl_cli_path {label}: bad images "
                                         f"{[(n, a.shape, a.dtype) for n, a in images.items()]}")
                qtag = next(t for t in res["run_s"] if t != "fp")
                results[label] = {"images": images, "q_eps": q_eps, "q_latents": q_lat}
                print(f"sdxl_cli_path {label}: {sorted(images)}; load + fold "
                      f"{res['load_fold_s']:.2f} s; " + "; ".join(
                          f"{t}: {s / STEPS_SDXL:.4f} s a step ({STEPS_SDXL} UNet forwards at "
                          f"batch {IMAGES}), {res['run_s'][t] / IMAGES:.4f} s an image (the "
                          f"1024px decode included)" for t, s in (("fp", fp_s), (qtag, q_s)))
                      + f"; K5 on {k5} of {n_group} group convs a forward | {tag}", flush=True)
        finally:
            sd_pipeline.sdxl_turbo_sample = real_sample
            sd_pipeline.SDXLTurboPipeline._initial_latents = real_latents

    y, plain = results[runs[0][0]], results[runs[1][0]]
    chaos = (results[witness]["q_eps"] - plain["q_eps"]).abs()
    d1 = (y["q_eps"] - plain["q_eps"]).abs()
    names = sorted(n for n in y["images"] if not n.endswith("_fp.npy"))
    img = [np.abs(y["images"][n].astype(int) - plain["images"][n].astype(int)) for n in names]
    wimg = [np.abs(results[witness]["images"][n].astype(int) - plain["images"][n].astype(int))
            for n in names]
    print(f"sdxl_cli_path: (y) against (y'), quantized run: first UNet forward's eps max |d| "
          f"{float(d1.max()):.6g}, mean |d| {float(d1.mean()):.6g}; the witness (y'') "
          f"{float(chaos.max()):.6g}, {float(chaos.mean()):.6g} (gate: 5x); final latents mean "
          f"|d| {float((y['q_latents'] - plain['q_latents']).abs().mean()):.6g} (witness "
          f"{float((results[witness]['q_latents'] - plain['q_latents']).abs().mean()):.6g}); "
          f"final images mean |d| {np.mean([d.mean() for d in img]):.4f} of 255 levels, more "
          f"than one level on a share {np.mean([(d > 1).mean() for d in img]):.6g} (witness "
          f"{np.mean([d.mean() for d in wimg]):.4f}, "
          f"{np.mean([(d > 1).mean() for d in wimg]):.6g}) "
          f"| {tag}", flush=True)
    if not (float(d1.max()) <= 5 * float(chaos.max())
            and float(d1.mean()) <= 5 * float(chaos.mean())):
        raise AssertionError("sdxl_cli_path (y): the first UNet forward differs from (y')'s by "
                             "more than 5x the chaos of (y')")
    torch.cuda.empty_cache()


SD_FIT_UNIT = "up_blocks.3.resnets.0"  # SD v1.4's largest captures: 960 + 320 ch at 64px
SDXL_FIT_UNIT = "up_blocks.2.resnets.0"  # SDXL-turbo's largest captures: 960 + 320 ch at 128px
FIT_ITERS = 20  # Adam steps of the fitted unit; its loop then runs once more, warm
FIT_SEED = {"sd": 42, "sdxl": 0}
SD_FIT_SLOTS = 25 + 1  # quantize_act's default --step_size 25: 26 PNDM calls, 26 time slots
SD_FIT_INTERVAL = 2 * 64  # its default 64 prompts, each with its CFG pair, a slot


def _fit_extra(real, args, kw):
    """`_ReconProbe`'s extra for the fits: the unit's Adam loop run again on
    the same captures (ms a step warm, without the first run's warm-up; its
    losses must be the first run's); one step's rows copied row by row into
    buffers on the card, as `_RowFeed` copies them (device ms, CUDA events);
    and the same rows gathered where the captures lie into one staging
    buffer a tensor (pinned when the captures are on the host), as a host
    gather would take them (the copy that the ring leaves out): twice into
    the same buffers, the first gather paying their pages' first touch, the
    second warm."""
    import torch
    from dgq_tpu_torch.calib import reconstruction as TR

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, losses = real(*args, **kw)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    inputs, outputs = args[4], args[5]
    idx = TR.batch_indices(args[0], 1, kw["batch_size"], outputs.shape[0])[0]
    bufs = [torch.empty((len(idx),) + x.shape[1:], dtype=x.dtype, device="cuda")
            for x in inputs + (outputs,)]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for j, i in enumerate(idx.tolist()):
        for buf, x in zip(bufs, inputs + (outputs,)):
            buf[j].copy_(x[i], non_blocking=True)
    end.record()
    torch.cuda.synchronize()
    copy_ms = start.elapsed_time(end)
    del bufs
    host = outputs.device.type == "cpu"
    staged = [torch.empty((len(idx),) + x.shape[1:], dtype=x.dtype, device=x.device,
                          pin_memory=host) for x in inputs + (outputs,)]
    gather_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for buf, x in zip(staged, inputs + (outputs,)):
            torch.index_select(x, 0, idx.to(x.device), out=buf)
        torch.cuda.synchronize()
        gather_ms.append(1e3 * (time.perf_counter() - t0))
    return {"adam_warm_s": warm, "warm_losses": losses.tolist(), "copy_ms": copy_ms,
            "gather_first_ms": gather_ms[0], "gather_ms": gather_ms[1],
            "gather_bytes": sum(x.nbytes for x in staged)}


def _recon_fit(model, unit, tag, tmp, label):
    """`quantize_weight --model <model> --wq 4 --cali` at every data default
    (SD v1.4: 64 prompts x 25 PNDM steps, 3328 samples; SDXL-turbo: 64 x 4
    Euler steps, 256), random weights from FIT_SEED, with --partial_dir and
    --max_units as far as `unit`, every unit before it resumed from saves of
    its nearest rounding (`_NearestPartials`), so that the walk
    reconstructs `unit` alone, FIT_ITERS Adam steps; the captures placed
    by the CLI's rule (captures="auto"). Prints where they were held and
    their bytes, the card's peak of its total, the pinned host bytes beside
    the host's MemTotal and its MemAvailable as they were placed, the
    seconds of each part, ms an Adam step cold and warm, and one step's
    rows copied and gathered (`_fit_extra`). Returns the CLI's result."""
    import torch
    from dgq_tpu_torch.calib.reconstruction import host_memory, recon_units
    from dgq_tpu_torch.cli import quantize_weight
    from dgq_tpu_torch.models.unet_sd import sd_unet_spec
    from dgq_tpu_torch.models.unet_sdxl import sdxl_unet_spec

    spec = sd_unet_spec() if model == "sd" else sdxl_unet_spec()
    k = [u.name for u in recon_units(spec)].index(unit)
    argv = ["--model", model, "--seed", str(FIT_SEED[model]), "--wq", "4", "--cali", "--iters",
            str(FIT_ITERS), "--max_units", str(k + 1), "--partial_dir",
            os.path.join(tmp, f"parts_{model}"), "--cali_data_path",
            os.path.join(tmp, f"cali_{model}"), "--outdir", os.path.join(tmp, f"out_{model}")]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _NearestPartials([unit]) as nearest, _ReconProbe(_fit_extra) as probe:
        res = quantize_weight.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if [r["name"] for r in probe.units] != [unit] or nearest.written != k:
        raise AssertionError(f"--recon-fit {label}: reconstructed "
                             f"{[r['name'] for r in probe.units]} after {nearest.written} "
                             f"nearest saves, not {unit} after {k}")
    (r,) = probe.units
    n = round(r["held_bytes"] / r["bytes_a_sample"])
    host = r["placement"] == "host"
    s = res["seconds"]
    print(f"--recon-fit {label}: {unit} at the CLI's default data size ({n} samples): "
          f"captures {r['bytes_a_sample'] / 2 ** 20:.2f} MiB a sample, "
          f"{r['held_bytes'] / 2 ** 30:.2f} GiB in all, "
          f"{'in pinned host memory' if host else 'on the card'} ({nearest.placed}); card peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB allocated (reserved "
          f"{torch.cuda.max_memory_reserved() / 2 ** 30:.2f}) of "
          f"{torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.2f}; pinned host "
          f"{(r['held_bytes'] if host else 0) / 2 ** 30:.2f} GiB of the host's MemTotal "
          f"{host_memory()['MemTotal'] / 2 ** 30:.2f} GiB (MemAvailable "
          f"{nearest.available / 2 ** 30:.2f} GiB as the captures were placed); run "
          f"{seconds:.2f} s (MSE init {s['weight_init']:.2f}, "
          f"{k} nearest saves {nearest.seconds:.2f}, calibration data {s['cali_data']:.2f}, "
          f"captures {r['capture_s']:.2f}, their tensors allocated"
          f"{' and page-locked' if host else ''} {r['store_s']:.2f}, folds {r['fold_s']:.2f}, "
          f"{r['iters']} Adam steps {r['adam_s']:.2f}: {1e3 * r['adam_s'] / r['iters']:.2f} ms "
          f"a step, warm {1e3 * r['adam_warm_s'] / r['iters']:.2f}); one step's rows "
          f"({r['gather_bytes'] / 2 ** 20:.1f} MiB) copied row by row to the card "
          f"{r['copy_ms']:.2f} ms (device), gathered {'on the host' if host else 'on the card'} "
          f"into reused {'pinned ' if host else ''}buffers {r['gather_ms']:.2f} ms warm (first "
          f"{r['gather_first_ms']:.2f}); unit error learned / nearest "
          f"{r['err_learned'] / r['err_nearest']:.4f} | {tag}", flush=True)
    if r["warm_losses"] != r["losses"] or not r["err_learned"] <= 1.5 * r["err_nearest"]:
        raise AssertionError(f"--recon-fit {label}: the warm loop's losses are not the first's, "
                             f"or the learned rounding is worse than 1.5x nearest")
    return res


def _sd_act_order():
    """The tap order of `quantize_act`'s t2i flags with --pallas_attn, from
    the tiny SD net (base 32, cross 64; its layers are SD v1.4's)."""
    import torch
    from dgq_tpu_torch.calib.act_calib import tap_execution_order
    from dgq_tpu_torch.models.qconfig import QConfig
    from dgq_tpu_torch.models.unet_sd import init_unet_sd, sd_unet_spec

    g = torch.Generator().manual_seed(3)
    spec = sd_unet_spec(base=32, cross=64)
    params = init_unet_sd(g, "cpu", spec=spec)
    batch = (torch.randn(1, 16, 16, 4, generator=g), torch.tensor([801], dtype=torch.int32),
             torch.randn(1, 77, 64, generator=g))
    return tap_execution_order(params, batch, QConfig(
        use_aq=True, use_pallas_attention=True, t2i_log_quant=True, t2i_real_time=True,
        t2i_start_peak=True))


def _act_fit(tag, weight_only, tmp):
    """(fit-sd-act): `quantize_act --model sd --group_num 8` with the t2i
    flags and --pallas_attn on (fit-sd)'s weight-only file at the default
    data size, reading (fit-sd)'s calibration cache: SD_FIT_SLOTS time
    slots of SD_FIT_INTERVAL samples, batch 8. Exact forwards and K3b
    launches (as calib_path (f)), seconds a slot and of the host k-means,
    every state finite and positive."""
    from dgq_tpu_torch.calib import act_calib
    from dgq_tpu_torch.cli import quantize_act
    from dgq_tpu_torch.models.unet_sd import sd_unet_spec

    spec = sd_unet_spec()
    n_att = len(act_calib.attention_prefixes(spec))
    batches = -(-SD_FIT_INTERVAL // CALI_BATCH)
    fwd, _ = _act_plan(_sd_act_order(), SD_FIT_SLOTS, batches, n_att)
    real_kmeans, kmeans = act_calib.kmeans_group_qparams, {"s": 0.0, "calls": 0}

    def timed_kmeans(*args, **kw):
        t0 = time.perf_counter()
        out = real_kmeans(*args, **kw)
        kmeans["s"] += time.perf_counter() - t0
        kmeans["calls"] += 1
        return out
    act_calib.kmeans_group_qparams = timed_kmeans
    try:
        x = _run_cli("--recon-fit", "(fit-sd-act) quantize_act --group_num 8", quantize_act.main,
                     ["--model", "sd", "--wq", "4", "--aq", "8", "--softmax_a_bit", "8",
                      "--group_num", "8", "--cali_ckpt", weight_only, "--cali_data_path",
                      os.path.join(tmp, "cali_sd"), "--outdir", os.path.join(tmp, "act"),
                      "--pallas_attn", "--t2i_log_quant", "--t2i_real_time", "--t2i_start_peak",
                      "--time_aware_aqtizer"], fwd,
                     lambda f: {"rt_stats": n_att * f, "quant_accum": n_att * f}, tag)
    finally:
        act_calib.kmeans_group_qparams = real_kmeans
    slot_s = x["seconds"]["act_slots"]
    print(f"--recon-fit (fit-sd-act): {len(slot_s)} slots of {SD_FIT_INTERVAL} samples at batch "
          f"{CALI_BATCH} ({fwd // SD_FIT_SLOTS} forwards a slot), s a slot {min(slot_s):.2f} to "
          f"{max(slot_s):.2f} (mean {sum(slot_s) / len(slot_s):.2f}); the host k-means "
          f"{kmeans['s']:.2f} s over {kmeans['calls']} calls; calibration data from (fit-sd)'s "
          f"cache {x['seconds']['cali_data']:.2f} s | {tag}", flush=True)
    _check_calibrated("--recon-fit (fit-sd-act) g=8", x["per_t"], spec, tag)
    if len(x["per_t"]) != SD_FIT_SLOTS or not x["group_layers"]:
        raise AssertionError(f"--recon-fit (fit-sd-act): {len(x['per_t'])} slots, "
                             f"{len(x['group_layers'])} group layers")


def recon_fit():
    """`python3 chip_smoke.py --recon-fit` (not part of the run without
    arguments, whose time limit it does not fit; about 20 minutes): the
    calibration CLIs at their default data size on one card, the kernels
    built from the checkout while (fit-sd) runs (it launches none):
      (fit-sd) SD v1.4 `quantize_weight --cali` reconstructing
          SD_FIT_UNIT (`_recon_fit`): 65 GiB of captures, held by the
          placement rule in pinned host memory;
      (fit-sd-act) `quantize_act --group_num 8` on its file (`_act_fit`):
          K3b in every forward;
      (fit-sdxl) SDXL-turbo `quantize_weight --cali` reconstructing
          SDXL_FIT_UNIT.
    When the card runs out of memory it prints the functions of the port it
    ran out in and exits 1; it exits 1 without a card."""
    import shutil
    import tempfile
    import traceback

    import torch
    from dgq_tpu_torch.ops import build

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py --recon-fit needs a CUDA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    tag = f"card: {card}"
    # why the captures are page-locked with cudaHostRegister, not allocated pinned
    torch.cuda.init()  # host_memory_stats() is empty before
    block = 1536 * 2 ** 20 + 4096
    probe = torch.empty(block, dtype=torch.uint8, pin_memory=True)
    held = torch.cuda.host_memory_stats()["allocated_bytes.current"]
    del probe
    print(f"--recon-fit: PyTorch's pinned allocator (pin_memory=True) holds {held / 2 ** 30:.4f} "
          f"GiB for a block of {block / 2 ** 30:.4f} GiB | {tag}", flush=True)
    built = {}

    def build_all():
        try:
            built["paths"] = build.build_kernels()
        except BaseException as exc:  # handed to the main thread, which raises it
            built["error"] = exc
    compiling = threading.Thread(target=build_all)
    compiling.start()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=root)
    t0 = time.perf_counter()

    def phase(label, fn, *args):
        t1 = time.perf_counter()
        out = fn(*args)
        print(f"phase {label}: {time.perf_counter() - t1:.1f} s | {tag}", flush=True)
        return out
    try:
        try:
            res = phase("fit-sd", _recon_fit, "sd", SD_FIT_UNIT, tag, tmp, "(fit-sd)")
            weight_only = res["weight_only"]
            del res
            compiling.join()
            if "error" in built:
                raise built["error"]
            build.load_kernels()
            phase("fit-sd-act", _act_fit, tag, weight_only, tmp)
            shutil.rmtree(os.path.dirname(weight_only))
            phase("fit-sdxl", _recon_fit, "sdxl", SDXL_FIT_UNIT, tag, tmp, "(fit-sdxl)")
        except torch.cuda.OutOfMemoryError as exc:
            where = [f"{f.name} ({os.path.basename(f.filename)}:{f.lineno})"
                     for f in traceback.extract_tb(exc.__traceback__)
                     if "dgq_tpu_torch" in f.filename]
            print(f"--recon-fit: out of memory after {time.perf_counter() - t0:.2f} s, peak "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB allocated, in "
                  f"{' <- '.join(reversed(where))}: {str(exc).splitlines()[0]} | {tag}",
                  flush=True)
            return 1
    finally:
        compiling.join()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"--recon-fit: {time.perf_counter() - t0:.1f} s | {tag}", flush=True)
    return 0


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
            tf = re.search(r"flash_tf32_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELb([01])E",
                           sym)
            qf = re.search(r"quant_tf32_kernelILi(\d)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELb([01])E",
                           sym)
            pf = re.search(r"pipelined17quant_tf32_kernelILi(\d)ELi(\d+)ELi(\d+)E", sym)
            if pf:
                kname = (f"{modes[pf.group(1)]} body (f) TMA pipeline 3xTF32 wgmma "
                         f"D<={8 * int(pf.group(2))} {pf.group(3)} columns (registers at entry; "
                         f"the consumers take 232 by setmaxnreg)")
            elif qf:
                kname = (f"{modes[qf.group(1)]} 3xTF32 wgmma D<={8 * int(qf.group(3))} "
                         f"{qf.group(5)} x {qf.group(4)} columns"
                         + (" 16-byte loads" if qf.group(6) == "1" else " element loads"))
            elif qt:
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
            elif tf:
                kname = (f"K2/K2p flash 3xTF32 wgmma D<={8 * int(tf.group(2))} BK={tf.group(3)} "
                         f"{tf.group(5)} x {tf.group(4)} columns"
                         + (" 16-byte loads" if tf.group(6) == "1" else " element loads"))
            elif "linear_tf32x3_gemm_kernel" in sym:
                kname = ("linear GEMM 3xTF32 wgmma 128 x "
                         f"{re.search(r'gemm_kernelILi(\d+)E', sym).group(1)} tiles (registers "
                         "at entry; the consumers take 232 by setmaxnreg)")
            elif "group_conv_tf32_kernel" in sym:
                kname = "K5 group_conv 3xTF32 wgmma" + (" split K" if "ILb1E" in sym else "")
            elif "group_conv_tc_kernel" in sym:
                dtype = "bf16"
                kname = "K5 group_conv wgmma" + (" split K" if "ILb1E" in sym else "")
            elif "fold_oihw_kernel" in sym:
                dtype = "bf16"
                kname = ("K5 weight fold (OIHW, in registers), scales "
                         + ("f32" if "fold_oihw_kernelIfE" in sym else "bf16"))
            elif "fold_kernel" in sym:
                t = re.search(r"fold_kernelI(f|13__nv_bfloat16)(f|13__nv_bfloat16|S\d*_)Lb([01])E",
                              sym)
                dtype = "bf16" if t and t.group(1) != "f" else "f32"
                kname = ("K5 weight fold" + (" to TF32 panels" if t and t.group(3) == "1" else "")
                         + ", scales " + ("bf16" if t and t.group(2) != "f" else "f32"))
            elif "finish_kernel" in sym:
                dtype = "f32" if "finish_kernelIfE" in sym else "bf16"
                kname = "K5 split-K finish"
            else:
                kname = "K5 group_conv CUDA cores"
            print(f"  ptxas {kname} {dtype}: {m.group(4)} registers, {m.group(3)} bytes "
                  f"spilled | {tag}")
            if int(m.group(3)):
                spilled.append(f"{kname} {dtype}")
    print(f"ptxas: instances that spill: {', '.join(spilled) or 'none'} | {tag}")


def _cpu_threads(n):
    """The reference process's initializer: n threads for torch on the CPU."""
    import torch

    torch.set_num_threads(n)


def _reference_bytes(name):
    """(in the reference process) The CPU reference `name`, serialized by
    torch.save: thousands of tensors sent as they are would each hold a
    file descriptor of shared memory."""
    import io

    import torch

    buf = io.BytesIO()
    torch.save(globals()[name](), buf)
    return buf.getvalue()


def fake_quant_alone():
    """`compare_fake_quant` by itself: build the kernels, then the rows."""
    import torch
    from dgq_tpu_torch.ops import build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    build.build_kernels()
    build.load_kernels()
    print(f"{torch.cuda.get_device_name(0)}; {card}", flush=True)
    compare_fake_quant(f"card: {card}", _Summary())


def linear_gemm_alone():
    """`compare_linear_gemm` by itself: build the kernels, then the rows."""
    import torch
    from dgq_tpu_torch.ops import build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    paths = build.build_kernels()
    build.load_kernels()
    print(f"{torch.cuda.get_device_name(0)}; {card}", flush=True)
    print_build_report({"linear_gemm": paths["linear_gemm"]}, f"card: {card}")
    summary = _Summary()
    compare_linear_gemm(f"card: {card}", summary)
    print(json.dumps(summary["linear_gemm"]))


def k3b_alone():
    """`k3b_bodies` by itself: build the kernels, report the attention
    library's instances, then the rows."""
    import torch
    from dgq_tpu_torch.ops import build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    paths = build.build_kernels()
    build.load_kernels()
    print(f"{torch.cuda.get_device_name(0)}; {card}", flush=True)
    print_build_report({"attention": paths["attention"]}, f"card: {card}")
    print(json.dumps(k3b_bodies(f"card: {card}")))


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

    # the compilers run (one process per source) while a process of its own
    # computes the tiny nets' CPU references, which need neither them nor
    # the card, on the other cores, one reference after another: each is
    # ready well before the phase that reads it (with all the cores, their
    # threads and nvcc's shared them, and the references took 3x as long on
    # an 8-core host)
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
    n_refs = max(1, min(torch.get_num_threads(),
                        (os.cpu_count() or 1) - len(build.library_paths())))
    refs = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"), initializer=_cpu_threads,
        initargs=(n_refs,))
    pending = {name: refs.submit(_reference_bytes, name) for name in (
        "small_input_reference", "calib_reference", "recon_reference", "sdxl_cli_reference")}

    def reference(name):
        import io

        t1 = time.perf_counter()
        out = torch.load(io.BytesIO(pending.pop(name).result()), weights_only=False)
        print(f"CPU reference {name}: waited {time.perf_counter() - t1:.2f} s, ready "
              f"{time.perf_counter() - t0:.2f} s after the start ({n_refs} threads) | {tag}",
              flush=True)
        return out

    try:
        _run_phases(build, built, compiling, reference, card, tag, t0)
    finally:
        refs.shutdown(wait=True, cancel_futures=True)


def _run_phases(build, built, compiling, reference, card, tag, t0):
    """main()'s phases once the compilers and the CPU references started."""
    import os
    import shutil
    import tempfile

    import torch

    compiling.join()
    if "error" in built:
        raise built["error"]
    paths = built["paths"]
    build.load_kernels()
    _count_int8_convs()
    print(f"build: {built['seconds']:.2f} s ({', '.join(p.name for p in paths.values())}) | "
          f"{tag}", flush=True)
    print_build_report(paths, tag)

    def phase(fn, *args, note=""):
        t0 = time.perf_counter()
        result = fn(*args)
        print(f"phase {fn.__name__}: {time.perf_counter() - t0:.1f} s | {tag}{note}", flush=True)
        return result

    summary = _Summary()
    phase(compare_attention, tag, summary)
    phase(compare_attention_packed, tag, summary)
    phase(compare_group_conv, tag, summary)
    phase(wrapper_host_cost, tag)
    phase(compare_fake_quant, tag, summary)
    phase(compare_linear_gemm, tag, summary)
    phase(compare_int8, tag, summary)
    phase(int8_conv, tag)
    phase(small_input_check, *reference("small_input_reference"), tag)
    launches = phase(main_paths, tag)
    s_4a = launches.pop("s_4a")
    torch.cuda.empty_cache()  # the SD model is gone
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    # calib_path's merged file, for eval_path and dp_path; dp_path's calibration cache, for tp_path
    keep = tempfile.mkdtemp(dir=build_dir)
    try:
        calib = phase(calib_path, tag, reference("calib_reference"), keep)
        torch.cuda.empty_cache()
        # the two-rank launches are bound by the host (gloo through it): a
        # phase runs on the card in this process while each does, for the
        # script's time limit. Its ranks share the card and the host with
        # that phase, so the phase's readings are not those of a card to
        # itself: every line it prints says so. cli_path, whose seconds a
        # step earlier runs are compared with, runs alone.
        on_dp = "; beside dp_path's two-rank launch (its ranks share the card and the host)"
        on_tp = "; beside tp_path's two-rank launch (its ranks share the card and the host)"
        tp1 = phase(dp_path, tag, calib, s_4a,
                    lambda: phase(eval_path, tag + on_dp, calib, note=on_dp))
        torch.cuda.empty_cache()
        cli = phase(cli_path, tag)
        # the f32 states' g=8 run: every per-tensor quantizer takes the kernel
        launches["fake_quant"] = cli["(b) README + --pallas_attn --group_impl fused"].get(
            "fake_quant", 0)
        # ... and its f32 linears of 128 rows or more take the GEMM
        launches["linear_gemm"] = cli["(b) README + --pallas_attn --group_impl fused"].get(
            "linear_gemm", 0)
        torch.cuda.empty_cache()
        phase(f32_bodies, tag)
        phase(k3b_bodies, tag)
        phase(text_encoders_full_width, tag)
        phase(tp_path, tag, tp1, lambda: phase(recon_path, tag + on_tp,
                                               reference("recon_reference"), note=on_tp))
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    torch.cuda.empty_cache()  # SDXL needs 20 GB while it folds
    sdxl = phase(sdxl_path, tag)
    launches["int8_matmul"] = sdxl["int8_matmul"]
    sdxl_roofline(sdxl["s"][0], tag)
    torch.cuda.empty_cache()
    phase(sdxl_cli_path, tag, reference("sdxl_cli_reference"))

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], **{k: v for k, v in summary[name].items() if k != "at"}}
        for name, (source, replaces) in KERNELS.items()]}
    print("kernels: max_abs_err (and mismatch_share) are the largest over the shapes above; "
          "ms, plain_ms, bound_ms, library_ms, device_ms at "
          + ", ".join(f"{n}: {summary[n]['at']}" for n in KERNELS) + f" | {tag}")
    print(f"chip_smoke.py: {time.perf_counter() - t0:.1f} s from the start of the build | {tag}")
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        dp_rank(sys.argv[2])
    elif sys.argv[1:2] == ["--tp-rank"]:
        tp_rank(sys.argv[2])
    elif sys.argv[1:] == ["--recon-fit"]:
        sys.exit(recon_fit())
    elif sys.argv[1:] == ["--fake-quant"]:
        fake_quant_alone()
    elif sys.argv[1:] == ["--linear-gemm"]:
        linear_gemm_alone()
    elif sys.argv[1:] == ["--k3b"]:
        k3b_alone()
    else:
        main()
