"""Fused attention with DGQ softmax quantization, on hand-written CUDA kernels.

Counterpart of `dgq_tpu/ops/pallas/attention.py`. Its Pallas kernels are
ported in `csrc/attention.cu`:

  * K1 `_static_uniform_kernel` (`sm_mode="uniform"`, no start_peak): every
    UNet attention of the g=1 policy;
  * K2 `_flash_kernel` (`sm_mode="none"`): the VAE mid-block attention and
    the unquantized UNet path;
  * K3 `_rt_fused_kernel` (`sm_mode="log2_real_time"`), in its two-launch
    form K3b (`_stats_kernel`, `_stats_kernel_nonpeak`, `_accum_kernel`):
    `rt_stats` reduces the per-call delta into one device scalar with an
    atomic, `quant_accum` reads it. A GPU grid has no order, so the TPU's
    one-call form with a sequential phase axis has no counterpart;
  * K4 `_static_quant_kernel` (`sm_mode="log2"`, or `"uniform"` with
    start_peak): statistics and quantized accumulation in one launch.

`fused_attention` takes the plain PyTorch version (`attention_reference`)
only for tensors on the CPU. A CUDA tensor launches a kernel or raises.

Layout: q (BH, T, D), k/v (BH, S, D), contiguous, as in the JAX package.
"""
from __future__ import annotations

import torch

from dgq_tpu_torch.ops.build import load_kernels

# Launches of each kernel since the last reset (a run can show that the main
# path went through the kernels). Only the kernel wrappers add to them.
LAUNCHES = {"static_uniform_attention": 0, "flash_attention": 0, "rt_stats": 0,
            "quant_accum": 0, "static_quant_attention": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def attention_reference(q, k, v, scale, sm_mode="none", sm_bits=8,
                        sm_delta=None, start_peak=False):
    """Plain version with the softmax materialized in f32 (the reference's
    math; port of `attention.py:attention_reference`), for every sm_mode."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    level = 2 ** sm_bits
    if sm_mode != "none":
        if sm_mode == "log2_real_time":
            # start_peak slices column 0 off BEFORE the quantizer, so the
            # dynamic delta excludes the peak
            delta = p[..., 1:].max() if start_peak else p.max()
        else:
            delta = torch.as_tensor(sm_delta, device=p.device)
        if sm_mode in ("log2", "log2_real_time"):
            code = torch.clamp(torch.round(-torch.log2(p / delta)), 0, level - 1)
            pq = 2.0 ** (-code) * delta
        elif sm_mode == "uniform":
            pq = torch.clamp(torch.round(p / delta), 0, level - 1) * delta
        else:
            raise ValueError(f"unknown sm_mode {sm_mode!r}")
        if start_peak:
            pq[..., 0] = p[..., 0]
        p = pq
    return torch.matmul(p, v.float()).to(q.dtype)


def _check_inputs(q, k, v):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"attention kernels need CUDA tensors, got {q.device}, "
                         f"{k.device}, {v.device}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"attention kernels take f32 or bf16 q/k/v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"expected q (BH,T,D), k/v (BH,S,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, _, d = q.shape
    if k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention kernels need contiguous q, k, v")
    if d > 512 or bh > 65535:
        raise ValueError(f"head_dim {d} > 512 or batch*heads {bh} > 65535 is not supported")


def _raise_on_error(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _check_quant_inputs(q, k, v, sm_bits: int) -> None:
    _check_inputs(q, k, v)
    if not 1 <= sm_bits <= 16:
        raise ValueError(f"sm_bits {sm_bits} out of range")
    if q.shape[2] > 160:
        raise ValueError(f"the log2 / start_peak kernels are built for head_dim <= 160 "
                         f"(the UNet's), got {q.shape[2]}")


def _scalar_delta(sm_delta, device) -> torch.Tensor:
    delta = torch.as_tensor(sm_delta).to(device=device, dtype=torch.float32)
    if delta.numel() != 1:
        raise ValueError(f"sm_delta must be a scalar, got shape {tuple(delta.shape)}")
    return delta.reshape(1).contiguous()


def flash_attention(q, k, v, scale: float):
    """K2: unquantized softmax attention (`_flash_kernel`)."""
    _check_inputs(q, k, v)
    lib = load_kernels()
    out = torch.empty_like(q)
    bh, t, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dgq_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bh, t, k.shape[1], d, float(scale), int(q.dtype == torch.bfloat16), stream)
    _raise_on_error(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


def static_uniform_attention(q, k, v, scale: float, sm_delta, sm_bits: int = 8):
    """K1: softmax attention with the uniform post-softmax quantizer
    (`_static_uniform_kernel`). sm_delta: scalar tensor (any float dtype);
    the kernel reads it from device memory, so no host synchronisation."""
    _check_inputs(q, k, v)
    if not 1 <= sm_bits <= 16:
        raise ValueError(f"sm_bits {sm_bits} out of range")
    delta = _scalar_delta(sm_delta, q.device)
    lib = load_kernels()
    out = torch.empty_like(q)
    bh, t, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dgq_uniform_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bh, t, k.shape[1], d, float(scale), delta.data_ptr(), sm_bits,
            int(q.dtype == torch.bfloat16), stream)
    _raise_on_error(rc, "static_uniform_attention")
    LAUNCHES["static_uniform_attention"] += 1
    return out


def rt_stats(q, k, scale: float, start_peak: bool = False):
    """K3b, first launch (`_stats_kernel` / `_stats_kernel_nonpeak`): returns
    (z, red). z (BH, T) f32 holds each row's m + ln(l). red is one f32 on the
    device, the call's reduction over every batch, head and row: min(l), or
    under start_peak the largest probability outside key column 0. It is
    folded by an atomic min/max on the bit pattern, exact and
    order-independent for positive floats, from an initial +inf / 0 filled on
    the current stream; both buffers are allocated per call, so overlapping
    calls share nothing."""
    _check_inputs(q, k, k)
    if q.shape[2] > 160:
        raise ValueError(f"rt_stats is built for head_dim <= 160, got {q.shape[2]}")
    lib = load_kernels()
    bh, t, d = q.shape
    z = torch.empty(bh, t, dtype=torch.float32, device=q.device)
    red = torch.full((1,), 0.0 if start_peak else float("inf"), dtype=torch.float32,
                     device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dgq_rt_stats(q.data_ptr(), k.data_ptr(), z.data_ptr(), red.data_ptr(),
                              bh, t, k.shape[1], d, float(scale), int(start_peak),
                              int(q.dtype == torch.bfloat16), stream)
    _raise_on_error(rc, "rt_stats")
    LAUNCHES["rt_stats"] += 1
    return z, red


def rt_stats_reference(q, k, scale, start_peak=False):
    """Plain version of rt_stats: (z, red) from the materialized scores."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.max(dim=-1, keepdim=True).values
    l = torch.exp(s - m).sum(dim=-1, keepdim=True)
    z = (m + torch.log(l)).squeeze(-1)
    red = torch.exp(s[..., 1:] - z[..., None]).max() if start_peak else l.min()
    return z, red.reshape(1)


def rt_delta(red, start_peak: bool = False):
    """The real_time delta from rt_stats' reduction, as quant_accum forms it."""
    return red if start_peak else 1.0 / red


def quant_accum(q, k, v, z, red, scale: float, sm_bits: int = 8, start_peak: bool = False):
    """K3b, second launch (`_accum_kernel`): reads delta from rt_stats' scalar
    through a pointer, recomputes Q K^T and forms the log2 codes from
    z - s without exp or log; under start_peak key column 0 stays exact. Its
    plain version is `attention_reference(..., "log2", sm_delta=rt_delta(red))`."""
    _check_quant_inputs(q, k, v, sm_bits)
    bh, t, d = q.shape
    for name, buf, shape in (("z", z, (bh, t)), ("red", red, (1,))):
        if (buf.device != q.device or buf.dtype != torch.float32 or tuple(buf.shape) != shape
                or not buf.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous f32 {shape} tensor on {q.device}")
    lib = load_kernels()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dgq_quant_accum(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                 z.data_ptr(), red.data_ptr(), bh, t, k.shape[1], d,
                                 float(scale), sm_bits, int(start_peak),
                                 int(q.dtype == torch.bfloat16), stream)
    _raise_on_error(rc, "quant_accum")
    LAUNCHES["quant_accum"] += 1
    return out


def log2_real_time_attention(q, k, v, scale: float, sm_bits: int = 8,
                             start_peak: bool = False):
    """K3 in its Hopper form K3b: softmax attention with the log2 quantizer
    whose delta is reduced over the whole call, as two launches on the
    current stream with no host synchronisation between them."""
    _check_quant_inputs(q, k, v, sm_bits)
    z, red = rt_stats(q, k, scale, start_peak)
    return quant_accum(q, k, v, z, red, scale, sm_bits, start_peak)


def static_quant_attention(q, k, v, scale: float, sm_mode: str, sm_delta, sm_bits: int = 8,
                           start_peak: bool = False):
    """K4: softmax attention with a static-delta quantizer in one launch:
    `sm_mode="log2"` (with or without start_peak) or `"uniform"` with
    start_peak. sm_delta is a scalar tensor read from device memory."""
    _check_quant_inputs(q, k, v, sm_bits)
    if sm_mode not in ("log2", "uniform"):
        raise ValueError(f"static_quant_attention takes 'log2' or 'uniform', got {sm_mode!r}")
    delta = _scalar_delta(sm_delta, q.device)
    lib = load_kernels()
    out = torch.empty_like(q)
    bh, t, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dgq_static_quant_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, t, k.shape[1], d,
            float(scale), delta.data_ptr(), sm_bits, int(sm_mode == "uniform"),
            int(start_peak), int(q.dtype == torch.bfloat16), stream)
    _raise_on_error(rc, "static_quant_attention")
    LAUNCHES["static_quant_attention"] += 1
    return out


def fused_attention(q, k, v, scale: float, sm_mode: str = "none", sm_bits: int = 8,
                    sm_delta=None, start_peak: bool = False):
    """Attention with an optional post-softmax quantizer (JAX
    `fused_attention`, unpacked layout). CPU tensors take the plain version;
    anything else launches a kernel or raises."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale, sm_mode, sm_bits, sm_delta, start_peak)
    if sm_mode == "none":
        # start_peak only changes which probabilities are quantized
        return flash_attention(q, k, v, scale)
    if sm_mode == "log2_real_time":
        return log2_real_time_attention(q, k, v, scale, sm_bits, start_peak)
    if sm_mode not in ("uniform", "log2"):
        raise ValueError(f"unknown sm_mode {sm_mode!r}")
    if sm_delta is None:
        raise ValueError(f"{sm_mode} softmax quantization needs sm_delta")
    if sm_mode == "uniform" and not start_peak:
        return static_uniform_attention(q, k, v, scale, sm_delta, sm_bits)
    return static_quant_attention(q, k, v, scale, sm_mode, sm_delta, sm_bits, start_peak)
