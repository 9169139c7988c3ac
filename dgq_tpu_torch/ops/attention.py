"""Fused attention with DGQ softmax quantization, on hand-written CUDA kernels.

Counterpart of `dgq_tpu/ops/pallas/attention.py`. Two of its Pallas kernels
are ported, in `csrc/attention.cu`:

  * K1 `_static_uniform_kernel` (`sm_mode="uniform"`, no start_peak): every
    UNet attention of the g=1 policy;
  * K2 `_flash_kernel` (`sm_mode="none"`): the VAE mid-block attention and
    the unquantized UNet path.

`fused_attention` takes the plain PyTorch version (`attention_reference`)
only for tensors on the CPU. A CUDA tensor launches a kernel or raises;
the log2 modes and start_peak (K3/K4) are not ported yet.

Layout: q (BH, T, D), k/v (BH, S, D), contiguous, as in the JAX package.
"""
from __future__ import annotations

import torch

from dgq_tpu_torch.ops.build import load_kernels

# Launches of each kernel since the last reset (a run can show that the main
# path went through the kernels). Only the kernel wrappers add to them.
LAUNCHES = {"static_uniform_attention": 0, "flash_attention": 0}


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
    delta = torch.as_tensor(sm_delta).to(device=q.device, dtype=torch.float32)
    if delta.numel() != 1:
        raise ValueError(f"sm_delta must be a scalar, got shape {tuple(delta.shape)}")
    delta = delta.reshape(1).contiguous()
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


def fused_attention(q, k, v, scale: float, sm_mode: str = "none", sm_bits: int = 8,
                    sm_delta=None, start_peak: bool = False):
    """Attention with an optional post-softmax quantizer (JAX
    `fused_attention`, unpacked layout). CPU tensors take the plain version;
    anything else launches K1/K2 or raises."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale, sm_mode, sm_bits, sm_delta, start_peak)
    if sm_mode == "none":
        # start_peak only changes which probabilities are quantized
        return flash_attention(q, k, v, scale)
    if sm_mode == "uniform" and not start_peak:
        if sm_delta is None:
            raise ValueError("uniform softmax quantization needs sm_delta")
        return static_uniform_attention(q, k, v, scale, sm_delta, sm_bits)
    raise NotImplementedError(
        f"K3/K4 (sm_mode={sm_mode!r}, start_peak={start_peak}) have no CUDA kernel yet: "
        "ROADMAP queue 2 (_rt_fused_kernel / _static_quant_kernel)")
