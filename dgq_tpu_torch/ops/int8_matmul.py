"""Fused quantize -> int8 matmul -> dequantize on a hand-written CUDA kernel (K6).

Counterpart of `dgq_tpu/ops/pallas/int8_matmul.py` (`quantized_matmul`,
`_kernel`): the deploy path of the W4/W8 x A6/A8 linears and 1x1 convs whose
activation has one scale per tensor. Per output column o, over the
contraction k:

    x_dq = dx * (xq - zx),  w_dq = dw[o] * (wq[o, :] - zw[o])
    y[m, o] = dx*dw[o] * ( SUM_k xq*wq
                           - zx * wsum[o]          # wsum = SUM_k wq[o, k]
                           - zw[o] * xsum[m]       # xsum = SUM_k xq[m, k]
                           + K * zx * zw[o] ) + bias[o]

`csrc/int8_matmul.cu` builds xq from the f32/bf16 input inside the kernel
(clip(round(x / dx) + zx, nb, pb), recentered by 2^(a_bits-1) so the codes
fit int8), multiplies s8 x s8 -> s32 on the tensor cores and applies the
epilogue in f32; wq, dw, zw and wsum are made once at load
(`pack_weight_int8`, `calib.weight_calib.attach_int8_packed`).

What bounds it on the H100: operations (2*M*N*K at the int8 tensor-core
rate) at the wide shapes, bytes at the small-M ones.

Code layout: the port stores weights out-channel first, so the packed codes
are (N, K) int8 with K contiguous, which is what both operands of an integer
dot product want (the JAX package keeps (K, N); `io.convert` transposes).

`quantized_matmul` takes the plain PyTorch version only for tensors on the
CPU. A CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from dgq_tpu_torch.ops.build import load_kernels

# Launches of the kernel since the last reset; only the wrapper adds to it.
LAUNCHES = {"int8_matmul": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def pack_weight_int8(w: torch.Tensor, delta: torch.Tensor, zero_point: torch.Tensor,
                     bits: int):
    """Recentered int8 weight codes and adjusted scales, made once at load.

    w: (N, K) float, out channel first; delta / zero_point broadcastable to
    (N, 1), one per out channel. Returns (wq int8 (N, K), w_delta (N,),
    w_zp recentered (N,) f32)."""
    level, off = 2 ** bits, 2 ** (bits - 1)
    n = w.shape[0]
    d = torch.as_tensor(delta, device=w.device).reshape(-1).expand(n)
    z = torch.as_tensor(zero_point, device=w.device).reshape(-1).expand(n)
    codes = torch.clamp(torch.round(w / d[:, None]) + z[:, None], 0, level - 1) - off
    return codes.to(torch.int8), d.contiguous(), (z - off).float().contiguous()


def _act_bounds(a_bits: int):
    off = 2 ** (a_bits - 1)
    return float(-off), float(2 ** a_bits - 1 - off)


def quantized_matmul_reference(x, wq, w_delta, w_zp, x_delta, x_zp, bias=None, w_ksum=None,
                               a_bits: int = 8, out_dtype=None):
    """Plain version of the kernel (not of the JAX package's float oracle,
    which pins the clip bounds to A8): bounds from a_bits, a true division,
    half-to-even rounding, an exact integer accumulator (float64 holds
    K * 128 * 128 exactly; f32 would not past K = 1024 with W8 codes), then
    the kernel's f32 epilogue in the kernel's order."""
    k = x.shape[1]
    nb, pb = _act_bounds(a_bits)
    dx = torch.as_tensor(x_delta, device=x.device).float().reshape(())
    zx = torch.as_tensor(x_zp, device=x.device).float().reshape(())
    xq = torch.clamp(torch.round(x.float() / dx) + zx, nb, pb)
    acc = (xq.double() @ wq.double().t()).float()
    xsum = xq.double().sum(dim=1, keepdim=True).float()
    wsum = (wq.double().sum(dim=1).float() if w_ksum is None else w_ksum.float())[None, :]
    dw, zw = w_delta.float()[None, :], w_zp.float()[None, :]
    y = (dx * dw) * (acc - zx * wsum - zw * xsum + (float(k) * zx) * zw)
    if bias is not None:
        y = y + bias.float()[None, :]
    return y.to(x.dtype if out_dtype is None else out_dtype)


def _scalar_f32(v, device) -> torch.Tensor:
    t = torch.as_tensor(v).to(device=device, dtype=torch.float32)
    if t.numel() != 1:
        raise ValueError(f"the activation scale and zero point must be scalars, got shape "
                         f"{tuple(t.shape)}")
    return t.reshape(1)


def quantized_matmul(x, wq, w_delta, w_zp, x_delta, x_zp, bias=None, w_ksum=None,
                     a_bits: int = 8, return_codes: bool = False):
    """K6: y (M, N) in x's dtype from x (M, K) f32/bf16 and packed weights.

    wq (N, K) int8 recentered codes; w_delta, w_zp (recentered), w_ksum (the
    codes' row sums; made here when None) and bias: (N,). x_delta and x_zp
    (recentered, already rounded to an integer by the caller) are scalar
    tensors the kernel reads from device memory, so a time-aware slot costs
    no host synchronisation. With `return_codes` the kernel also writes the
    codes it built and their row sums: (y, codes int8 (M, K), xsum f32 (M,))."""
    if x.dim() != 2 or wq.dim() != 2 or wq.shape[1] != x.shape[1]:
        raise ValueError(f"expected x (M, K) and wq (N, K); got {tuple(x.shape)}, "
                         f"{tuple(wq.shape)}")
    m, k = x.shape
    n = wq.shape[0]
    if wq.dtype != torch.int8:
        raise ValueError(f"wq must be int8 codes, got {wq.dtype}")
    if not 2 <= a_bits <= 8:
        raise ValueError(f"a_bits {a_bits} does not fit int8 codes")
    for name, v in (("w_delta", w_delta), ("w_zp", w_zp), ("bias", bias), ("w_ksum", w_ksum)):
        if v is not None and tuple(v.shape) != (n,):
            raise ValueError(f"{name} must be ({n},), got {tuple(v.shape)}")
    if x.device.type == "cpu":
        y = quantized_matmul_reference(x, wq, w_delta, w_zp, x_delta, x_zp, bias, w_ksum, a_bits)
        if not return_codes:
            return y
        nb, pb = _act_bounds(a_bits)
        xq = torch.clamp(torch.round(x.float() / torch.as_tensor(x_delta).float())
                         + torch.as_tensor(x_zp).float(), nb, pb)
        return y, xq.to(torch.int8), xq.sum(dim=1)
    if not x.is_cuda or wq.device != x.device:
        raise ValueError(f"the int8 matmul kernel needs CUDA tensors on one device, got "
                         f"{x.device}, {wq.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the int8 matmul kernel takes f32 or bf16 activations, got {x.dtype}")
    if not (x.is_contiguous() and wq.is_contiguous()):
        raise ValueError("the int8 matmul kernel needs contiguous x and wq")
    if m < 1 or m >= 2 ** 31 or x.numel() >= 2 ** 40:
        raise ValueError(f"unsupported shape: x {tuple(x.shape)}")
    dev = x.device
    dx, zx = _scalar_f32(x_delta, dev), _scalar_f32(x_zp, dev)
    wsum = (wq.sum(dim=1, dtype=torch.int32) if w_ksum is None else w_ksum).float().contiguous()
    dw, zw = w_delta.float().contiguous(), w_zp.float().contiguous()
    bias_f = (torch.zeros(n, dtype=torch.float32, device=dev) if bias is None
              else bias.float().contiguous())
    out = torch.empty(m, n, dtype=x.dtype, device=dev)
    codes = torch.empty(m, k, dtype=torch.int8, device=dev) if return_codes else None
    xsum = torch.empty(m, dtype=torch.float32, device=dev) if return_codes else None
    lib = load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dgq_int8_matmul(
            x.data_ptr(), wq.data_ptr(), dx.data_ptr(), zx.data_ptr(), wsum.data_ptr(),
            dw.data_ptr(), zw.data_ptr(), bias_f.data_ptr(), out.data_ptr(),
            codes.data_ptr() if return_codes else None,
            xsum.data_ptr() if return_codes else None,
            m, n, k, a_bits, int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error {rc}")
    LAUNCHES["int8_matmul"] += 1
    return (out, codes, xsum) if return_codes else out
