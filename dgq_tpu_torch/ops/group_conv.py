"""Fused group-quantized conv on a hand-written CUDA kernel (K5).

Counterpart of `dgq_tpu/ops/pallas/group_conv.py` (`group_quant_conv`,
`_kernel`). DGQ's group activation quantization gives every (tap, input
channel) position of the im2col'd input its own scale and zero point, so one
input pixel is quantized differently by each of the kh*kw taps that read it.
`csrc/group_conv.cu` runs the stride-1 kh x kw conv as an implicit GEMM that
quantizes each tap's A tile to shifted-clip codes as it loads it,

    code = clip(round(x * rd[t, c]), -z[t, c], 2^b - 1 - z[t, c]),
    rd = 1 / (dm * dl),  z = zm + zl,

and multiplies the codes against the weights with dm*dl folded in. An
out-of-image position is the value 0 quantized like any other.

What bounds it on the H100: operations. A 3x3 conv at the UNet's widths does
2*9*C*O flops per output pixel against (C + O) elements moved, hundreds of
flops per byte. This first version does them in f32 on the CUDA cores
(128 x 64 output tile a block, 8 x 4 a thread), so it sits far above the
tensor-core bound; the weight pre-scale `w * dm * dl` is weight-sized
elementwise work redone each call, because the time-aware dm changes with
the step.

`group_quant_conv` takes the plain PyTorch version only for tensors on the
CPU. A CUDA tensor launches the kernel or raises.

Layout (the JAX function's): x NHWC (B, H, W, C); w HWIO (kh, kw, C, O), of
which `w.reshape(kh*kw, C, O)` is the (taps, C, O) view the kernel reads
(`models.layers.quant_conv2d` makes the HWIO view of the port's OIHW weights
with a permute); dm, zm (kh*kw, C); dl, zl scalars; bias (O,) or None.
"""
from __future__ import annotations

import torch

from dgq_tpu_torch.models.qconfig import GroupQParams
from dgq_tpu_torch.ops.build import load_kernels

# Launches of the kernel since the last reset; only the wrapper adds to it.
LAUNCHES = {"group_quant_conv": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def matmul_f32acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N) with an f32 result, as the JAX package's
    `preferred_element_type=float32`: a bf16 product is not rounded to bf16
    before it joins the f32 accumulator."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def fused_eligible(x_shape, o: int, kh: int, kw: int, stride: int, padding: int, gqp) -> bool:
    """Whether the kernel takes this conv: stride 1, per-(tap, channel)
    mid-axis scales and a scalar last-axis factor. (The JAX check's VMEM and
    band-count terms belong to the TPU kernel and have no counterpart.)"""
    if stride != 1 or not isinstance(gqp, GroupQParams):
        return False
    c = x_shape[-1]
    return gqp.delta_mid.shape[-1] == c * kh * kw and gqp.delta_last.shape[-1] == 1


def _fold(x, w, dm, zm, dl, zl, kh, kw):
    """Weight-sized preparation shared by the kernel and the plain version:
    w_t (taps, C, O) = w * dm * dl in x's dtype, rd = 1/(dm*dl) and
    z = zm + zl, both (taps, C) f32."""
    taps, c, o = kh * kw, w.shape[2], w.shape[3]
    d = dm.float() * dl.reshape(()).float()
    w_t = (w.reshape(taps, c, o).float() * d[:, :, None]).to(x.dtype).contiguous()
    rd = (1.0 / d).contiguous()
    z = (zm.float() + zl.reshape(()).float()).contiguous()
    return w_t, rd, z


def group_quant_conv_reference(x, w, dm, zm, dl, zl, bias, kh=3, kw=3, padding=1, a_bits=8):
    """Plain version: the tap decomposition with the same fold as the kernel
    (codes in x's dtype, f32 accumulator over taps, bias added in f32)."""
    w_t, rd, z = _fold(x, w, dm, zm, dl, zl, kh, kw)
    b, h, wd, c = x.shape
    o = w.shape[3]
    ho, wo = h + 2 * padding - kh + 1, wd + 2 * padding - kw + 1
    qmax = float(2 ** a_bits - 1)
    xp = torch.nn.functional.pad(x, (0, 0, padding, padding, padding, padding))
    acc = torch.zeros(b * ho * wo, o, dtype=torch.float32, device=x.device)
    for t in range(kh * kw):
        i, j = divmod(t, kw)
        xs = xp[:, i:i + ho, j:j + wo, :].float()
        q = torch.clamp(torch.round(xs * rd[t]), -z[t], qmax - z[t]).to(x.dtype)
        acc += matmul_f32acc(q.reshape(-1, c), w_t[t])
    if bias is not None:
        acc = acc + bias.float()
    return acc.reshape(b, ho, wo, o).to(x.dtype)


def group_quant_conv(x, w, dm, zm, dl, zl, bias, kh: int = 3, kw: int = 3, padding: int = 1,
                     a_bits: int = 8):
    """K5: stride-1 group-quantized conv (`group_conv.py:group_quant_conv`)."""
    b, h, wd, c = x.shape
    taps = kh * kw
    if tuple(w.shape[:3]) != (kh, kw, c):
        raise ValueError(f"w {tuple(w.shape)} is not (kh, kw, C, O) for x {tuple(x.shape)}")
    if tuple(dm.shape) != (taps, c) or tuple(zm.shape) != (taps, c):
        raise ValueError(f"dm/zm must be (kh*kw, C) = ({taps}, {c}); got {tuple(dm.shape)}, "
                         f"{tuple(zm.shape)}")
    if dl.numel() != 1 or zl.numel() != 1:
        raise ValueError("dl and zl must be scalars (spatial groups take the taps path)")
    if x.device.type == "cpu":
        return group_quant_conv_reference(x, w, dm, zm, dl, zl, bias, kh, kw, padding, a_bits)
    if not x.is_cuda:
        raise ValueError(f"the group conv kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the group conv kernel takes f32 or bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the group conv kernel needs a contiguous NHWC x")
    if not 1 <= a_bits <= 16:
        raise ValueError(f"a_bits {a_bits} out of range")
    o = w.shape[3]
    ho, wo = h + 2 * padding - kh + 1, wd + 2 * padding - kw + 1
    if ho < 1 or wo < 1 or b * ho * wo >= 2 ** 31 or x.numel() >= 2 ** 31:
        raise ValueError(f"unsupported conv geometry: x {tuple(x.shape)}, out {ho}x{wo}")
    w_t, rd, z = _fold(x, w, dm, zm, dl, zl, kh, kw)
    bias_f = (torch.zeros(o, dtype=torch.float32, device=x.device) if bias is None
              else bias.float().contiguous())
    out = torch.empty(b, ho, wo, o, dtype=x.dtype, device=x.device)
    lib = load_kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.dgq_group_quant_conv(
            x.data_ptr(), w_t.data_ptr(), rd.data_ptr(), z.data_ptr(), bias_f.data_ptr(),
            out.data_ptr(), b, h, wd, c, o, kh, kw, padding, a_bits,
            int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"group_quant_conv kernel launch failed: CUDA error {rc}")
    LAUNCHES["group_quant_conv"] += 1
    return out
