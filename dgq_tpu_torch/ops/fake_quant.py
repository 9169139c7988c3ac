"""Activation fake quantization in one hand-written CUDA launch.

Replaces no TPU kernel: XLA fuses the JAX package's quantize-dequantize into
one pass, where eager PyTorch runs `quant.affine.fake_quant` as eight
launches, six of which stream the whole activation. `csrc/fake_quant.cu`
(`fake_quant_kernel`) reads the activation once, through its strides, and
writes the dequantized values once, contiguous in the input's logical order,
with the plain chain's arithmetic in its order (`r = x / delta`, `q = r +
(rint(r) - r)`, torch.clamp's clip to `[nb - zp, pb - zp]`, `delta * q`), so
the bits are the chain's. What bounds it is bytes.

`models.qconfig.aq_apply` launches it where `kernel_takes` holds (a CUDA
tensor, no gradient wanted, f32 or bf16, f32 parameters that are one value or
a vector over the last axis, times and plus a group quantizer's factors over
axis -2) and keeps the chain for everything else: CPU tensors, learnable
deltas under reconstruction, bf16 parameters, other broadcasts.
`fused_fake_quant_reference` is the plain version the kernel is held to.

`start_rows`: the first rows along axis -2 pass through unquantized, widened
to the output's f32 (the start-peak key row, formerly put back by
`torch.cat`).
"""
from __future__ import annotations

import torch

from dgq_tpu_torch.ops.build import load_kernels, refuse_grad, wants_grad
from dgq_tpu_torch.quant.affine import QParams, fake_quant, quant_bounds

# Since the last reset: launches of the kernel ("fake_quant"), and the CUDA
# quantizers `aq_apply` sent to the plain chain ("fake_quant_plain"; it adds
# to it). fake_quant / (fake_quant + fake_quant_plain) is the share of the
# card's quantizers the kernel took.
LAUNCHES = {"fake_quant": 0, "fake_quant_plain": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernel_rule(device_type: str, dtype, needs_grad: bool, shape, params, mid=None,
                start_rows: int = 0) -> bool:
    """Whether the kernel takes a quantizer: on a CUDA device, no gradient
    wanted, an f32 or bf16 activation of rank 1 to 4 and under 2^31
    elements, and each of `params` (the (dtype, shape) of delta and of the
    zero point) f32, 0-d or a vector over the last axis (leading sizes 1, the
    last 1 or the activation's). `mid`, a group quantizer's (dtype, shape) of
    delta_mid and zp_mid, each f32, 0-d or 1-d, of one value or one a row of
    the `shape[-2] - start_rows` quantized rows; then `params` (delta_last,
    zp_last) are 0-d or 1-d too, and the activation of rank 2 or more. A pure
    function of what a call can see."""
    if device_type != "cuda" or needs_grad or dtype not in (torch.float32, torch.bfloat16):
        return False
    if not 1 <= len(shape) <= 4 or torch.Size(shape).numel() >= 2 ** 31:
        return False
    for p_dtype, p_shape in params:
        if p_dtype != torch.float32 or len(p_shape) > (len(shape) if mid is None else 1):
            return False
        if any(s != 1 for s in p_shape[:-1]) or (p_shape and p_shape[-1] not in (1, shape[-1])):
            return False
    if mid is None:
        return True
    if len(shape) < 2:
        return False
    return all(p_dtype == torch.float32 and len(p_shape) <= 1
               and torch.Size(p_shape).numel() in (1, shape[-2] - start_rows)
               for p_dtype, p_shape in mid)


def kernel_takes(x: torch.Tensor, delta, zp, mid=None, start_rows: int = 0) -> bool:
    """`kernel_rule` on a call's tensors, whose parameters lie on x's device.
    mid: None, or a group quantizer's (delta_mid, zp_mid)."""
    params = (delta, zp) + tuple(mid or ())
    return (all(torch.is_tensor(p) and p.device == x.device for p in params)
            and kernel_rule(x.device.type, x.dtype, wants_grad(x, *params), x.shape,
                            ((delta.dtype, delta.shape), (zp.dtype, zp.shape)),
                            None if mid is None else tuple((p.dtype, p.shape) for p in mid),
                            start_rows))


def _describe(p) -> str:
    return f"{p.dtype} {tuple(p.shape)}" if torch.is_tensor(p) else type(p).__name__


def _step(p: torch.Tensor) -> int:
    """The element step of a parameter over the last axis: 0 for one value."""
    return p.stride(-1) if p.numel() > 1 else 0


def fused_fake_quant_reference(x, delta, zp, bits: int, start_rows: int = 0, mid=None):
    """The plain version: `quant.affine.fake_quant`'s chain, with a group
    quantizer's parameters made as `models.qconfig.aq_apply` makes them (the
    broadcast product and sum of the factors over axis -2 and -1), and the
    start rows put back by `torch.cat`."""
    def chain(q):
        if mid is None:
            return fake_quant(q, QParams(delta, zp), bits)
        rows = (1,) * (q.dim() - 2) + (-1, 1)
        cols = (1,) * (q.dim() - 1) + (-1,)
        return fake_quant(q, QParams(mid[0].reshape(rows) * delta.reshape(cols),
                                     mid[1].reshape(rows) + zp.reshape(cols)), bits)
    if not start_rows:
        return chain(x)
    return torch.cat([x[..., :start_rows, :], chain(x[..., start_rows:, :])], dim=-2)


def fused_fake_quant(x, delta, zp, bits: int, start_rows: int = 0, mid=None,
                     checked: bool = False) -> torch.Tensor:
    """Quantize-dequantize the CUDA tensor x with unsigned `bits`-bit codes
    (clip bounds 0 and 2^bits - 1, the zero point inside them), the first
    `start_rows` rows along axis -2 passed through, in one launch. mid: None,
    or a group quantizer's (delta_mid, zp_mid) over the quantized rows, which
    multiply delta and add to zp. Returns a new contiguous f32 tensor of x's
    shape, bit for bit the plain version's. `checked`: the caller has seen
    `kernel_takes` hold (`aq_apply`), so the checks are not made again."""
    if not checked:
        refuse_grad("fused_fake_quant", x, delta, zp, *(mid or ()))
        if start_rows and (x.dim() < 2 or start_rows < 0):
            raise ValueError(f"start_rows {start_rows}: takes 0 or more rows along axis -2, "
                             f"got {tuple(x.shape)}")
        if not kernel_takes(x, delta, zp, mid, start_rows):
            raise ValueError(
                f"fused_fake_quant takes an f32 or bf16 CUDA tensor of rank 1 to 4 and f32 "
                f"delta and zero point on its device, each one value or a vector over the last "
                f"axis (group factors: over the quantized rows); got {x.device.type} {x.dtype} "
                f"{tuple(x.shape)}, delta {_describe(delta)}, zero point {_describe(zp)}, group "
                f"factors {None if mid is None else [_describe(p) for p in mid]}")
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return out
    pad = 4 - x.dim()
    nb, pb = quant_bounds(bits, False, False)
    device = x.device.index
    dm, zm = mid or (None, None)
    rc = load_kernels().dgq_fake_quant(
        x.data_ptr(), out.data_ptr(), delta.data_ptr(), zp.data_ptr(), _step(delta), _step(zp),
        dm.data_ptr() if mid else None, zm.data_ptr() if mid else None,
        _step(dm) if mid else 0, _step(zm) if mid else 0, *((1,) * pad + tuple(x.shape)),
        *((0,) * pad + x.stride()), nb, pb, start_rows, int(x.dtype == torch.bfloat16), device,
        torch._C._cuda_getCurrentRawStream(device))
    if rc != 0:
        raise RuntimeError(f"fake_quant kernel launch failed: CUDA error {rc}")
    LAUNCHES["fake_quant"] += 1
    return out
