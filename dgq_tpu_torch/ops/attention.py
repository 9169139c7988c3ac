"""Fused attention with DGQ softmax quantization, on hand-written CUDA kernels.

Counterpart of `dgq_tpu/ops/pallas/attention.py`. Its Pallas kernels are
ported in `csrc/attention.cu`:

  * K1 `_static_uniform_kernel` (`sm_mode="uniform"`, no start_peak): every
    UNet attention of the g=1 policy; on the tensor cores in bf16, and in f32
    as three TF32 products for Q K^T and two for P V (`quant_form`);
  * K2 `_flash_kernel` (`sm_mode="none"`): the VAE mid-block attention and
    the unquantized UNet path; on the tensor cores in bf16, and in f32 as
    three TF32 products a product (`flash_form`);
  * K3 `_rt_fused_kernel` (`sm_mode="log2_real_time"`), in its two-launch
    form K3b (`_stats_kernel`, `_stats_kernel_nonpeak`, `_accum_kernel`):
    `rt_stats` reduces the per-call delta into one device scalar with an
    atomic, `quant_accum` reads it. A GPU grid has no order, so the TPU's
    one-call form with a sequential phase axis has no counterpart; both
    launches run on the tensor cores, in bf16 and in f32 (`quant_form`);
  * K4 `_static_quant_kernel` (`sm_mode="log2"`, or `"uniform"` with
    start_peak): statistics and quantized accumulation in one launch; on the
    tensor cores in bf16 and f32 (`quant_form`).

The packed head-slot path (`_fused_attention_packed` there: the same four
bodies, K1p to K4p, over (B, T, H*dp) arrays) is `fused_attention(...,
num_heads=H)` here: the `*_packed` wrappers launch the same CUDA kernels with
the heads addressed by stride, so q, k and v are read where the projections
wrote them and no transposed copy is made on either side of the call.

`fused_attention` takes the plain PyTorch version (`attention_reference`,
per head slot `packed_attention_reference`) only for tensors on the CPU. A
CUDA tensor launches a kernel or raises.

Layout: q (BH, T, D), k/v (BH, S, D), contiguous, as in the JAX package; with
`num_heads=H`, q (B, T, H*dp), k/v (B, S, H*dp), head h in lanes
[h*dp, (h+1)*dp) of which the first `head_dim` carry data and the rest zeros.
"""
from __future__ import annotations

import ctypes

import torch

from dgq_tpu_torch.ops.build import load_kernels, refuse_grad
from dgq_tpu_torch.parallel.mesh import batch_reduce_

# Calls of each kernel wrapper since the last reset (a run can show that the
# main path went through the kernels): one a Python call into the wrapper,
# which launches one kernel. Only the wrappers add to them. The benchmark's
# generation driver prints "rt_stats", "quant_accum" and "flash_attention" a
# batch (with group_conv's "group_quant_conv"); device launches are counted
# from a profiler trace, not here.
LAUNCHES = {"static_uniform_attention": 0, "flash_attention": 0, "rt_stats": 0,
            "quant_accum": 0, "static_quant_attention": 0,
            "static_uniform_attention_packed": 0, "flash_attention_packed": 0,
            "rt_stats_packed": 0, "quant_accum_packed": 0, "static_quant_attention_packed": 0}


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
            # dynamic delta excludes the peak; a data-parallel rank takes the
            # max over every rank's rows (`batch_reduce_`)
            delta = batch_reduce_(p[..., 1:].max() if start_peak else p.max(), "max")
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


def _check_device_dtype(q, k, v):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"attention kernels need CUDA tensors, got {q.device}, "
                         f"{k.device}, {v.device}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"attention kernels take f32 or bf16 q/k/v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")


def _check_inputs(q, k, v):
    _check_device_dtype(q, k, v)
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


# The bodies of the flash kernel, by the number the C interface takes.
FLASH_FORMS = {"cuda_core": 0, "wgmma_async": 1, "wgmma_plain": 2, "tf32x3_vector": 3,
               "tf32x3_plain": 4}


def flash_form(dtype, head_dim: int, ptrs, strides, slot: int = 0) -> str:
    """Which body of the flash kernel (K2, K2p) a call runs, from what the
    wrapper can see before the launch; both dtypes run on the tensor cores.
    bf16: its K and V tiles are filled by 16-byte asynchronous copies
    ("wgmma_async") where every row of q, k and v starts on a 16-byte
    boundary (base addresses `ptrs` in bytes; batch and row `strides` and the
    head `slot` in elements, all multiples of 8) and head_dim is a multiple of
    8, else by element loads into the same tiles ("wgmma_plain"): same bits,
    slower loads. f32 runs as three TF32 products a product; its operands are
    loaded as 16-byte vectors ("tf32x3_vector") where the base addresses are
    multiples of 16 bytes and head_dim, slot and strides multiples of 4
    elements, else element by element ("tf32x3_plain"): same bits. (The
    tensor-core bodies take a positive scale only: `_flash_form_checked`.)"""
    if dtype == torch.bfloat16:
        aligned = (head_dim % 8 == 0 and slot % 8 == 0 and all(p % 16 == 0 for p in ptrs)
                   and all(st % 8 == 0 for st in strides))
        return "wgmma_async" if aligned else "wgmma_plain"
    aligned = (head_dim % 4 == 0 and slot % 4 == 0 and all(p % 16 == 0 for p in ptrs)
               and all(st % 4 == 0 for st in strides))
    return "tf32x3_vector" if aligned else "tf32x3_plain"


def _flash_form_checked(scale, *args) -> int:
    """`flash_form` as the number the C interface takes. The tensor-core
    bodies find the row max on the raw scores, so they need scale > 0."""
    if not scale > 0:
        raise ValueError(f"the flash kernel needs a positive scale, got {scale}")
    return FLASH_FORMS[flash_form(*args)]


# The largest head_dim and uniform code each dtype's tensor-core quantizing
# body takes: bf16 codes are exact up to 256; TF32 (f32's three-product body,
# built for the UNet's head dims) holds integers up to 2048.
QUANT_TC_LIMITS = {torch.bfloat16: (192, 256), torch.float32: (160, 2048)}


def quant_form(dtype, head_dim: int, ptrs, strides, slot: int = 0, max_code: int = 255) -> str:
    """Which body of the quantizing kernels K1 (`static_uniform_attention`),
    K3b (`rt_stats`, `quant_accum`) and K4 (`static_quant_attention`), and
    of their packed entries, a call runs; the numbers are `FLASH_FORMS`'.
    bf16 at head_dim <= 192 and f32 at head_dim <= 160 run on the tensor
    cores (f32 as three TF32 products for Q K^T, two for P V), with the loads
    chosen as `flash_form` chooses them (`ptrs`: the base addresses the
    kernel reads, in bytes). The uniform quantizer (K1, K4 uniform) feeds its
    codes (integers up to `max_code` = 2^bits - 1) to the tensor cores as
    they are: bf16 holds integers exactly up to 256, TF32 up to 2048; the
    log2 quantizer feeds powers of two and takes any code length (leave
    `max_code` at its default). Wider heads (K1 at the VAE's 512) and longer
    uniform codes run on the CUDA cores. (The tensor-core bodies take a
    positive scale only: `_quant_form_checked`.)"""
    max_d, max_codes = QUANT_TC_LIMITS.get(dtype, (0, 0))
    if head_dim > max_d or max_code > max_codes:
        return "cuda_core"
    return flash_form(dtype, head_dim, ptrs, strides, slot)


def _quant_form_checked(scale, *args, **kw) -> int:
    """`quant_form` as the number the C interface takes: the tensor-core
    bodies take the row max on the raw scores, so they need scale > 0."""
    form = quant_form(*args, **kw)
    if form != "cuda_core" and not scale > 0:
        raise ValueError(f"the tensor-core quantizing kernels need a positive scale, got {scale}")
    return FLASH_FORMS[form]


def flash_attention(q, k, v, scale: float):
    """K2: unquantized softmax attention (`_flash_kernel`)."""
    refuse_grad("flash_attention", q, k, v)
    _check_inputs(q, k, v)
    lib = load_kernels()
    out = torch.empty_like(q)
    bh, t, d = q.shape
    s = k.shape[1]
    form = _flash_form_checked(scale, q.dtype, d, (q.data_ptr(), k.data_ptr(), v.data_ptr()),
                               (t * d, d, s * d, d, s * d, d))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dgq_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bh, t, s, d, float(scale), int(q.dtype == torch.bfloat16), form, stream)
    _raise_on_error(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


def static_uniform_attention(q, k, v, scale: float, sm_delta, sm_bits: int = 8):
    """K1: softmax attention with the uniform post-softmax quantizer
    (`_static_uniform_kernel`). sm_delta: scalar tensor (any float dtype);
    the kernel reads it from device memory, so no host synchronisation."""
    refuse_grad("static_uniform_attention", q, k, v, sm_delta)
    _check_inputs(q, k, v)
    if not 1 <= sm_bits <= 16:
        raise ValueError(f"sm_bits {sm_bits} out of range")
    delta = _scalar_delta(sm_delta, q.device)
    lib = load_kernels()
    out = torch.empty_like(q)
    bh, t, d = q.shape
    s = k.shape[1]
    form = _quant_form_checked(scale, q.dtype, d, (q.data_ptr(), k.data_ptr(), v.data_ptr()),
                               (t * d, d, s * d, d, s * d, d), max_code=2 ** sm_bits - 1)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dgq_uniform_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bh, t, s, d, float(scale), delta.data_ptr(), sm_bits,
            int(q.dtype == torch.bfloat16), form, stream)
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
    refuse_grad("rt_stats", q, k)
    _check_inputs(q, k, k)
    if q.shape[2] > 160:
        raise ValueError(f"rt_stats is built for head_dim <= 160, got {q.shape[2]}")
    lib = load_kernels()
    bh, t, d = q.shape
    s = k.shape[1]
    form = _quant_form_checked(scale, q.dtype, d, (q.data_ptr(), k.data_ptr()),
                               (t * d, d, s * d, d))
    z = torch.empty(bh, t, dtype=torch.float32, device=q.device)
    red = torch.full((1,), 0.0 if start_peak else float("inf"), dtype=torch.float32,
                     device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dgq_rt_stats(q.data_ptr(), k.data_ptr(), z.data_ptr(), red.data_ptr(),
                              bh, t, s, d, float(scale), int(start_peak),
                              int(q.dtype == torch.bfloat16), form, stream)
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
    refuse_grad("quant_accum", q, k, v, z, red)
    _check_quant_inputs(q, k, v, sm_bits)
    bh, t, d = q.shape
    for name, buf, shape in (("z", z, (bh, t)), ("red", red, (1,))):
        if (buf.device != q.device or buf.dtype != torch.float32 or tuple(buf.shape) != shape
                or not buf.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous f32 {shape} tensor on {q.device}")
    lib = load_kernels()
    out = torch.empty_like(q)
    s = k.shape[1]
    form = _quant_form_checked(scale, q.dtype, d, (q.data_ptr(), k.data_ptr(), v.data_ptr()),
                               (t * d, d, s * d, d, s * d, d))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dgq_quant_accum(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                 z.data_ptr(), red.data_ptr(), bh, t, s, d,
                                 float(scale), sm_bits, int(start_peak),
                                 int(q.dtype == torch.bfloat16), form, stream)
    _raise_on_error(rc, "quant_accum")
    LAUNCHES["quant_accum"] += 1
    return out


def log2_real_time_attention(q, k, v, scale: float, sm_bits: int = 8,
                             start_peak: bool = False):
    """K3 in its Hopper form K3b: softmax attention with the log2 quantizer
    whose delta is reduced over the whole call, as two launches on the
    current stream with no host synchronisation between them. A
    data-parallel rank folds its reduction with every rank's between the two
    (`batch_reduce_`: min, or max under start_peak, in place on the card)."""
    refuse_grad("log2_real_time_attention", q, k, v)
    _check_quant_inputs(q, k, v, sm_bits)
    z, red = rt_stats(q, k, scale, start_peak)
    batch_reduce_(red, "max" if start_peak else "min")
    return quant_accum(q, k, v, z, red, scale, sm_bits, start_peak)


def _static_max_code(sm_mode: str, sm_bits: int) -> int:
    """The code bound `quant_form` weighs for K4: the uniform codes' own; the
    log2 quantizer's codes are exponents and do not limit the body."""
    return 2 ** sm_bits - 1 if sm_mode == "uniform" else 255


def _static_quant_f32(fn, q, k, v, out=None):
    """K4 / K4p on bf16 tensors whose uniform codes pass 256, which bf16 does
    not hold exactly: the f32 kernel on f32 copies (its tensor-core body,
    whose TF32 codes are exact up to 2048; the CUDA-core body past that), the
    result rounded to bf16 once, into `out` where one is given."""
    res = fn(q.float(), k.float(), v.float()).to(q.dtype)
    return res if out is None else out.copy_(res)


def static_quant_attention(q, k, v, scale: float, sm_mode: str, sm_delta, sm_bits: int = 8,
                           start_peak: bool = False):
    """K4: softmax attention with a static-delta quantizer in one launch:
    `sm_mode="log2"` (with or without start_peak) or `"uniform"` with
    start_peak. sm_delta is a scalar tensor read from device memory."""
    refuse_grad("static_quant_attention", q, k, v, sm_delta)
    _check_quant_inputs(q, k, v, sm_bits)
    if sm_mode not in ("log2", "uniform"):
        raise ValueError(f"static_quant_attention takes 'log2' or 'uniform', got {sm_mode!r}")
    bh, t, d = q.shape
    s = k.shape[1]
    form = _quant_form_checked(scale, q.dtype, d, (q.data_ptr(), k.data_ptr(), v.data_ptr()),
                               (t * d, d, s * d, d, s * d, d),
                               max_code=_static_max_code(sm_mode, sm_bits))
    if q.dtype == torch.bfloat16 and form == FLASH_FORMS["cuda_core"]:
        return _static_quant_f32(lambda *f32: static_quant_attention(
            *f32, scale, sm_mode, sm_delta, sm_bits, start_peak), q, k, v)
    delta = _scalar_delta(sm_delta, q.device)
    lib = load_kernels()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dgq_static_quant_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, t, s, d,
            float(scale), delta.data_ptr(), sm_bits, int(sm_mode == "uniform"),
            int(start_peak), int(q.dtype == torch.bfloat16), form, stream)
    _raise_on_error(rc, "static_quant_attention")
    LAUNCHES["static_quant_attention"] += 1
    return out


def packed_slot_width(width: int, num_heads: int) -> int:
    """The slot width dp of a (.., H*dp) packed tensor, held to the JAX
    package's layout rules: 64 with an even head count (its pair mode), else
    a multiple of 128."""
    if num_heads < 1 or width % num_heads:
        raise ValueError(f"packed width {width} is no multiple of num_heads {num_heads}")
    dp = width // num_heads
    if dp == 64:
        if num_heads % 2:
            raise ValueError("pair-packed layout needs an even head count")
    elif dp % 128:
        raise ValueError(f"packed head slot width {dp} must be 64 or a multiple of 128")
    return dp


def unpack_heads(x, num_heads: int, head_dim: int):
    """(B, T, H*dp) head slots -> (B*H, T, head_dim), the classic layout."""
    b, t, c = x.shape
    x4 = x.reshape(b, t, num_heads, c // num_heads)[..., :head_dim]
    return x4.permute(0, 2, 1, 3).reshape(b * num_heads, t, head_dim)


def repack_heads(x, num_heads: int, dp: int):
    """(B*H, T, d) -> (B, T, H*dp), lanes d..dp of every slot zero."""
    bh, t, d = x.shape
    b = bh // num_heads
    out = x.new_zeros(b, t, num_heads, dp)
    out[..., :d] = x.reshape(b, num_heads, t, d).permute(0, 2, 1, 3)
    return out.reshape(b, t, num_heads * dp)


def packed_attention_reference(q, k, v, scale, num_heads: int, head_dim=None, sm_mode="none",
                               sm_bits=8, sm_delta=None, start_peak=False):
    """Plain version of the packed entries: unpack the head slots, run
    `attention_reference` (one real_time delta over every batch and head),
    repack with zeros in the padding lanes."""
    dp = q.shape[-1] // num_heads
    d = dp if head_dim is None else head_dim
    out = attention_reference(unpack_heads(q, num_heads, d), unpack_heads(k, num_heads, d),
                              unpack_heads(v, num_heads, d), scale, sm_mode, sm_bits, sm_delta,
                              start_peak)
    return repack_heads(out, num_heads, dp)


class _Packed:
    """The checked arguments of one packed launch: shapes, the strides array
    and the output buffer."""

    def __init__(self, q, k, v, num_heads, head_dim, max_head_dim, out, need_out=True):
        _check_device_dtype(q, k, v)
        if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
            raise ValueError(f"expected q (B,T,H*dp), k/v (B,S,H*dp); got {tuple(q.shape)}, "
                             f"{tuple(k.shape)}, {tuple(v.shape)}")
        self.b, self.t, c = q.shape
        if k.shape[0] != self.b or k.shape[2] != c:
            raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
        self.s = k.shape[1]
        self.heads = num_heads
        self.slot = packed_slot_width(c, num_heads)
        self.d = self.slot if head_dim is None else head_dim
        if not 1 <= self.d <= self.slot:
            raise ValueError(f"head_dim {self.d} does not fit the slot width {self.slot}")
        if self.d > max_head_dim:
            raise ValueError(f"this kernel is built for head_dim <= {max_head_dim}, got {self.d} "
                             f"(slot width {self.slot}: pass the true head_dim)")
        if self.b * num_heads > 65535:
            raise ValueError(f"batch*heads {self.b * num_heads} > 65535 is not supported")
        if need_out and out is None:
            out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        elif need_out and (out.shape != q.shape or out.dtype != q.dtype
                           or out.device != q.device):
            raise ValueError(f"out must be a {q.dtype} {tuple(q.shape)} tensor on {q.device}")
        self.out = out
        # any view whose lanes are contiguous and whose rows do not overlap: a
        # storage offset needs no alignment (the tensor-core bodies pick 16-byte
        # copies or element loads from the addresses, `flash_form` and
        # `quant_form`; the CUDA-core bodies read element by element)
        strides = ()
        for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
            sb, sr, sl = (0, c, 1) if x is None else x.stride()
            if sl != 1 or sr < c or sb < 0:
                raise ValueError(f"packed attention kernels need {name} with a contiguous last "
                                 f"axis and rows at least {c} apart, got strides {x.stride()}")
            strides += (sb, sr)
        self.strides = (ctypes.c_longlong * 8)(*strides)
        self.bf16 = int(q.dtype == torch.bfloat16)
        self.device = q.device

    def dims(self):
        return self.b, self.heads, self.t, self.s, self.d, self.slot, self.strides


def flash_attention_packed(q, k, v, scale: float, num_heads: int, head_dim=None, out=None):
    """K2p: `flash_attention` over head slots (`_flash_kernel(sub_heads)`)."""
    refuse_grad("flash_attention_packed", q, k, v)
    a = _Packed(q, k, v, num_heads, head_dim, 512, out)
    lib = load_kernels()
    form = _flash_form_checked(scale, q.dtype, a.d,
                               (q.data_ptr(), k.data_ptr(), v.data_ptr()),
                               tuple(a.strides)[:6], a.slot)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.dgq_flash_attention_packed(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                            a.out.data_ptr(), *a.dims(), float(scale), a.bf16,
                                            form, stream)
    _raise_on_error(rc, "flash_attention_packed")
    LAUNCHES["flash_attention_packed"] += 1
    return a.out


def static_uniform_attention_packed(q, k, v, scale: float, sm_delta, num_heads: int,
                                    head_dim=None, sm_bits: int = 8, out=None):
    """K1p: `static_uniform_attention` over head slots
    (`_static_uniform_kernel(sub_heads)`)."""
    refuse_grad("static_uniform_attention_packed", q, k, v, sm_delta)
    a = _Packed(q, k, v, num_heads, head_dim, 512, out)
    if not 1 <= sm_bits <= 16:
        raise ValueError(f"sm_bits {sm_bits} out of range")
    delta = _scalar_delta(sm_delta, a.device)
    lib = load_kernels()
    form = _quant_form_checked(scale, q.dtype, a.d, (q.data_ptr(), k.data_ptr(), v.data_ptr()),
                               tuple(a.strides)[:6], a.slot, max_code=2 ** sm_bits - 1)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.dgq_uniform_attention_packed(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                              a.out.data_ptr(), *a.dims(), float(scale),
                                              delta.data_ptr(), sm_bits, a.bf16, form, stream)
    _raise_on_error(rc, "static_uniform_attention_packed")
    LAUNCHES["static_uniform_attention_packed"] += 1
    return a.out


def rt_stats_packed(q, k, scale: float, num_heads: int, head_dim=None,
                    start_peak: bool = False):
    """K3p, first launch: `rt_stats` over head slots. z is (B*H, T), row
    b*H + h for head h of batch b; red folds every batch and head of the
    call, as `_rt_fused_kernel`'s one scalar does."""
    refuse_grad("rt_stats_packed", q, k)
    a = _Packed(q, k, k, num_heads, head_dim, 160, None, need_out=False)
    lib = load_kernels()
    form = _quant_form_checked(scale, q.dtype, a.d, (q.data_ptr(), k.data_ptr()),
                               tuple(a.strides)[:4], a.slot)
    z = torch.empty(a.b * num_heads, a.t, dtype=torch.float32, device=a.device)
    red = torch.full((1,), 0.0 if start_peak else float("inf"), dtype=torch.float32,
                     device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.dgq_rt_stats_packed(q.data_ptr(), k.data_ptr(), z.data_ptr(), red.data_ptr(),
                                     *a.dims(), float(scale), int(start_peak), a.bf16, form,
                                     stream)
    _raise_on_error(rc, "rt_stats_packed")
    LAUNCHES["rt_stats_packed"] += 1
    return z, red


def quant_accum_packed(q, k, v, z, red, scale: float, num_heads: int, head_dim=None,
                       sm_bits: int = 8, start_peak: bool = False, out=None):
    """K3p, second launch: `quant_accum` over head slots."""
    refuse_grad("quant_accum_packed", q, k, v, z, red)
    a = _Packed(q, k, v, num_heads, head_dim, 160, out)
    if not 1 <= sm_bits <= 16:
        raise ValueError(f"sm_bits {sm_bits} out of range")
    for name, buf, shape in (("z", z, (a.b * num_heads, a.t)), ("red", red, (1,))):
        if (buf.device != a.device or buf.dtype != torch.float32 or tuple(buf.shape) != shape
                or not buf.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous f32 {shape} tensor on {a.device}")
    lib = load_kernels()
    form = _quant_form_checked(scale, q.dtype, a.d, (q.data_ptr(), k.data_ptr(), v.data_ptr()),
                               tuple(a.strides)[:6], a.slot)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.dgq_quant_accum_packed(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                        a.out.data_ptr(), z.data_ptr(), red.data_ptr(),
                                        *a.dims(), float(scale), sm_bits, int(start_peak),
                                        a.bf16, form, stream)
    _raise_on_error(rc, "quant_accum_packed")
    LAUNCHES["quant_accum_packed"] += 1
    return a.out


def log2_real_time_attention_packed(q, k, v, scale: float, num_heads: int, head_dim=None,
                                    sm_bits: int = 8, start_peak: bool = False, out=None):
    """K3p (`_rt_fused_kernel(sub_heads)`) as its two launches, the
    reduction folded over a data-parallel run's ranks between them, as in
    `log2_real_time_attention`."""
    refuse_grad("log2_real_time_attention_packed", q, k, v)
    z, red = rt_stats_packed(q, k, scale, num_heads, head_dim, start_peak)
    batch_reduce_(red, "max" if start_peak else "min")
    return quant_accum_packed(q, k, v, z, red, scale, num_heads, head_dim, sm_bits, start_peak,
                              out)


def static_quant_attention_packed(q, k, v, scale: float, sm_mode: str, sm_delta,
                                  num_heads: int, head_dim=None, sm_bits: int = 8,
                                  start_peak: bool = False, out=None):
    """K4p: `static_quant_attention` over head slots
    (`_static_quant_kernel(sub_heads)`)."""
    refuse_grad("static_quant_attention_packed", q, k, v, sm_delta)
    a = _Packed(q, k, v, num_heads, head_dim, 160, out)
    if not 1 <= sm_bits <= 16:
        raise ValueError(f"sm_bits {sm_bits} out of range")
    if sm_mode not in ("log2", "uniform"):
        raise ValueError(f"static_quant_attention takes 'log2' or 'uniform', got {sm_mode!r}")
    form = _quant_form_checked(scale, q.dtype, a.d, (q.data_ptr(), k.data_ptr(), v.data_ptr()),
                               tuple(a.strides)[:6], a.slot,
                               max_code=_static_max_code(sm_mode, sm_bits))
    if a.bf16 and form == FLASH_FORMS["cuda_core"]:
        return _static_quant_f32(lambda *f32: static_quant_attention_packed(
            *f32, scale, sm_mode, sm_delta, num_heads, head_dim, sm_bits, start_peak),
            q, k, v, a.out)
    delta = _scalar_delta(sm_delta, a.device)
    lib = load_kernels()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.dgq_static_quant_attention_packed(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), a.out.data_ptr(), *a.dims(), float(scale),
            delta.data_ptr(), sm_bits, int(sm_mode == "uniform"), int(start_peak), a.bf16, form,
            stream)
    _raise_on_error(rc, "static_quant_attention_packed")
    LAUNCHES["static_quant_attention_packed"] += 1
    return a.out


def _fused_attention_packed(q, k, v, scale, num_heads, head_dim, sm_mode, sm_bits, sm_delta,
                            start_peak, out):
    """Packed head-slot dispatch (JAX `_fused_attention_packed`): the slot
    checks hold on every device; then the plain version on the CPU, a packed
    kernel anywhere else."""
    dp = packed_slot_width(q.shape[-1], num_heads)
    if head_dim is not None and not 1 <= head_dim <= dp:
        raise ValueError(f"head_dim {head_dim} does not fit the slot width {dp}")
    if q.device.type == "cpu":
        ref = packed_attention_reference(q, k, v, scale, num_heads, head_dim, sm_mode, sm_bits,
                                         sm_delta, start_peak)
        return ref if out is None else out.copy_(ref)
    if sm_mode == "none":
        return flash_attention_packed(q, k, v, scale, num_heads, head_dim, out)
    if sm_mode == "log2_real_time":
        return log2_real_time_attention_packed(q, k, v, scale, num_heads, head_dim, sm_bits,
                                               start_peak, out)
    if sm_mode not in ("uniform", "log2"):
        raise ValueError(f"unknown sm_mode {sm_mode!r}")
    if sm_delta is None:
        raise ValueError(f"{sm_mode} softmax quantization needs sm_delta")
    if sm_mode == "uniform" and not start_peak:
        return static_uniform_attention_packed(q, k, v, scale, sm_delta, num_heads, head_dim,
                                               sm_bits, out)
    return static_quant_attention_packed(q, k, v, scale, sm_mode, sm_delta, num_heads, head_dim,
                                         sm_bits, start_peak, out)


def fused_attention(q, k, v, scale: float, sm_mode: str = "none", sm_bits: int = 8,
                    sm_delta=None, start_peak: bool = False, num_heads=None, head_dim=None,
                    out=None):
    """Attention with an optional post-softmax quantizer (JAX
    `fused_attention`). CPU tensors take the plain version; anything else
    launches a kernel or raises.

    num_heads=None: the classic (BH, T, D) layout. num_heads=H: the packed
    head-slot layout, q (B, T, H*dp) and k, v (B, S, H*dp) as the packed
    projections (`calib.weight_calib.pack_attention_heads`) write them, dp 64
    (even H) or a multiple of 128; returns (B, T, H*dp) with zeros in the
    padding lanes. head_dim is the number of leading lanes of a slot that
    carry data (default: all dp); the kernels contract over those alone,
    which changes no bit, the others being zeros. `out` (packed layout only)
    is a buffer to write into."""
    refuse_grad("fused_attention", q, k, v, sm_delta)
    if num_heads is not None:
        return _fused_attention_packed(q, k, v, scale, num_heads, head_dim, sm_mode, sm_bits,
                                       sm_delta, start_peak, out)
    if head_dim is not None or out is not None:
        raise ValueError("head_dim and out belong to the packed layout (num_heads=H)")
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
