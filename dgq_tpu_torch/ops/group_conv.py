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

What bounds it on the H100: operations at the wide-image shapes (a 3x3 conv
at the UNet's widths does 2*9*C*O flops per output pixel against (C + O)
elements moved), bytes at the deep ones (8x8 images, 2560 -> 1280: 59 MB of
weights). A call is two or three launches of `csrc/group_conv.cu`: the fold
(`w * dm * dl`, `1/(dm*dl)`, `zm + zl`; redone each call because the
time-aware dm changes with the step), the conv, and where K is split over
blocks the pass that adds the partial sums in a fixed order. Convs whose C
and O are multiples of 8 run on the tensor cores (`conv_form`): bf16 as it
is, f32 as three TF32 products a product, with the fold writing the weights
as two K-major panels of TF32 parts (`fold_weights(..., panels=True)`); the
rest (conv_in, conv_out) on the CUDA cores. `conv_plan` is the tile and
split plan the tensor-core bodies follow, a pure function of dtype and shape.

`group_quant_conv` takes the plain PyTorch version only for tensors on the
CPU. A CUDA tensor launches the kernel or raises.

Layout (the JAX function's): x NHWC (B, H, W, C); w HWIO (kh, kw, C, O), of
which `w.reshape(kh*kw, C, O)` is the (taps, C, O) view the kernel reads
(`models.layers.quant_conv2d` makes the HWIO view of the port's OIHW weights
with a permute); dm, zm (kh*kw, C); dl, zl scalars; bias (O,) or None.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from dgq_tpu_torch.models.qconfig import GroupQParams
from dgq_tpu_torch.ops.build import load_kernels, refuse_grad
from dgq_tpu_torch.ops.tf32 import tf32_split

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
    band-count terms belong to the TPU kernel and have no counterpart.) Which
    body of the kernel an eligible conv runs is `conv_form`'s rule on dtype,
    shape and address: shapes too narrow for 16-byte vectors (C or O not a
    multiple of 8: conv_in's 4 channels, conv_out's 4 outputs) take the
    CUDA-core body, the others a tensor-core body."""
    if stride != 1 or not isinstance(gqp, GroupQParams):
        return False
    c = x_shape[-1]
    return gqp.delta_mid.shape[-1] == c * kh * kw and gqp.delta_last.shape[-1] == 1


# The tensor-core bodies' tiles: output pixels and output channels per block,
# input channels (of one tap) per K step; bf16 and f32 (3xTF32, half the
# channels a step in the same 128-byte rows, half the outputs a block so that
# two stages of both TF32 parts fit). And the SM count the split aims at, the
# H100 SXM's (a plan must be a pure function of dtype and shape, so it is a
# constant here and not read from the device; on a card with another count
# the plan is still right, only its splits fill the card less well).
TILE_M, TILE_N, TILE_K = 128, 320, 64
TILE_N_F32, TILE_K_F32 = 160, 32
SM_COUNT = 132
MAX_SPLITS = 16
# The body a form names, by the number the C interface takes.
CONV_FORMS = {"cuda_core": 0, "tensor_core": 1, "tf32x3": 2}


def conv_form(dtype, c: int, o: int, x_ptr: int = 0) -> str:
    """Which body of the kernel a conv runs: with C and O multiples of 8 and x
    on a 16-byte boundary (the loads are 16-byte vectors, the stores pairs of
    outputs) "tensor_core" for bf16 and "tf32x3" for f32 (three TF32
    products a product), else "cuda_core"."""
    if c % 8 == 0 and o % 8 == 0 and c >= 8 and x_ptr % 16 == 0:
        return "tensor_core" if dtype == torch.bfloat16 else "tf32x3"
    return "cuda_core"


class ConvPlan(NamedTuple):
    """A tensor-core body's grid: m_tiles x n_tiles output tiles, each K
    walked in `steps` steps of one (tap, `tile_k`-channel chunk), cut into
    `splits` runs of `steps_per_split` consecutive steps (the last may be
    shorter)."""
    m_tiles: int
    n_tiles: int
    c_chunks: int
    steps: int
    splits: int
    steps_per_split: int
    tile_k: int


def conv_plan(m: int, c: int, o: int, taps: int, dtype=torch.bfloat16) -> ConvPlan:
    """Tile and split plan for M output pixels, C -> O channels, `taps` taps,
    with the tiles of `dtype`'s body (bf16: TILE_N x TILE_K, f32: TILE_N_F32
    x TILE_K_F32). A block is resident alone on its SM, so with fewer output
    tiles than SMs (SM_COUNT = 132, the H100 SXM's; another card changes how
    well a split fills it, not the result) the K steps are split as many ways
    as still fit one wave of blocks, at most MAX_SPLITS and never into runs
    shorter than 8 steps; each split writes an f32 partial tile and a last
    pass adds them in split order."""
    tile_n, tile_k = (TILE_N, TILE_K) if dtype == torch.bfloat16 else (TILE_N_F32, TILE_K_F32)
    m_tiles, n_tiles = -(-m // TILE_M), -(-o // tile_n)
    c_chunks = -(-c // tile_k)
    steps = taps * c_chunks
    splits = max(1, min(SM_COUNT // (m_tiles * n_tiles), MAX_SPLITS, steps // 8))
    per = -(-steps // splits)
    return ConvPlan(m_tiles, n_tiles, c_chunks, steps, -(-steps // per), per, tile_k)


def plan_k_ranges(plan: ConvPlan, c: int):
    """Per split, the (tap, first channel, end channel) pieces of K it walks."""
    ranges = []
    for s in range(plan.splits):
        steps = range(s * plan.steps_per_split,
                      min(plan.steps, (s + 1) * plan.steps_per_split))
        ranges.append([(step // plan.c_chunks, step % plan.c_chunks * plan.tile_k,
                        min(c, (step % plan.c_chunks + 1) * plan.tile_k)) for step in steps])
    return ranges


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


def fold_panels(w_t):
    """The f32 tensor-core body's weights from `_fold`'s w_t (taps, C, O):
    (2, taps, O, C), w_t transposed to K-major and split into TF32 big and
    small parts (`tf32_split`). The plain version of `fold_weights(...,
    panels=True)`, whose panels equal these bit for bit."""
    return torch.stack(tf32_split(w_t.transpose(1, 2))).contiguous()


def fold_weights(dtype, w, dm, zm, dl, zl, kh: int, kw: int, panels: bool = False):
    """`_fold` in one hand-written launch (`fold_kernel`), for CUDA tensors:
    w (kh, kw, C, O) is read through its strides (so the HWIO view of an OIHW
    weight needs no copy), dm and zm (taps, C) through theirs; returns w_t
    (taps, C, O) contiguous in `dtype`, rd and z (taps, C) f32, with `_fold`'s
    bits. With `panels` (f32 only) the first is instead the f32 tensor-core
    body's (2, taps, O, C) TF32 panels, `fold_panels(w_t)` bit for bit. The
    kernel writes w_t in w's own dtype, so w must have `dtype`; it never gives
    way to `_fold`, which is the plain version's and the CPU's."""
    refuse_grad("fold_weights", w, dm, zm, dl, zl)
    taps, c, o = kh * kw, w.shape[2], w.shape[3]
    if w.dtype != dtype:
        raise ValueError(f"the group conv kernel needs w in x's dtype: w {w.dtype}, x {dtype}")
    if not w.is_cuda:
        raise ValueError(f"the fold kernel needs a CUDA tensor, got {w.device}")
    if panels and dtype != torch.float32:
        raise ValueError(f"the TF32 panels are folded from f32 weights, got {dtype}")
    if kh > 1 and w.stride(0) != kw * w.stride(1):
        w = w.contiguous()  # taps not evenly spaced: no single tap stride
    scales = [dm, zm, dl.reshape(1), zl.reshape(1)]
    if not all(t.dtype == scales[0].dtype for t in scales) or scales[0].dtype not in (
            torch.float32, torch.bfloat16):
        scales = [t.float() for t in scales]
    dm, zm, dl, zl = scales
    if zm.stride() != dm.stride():
        dm, zm = dm.contiguous(), zm.contiguous()
    shape = (2, taps, o, c) if panels else (taps, c, o)
    w_t = torch.empty(shape, dtype=dtype, device=w.device)
    rd = torch.empty(taps, c, dtype=torch.float32, device=w.device)
    z = torch.empty(taps, c, dtype=torch.float32, device=w.device)
    lib = load_kernels()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        common = (w.data_ptr(), w.stride(1), w.stride(2), w.stride(3), dm.data_ptr(),
                  zm.data_ptr(), dm.stride(0), dm.stride(1), dl.data_ptr(), zl.data_ptr(),
                  w_t.data_ptr(), rd.data_ptr(), z.data_ptr(), taps, c, o)
        if panels:
            rc = lib.dgq_group_conv_fold_panels(*common, int(dm.dtype == torch.bfloat16), stream)
        else:
            rc = lib.dgq_group_conv_fold(*common, int(dtype == torch.bfloat16),
                                         int(dm.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"group conv fold kernel launch failed: CUDA error {rc}")
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
    refuse_grad("group_quant_conv", x, w, dm, zm, dl, zl, bias)
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
    if w.dtype != x.dtype:
        raise ValueError(f"the group conv kernel needs w in x's dtype: w {w.dtype}, x {x.dtype}")
    if not 1 <= a_bits <= 16:
        raise ValueError(f"a_bits {a_bits} out of range")
    o = w.shape[3]
    ho, wo = h + 2 * padding - kh + 1, wd + 2 * padding - kw + 1
    if ho < 1 or wo < 1 or b * ho * wo >= 2 ** 31 or x.numel() >= 2 ** 31:
        raise ValueError(f"unsupported conv geometry: x {tuple(x.shape)}, out {ho}x{wo}")
    name = conv_form(x.dtype, c, o, x.data_ptr())
    w_t, rd, z = fold_weights(x.dtype, w, dm, zm, dl, zl, kh, kw, panels=name == "tf32x3")
    bias_f = (torch.zeros(o, dtype=torch.float32, device=x.device) if bias is None
              else bias.float().contiguous())
    out = torch.empty(b, ho, wo, o, dtype=x.dtype, device=x.device)
    form, splits, per, partial = CONV_FORMS[name], 1, 1, None
    if name != "cuda_core":
        plan = conv_plan(b * ho * wo, c, o, taps, x.dtype)
        splits, per = plan.splits, plan.steps_per_split
        if splits > 1:
            partial = torch.empty(splits, b * ho * wo, o, dtype=torch.float32, device=x.device)
    lib = load_kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.dgq_group_quant_conv(
            x.data_ptr(), w_t.data_ptr(), rd.data_ptr(), z.data_ptr(), bias_f.data_ptr(),
            out.data_ptr(), None if partial is None else partial.data_ptr(), b, h, wd, c, o, kh,
            kw, padding, a_bits, int(x.dtype == torch.bfloat16), form, splits, per, stream)
    if rc != 0:
        raise RuntimeError(f"group_quant_conv kernel launch failed: CUDA error {rc}")
    LAUNCHES["group_quant_conv"] += 1
    return out
