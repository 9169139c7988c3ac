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
fit int8), multiplies s8 x s8 -> s32 on the tensor cores (`wgmma`, A from
registers) and applies the epilogue in f32, reading the bias in its own
dtype; wq, dw, zw and wsum are made once at load (`pack_weight_int8`,
`calib.weight_calib.attach_int8_packed`). `int8_plan` is the tile and
split-K plan the kernel follows, a pure function of the shape; `int8_form`
picks the tiles' copies from the addresses.

What bounds it on the H100: bytes at most main-path shapes (the (M, N)
output at the wide ones, the weight panel at the small-M ones), operations
(2*M*N*K at the int8 tensor-core rate) where K is long and M and N wide.

Code layout: the port stores weights out-channel first, so the packed codes
are (N, K) int8 with K contiguous, which is what both operands of an integer
dot product want (the JAX package keeps (K, N); `io.convert` transposes).

`quantized_matmul` takes the plain PyTorch version only for tensors on the
CPU. A CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from dgq_tpu_torch.ops.build import load_kernels, refuse_grad

# Calls of the kernel's wrapper since the last reset (one kernel launch a
# call); only the wrapper adds to it. The benchmark reads none of it.
LAUNCHES = {"int8_matmul": 0}

# The kernel's tile: output rows and columns per block, codes of K per step;
# and the SM count the split aims at, the H100 SXM's (a plan must be a pure
# function of the shape, so it is a constant here and not read from the
# device; on a card with another count the plan is still right, only its
# splits fill the card less well).
TILE_M, TILE_N, TILE_K = 128, 256, 128
SM_COUNT = 132
MAX_SPLITS = 16
# the kernel's scratch per output tile and split: the s32 partial tile and
# its row sums
WS_INTS = TILE_M * TILE_N + TILE_M
# The split-K tickets, one int32 per output tile, per device: zeros that every
# split launch leaves zeros (the last block of a tile resets its counter), so
# they are made once and grown, never cleared. Calls on one device share
# them, as they share its current stream.
_COUNTERS = {}


class Int8Plan(NamedTuple):
    """The kernel's grid: m_tiles x n_tiles output tiles, K walked in `steps`
    steps of TILE_K codes, cut into `splits` runs of `steps_per_split`
    consecutive steps (the last may be shorter)."""
    m_tiles: int
    n_tiles: int
    steps: int
    splits: int
    steps_per_split: int


def int8_plan(m: int, n: int, k: int) -> Int8Plan:
    """Tile and split plan for x (M, K) times codes (N, K). A block is
    resident alone on its SM, so with fewer output tiles than SMs
    (SM_COUNT = 132) the K steps are split as many ways as still fit one wave
    of blocks, at most MAX_SPLITS and at most one split a step. The splits'
    s32 partial sums are exact, so where they meet changes no bit."""
    m_tiles, n_tiles = -(-m // TILE_M), -(-n // TILE_N)
    steps = -(-k // TILE_K)
    splits = max(1, min(SM_COUNT // (m_tiles * n_tiles), MAX_SPLITS, steps))
    per = -(-steps // splits)
    return Int8Plan(m_tiles, n_tiles, steps, -(-steps // per), per)


def plan_k_ranges(plan: Int8Plan, k: int):
    """Per split, the [first, end) range of K it walks."""
    return [(s * plan.steps_per_split * TILE_K, min(k, (s + 1) * plan.steps_per_split * TILE_K))
            for s in range(plan.splits)]


# The kernel's forms, by the number the C interface takes.
INT8_FORMS = {"cp_async": 1, "element": 2}


def int8_form(k: int, x_ptr: int, w_ptr: int) -> str:
    """Which copies fill the kernel's tiles: 16-byte asynchronous copies
    ("cp_async") where every row of x (f32 or bf16) and of the codes starts
    on a 16-byte boundary (K a multiple of 16, both base addresses too), else
    element loads into the same tiles ("element"): same bits, slower loads."""
    return "cp_async" if k % 16 == 0 and x_ptr % 16 == 0 and w_ptr % 16 == 0 else "element"


def _counters(device, tiles: int) -> torch.Tensor:
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < tiles:
        buf = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


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
                     a_bits: int = 8, return_codes: bool = False, plan: Int8Plan | None = None):
    """K6: y (M, N) in x's dtype from x (M, K) f32/bf16 and packed weights.

    wq (N, K) int8 recentered codes; w_delta, w_zp (recentered), w_ksum (the
    codes' row sums; made here when None): (N,), used as they are when f32
    and contiguous (`attach_int8_packed` makes them so), else converted
    here; bias (N,) or None, read by the kernel in f32 or bf16, so a call
    converts no weight-side vector before its launch. x_delta and x_zp
    (recentered, already rounded to an integer by the caller) are scalar
    tensors the kernel reads from device memory, so a time-aware slot costs
    no host synchronisation. With `return_codes` the kernel also writes the
    codes it built and their row sums: (y, codes int8 (M, K), xsum f32
    (M,)). `plan` is the tile and split plan the kernel follows
    (`int8_plan`'s by default; another split of the same K gives the same
    bits, the partial sums being exact)."""
    refuse_grad("quantized_matmul", x, wq, w_delta, w_zp, x_delta, x_zp, bias, w_ksum)
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
    if bias is not None and not (bias.dtype in (torch.float32, torch.bfloat16)
                                 and bias.is_contiguous() and bias.device == dev):
        bias = bias.float().contiguous()
    out = torch.empty(m, n, dtype=x.dtype, device=dev)
    codes = torch.empty(m, k, dtype=torch.int8, device=dev) if return_codes else None
    xsum = torch.empty(m, dtype=torch.float32, device=dev) if return_codes else None
    want = int8_plan(m, n, k)
    if plan is None:
        plan = want
    elif plan[:3] != want[:3]:
        raise ValueError(f"plan {plan} does not tile ({m}, {k}) x ({n}, {k}): {want}")
    tiles = plan.m_tiles * plan.n_tiles
    ws = counters = None
    if plan.splits > 1:
        ws = torch.empty(tiles * plan.splits * WS_INTS, dtype=torch.int32, device=dev)
        counters = _counters(dev, tiles)
    form = INT8_FORMS[int8_form(k, x.data_ptr(), wq.data_ptr())]
    lib = load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dgq_int8_matmul(
            x.data_ptr(), wq.data_ptr(), dx.data_ptr(), zx.data_ptr(), wsum.data_ptr(),
            dw.data_ptr(), zw.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), codes.data_ptr() if return_codes else None,
            xsum.data_ptr() if return_codes else None,
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(),
            m, n, k, a_bits, int(x.dtype == torch.bfloat16),
            int(bias is not None and bias.dtype == torch.bfloat16), form, plan.splits,
            plan.steps_per_split, stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error {rc}")
    LAUNCHES["int8_matmul"] += 1
    return (out, codes, xsum) if return_codes else out
