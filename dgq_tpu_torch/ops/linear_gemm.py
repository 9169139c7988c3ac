"""The port's f32 linear, y = x w^T + b, as one hand-written 3xTF32 `wgmma`
GEMM (`csrc/linear_gemm.cu`, `linear_tf32x3_gemm_kernel`).

Replaces no TPU kernel: the JAX package leaves its linears to XLA's dot. On
the card the library's f32 product runs on the f32 CUDA cores (67 TFLOP/s);
the kernel runs on the tensor cores with each f32 product formed from three
TF32 products (x = big + small, big = rna(x), small = x - big, which the
tensor cores cut to TF32; the product big big + big small + small big, as
K2, K3b and K5 form it), so it keeps the accuracy the port calls f32. What bounds it is operations: three TF32
products at 495 TFLOP/s, 165 TFLOP/s of f32 work at best.

`models.layers.linear` launches it where `kernel_takes` holds (a CUDA
tensor, f32 x and w, no gradient wanted, a shape the kernel takes: at least
MIN_ROWS rows and MIN_TILES tiles, K and N multiples of 4, rows of x and w
on 16-byte boundaries) and keeps `F.linear` for everything else: the CPU,
bf16, the AdaRound steps that differentiate it, the few-row products of the
time and adaLN embeddings, the few-tile cross-attention keys and values. `linear_gemm_reference` is the plain version the kernel is
held to; `gemm_plan` the tile plan it follows, a pure function of the shape.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from dgq_tpu_torch.ops.build import load_kernels, refuse_grad, wants_grad
from dgq_tpu_torch.ops.tf32 import tf32_split

# Since the last reset: the kernel's launches ("linear_gemm"), and the f32
# linears on a card that `models.layers.linear` left to the library
# ("linear_library"). linear_gemm / (linear_gemm + linear_library) is the
# share of the card's f32 linears the kernel took.
LAUNCHES = {"linear_gemm": 0, "linear_library": 0}

# What `models.layers.linear` sends to the kernel, from `chip_smoke.py`'s
# timings at the cells' shapes (H100): at least one tile of its 128 rows
# (below it a product is a few-row GEMV bound by the weight's bytes: the
# time and adaLN embeddings, M = 2 to 8), and at least MIN_TILES output
# tiles. With fewer, most SMs idle through a long K loop and the library,
# which splits K, is as fast or faster (the kernel 0.62x to 0.95x its speed
# at 25 to 40 tiles: the cross-attention keys and values at 308 and 616 rows
# and N 320 or 640; 1.00x at 60; 1.28x to 1.87x from 80 tiles). Every f32
# linear of 1024 rows or more in the cells has 64 tiles or more.
MIN_ROWS = 128
MIN_TILES = 64
TILE_M = 128
# the H100 SXM's SM count: the plan is a pure function of the shape, so it is
# a constant here and not read from the device (on another card the plan is
# still right, only its fill of the SMs differs)
SM_COUNT = 132


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class GemmPlan(NamedTuple):
    tile_n: int   # output columns a tile: 128, or 64
    tiles: int    # output tiles
    grid: int     # persistent blocks, one a SM at most


def gemm_plan(m: int, n: int) -> GemmPlan:
    """Tiles of 128 rows by 128 columns; by 64 columns where N is at most 64
    or the 128-wide tiles would not give every SM one (SD3's 1332 text rows
    at N 1536 fill the card at 128: 11 x 12 tiles), so that more SMs work.
    One persistent block a tile, at most one a SM."""
    m_tiles = -(-m // TILE_M)
    tile_n = 128 if n > 64 and m_tiles * -(-n // 128) >= SM_COUNT else 64
    tiles = m_tiles * -(-n // tile_n)
    return GemmPlan(tile_n, tiles, min(tiles, SM_COUNT))


def kernel_rule(device_type: str, x_dtype, w_dtype, needs_grad: bool, m: int, n: int, k: int,
                aligned: bool = True, floor: bool = True) -> bool:
    """Whether the kernel takes a linear of x (m, k) and w (n, k): on a CUDA
    device, f32 x and w, no gradient wanted, 1 to 2^31 - 1 rows, K and N
    multiples of 4 (16-byte rows for the TMA), `aligned`: x's and w's rows
    contiguous and on 16-byte boundaries; and, under `floor` (the routing of
    `models.layers.linear`), at least MIN_ROWS rows and MIN_TILES tiles in its
    plan. A pure function of what a call can see."""
    if floor and (m < MIN_ROWS or gemm_plan(m, n).tiles < MIN_TILES):
        return False
    return (device_type == "cuda" and x_dtype == torch.float32 and w_dtype == torch.float32
            and not needs_grad and 1 <= m < 2 ** 31 and n >= 4 and n % 4 == 0
            and k >= 4 and k % 4 == 0 and aligned)


def _rows_aligned(t: torch.Tensor) -> bool:
    """t (rows, k) has contiguous rows on 16-byte boundaries."""
    return (t.stride(-1) == 1 and t.stride(0) >= t.shape[-1] and t.stride(0) % 4 == 0
            and t.data_ptr() % 16 == 0)


def _as_rows(x: torch.Tensor) -> Optional[torch.Tensor]:
    """x as a (rows, K) view without a copy, or None."""
    if x.dim() == 2:
        return x
    try:
        return x.view(-1, x.shape[-1])
    except RuntimeError:
        return None


def kernel_takes(x: torch.Tensor, w: torch.Tensor, b=None, floor: bool = True) -> bool:
    """`kernel_rule` on a call's tensors: x (..., K) on the device of w (N, K)
    and of the bias (N) if any, an f32 bias."""
    if w.dim() != 2 or x.dim() < 1 or x.device != w.device or x.shape[-1] != w.shape[1]:
        return False
    if b is not None and (b.device != x.device or b.dtype != torch.float32
                          or tuple(b.shape) != (w.shape[0],) or b.stride(0) != 1):
        return False
    m = x.numel() // max(1, x.shape[-1])
    if not kernel_rule(x.device.type, x.dtype, w.dtype, wants_grad(x, w, b), m, w.shape[0],
                       w.shape[1], True, floor):
        return False  # the calls that keep the library leave here, before any view
    x2 = _as_rows(x)
    return x2 is not None and _rows_aligned(x2) and _rows_aligned(w)


def linear_gemm_reference(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """The plain version: the kernel's three TF32 products in f32, x and w
    each split as `ops.tf32.tf32_split` splits them (every TF32 product is
    exact in f32; the kernel cuts the small parts where this rounds them,
    below 2^-21 of each operand apart), the two small terms first, then the
    bias."""
    xb, xs = tf32_split(x)
    wb, ws = tf32_split(w)
    y = (F.linear(xs, wb) + F.linear(xb, ws)) + F.linear(xb, wb)
    return y if b is None else y + b


def linear_gemm(x: torch.Tensor, w: torch.Tensor, b=None, checked: bool = False) -> torch.Tensor:
    """y = x w^T + b for the f32 CUDA tensors x (..., K) and w (N, K), b (N)
    or None, in one launch, whatever its rows and tiles; a new contiguous f32
    tensor (..., N). `checked`: the caller has seen `kernel_takes` hold
    (`models.layers.linear`)."""
    if not checked:
        refuse_grad("linear_gemm", x, w, b)
        if not kernel_takes(x, w, b, floor=False):
            raise ValueError(
                f"linear_gemm takes f32 CUDA tensors x (..., K) of 1 to 2^31 - 1 rows "
                f"with contiguous rows on 16-byte boundaries, w (N, K) the same, K and N "
                f"multiples of 4, and an f32 bias (N) or none, on one device; got x "
                f"{x.device.type} {x.dtype} {tuple(x.shape)} strides {x.stride()}, w "
                f"{w.device.type} {w.dtype} {tuple(w.shape)} strides {w.stride()}, bias "
                f"{None if b is None else (b.dtype, tuple(b.shape))}")
    x2 = _as_rows(x)
    m, (n, k) = x2.shape[0], w.shape
    out = torch.empty(x.shape[:-1] + (n,), dtype=torch.float32, device=x.device)
    plan = gemm_plan(m, n)
    device = x.device.index
    rc = load_kernels().dgq_linear_gemm(
        x2.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(), m, n,
        k, x2.stride(0), w.stride(0), plan.tile_n, plan.grid,
        torch._C._cuda_getCurrentRawStream(device))
    if rc != 0:
        raise RuntimeError(f"linear_gemm kernel launch failed: CUDA error {rc}")
    LAUNCHES["linear_gemm"] += 1
    return out
