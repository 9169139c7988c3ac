"""TF32 rounding as the f32 tensor-core kernels do it, in plain PyTorch.

`wgmma` multiplies TF32 numbers (8 exponent bits, 10 fraction bits in the
high 19 bits of an f32 word) and ignores the low 13 bits of the words it
reads, so the kernels round every f32 operand with `cvt.rna.tf32.f32`
(round to nearest, ties away from zero) and form a product of f32 numbers
from three TF32 products: x = big + small, big = rna(x), small = rna(x - big)
(`csrc/wgmma.cuh`, `split_tf32`). These are the plain versions: the fold's
weight panels are held against them bit for bit, and the tests emulate the
kernels' arithmetic with them.
"""
from __future__ import annotations

import torch


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to TF32, ties away from zero, as an f32 tensor whose low
    13 bits are zero: the magnitude's bit pattern plus half of the dropped
    unit, cut (a carry into the exponent is the next binade, or infinity past
    the largest finite number). NaN is returned as it is."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    mag = bits & 0x7FFFFFFF
    rounded = (((mag + 0x1000) & ~0x1FFF) | (bits & ~0x7FFFFFFF)) & 0xFFFFFFFF
    out = torch.where(mag > 0x7F800000, bits & 0xFFFFFFFF, rounded)
    return (out - (out >= 2 ** 31).to(torch.int64) * 2 ** 32).to(torch.int32).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(big, small): big = rna(x), small = rna(x - big), so x - big - small is
    below 2^-22 |x|."""
    big = tf32_rna(x.float())
    return big, tf32_rna(x.float() - big)
