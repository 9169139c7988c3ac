"""What the scorers share: JAX's image resize, and the float32 precision
they run in.

`resize` is `jax.image.resize` (`scale_and_translate`) as the JAX package
calls it: one weight matrix per resized axis from JAX's kernels (the
triangle for bilinear, Keys' cubic with a = -0.5 for bicubic), the kernel
widened by the inverse scale when `antialias` downsamples, each column
normalized to sum 1, and columns whose sample falls outside the input set to
zero; then one product per axis. `F.interpolate` is another function (its
bicubic takes a = -0.75, its borders clamp), so it is not used.

`strict_f32` runs a scorer in true float32, as pytorch-fid does: convolutions
and products on the card would otherwise take TF32 (cuDNN's default for
convolutions), about 10 bits of mantissa.
"""
from __future__ import annotations

import contextlib
import functools

import torch


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1 - torch.abs(x), min=0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


_KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


def weight_matrix(in_size: int, out_size: int, method: str, antialias: bool,
                  device=None) -> torch.Tensor:
    """(in_size, out_size) f32 resampling weights of one axis, JAX's
    `compute_weight_mat` with scale out/in and no translation."""
    f32 = dict(dtype=torch.float32, device=device)
    inv_scale = 1.0 / torch.tensor(out_size / in_size, **f32)
    kernel_scale = torch.clamp(inv_scale, min=1.0) if antialias else torch.tensor(1.0, **f32)
    sample_f = (torch.arange(out_size, **f32) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(in_size, **f32)[:, None]) / kernel_scale
    w = _KERNELS[method](x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize(x: torch.Tensor, height: int, width: int, method: str,
           antialias: bool = True) -> torch.Tensor:
    """NHWC f32 images resized to (height, width); an axis already of that
    size is left as it is, as in JAX."""
    n, h, w, c = x.shape
    if h != height:
        x = torch.einsum("nhwc,hH->nHwc", x,
                         weight_matrix(h, height, method, antialias, x.device))
    if w != width:
        x = torch.einsum("nhwc,wW->nhWc", x,
                         weight_matrix(w, width, method, antialias, x.device))
    return x


@contextlib.contextmanager
def f32_precision():
    """True float32 convolutions and products inside, the flags restored
    after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def strict_f32(fn):
    """Run `fn` under `f32_precision` and without autograd."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with f32_precision(), torch.no_grad():
            return fn(*args, **kwargs)
    return run
