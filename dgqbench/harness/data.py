"""Inputs made from the seed, on the device, in a few large calls: random
weights of a layer list, DGQ activation quantizers of a real calibration's
shapes, and the sub-seeds and generators of a run's streams.

Weights are N(0, 1/fan_in) (a conv's fan-in C k k, a linear's C), biases
zero, norms scale one and shift zero: one `randn` over every weight of the
model, then views of it. The same seed gives the same values.
"""
from __future__ import annotations

import hashlib
import math

import torch

from dgqbench.reference import specs


def sub_seed(seed: int, *parts) -> int:
    """A 63-bit seed for one stream of the run (`parts` name it)."""
    h = hashlib.sha256(repr((int(seed),) + parts).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, *parts, device="cuda") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *parts))


def _weight_shape(kind, meta):
    if kind == "conv":
        cin, cout, k, _, _ = meta
        return (cout, cin, k, k), cin * k * k
    cin, cout, _ = meta
    return (cout, cin), cin


@torch.no_grad()
def weights(spec, seed: int, stream: str, device="cuda", dtype=torch.float32) -> dict:
    """{name: {"w", "b"}} for convs and linears, {name: {"scale", "bias"}}
    for norms; every weight a view of one draw."""
    shapes = [(n, *_weight_shape(k, m)) for n, k, m in spec if k in ("conv", "linear")]
    total = sum(math.prod(s) for _, s, _ in shapes)
    flat = torch.randn(total, generator=generator(seed, stream, device=device), device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for name, shape, fan_in in shapes:
        n = math.prod(shape)
        w = flat[at:at + n].view(shape)
        w.mul_(1.0 / math.sqrt(fan_in))
        out[name] = {"w": w if dtype == torch.float32 else w.to(dtype)}
        at += n
    for name, kind, meta in spec:
        if kind == "conv":
            out[name]["b"] = torch.zeros(meta[1], dtype=dtype, device=device)
        elif kind == "linear":
            out[name]["b"] = torch.zeros(meta[1], dtype=dtype, device=device) if meta[2] else None
        else:
            out[name] = {"scale": torch.ones(meta[0], dtype=dtype, device=device),
                         "bias": torch.zeros(meta[0], dtype=dtype, device=device)}
    return out


@torch.no_grad()
def act_quantizers(spec, slots: int, seed: int, device="cuda") -> dict:
    """DGQ's activation quantizers for `slots` time slots: {name: (delta,
    zp)}, delta and zp (slots,) for a per-tensor point and (slots, C k k)
    for a group conv (one per row of the c-major unfolded input). Deltas are
    0.05 e^u, u uniform in [-0.3, 0.3], drawn per slot and row; zero points
    128. A calibration would give other values: they set the codes, not the
    work."""
    meta = {n: m for n, k, m in spec if k == "conv"}
    groups = set(specs.group_conv_layers(spec))
    sizes = {n: (meta[n][0] * meta[n][2] ** 2 if n in groups else 1)
             for n in specs.act_points(spec)}
    u = torch.rand(slots * sum(sizes.values()), generator=generator(seed, "act", device=device),
                   device=device)
    out, at = {}, 0
    for name, n in sizes.items():
        d = 0.05 * torch.exp(0.6 * (u[at:at + slots * n] - 0.5)).view(slots, n)
        if name not in groups:
            d = d[:, 0]
        out[name] = (d, torch.full_like(d, 128.0))
        at += slots * n
    return out


def slot(quantizers: dict, s: int) -> dict:
    return {n: (d[s], z[s]) for n, (d, z) in quantizers.items()}
