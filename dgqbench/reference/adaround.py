"""AdaRound (Nagel et al., 2020) as BRECQ's and DGQ's reconstruction runs it,
plain: the rectified sigmoid, the soft-rounded W4 weights, the rounding
regulariser and its annealed temperature, the mse loss of a unit, Adam.

A reconstruction of one unit optimises one offset per weight. Each step
draws `batch` rows of the unit's captures, computes
mean_rows(sum_axis |unit(rows; soft weights) - target|^2), adds from step
warmup * iters on w * sum_layers sum(1 - |2h - 1|^beta), and takes one Adam
step (torch's defaults: betas 0.9 / 0.999, eps 1e-8, no weight decay).
"""
from __future__ import annotations

import numpy as np
import torch

GAMMA, ZETA = -0.1, 1.1
BETAS, EPS = (0.9, 0.999), 1e-8


def init_alpha(w, delta):
    rest = w / delta - torch.floor(w / delta)
    return -torch.log((ZETA - GAMMA) / (rest - GAMMA) - 1.0)


def soft_target(alpha):
    return torch.clamp(torch.sigmoid(alpha) * (ZETA - GAMMA) + GAMMA, 0.0, 1.0)


def soft_weight(w, delta, zp, alpha, bits: int):
    q = torch.clamp(torch.floor(w / delta) + soft_target(alpha) + zp, 0, 2 ** bits - 1)
    return delta * (q - zp)


def temperature(step: int, iters: int, warmup: float, start: float = 20.0, end: float = 2.0):
    """start until warmup * iters, then linear to end at iters (float32)."""
    t = np.float32(step)
    t0 = np.float32(warmup * iters)
    if t < t0:
        return float(np.float32(start))
    rel = (t - t0) / (np.float32(iters) - t0)
    return float(np.float32(end) + np.float32(start - end) * max(np.float32(1.0) - rel, 0))


def regulariser(alphas: dict, beta: float):
    return sum(torch.sum(1.0 - torch.abs(2.0 * soft_target(alphas[n]) - 1.0) ** beta)
               for n in sorted(alphas))


def regularised(step: int, iters: int, warmup: float) -> bool:
    return bool(np.float32(step) >= np.float32(warmup * iters))


def batch_rows(key: tuple, iters: int, batch: int, n: int) -> torch.Tensor:
    """The rows every step draws: (iters, batch) int64, uniform over [0, n),
    from a host generator seeded by the key (the draw DGQ's reconstruction
    makes)."""
    seed = 0
    for part in key:
        seed = (seed * 1_000_003 + int(part) + 1) % 2 ** 62
    return torch.randint(0, n, (iters, batch), generator=torch.Generator().manual_seed(seed))


class Adam:
    """Adam on a dict of tensors, with its moments and step count."""

    def __init__(self, params: dict, lr: float, m=None, v=None, t: int = 0):
        self.p = {n: a.detach().clone() for n, a in params.items()}
        self.lr = lr
        self.m = {n: torch.zeros_like(a) for n, a in self.p.items()} if m is None else dict(m)
        self.v = {n: torch.zeros_like(a) for n, a in self.p.items()} if v is None else dict(v)
        self.t = t

    def step(self, grads: dict):
        self.t += 1
        b1, b2 = BETAS
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for n, g in grads.items():
            self.m[n] = b1 * self.m[n] + (1 - b1) * g
            self.v[n] = b2 * self.v[n] + (1 - b2) * g * g
            self.p[n] = self.p[n] - self.lr * (self.m[n] / c1) / (torch.sqrt(self.v[n] / c2) + EPS)


def steps(apply, weights: dict, qparams: dict, adam: Adam, first: int, count: int,
          rows: torch.Tensor, data: tuple, sum_axis: int, iters: int, w: float,
          warmup: float, bits: int, dt) -> tuple:
    """`count` steps from `first` of one reconstruction: apply(weights, *inputs)
    is the unit's forward; data the captured (inputs..., target); rows the
    draw of `batch_rows`. Returns (the losses, the gradients of the first
    step), the losses as the program reports them: reconstruction plus
    regulariser."""
    losses, first_grads = [], None
    for s in range(first, first + count):
        idx = rows[s].to(data[0].device)
        batch = [x[idx].to(dt) for x in data]
        alphas = {n: a.detach().to(dt).requires_grad_(True) for n, a in adam.p.items()}
        soft = {n: soft_weight(weights[n].to(dt), qparams[n][0].to(dt), qparams[n][1].to(dt),
                               alphas[n], bits) for n in alphas}
        pred = apply(soft, *batch[:-1])
        loss = torch.mean(torch.sum((pred - batch[-1]) ** 2, dim=sum_axis))
        if regularised(s, iters, warmup):
            loss = loss + w * regulariser(alphas, temperature(s, iters, warmup))
        grads = torch.autograd.grad(loss, list(alphas.values()))
        grads = {n: g.to(adam.p[n].dtype) for n, g in zip(alphas, grads)}
        if first_grads is None:
            first_grads = grads
        with torch.no_grad():
            adam.step(grads)
        losses.append(float(loss.detach()))
    return losses, first_grads
