"""Faults planted in the timed path underneath a run, to show that the check
finds them: `plant(kind, fault)` is a context manager that breaks the port
while it is open. The CPU tests run every cell's faults at a tiny size;
`readings.py --fault` reads a training cell's numbers under one on the card.

  * "state unchanged": a step returns its state as it was (the PNDM update
    returns its sample; Adam's update leaves the offsets where they were);
  * "half the batch": half of the batch left out, the rest standing for it
    (the UNet computes the first half of its rows and repeats them; each
    Adam step's loss is the mean over the first half of its rows);
  * "answer altered": the answer changed where it is produced (every eps
    moved by a hundredth of its spread; the losses a reconstruction reports
    scaled by 1.01).

There is no exchange between chips to leave out: every cell runs on one.
"""
from __future__ import annotations

import contextlib

import torch

FAULTS = ("state unchanged", "half the batch", "answer altered")


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _generate(fault):
    from dgq_tpu_torch.models import unet_sd
    from dgq_tpu_torch.pipeline import schedulers

    if fault == "state unchanged":
        step = schedulers.pndm_plms_step

        def same(state, i, latents, *a):
            return step(state, i, latents, *a)[0], latents
        return _patched(schedulers, "pndm_plms_step", same)
    apply = unet_sd.unet_sd_apply
    if fault == "half the batch":
        def half(params, x, t, ehs, **kw):
            h = x.shape[0] // 2
            return apply(params, x[:h], t[:h], ehs[:h], **kw).repeat(2, 1, 1, 1)
        return _patched(unet_sd, "unet_sd_apply", half)

    def altered(*a, **kw):
        eps = apply(*a, **kw)
        return eps + 0.01 * eps.std() * torch.ones_like(eps)
    return _patched(unet_sd, "unet_sd_apply", altered)


class _Still(torch.optim.Adam):
    """Adam whose step leaves its parameters as they were."""

    def step(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]]
        keep = [p.detach().clone() for p in params]
        out = super().step(closure)
        with torch.no_grad():
            for p, k in zip(params, keep):
                p.copy_(k)
        return out


def _reconstruct(fault):
    from dgq_tpu_torch.calib import reconstruction

    if fault == "state unchanged":
        return _patched(torch.optim, "Adam", _Still)
    if fault == "half the batch":
        get = reconstruction._RowFeed.get

        def half(self, k):
            return tuple(x[: x.shape[0] // 2] for x in get(self, k))
        return _patched(reconstruction._RowFeed, "get", half)
    run = reconstruction.reconstruct_unit

    def altered(*a, **kw):
        alphas, losses = run(*a, **kw)
        return alphas, losses * 1.01
    return _patched(reconstruction, "reconstruct_unit", altered)


def plant(kind: str, fault: str):
    """The fault `fault` in the timed path of a `kind` driver, while open."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}: one of {FAULTS}")
    return {"generate": _generate, "reconstruct": _reconstruct}[kind](fault)
