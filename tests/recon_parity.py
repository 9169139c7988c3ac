"""Shared by the port's reconstruction tests (tests/test_torch_recon*.py,
tests/test_torch_dp_*.py): the tiny SD and SDXL nets of
tests/test_torch_calib_act.py in both packages from the same numpy weights,
JAX's index stream for the port's Adam loops, the comparison of learned
offsets, and `launch_ranks`, which starts the ranks of a CPU process group.

Offsets are compared in the port's layout (`reference_layout` views the
port's in the JAX package's). Adam normalises each step by the gradient's
own size, so an offset whose gradient is near zero in both packages can
take a step of lr in another direction when the two gradients differ in
their last bits (PyTorch's and XLA:CPU's sums run in other orders). Over K
steps such an offset parts from JAX's by at most 2 lr K: that is the
tolerance, `alpha_bound`. The hard rounding (alpha >= 0) must agree
wherever |alpha_jax| exceeds it."""
import os
import subprocess
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

from dgq_tpu.models import unet_sd as JU, unet_sdxl as JX
from dgq_tpu_torch.io.convert import params_from_numpy, reference_layout

BASE, CROSS = 32, 64


def tiny_sd(n=4, seed=0):
    """(spec, JAX params, port params, cali numpy (sample, t, ehs))."""
    spec = JU.sd_unet_spec(base=BASE, cross=CROSS)
    jp = JU.init_unet_sd(jax.random.PRNGKey(seed), spec=spec, fast=True)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), spec, device="cpu")
    rng = np.random.RandomState(seed)
    cali = (rng.randn(n, 16, 16, 4).astype(np.float32),
            rng.randint(0, 1000, (n,)).astype(np.int32),
            rng.randn(n, 77, CROSS).astype(np.float32))
    return spec, jp, tp, cali


def tiny_sdxl(n=2, seed=1):
    """The tiny SDXL-turbo net (add_ch 8, depths (1, 2)) and its cali data."""
    spec = JX.sdxl_unet_spec(BASE, CROSS, 8, (1, 2))
    jp = JU.init_unet_sd(jax.random.PRNGKey(seed), spec=spec, fast=True)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), spec, device="cpu")
    rng = np.random.RandomState(seed)
    cali = (rng.randn(n, 16, 16, 4).astype(np.float32),
            np.full((n,), 500, np.int32),
            rng.randn(n, 77, CROSS).astype(np.float32),
            rng.randn(n, 4 * BASE).astype(np.float32),
            np.tile(np.asarray([[128, 128, 0, 0, 128, 128]], np.float32), (n, 1)))
    return spec, jp, tp, cali


def jax_key(key: tuple):
    """The port's key tuple as the JAX package's folded key."""
    k = jax.random.PRNGKey(key[0])
    for part in key[1:]:
        k = jax.random.fold_in(k, part)
    return k


def jax_batch_indices(key, iters, batch_size, n):
    """The JAX package's index stream for a loop keyed `key`: step s draws
    randint(fold_in(key, s), (batch_size,), 0, n)."""
    k = jax_key(key)
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.randint(jax.random.fold_in(k, s), (batch_size,), 0, n))
        for s in range(iters)]).astype(np.int64).reshape(iters, batch_size))


def hand_jax_indices(monkeypatch):
    from dgq_tpu_torch.calib import reconstruction as TR

    monkeypatch.setattr(TR, "batch_indices", jax_batch_indices)


def record_units(monkeypatch):
    """Wraps the port's `reconstruct_unit` and `reconstruct_tib` as a walk
    calls them. Returns a list that gets one dict a reconstructed unit, in
    order: 'unit', 'alphas', 'losses', and for a unit its call's 'params',
    'wqp', 'inputs', 'outputs', 'cfg' and keywords 'kw'."""
    from dgq_tpu_torch.calib import reconstruction as TR

    calls = []
    unit_real, tib_real = TR.reconstruct_unit, TR.reconstruct_tib

    def unit(key, u, params, wqp, inputs, outputs, cfg, **kw):
        alphas, losses = unit_real(key, u, params, wqp, inputs, outputs, cfg, **kw)
        calls.append(dict(unit=u, alphas=alphas, losses=losses, params=params, wqp=wqp,
                          inputs=inputs, outputs=outputs, cfg=cfg, kw=kw))
        return alphas, losses

    def tib(key, params, spec, *args, **kw):
        alphas, losses = tib_real(key, params, spec, *args, **kw)
        calls.append(dict(unit=TR.tib_unit(spec), alphas=alphas, losses=losses))
        return alphas, losses

    monkeypatch.setattr(TR, "reconstruct_unit", unit)
    monkeypatch.setattr(TR, "reconstruct_tib", tib)
    return calls


def tnp(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def alpha_bound(lr, iters):
    return 2.0 * lr * iters


def compare_alphas(t_alphas: dict, j_alphas: dict, lr: float, iters: int):
    """Every offset within alpha_bound; the hard rounding equal wherever
    |alpha_jax| exceeds it. Returns (largest difference, share of offsets
    within 1e-4)."""
    assert set(t_alphas) == set(j_alphas)
    bound = alpha_bound(lr, iters)
    worst, close, total = 0.0, 0, 0
    for name in sorted(j_alphas):
        t = tnp(reference_layout("w", t_alphas[name].detach()))
        j = np.asarray(j_alphas[name])
        assert t.shape == j.shape, name
        d = np.abs(t - j)
        worst = max(worst, float(d.max()))
        close += int((d <= 1e-4).sum())
        total += d.size
        assert float(d.max()) <= bound, (name, float(d.max()), bound)
        firm = np.abs(j) > bound
        np.testing.assert_array_equal(t[firm] >= 0, j[firm] >= 0, err_msg=name)
    return worst, close / total


def to_t(batch):
    return tuple(torch.from_numpy(np.asarray(x)) for x in batch)


def to_j(batch):
    return tuple(jnp.asarray(x) for x in batch)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


TEARDOWN = """
import torch.distributed
if torch.distributed.is_initialized():
    torch.distributed.destroy_process_group()
"""


def launch_ranks(code: str, store, *args, world: int = 2, timeout: float = 240) -> list:
    """Run `python -c code rank world init_method *args` once for each rank
    of a CPU process group (gloo) whose rendezvous is the file `store` (it
    must not exist yet), one thread each; each rank destroys its group when
    `code` ends. Returns each rank's output, and fails naming the rank whose
    exit code is not 0."""
    env = {k: v for k, v in os.environ.items() if k not in (
        "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
        "SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID", "SLURM_TASKS_PER_NODE")}
    env.update(OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="", JAX_PLATFORMS="cpu")
    # a process that exits with its gloo group alive can abort in teardown
    code += TEARDOWN
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(world), f"file://{store}",
                               *map(str, args)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
    return outs
