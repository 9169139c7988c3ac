"""`cli.quantize_weight`'s default path, reconstruction, on the CPU at base 32
(16x16 latents, 2 prompts, 2 PNDM steps: 12 calibration samples):

  * `--wq 4 --iters 10 --max_units 6` writes a weight-only file that carries
    the learned offsets: the port's `load_weight_only` reads them back bit
    for bit, and so does the JAX package's (in its layout); the walk
    reconstructs each unit once (`recon_parity.record_units`), with finite
    losses;
  * `--partial_dir`: a second run on the same directory resumes every unit
    (nothing reconstructed) and writes the same offsets bit for bit; the
    saves pass the port's `ckpt_tools check` against the file;
  * `--tib_recon --recon_loss fisher_diag --max_units 7`: the temporal block
    and the Fisher-weighted walk (the 7th unit is the first transformer);
  * `--use_aq` after reconstruction: the merged file carries the offsets;
  * `--dp 2` and `--tp 2` outside a process group of 2 ranks, and
    reconstruction with `--pallas_attn`, raise before any work
    (tests/test_torch_calib_cli.py holds the messages);
  * SDXL-turbo (`--model sdxl`, depths (1, 2), 4 calibration samples), the
    port's CLI against the JAX package's on the same weights (a torch state
    dict both read through --unet_weights) and the same calibration data
    (the JAX CLI writes the `.npz` cache, whose name both packages derive
    alike, and the port's CLI reads it), the port handed the JAX index
    stream: the same units, every step's loss within 5e-5 relative (and
    within 5e-5 of the unit's largest loss: the losses before the
    regularizer starts are float error alone) and more than 0.9 of the
    offsets within 1e-4 (the loops' limits), the hard
    rounding as `recon_parity.compare_alphas` holds it; `--use_aq` after the
    walk carries the offsets into the merged file.

For SD the offsets are held to the JAX package's in
tests/test_torch_recon_walk.py (the CLIs draw their stand-in data from
their own generators, so the two packages' CLIs see other data).
"""
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from recon_parity import compare_alphas, hand_jax_indices, record_units  # noqa: E402

from dgq_tpu.calib import reconstruction as JR  # noqa: E402
from dgq_tpu.cli import quantize_weight as JQW  # noqa: E402
from dgq_tpu.io import dgq_ckpt as JK  # noqa: E402
from dgq_tpu_torch.calib.reconstruction import recon_units, tib_unit  # noqa: E402
from dgq_tpu_torch.cli import ckpt_tools as TCT, quantize_weight as TQW  # noqa: E402
from dgq_tpu_torch.io import dgq_ckpt as TK  # noqa: E402
from dgq_tpu_torch.io.convert import params_to_torch_unet, reference_layout  # noqa: E402
from dgq_tpu_torch.models.unet_sd import init_unet_sd, sd_unet_spec  # noqa: E402
from dgq_tpu_torch.models.unet_sdxl import sdxl_unet_spec  # noqa: E402

BASE = 32
SDXL_DEPTHS = (1, 2)
SDXL_UNITS = 12  # the 12th unit of the tiny SDXL-turbo is its first transformer block
ITERS, LR = 10, 1e-3  # --iters; reconstruct_unit's Adam rate


def _argv(d, *extra, model="sd", device=True):
    """A CLI's arguments at the tiny size; device=False leaves out --device,
    which the JAX package's CLI does not take."""
    tiny = ["--sdxl_depths", ",".join(map(str, SDXL_DEPTHS))] if model == "sdxl" else []
    return ((["--device", "cpu"] if device else []) + ["--model", model] + tiny
            + ["--base", str(BASE), "--wq", "4", "--cali_prompt_data_n", "2", "--step_size", "2",
               "--latent_hw", "16", "--cali_data_path", str(d / "cali"), "--outdir",
               str(d / "results")] + list(extra))


def _sdxl_weights(d):
    """The tiny SDXL-turbo's random weights as a torch state dict under the
    reference's names, in `d`/unet (what --unet_weights reads)."""
    spec = sdxl_unet_spec(base=BASE, depths=SDXL_DEPTHS)
    params = init_unet_sd(torch.Generator().manual_seed(1), "cpu", spec=spec)
    os.makedirs(d / "unet")
    torch.save(params_to_torch_unet(params, spec), d / "unet" / "diffusion_pytorch_model.bin")
    return spec, str(d / "unet")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("recon")
    parts = str(d / "parts")
    runs = []
    for _ in range(2):
        mp = pytest.MonkeyPatch()
        calls = record_units(mp)
        try:
            res = TQW.main(_argv(d, "--iters", "10", "--max_units", "6", "--partial_dir", parts))
        finally:
            mp.undo()
        runs.append(dict(res, recon=calls))
    return d, parts, runs[0], runs[1]


def test_reconstruction_is_the_default_and_writes_the_offsets(runs):
    _, _, w, _ = runs
    spec = sd_unet_spec(base=BASE)
    covered = {l for u in recon_units(spec)[:6] for l in u.layers}
    assert set(w["alphas"]) == covered
    assert [c["unit"] for c in w["recon"]] == recon_units(spec)[:6]
    assert all(bool(torch.isfinite(c["losses"]).all()) for c in w["recon"])
    assert set(w["seconds"]) == {"build", "shard", "weight_init", "cali_data", "recon"}
    _, _, alphas = TK.load_weight_only(w["weight_only"], spec, device="cpu")
    assert set(alphas) == covered
    for n in covered:
        assert torch.equal(alphas[n], w["alphas"][n])
    _, _, jalphas = JK.load_weight_only(w["weight_only"], spec)
    for n in covered:
        np.testing.assert_array_equal(np.asarray(jalphas[n]),
                                      reference_layout("w", w["alphas"][n]).numpy())


def test_partial_dir_resumes_every_unit_bit_for_bit(runs):
    _, parts, first, second = runs
    assert second["recon"] == []  # every unit resumed
    assert set(second["alphas"]) == set(first["alphas"])
    for n in first["alphas"]:
        assert torch.equal(second["alphas"][n], first["alphas"][n])
    assert TCT.main(["check", first["weight_only"], parts]) == 0


def test_tib_and_fisher_walk(tmp_path, monkeypatch):
    calls = record_units(monkeypatch)
    w = TQW.main(_argv(tmp_path, "--iters", "4", "--max_units", "7", "--tib_recon",
                       "--recon_loss", "fisher_diag"))
    spec = sd_unet_spec(base=BASE)
    tib = set(tib_unit(spec).layers)
    assert tib <= set(w["alphas"])
    kinds = [c["unit"].kind for c in calls]
    assert kinds[0] == "tib" and "transformer" in kinds and "resnet" in kinds
    walked = calls[1:]
    for c in walked:  # the Fisher gradients ran
        assert c["kw"]["opt_mode"] == "fisher_diag" and c["kw"]["cached_grads"] is not None
        assert c["kw"]["cached_grads"].shape == c["outputs"].shape
    units = {u.name: u for u in recon_units(spec)}
    for c in walked:  # the walk left the temporal block's layers to it
        assert set(c["unit"].layers) == set(units[c["unit"].name].layers) - tib
        assert set(c["unit"].layers) <= set(w["alphas"])
    assert len(w["alphas"]) == len(tib | {l for u in recon_units(spec)[:7] for l in u.layers})


def _use_aq_carries_the_offsets(d, model, spec, units, slots):
    """--use_aq after a walk of `units` units: the merged file holds the
    walk's offsets bit for bit and `slots` activation states."""
    w = TQW.main(_argv(d, "--iters", "2", "--max_units", str(units), "--use_aq", "--fast",
                       model=model))
    _, _, alphas, per_t, _ = TK.load_merged(w["merged"], spec, device="cpu")
    assert set(alphas) == set(w["alphas"]) and len(per_t) == slots
    assert set(alphas) == {l for u in recon_units(spec)[:units] for l in u.layers}
    for n in alphas:
        assert torch.equal(alphas[n], w["alphas"][n])


def test_use_aq_after_reconstruction_carries_the_offsets(tmp_path):
    _use_aq_carries_the_offsets(tmp_path, "sd", sd_unet_spec(base=BASE), 3, 3)


@pytest.fixture(scope="module")
def sdxl_clis(tmp_path_factory):
    """Both packages' `quantize_weight --model sdxl --iters ITERS --max_units
    SDXL_UNITS` on the same weights and data: the JAX CLI first (it writes
    the calibration cache, and its per-step losses are recorded), then the
    port's, handed JAX's index stream. --seed 0: the JAX CLI's walk always
    keys its loops from 0."""
    d = tmp_path_factory.mktemp("sdxl_cli")
    spec, unet = _sdxl_weights(d)
    extra = ("--iters", str(ITERS), "--max_units", str(SDXL_UNITS), "--seed", "0",
             "--unet_weights", unet)
    j_units = []
    unit_real = JR.reconstruct_unit

    def unit(key, u, *args, **k):
        alphas, losses = unit_real(key, u, *args, **k)
        j_units.append((u.name, np.asarray(losses)))
        return alphas, losses
    mp = pytest.MonkeyPatch()
    mp.setattr(JR, "reconstruct_unit", unit)
    mp.setattr(sys, "argv", ["quantize_weight"]
               + _argv(d, *extra, "--outdir", str(d / "jax"), model="sdxl", device=False))
    try:
        JQW.main()
    finally:
        mp.undo()
    (j_file,) = [os.path.join(r, f) for r, _, fs in os.walk(d / "jax") for f in fs
                 if f == "cali_ckpt.pth_weight_only"]
    mp = pytest.MonkeyPatch()
    hand_jax_indices(mp)
    calls = record_units(mp)
    try:
        t = TQW.main(_argv(d, *extra, "--outdir", str(d / "port"), model="sdxl"))
    finally:
        mp.undo()
    return spec, JK.load_weight_only(j_file, spec)[2], j_units, t, calls


def test_sdxl_walk_through_the_cli_follows_the_jax_cli(sdxl_clis):
    spec, j_alphas, j_units, t, calls = sdxl_clis
    units = recon_units(spec)[:SDXL_UNITS]
    assert [c["unit"] for c in calls] == units
    assert [n for n, _ in j_units] == [u.name for u in units]
    assert any(u.kind == "transformer" for u in units) and any(u.kind == "resnet" for u in units)
    for c, (name, j_losses) in zip(calls, j_units):
        # a loss of the first steps, before the regularizer starts, is the
        # soft-rounded weights' float error alone (1e-3 of a loss of 1e3 at
        # add_embedding.linear_1), where the two packages' summation orders
        # differ relatively most: it is held within 5e-5 of the unit's
        # largest loss
        np.testing.assert_allclose(c["losses"].numpy(), j_losses, rtol=5e-5,
                                   atol=5e-5 * float(np.abs(j_losses).max()), err_msg=name)
    assert set(t["alphas"]) == {l for u in units for l in u.layers}
    worst, share = compare_alphas(t["alphas"], j_alphas, LR, ITERS)
    assert share > 0.9, (worst, share)


def test_sdxl_use_aq_after_reconstruction_carries_the_offsets(tmp_path):
    """2 Euler steps: 2 time slots (no PNDM call more, no CFG pair)."""
    _use_aq_carries_the_offsets(tmp_path, "sdxl", sdxl_unet_spec(base=BASE, depths=SDXL_DEPTHS),
                                5, 2)


@pytest.mark.parametrize("extra,exc", [(["--dp", "2"], RuntimeError),  # no process group
                                       (["--tp", "2"], RuntimeError),  # no process group
                                       (["--pallas_attn"], NotImplementedError)])
def test_refused_before_any_work(extra, exc, tmp_path, monkeypatch):
    for name in ("MASTER_ADDR", "RANK", "WORLD_SIZE", "SLURM_PROCID", "SLURM_NTASKS"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(exc):
        TQW.main(_argv(tmp_path, *extra))
    assert not os.path.exists(tmp_path / "results")
