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
    (tests/test_torch_calib_cli.py holds the messages).

The offsets themselves are held to the JAX package's in
tests/test_torch_recon_walk.py (the CLIs draw their stand-in data from
their own generators, so the two packages' CLIs see other data).
"""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from recon_parity import record_units  # noqa: E402

from dgq_tpu.io import dgq_ckpt as JK  # noqa: E402
from dgq_tpu_torch.calib.reconstruction import recon_units, tib_unit  # noqa: E402
from dgq_tpu_torch.cli import ckpt_tools as TCT, quantize_weight as TQW  # noqa: E402
from dgq_tpu_torch.io import dgq_ckpt as TK  # noqa: E402
from dgq_tpu_torch.io.convert import reference_layout  # noqa: E402
from dgq_tpu_torch.models.unet_sd import sd_unet_spec  # noqa: E402

BASE = 32


def _argv(d, *extra):
    return ["--device", "cpu", "--model", "sd", "--base", str(BASE), "--wq", "4",
            "--cali_prompt_data_n", "2", "--step_size", "2", "--latent_hw", "16",
            "--cali_data_path", str(d / "cali"), "--outdir", str(d / "results")] + list(extra)


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


def test_use_aq_after_reconstruction_carries_the_offsets(tmp_path):
    w = TQW.main(_argv(tmp_path, "--iters", "2", "--max_units", "3", "--use_aq", "--fast"))
    spec = sd_unet_spec(base=BASE)
    _, _, alphas, per_t, _ = TK.load_merged(w["merged"], spec, device="cpu")
    assert set(alphas) == set(w["alphas"]) and len(per_t) == 3
    for n in alphas:
        assert torch.equal(alphas[n], w["alphas"][n])


@pytest.mark.parametrize("extra,exc", [(["--dp", "2"], RuntimeError),  # no process group
                                       (["--tp", "2"], RuntimeError),  # no process group
                                       (["--pallas_attn"], NotImplementedError)])
def test_refused_before_any_work(extra, exc, tmp_path, monkeypatch):
    for name in ("MASTER_ADDR", "RANK", "WORLD_SIZE", "SLURM_PROCID", "SLURM_NTASKS"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(exc):
        TQW.main(_argv(tmp_path, *extra))
    assert not os.path.exists(tmp_path / "results")
