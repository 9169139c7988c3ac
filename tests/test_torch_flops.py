"""The port's cost model (`utils/flops.py`) and cost CLI (`cli/flops.py`)
against the JAX package's, for SD v1.4, SDXL and the tiny `base 32` SD
spec: `spec_cost` and `bops` equal exactly, `spec_roofline`'s times within
1e-12 relative (its integers exactly) at equal peaks, and every printed line
of `cli.flops` equal with and without --roofline at equal --peak_tfs /
--hbm_gbs. The port's roofline defaults are one H100 SXM's published peaks.
"""
import sys

import pytest

jax = pytest.importorskip("jax")

from dgq_tpu.cli import flops as JF_CLI  # noqa: E402
from dgq_tpu.models.unet_sd import sd_unet_spec as j_sd_spec  # noqa: E402
from dgq_tpu.models.unet_sdxl import sdxl_unet_spec as j_sdxl_spec  # noqa: E402
from dgq_tpu.utils import flops as JF  # noqa: E402
from dgq_tpu_torch.cli import flops as TF_CLI  # noqa: E402
from dgq_tpu_torch.models.unet_sd import sd_unet_spec as t_sd_spec  # noqa: E402
from dgq_tpu_torch.models.unet_sdxl import sdxl_unet_spec as t_sdxl_spec  # noqa: E402
from dgq_tpu_torch.utils import flops as TF  # noqa: E402

SPECS = {  # name -> (JAX spec, port spec, latent size, SDXL's 64-wide heads)
    "sd": (j_sd_spec(), t_sd_spec(), 64, None),
    "sdxl": (j_sdxl_spec(), t_sdxl_spec(), 128, 64),
    "sd base 32": (j_sd_spec(base=32), t_sd_spec(base=32), 16, None),
}


def _close(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _close(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, int):
        assert a == b, path
    else:
        assert a == pytest.approx(b, rel=1e-12, abs=0), path


@pytest.mark.parametrize("name", list(SPECS))
@pytest.mark.parametrize("latent_hw", [None, 32])
def test_spec_cost_and_bops_equal_jax(name, latent_hw):
    j_spec, t_spec, hw, _ = SPECS[name]
    hw = latent_hw or hw
    got, want = TF.spec_cost(t_spec, latent_hw=hw), JF.spec_cost(j_spec, latent_hw=hw)
    assert got == want
    for w, a in ((32, 32), (4, 8), (8, 8)):
        assert TF.bops(got["macs"], w, a) == JF.bops(want["macs"], w, a)


@pytest.mark.parametrize("name", list(SPECS))
@pytest.mark.parametrize("batch,peaks", [(8, (197.0, 819.0)), (4, (989.0, 3350.0)),
                                         (2, (500.0, 2000.0))])
def test_spec_roofline_equals_jax_at_equal_peaks(name, batch, peaks):
    j_spec, t_spec, hw, head_dim = SPECS[name]
    kw = dict(latent_hw=hw, batch=batch, peak_tfs=peaks[0], hbm_gbs=peaks[1],
              attn_head_dim=head_dim)
    _close(TF.spec_roofline(t_spec, **kw), JF.spec_roofline(j_spec, **kw))


def test_spec_roofline_defaults_are_the_h100s():
    spec = t_sd_spec()
    assert (TF.H100_BF16_TFS, TF.H100_HBM_GBS) == (989.0, 3350.0)
    _close(TF.spec_roofline(spec, batch=4),
           JF.spec_roofline(j_sd_spec(), batch=4, peak_tfs=989.0, hbm_gbs=3350.0))


def _jax_lines(argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["flops"] + argv)
    JF_CLI.main()
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("argv", [
    ["--model", "sd", "--wq", "4", "--aq", "8"],
    ["--model", "sdxl"],
    ["--model", "sd", "--roofline", "--peak_tfs", "989", "--hbm_gbs", "3350"],
    ["--model", "sdxl", "--wq", "4", "--aq", "8", "--roofline", "--batch", "2", "--steps", "4",
     "--cfg", "1", "--peak_tfs", "197", "--hbm_gbs", "819"],
])
def test_cli_flops_prints_the_jax_lines(argv, capsys, monkeypatch):
    want = _jax_lines(argv, capsys, monkeypatch)
    TF_CLI.main(argv)
    got = capsys.readouterr().out.splitlines()
    assert got == want
    if argv[1] == "sd":
        assert got[0] == "#Params: 859.5210 M"


def test_cli_flops_roofline_defaults_name_the_h100(capsys):
    TF_CLI.main(["--model", "sd", "--roofline"])
    out = capsys.readouterr().out
    assert "(989 TF/s, 3350 GB/s)" in out
    assert TF_CLI.parse_args([]).peak_tfs == 989.0
