"""Dry runs of each driver on the CPU at a tiny size: a run through the
harness comes out correct; the control (the reference in bfloat16 in the
program's place) does not; and with the timed path broken underneath, once
for each fault the cell can have, the run's `correct` comes out false."""
from __future__ import annotations

import pytest
import torch

from dgqbench import faults
from dgqbench.harness import bench
from dgqbench.tests.helpers import tiny_checkout

SEED = 2 ** 34 + 12345


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("checkout"))


def _run(root, work, trace=False):
    return bench.run_cell(root, work, SEED, 0.2, trace, 0.0, device="cpu")


@pytest.mark.parametrize("work", ["tiny_gen", "tiny_recon"])
def test_dry_run_is_correct(root, work):
    r = _run(root, work, trace=True)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    e2e = "images_per_s" if work == "tiny_gen" else "recon_steps_per_s"
    assert ("mfu.gen" if work == "tiny_gen" else "mfu.recon") in r["metrics"]
    r0 = _run(root, work)
    assert set(r0["metrics"]) == {e2e, "peak_gib", "setup_s"}


@pytest.mark.parametrize("work", ["tiny_gen", "tiny_recon"])
def test_control_is_not_correct(root, work):
    _, w, config, traffic, limits = bench.load_cell(root, work)
    from importlib import import_module

    driver = import_module(f"dgqbench.drivers.{traffic['kind']}")
    cell = driver.setup(bench.Context(config, traffic, SEED, "cpu"))
    driver.window(cell, 0.2)
    nums = driver.check(cell, control=True)
    failed = [k for k, v in nums.items() if v > limits[k]]
    assert failed, nums


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("work", ["tiny_gen", "tiny_recon"])
def test_a_broken_timed_path_is_not_correct(root, work, fault):
    with faults.plant("generate" if work == "tiny_gen" else "reconstruct", fault):
        r = _run(root, work)
    assert r["correct"] is False, (fault, r["checks"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("work", ["tiny_gen", "tiny_recon"])
def test_dry_run_on_the_card(root, work, card):
    """The tiny cells through the card's kernels, traced: the exact numbers
    are exact and the others finite (the tiny limits are the CPU's; the
    card's TF32 convs read above some of them)."""
    r = bench.run_cell(root, work, SEED, 1.0, True, 0.0, device="cuda")
    checks = {k: c["value"] for k, c in r["checks"].items()}
    assert all(v is not None for v in checks.values()), checks
    assert all(checks[k] == 0 for k in ("rerun_gap", "inputs_gap", "image_gap") if k in checks)
    assert r["device"]["busy_s"] > 0 and r["device"]["kind"] == torch.cuda.get_device_name(0)
