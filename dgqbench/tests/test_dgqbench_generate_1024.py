"""The `generate_1024` driver (SDXL-turbo and SD3 generation at 1024 px),
its cost functions and its metric readers, on the CPU at a tiny size: a
run through the harness comes out correct with its new per-layer metrics;
the control (the reference in bfloat16 in the program's place) does not;
the timed path broken underneath (the sampler's state left unchanged, half
the batch, the answer altered) is not correct; the SD3 operations by hand;
the readers on hand-made sessions."""
from __future__ import annotations

import importlib.util
import json
import os
from importlib import import_module
from types import SimpleNamespace

import pytest
import torch

from dgqbench import costs
from dgqbench.costs import sd3 as sd3_costs
from dgqbench.harness import bench
from dgqbench.harness.trace import Session
from dgqbench.reference import sd3 as ref3
from dgqbench.tests.helpers import tiny_checkout

SEED = 2 ** 34 + 12345
TINY = {"tiny_gen_sd3": ("tiny-sd3", "tiny_generate_sd3", "sd3m_gen_b2"),
        "tiny_gen_xl": ("tiny-sdxl", "tiny_generate_xl", "sdxlt_gen_b4")}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny_checkout(tmp_path_factory.mktemp("checkout"))
    path = os.path.join(root, "BENCHMARK.json")
    b = json.load(open(path))
    for work, (conf, traffic, real) in TINY.items():
        if not any(c["name"] == conf for c in b["configs"]):
            b["configs"].append({"name": conf, "source": "https://example.org/tiny",
                                 "file": f"dgqbench/configs/{conf}.json", "reduced": [],
                                 "why": "tiny"})
        b["workloads"].append({"name": work, "config": conf, "traffic": traffic, "chips": 1,
                               "why": "tiny"})
        for m in b["end_to_end"] + b["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(work)
    json.dump(b, open(path, "w"))
    return root


def _driver(root, work):
    _, _, config, traffic, limits = bench.load_cell(root, work)
    return import_module(f"dgqbench.drivers.{traffic['kind']}"), config, traffic, limits


@pytest.mark.parametrize("work", sorted(TINY))
def test_dry_run_is_correct(root, work):
    r = bench.run_cell(root, work, SEED, 0.2, True, 0.0, device="cpu")
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert ("mfu.sd3gen" if work == "tiny_gen_sd3" else "mfu.xlgen") in r["metrics"]
    r0 = bench.run_cell(root, work, SEED, 0.2, False, 0.0, device="cpu")
    assert set(r0["metrics"]) == {"images_per_s", "peak_gib", "setup_s"}


@pytest.mark.parametrize("work", sorted(TINY))
def test_control_is_not_correct(root, work):
    driver, config, traffic, limits = _driver(root, work)
    cell = driver.setup(bench.Context(config, traffic, SEED, "cpu"))
    driver.window(cell, 0.2)
    nums = driver.check(cell, control=True)
    failed = [k for k, v in nums.items() if v > limits[k]]
    assert len(failed) >= 2, nums


def _faulty(work, fault, monkeypatch):
    from dgq_tpu_torch.models import mmdit_sd3, unet_sdxl
    from dgq_tpu_torch.pipeline import schedulers

    if fault == "state unchanged":
        name = "flow_euler_step" if work == "tiny_gen_sd3" else "euler_step"
        monkeypatch.setattr(schedulers, name, lambda x, *a: x)
        return
    mod, name = ((mmdit_sd3, "mmdit_sd3_apply") if work == "tiny_gen_sd3"
                 else (unet_sdxl, "unet_sdxl_apply"))
    apply = getattr(mod, name)
    if fault == "half the batch":
        def half(params, x, t, *args, **kw):
            h = x.shape[0] // 2
            return apply(params, x[:h], t[:h], *(a[:h] for a in args),
                         **{k: (v[:h] if k in ("text_embeds", "time_ids") else v)
                            for k, v in kw.items()}).repeat(2, 1, 1, 1)
        monkeypatch.setattr(mod, name, half)
    else:
        def altered(*a, **kw):
            out = apply(*a, **kw)
            return out + 0.01 * out.std() * torch.ones_like(out)
        monkeypatch.setattr(mod, name, altered)


@pytest.mark.parametrize("fault", ["state unchanged", "half the batch", "answer altered"])
@pytest.mark.parametrize("work", sorted(TINY))
def test_a_broken_timed_path_is_not_correct(root, work, fault, monkeypatch):
    _faulty(work, fault, monkeypatch)
    r = bench.run_cell(root, work, SEED, 0.2, False, 0.0, device="cpu")
    assert r["correct"] is False, (fault, r["checks"])


def test_sd3_forward_operations_by_hand():
    d, ff, heads = 8, 32, 2
    spec = ref3.mmdit_spec(layers=2, heads=heads, head_dim=4, in_channels=3, patch=2,
                           joint_dim=5, pooled_dim=6, freq_dim=7)
    tokens, text, b = 9, 4, 2
    n = tokens + text

    def block(last):
        macs = d * 6 * d + d * (2 if last else 6) * d      # adaLN of both streams
        macs += 3 * d * d * tokens + 3 * d * d * text      # q, k, v of both streams
        macs += 2 * n * n * d + d * d * tokens             # the joint core, to_out.0
        macs += 2 * d * ff * tokens                        # the image MLP
        if not last:
            macs += d * d * text + 2 * d * ff * text       # to_add_out, the text MLP
        return macs

    macs = (3 * d * 4 * tokens                             # the 2 x 2 patch embedding
            + 7 * d + d * d + 6 * d + d * d                # timestep and pooled MLPs
            + 5 * d * text                                 # the context embedder
            + block(False) + block(True)
            + d * 2 * d + d * 4 * 3 * tokens)              # norm_out, proj_out
    assert sd3_costs.mmdit_forward_flops(spec, tokens, text, b) == 2 * b * macs


def test_sd3_medium_at_1024_px_counts_35_6_tflop_a_call():
    spec = ref3.mmdit_spec()
    call = sd3_costs.mmdit_forward_flops(spec, 4096, 333, 4)
    assert 35.5e12 < call < 35.7e12
    assert 20.9e12 < costs.vae_decode_flops(ref3.vae_spec(), 128, 2) < 21.0e12


def _session(label, units, ops):
    s = Session(label, units, device="cpu")
    s.device_ops = sorted(ops, key=lambda r: r[1])
    return s


def test_readers_on_hand_made_sessions():
    root = os.path.join(os.path.dirname(__file__), "..", "metrics")

    def read(name, rc):
        spec = importlib.util.spec_from_file_location("m", os.path.join(root, name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read(rc)

    k3b = [(96, 4429, 4429, 64)] * 24
    bound = sum(costs.bound_s(*costs.attention(*a)) for a in k3b)
    mmdit = _session("mmdit", 2, [("quant_tf32_kernel<1>", 0, int(2e9 * bound)),
                                  ("gemm", int(2e9 * bound), int(3e9 * bound))])
    k2 = (2, 16384, 16384, 512)
    vae = _session("vae", 1, [("flash_tf32_kernel<3>", 0, int(4e9 * costs.bound_s(
        *costs.attention(*k2))))])
    rc = SimpleNamespace(sessions=[mmdit, vae], costs=costs,
                         window={"batches": 2, "seconds": 10.0},
                         info={"k3b_calls": k3b, "k2_calls": [k2], "flops_per_batch": 495e12})
    assert read("k3b_roofline.sd3gen", rc) == pytest.approx(100.0, rel=1e-6)
    assert read("k2_roofline.1024", rc) == pytest.approx(25.0, rel=1e-6)
    assert read("mmdit_device_ms.sd3gen", rc) == pytest.approx(1.5e3 * bound, rel=1e-6)
    assert read("mfu.sd3gen", rc) == pytest.approx(20.0)
    assert read("mfu.xlgen", rc) == pytest.approx(20.0)
    # a cell without these shapes, or a program without the spans, reads nothing
    bare = SimpleNamespace(sessions=[_session("steps", 1, [])], costs=costs,
                           window={"batches": 1, "seconds": 1.0}, info={})
    for name in ("k3b_roofline.sd3gen", "k2_roofline.1024", "mmdit_device_ms.sd3gen",
                 "mfu.sd3gen", "mfu.xlgen", "jointattn_device_ms.sd3gen",
                 "adaln_device_ms.sd3gen"):
        assert read(name, bare) is None, name
