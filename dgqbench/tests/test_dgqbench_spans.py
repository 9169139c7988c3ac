"""The per-layer metrics that read the program's own spans and counters, on
synthetic traced slices: each reads what its spans give, and None where the
program has no such span or counter (a program without them, or a run on
the CPU)."""
from __future__ import annotations

import pytest

from dgq_tpu_torch.utils import profiler
from dgqbench.harness import bench
from dgqbench.harness.spans import idle_inside_ns
from dgqbench.harness.trace import Session
from dgqbench.tests.helpers import REPO

RECON = {"softweights_device_ms.recon": "dgq.recon.soft_weights",
         "backward_device_ms.recon": "dgq.recon.backward",
         "optimizer_device_ms.recon": "dgq.recon.optim",
         "unitforward_device_ms.recon": "dgq.recon.unit_forward",
         "reg_device_ms.recon": "dgq.recon.reg"}


def _read(name, sessions=()):
    return bench.read_metric(REPO, name, bench.ReadContext(list(sessions), {}, {}, None))


def _counters(monkeypatch, counters):
    monkeypatch.setattr(profiler, "device_counters", lambda: counters)


def _session(label, units, host_ops):
    """Device operations [0, 10) [20, 30) [34, 40) [50, 60) ns, so idle gaps
    [10, 20), [30, 34) and [40, 50)."""
    s = Session(label, units, device="cpu")
    s.device_ops = [("k", 0, 10), ("k", 20, 30), ("k", 34, 40), ("k", 50, 60)]
    s.host_ops = sorted(host_ops, key=lambda h: h[1])
    return s


def test_idle_inside_sums_each_gaps_overlap_with_each_span():
    s = _session("steps", 2, [("dgq.x", 5, 15), ("dgq.x", 18, 45), ("dgq.y", 0, 60)])
    # [10, 15) in the first; [18, 20), [30, 34) and [40, 45) in the second
    assert idle_inside_ns([s], "dgq.x") == 5 + 2 + 4 + 5
    assert idle_inside_ns([s], "dgq.y") == 10 + 4 + 10
    assert idle_inside_ns([s], "dgq.z") == 0


def test_fake_quant_span_ms_is_busy_per_unet_call(monkeypatch):
    # 2 ms of extents, 1 ms of them idle (a gap of 1e6 ns inside a span)
    s = Session("unet", 2, device="cpu")
    s.device_ops = [("k", 0, 10), ("k", 1_000_010, 1_000_020)]
    s.host_ops = [("dgq.fake_quant", 5, 1_000_015)]
    _counters(monkeypatch, {"dgq.fake_quant": (660, 2.0), "dgq.unet": (2, None)})
    assert _read("fakequant_span_ms.gen", [s]) == pytest.approx((2.0 - 1.0) / 2)


def test_fake_quant_span_ms_leaves_out_the_untimed_calls(monkeypatch):
    # the second call is untimed: its span's idle [3e6, 4e6) is not taken
    # out, and the 2 ms of extents are the first call's alone
    s = Session("unet", 2, device="cpu")
    s.device_ops = [("k", 0, 10), ("k", 1_000_010, 1_000_020), ("k", 2_000_000, 3_000_000),
                    ("k", 4_000_000, 4_000_010)]
    s.host_ops = sorted([("dgq.unet", 0, 1_500_000), ("dgq.fake_quant", 5, 1_000_015),
                         ("dgq.unet", 1_900_000, 4_100_000),
                         ("dgq.unet.untimed", 1_900_001, 4_099_999),
                         ("dgq.fake_quant", 2_900_000, 4_000_005)], key=lambda h: h[1])
    _counters(monkeypatch, {"dgq.fake_quant": (660, 2.0), "dgq.unet": (2, None),
                            "dgq.unet.untimed": (1, None)})
    assert _read("fakequant_span_ms.gen", [s]) == pytest.approx(2.0 - 1.0)
    _counters(monkeypatch, {"dgq.fake_quant": (330, 0.0), "dgq.unet": (1, None),
                            "dgq.unet.untimed": (1, None)})
    assert _read("fakequant_span_ms.gen", [s]) is None


@pytest.mark.parametrize("counters", [
    {},                                                  # the program has no counters
    {"dgq.fake_quant": (660, None), "dgq.unet": (2, None)},  # the CPU: counts, no ms
    {"dgq.fake_quant": (660, 30.0)},                     # no UNet span
])
def test_fake_quant_span_ms_reads_none_without_its_spans(monkeypatch, counters):
    _counters(monkeypatch, counters)
    assert _read("fakequant_span_ms.gen", [_session("unet", 2, [])]) is None


@pytest.mark.parametrize("metric", sorted(RECON))
def test_recon_phase_ms_is_busy_per_span(monkeypatch, metric):
    name = RECON[metric]
    s = _session("steps", 2, [(name, 5, 15), (name, 18, 45), ("dgq.recon.step", 0, 60)])
    _counters(monkeypatch, {name: (2, 42.0), "dgq.recon.step": (2, None)})
    assert _read(metric, [s]) == pytest.approx((42.0 - 16 / 1e6) / 2)
    _counters(monkeypatch, {name: (2, None)})
    assert _read(metric, [s]) is None
    _counters(monkeypatch, {})
    assert _read(metric, [s]) is None


def test_the_counters_of_a_program_without_them_read_none(monkeypatch):
    monkeypatch.delattr(profiler, "device_counters")
    for metric in ["fakequant_span_ms.gen"] + sorted(RECON):
        assert _read(metric, [_session("unet", 2, [])]) is None


def test_lowres_idle_sums_the_gaps_inside_the_low_resolution_stages():
    stages = [("dgq.unet.down_blocks.1", 0, 12), ("dgq.unet.down_blocks.2", 12, 31),
              ("dgq.unet.up_blocks.2", 31, 60)]
    s = _session("unet", 2, [("dgq.unet", 0, 60), ("dgq.unet.untimed", 0, 60), ("aten::mm", 14, 16)]
                 + stages)
    # the gap [10, 20) has its midpoint in down_blocks.2; [30, 34) in
    # up_blocks.2 and [40, 50) too: 10 ns over the one untimed call
    assert _read("lowres_idle_ms.gen", [s]) == pytest.approx(10 / 1e6)


def test_lowres_idle_reads_the_untimed_calls_alone():
    # a timed call [0, 30) and an untimed one [30, 60), each with its
    # down_blocks.2: only the gaps [30, 34) and [40, 50) count
    s = _session("unet", 2, [("dgq.unet", 0, 30), ("dgq.unet.down_blocks.2", 0, 30),
                             ("dgq.unet", 30, 60), ("dgq.unet.untimed", 30, 60),
                             ("dgq.unet.down_blocks.2", 30, 60)])
    assert _read("lowres_idle_ms.gen", [s]) == pytest.approx(14 / 1e6)


def test_lowres_idle_reads_none_without_the_stage_spans():
    s = _session("unet", 2, [("aten::mm", 14, 16), ("dgq.unet", 0, 60)])
    assert _read("lowres_idle_ms.gen", [s]) is None
    assert _read("lowres_idle_ms.gen", []) is None
    # stage spans, but no untimed call to read them in
    timed = _session("unet", 2, [("dgq.unet", 0, 60), ("dgq.unet.mid_block", 0, 60)])
    assert _read("lowres_idle_ms.gen", [timed]) is None
    empty = _session("unet", 2, [("dgq.unet.untimed", 0, 60), ("dgq.unet.mid_block", 0, 60)])
    empty.device_ops = []
    assert _read("lowres_idle_ms.gen", [empty]) is None
