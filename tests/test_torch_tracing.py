"""The port's spans and device counters (`utils/profiler.py`: `span`,
`device_counters`), on the tiny SD net on the CPU:

  * with no profiler recording, `span` is one shared object that counts
    nothing;
  * under `torch.profiler` the UNet's call holds its nine stage spans in
    order and the activation quantizers' spans, the sampler gives its slot
    and update spans, and every span is a CPU operation, not a user
    annotation (which the profiler would also put on the device's
    timeline);
  * every second UNet call under one profiler holds its stages and
    quantizers inside a `dgq.unet.untimed` span, where the quantizers time
    no extent;
  * each Adam step of `reconstruct_unit` holds one span of each phase, and
    the counters count them (no device ms on the CPU), leaving out a span
    the profiler stopped inside; the pending event pairs stay bounded
    (stand-in events on the CPU);
  * the outputs are bit for bit the same with and without a profiler;
  * `device_trace`'s Chrome trace carries the spans, and the weight walk
    logs each unit's phases.
"""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dgq_tpu_torch.calib import reconstruction as TR
from dgq_tpu_torch.calib.weight_calib import init_weight_qparams, quantize_model_weights
from dgq_tpu_torch.models.qconfig import QConfig
from dgq_tpu_torch.models.unet_sd import init_unet_sd, sd_unet_spec, unet_sd_apply
from dgq_tpu_torch.pipeline.sampler import sd_sample, select_time_qstate
from dgq_tpu_torch.utils import profiler as P
from dgq_tpu_torch.utils.synthetic import synthetic_group_qstate

STAGES = ["dgq.unet.down_blocks.0", "dgq.unet.down_blocks.1", "dgq.unet.down_blocks.2",
          "dgq.unet.down_blocks.3", "dgq.unet.mid_block", "dgq.unet.up_blocks.0",
          "dgq.unet.up_blocks.1", "dgq.unet.up_blocks.2", "dgq.unet.up_blocks.3"]
PHASES = ["dgq.recon.rows", "dgq.recon.soft_weights", "dgq.recon.unit_forward",
          "dgq.recon.reg", "dgq.recon.backward", "dgq.recon.optim"]
UNIT = "down_blocks.0.attentions.0.transformer_blocks.0"


@pytest.fixture(scope="module")
def net():
    """The tiny SD UNet, W4-folded, with g=8-shaped time-aware quantizers
    (two slots), the flagship's softmax policy, and one call's inputs."""
    spec = sd_unet_spec(base=32, cross=64)
    params = init_unet_sd(torch.Generator().manual_seed(0), "cpu", spec=spec)
    qstate, groups = synthetic_group_qstate(spec, 2, True, torch.float32, device="cpu")
    cfg = QConfig(w_bits=4, a_bits=8, use_wq=True, use_aq=True, group_conv_layers=groups,
                  group_conv_impl="taps", use_pallas_attention=True, t2i_log_quant=True,
                  t2i_real_time=True, t2i_start_peak=True)
    folded, _ = quantize_model_weights(params, spec, cfg)
    g = torch.Generator().manual_seed(1)
    lat = torch.randn(1, 8, 8, 4, generator=g)
    ehs = torch.randn(2, 77, 64, generator=g)
    return spec, params, folded, qstate, cfg, lat, ehs


def _unet(net):
    _, _, folded, qstate, cfg, lat, ehs = net
    return unet_sd_apply(folded, torch.cat([lat, lat]), torch.tensor([501, 501]), ehs,
                         qstate=select_time_qstate(qstate, 501, 2), cfg=cfg)


def _sample(net):
    _, _, folded, qstate, cfg, lat, ehs = net
    return sd_sample(folded, lat, ehs[1:], ehs[:1], num_inference_steps=1, qstate=qstate,
                     cfg=cfg, time_aware=True)


@pytest.fixture(scope="module")
def unit():
    """A transformer block of the tiny net, its W4 scales and its captures
    over 4 calibration samples."""
    spec = sd_unet_spec(base=32, cross=64)
    params = init_unet_sd(torch.Generator().manual_seed(2), "cpu", spec=spec)
    g = torch.Generator().manual_seed(3)
    cali = (torch.randn(4, 16, 16, 4, generator=g), torch.randint(0, 1000, (4,), generator=g),
            torch.randn(4, 77, 64, generator=g))
    cfg = QConfig(w_bits=4, use_wq=True)
    ins, out = TR.capture_unit_io(params, cali, UNIT, cfg)
    units = {u.name: u for u in TR.recon_units(spec)}
    return spec, params, init_weight_qparams(params, spec, 4), cfg, cali, units[UNIT], ins, out


def _recon(unit):
    _, params, wqp, cfg, _, u, ins, out = unit
    # warmup 0: every step is past the warm-up, so the regulariser runs
    return TR.reconstruct_unit((7,), u, params, wqp, ins, out, cfg, iters=3, batch_size=2,
                               warmup=0.0)[1]


def _traced(fn):
    """fn() under a CPU profiler: (its result, the spans as (name, start,
    end, device type, user annotation), sorted by start), the counters
    reset before."""
    P.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.device_type(),
                     e.is_user_annotation())
                    for e in prof.profiler.kineto_results.events() if e.name().startswith("dgq.")),
                   key=lambda s: s[1])
    return out, spans


def _inside(spans, outer):
    return [s[0] for s in spans if outer[1] <= s[1] and s[2] <= outer[2] and s is not outer]


class _Event:
    """A stand-in for torch.cuda.Event: every extent is 1 ms."""
    made = 0

    def __init__(self, enable_timing=False):
        _Event.made += 1

    def record(self, stream):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 1.0


@pytest.fixture
def events(monkeypatch):
    """Device spans record stand-in events on a stand-in stream."""
    monkeypatch.setattr(P, "_stream", lambda: "stream")
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    _Event.made = 0
    yield _Event
    P.reset_counters()


def test_spans_cost_nothing_without_a_profiler(net):
    assert P.span("dgq.unet") is P.span("dgq.fake_quant", device=True)
    assert P.untimed_every_other("dgq.unet") is P.span("dgq.unet")
    before = P.device_counters()
    _unet(net)
    assert P.device_counters() == before


def test_unet_and_sampler_spans_are_cpu_operations_in_order(net):
    _, spans = _traced(lambda: _sample(net))
    assert spans and all(s[3] == torch.autograd.DeviceType.CPU and not s[4] for s in spans)
    names = [s[0] for s in spans]
    assert names.count("dgq.unet") == 1
    assert names.count("dgq.sampler.slot") == names.count("dgq.sampler.update") == 1
    unet = next(s for s in spans if s[0] == "dgq.unet")
    inner = _inside(spans, unet)
    assert [n for n in inner if n in STAGES] == STAGES
    assert inner.count("dgq.fake_quant") > 100
    assert inner.count("dgq.linear") > 10  # every linear's product, kernel or library
    assert set(inner) == set(STAGES) | {"dgq.fake_quant", "dgq.linear"}
    slot = next(s for s in spans if s[0] == "dgq.sampler.slot")
    update = next(s for s in spans if s[0] == "dgq.sampler.update")
    assert slot[2] <= unet[1] and unet[2] <= update[1]


def test_every_second_unet_call_leaves_the_quantizers_untimed(net, events):
    _, spans = _traced(lambda: (_unet(net), _unet(net)))
    calls = [s for s in spans if s[0] == "dgq.unet"]
    untimed = [s for s in spans if s[0] == "dgq.unet.untimed"]
    assert len(calls) == 2 and len(untimed) == 1
    assert "dgq.unet.untimed" not in _inside(spans, calls[0])
    assert calls[1][1] <= untimed[0][1] and untimed[0][2] <= calls[1][2]
    assert [n for n in _inside(spans, untimed[0]) if n in STAGES] == STAGES
    timed = _inside(spans, calls[0]).count("dgq.fake_quant")
    assert timed > 100 and _inside(spans, untimed[0]).count("dgq.fake_quant") == timed
    # one 1 ms extent a quantizer of the first call, none of the second
    assert P.device_counters()["dgq.fake_quant"] == (2 * timed, float(timed))
    assert P.device_counters()["dgq.unet"] == (2, None)


def test_pending_event_pairs_stay_bounded(events):
    n = 10 * P._PENDING_MAX
    P.reset_counters()
    most = 0
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(n):
            with P.span("dgq.x", device=True):
                pass
            most = max(most, len(P._PENDING))
    assert most <= P._PENDING_MAX
    # resolved pairs hand their events to later spans
    assert events.made <= 2 * P._PENDING_MAX + 2
    assert P.device_counters() == {"dgq.x": (n, float(n))}
    assert not P._PENDING


def test_each_adam_step_holds_one_span_of_each_phase(unit):
    P.reset_counters()
    _, spans = _traced(lambda: _recon(unit))
    steps = [s for s in spans if s[0] == "dgq.recon.step"]
    assert len(steps) == 3
    for step in steps:
        inner = _inside(spans, step)
        # and the unit's linears (each runs the library's product: it wants a gradient)
        assert inner.count("dgq.linear") > 0
        assert sorted(n for n in inner if n != "dgq.linear") == sorted(PHASES)
    call = next(s for s in spans if s[0] == "dgq.recon.call")
    assert _inside(spans, call).count("dgq.recon.setup") == 1
    counters = P.device_counters()
    linears = _inside(spans, steps[0]).count("dgq.linear")
    assert counters == {**{n: (3, None) for n in PHASES + ["dgq.recon.step"]},
                        "dgq.recon.call": (1, None), "dgq.recon.setup": (1, None),
                        "dgq.linear": (3 * linears, None)}
    P.reset_counters()
    assert P.device_counters() == {}


def test_a_span_the_profiler_stops_inside_is_left_out():
    P.reset_counters()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with P.span("dgq.outer", device=True):
        with P.span("dgq.inner", device=True):
            pass
        prof.stop()
    assert P.device_counters() == {"dgq.inner": (1, None)}
    P.reset_counters()


def test_outputs_are_bit_identical_under_a_profiler(net, unit):
    eps, traced = _unet(net), _traced(lambda: _unet(net))[0]
    assert torch.equal(eps, traced)
    losses, traced = _recon(unit), _traced(lambda: _recon(unit))[0]
    assert losses.shape == (3,) and torch.equal(losses, traced)


def test_device_trace_carries_the_spans(net, tmp_path):
    with P.device_trace(str(tmp_path)) as prof:
        _unet(net)
    names = {e.get("name") for e in json.load(open(prof.trace_path))["traceEvents"]}
    assert {"dgq.unet", "dgq.fake_quant"} | set(STAGES) <= names


def test_the_walk_logs_each_units_phases(unit):
    spec, params, wqp, cfg, cali, _, _, _ = unit
    lines = []
    _, spans = _traced(lambda: TR.calibrate_weights(
        params, spec, cfg, wqp, cali, iters=2, batch_size=2, capture_batch=2, max_units=2,
        progress=lines.append))
    done = [l for l in lines if " done: " in l]
    assert len(done) == 2 and done[1].startswith("[2/2] ")
    for line in done:
        assert all(f"{k} " in line for k in TR.WALK_PHASES) and line.endswith(" ms an Adam step")
        assert "] reconstructing " not in line and "resumed from partial save" not in line
    names = [s[0] for s in spans]
    # the second unit's inputs come from the quantized prefix: a fold and a
    # second capture
    assert names.count("dgq.walk.adam") == 2 and names.count("dgq.walk.fold") == 1
    assert names.count("dgq.walk.capture") == 3 and "dgq.walk.grad" not in names
