"""The MMDiT's spans and device counters (`utils/profiler.py`), on a tiny
SD3 MMDiT on the CPU:

  * one transformer call holds `dgq.mmdit.embed`, one `dgq.mmdit.blocks.<i>`
    a block in order and `dgq.mmdit.final`, every one a CPU operation;
  * each block holds one `dgq.joint_attention` (the q, k, v quantizers and
    the attention core inside it, the projections outside) and three
    `dgq.adaln` (two after the last block, whose text stream has no MLP);
  * the sampler's slot and update spans surround each call;
  * every second call under one profiler lies inside `dgq.mmdit.untimed`,
    where the device counters time no extent;
  * the output is bit for bit the same with and without a profiler.
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dgq_tpu_torch.calib.weight_calib import quantize_model_weights
from dgq_tpu_torch.models import mmdit_sd3 as M
from dgq_tpu_torch.models.qconfig import QConfig
from dgq_tpu_torch.pipeline.sampler import sd3_sample, select_slot_qstate
from dgq_tpu_torch.utils import profiler as P
from dgq_tpu_torch.utils.synthetic import synthetic_mmdit_qstate

GEO = {"head_dim": 32, "sample_size": 16, "pos_embed_max_size": 24}
BLOCKS = ["dgq.mmdit.blocks.0", "dgq.mmdit.blocks.1", "dgq.mmdit.blocks.2"]


@pytest.fixture(scope="module")
def net():
    spec = M.mmdit_sd3_spec(layers=3, heads=2, head_dim=32, joint_dim=96, pooled_dim=48,
                            freq_dim=32)
    params = M.init_mmdit_sd3(torch.Generator().manual_seed(0), "cpu", spec)
    cfg = QConfig(w_bits=4, a_bits=8, use_wq=True, use_aq=True, t2i_log_quant=True,
                  t2i_real_time=True, t2i_start_peak=True, use_pallas_attention=True)
    folded, _ = quantize_model_weights(params, M.quantized_spec(spec), cfg)
    qs = synthetic_mmdit_qstate(spec, 2, device="cpu")
    g = torch.Generator().manual_seed(1)
    inputs = (torch.randn(1, 16, 16, 16, generator=g), torch.randn(1, 85, 96, generator=g),
              torch.randn(1, 48, generator=g))
    return folded, qs, cfg, inputs


def _call(net):
    folded, qs, cfg, (x, e, p) = net
    return M.mmdit_sd3_apply(folded, x, torch.tensor([500.0]), e, p,
                             qstate=select_slot_qstate(qs, 0), cfg=cfg, **GEO)


def _traced(fn):
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

    def __init__(self, enable_timing=False):
        pass

    def record(self, stream):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 1.0


def test_a_call_holds_embed_blocks_and_final_in_order(net):
    _, spans = _traced(lambda: _call(net))
    assert spans and all(s[3] == torch.autograd.DeviceType.CPU and not s[4] for s in spans)
    call = next(s for s in spans if s[0] == "dgq.mmdit")
    inner = [n for n in _inside(spans, call) if n.startswith("dgq.mmdit.")]
    assert inner == ["dgq.mmdit.embed"] + BLOCKS + ["dgq.mmdit.final"]


def test_each_block_holds_its_joint_attention_and_adaln_spans(net):
    _, spans = _traced(lambda: _call(net))
    for i, name in enumerate(BLOCKS):
        block = next(s for s in spans if s[0] == name)
        inner = _inside(spans, block)
        assert inner.count("dgq.joint_attention") == 1
        assert inner.count("dgq.adaln") == (2 if i == len(BLOCKS) - 1 else 3)
        joint = next(s for s in spans if s[0] == "dgq.joint_attention" and block[1] <= s[1]
                     and s[2] <= block[2])
        # the q, k and v quantizers inside, the six projections and to_out.0 outside
        assert _inside(spans, joint).count("dgq.fake_quant") == 3
    counters = P.device_counters()
    assert counters["dgq.joint_attention"] == (3, None)
    assert counters["dgq.adaln"] == (8, None)


def test_sampler_spans_surround_each_call(net):
    folded, qs, cfg, (x, e, p) = net

    def apply(*a, **kw):
        return M.mmdit_sd3_apply(*a, **kw, **GEO)

    _, spans = _traced(lambda: sd3_sample(folded, x, e, p, e, p, apply, num_inference_steps=2,
                                          qstate=qs, cfg=cfg, time_aware=True))
    names = [s[0] for s in spans if s[0] in ("dgq.sampler.slot", "dgq.mmdit",
                                             "dgq.sampler.update")]
    assert names == ["dgq.sampler.slot", "dgq.mmdit", "dgq.sampler.update"] * 2


def test_every_second_call_leaves_the_counters_untimed(net, monkeypatch):
    monkeypatch.setattr(P, "_stream", lambda: "stream")
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    try:
        _, spans = _traced(lambda: (_call(net), _call(net)))
        calls = [s for s in spans if s[0] == "dgq.mmdit"]
        untimed = [s for s in spans if s[0] == "dgq.mmdit.untimed"]
        assert len(calls) == 2 and len(untimed) == 1
        assert calls[1][1] <= untimed[0][1] and untimed[0][2] <= calls[1][2]
        assert _inside(spans, untimed[0]).count("dgq.joint_attention") == 3
        c = P.device_counters()
        # one 1 ms extent a span of the first call, none of the second
        assert c["dgq.joint_attention"] == (6, 3.0) and c["dgq.adaln"] == (16, 8.0)
        assert c["dgq.mmdit"] == (2, None) and c["dgq.mmdit.untimed"] == (1, None)
    finally:
        P.reset_counters()


def test_output_is_bit_identical_under_a_profiler(net):
    plain = _call(net)
    traced, _ = _traced(lambda: _call(net))
    assert torch.equal(plain, traced)
