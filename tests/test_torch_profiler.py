"""The port's Chrome trace helper (`utils/profiler.py:device_trace`): it
writes the block's CPU events (the CUDA ones too on a card) and does not
swallow an error. The spans are tested in test_torch_tracing.py."""
import json

import pytest
import torch

from dgq_tpu_torch.utils import profiler as TP


def test_device_trace_writes_the_cpu_events(tmp_path):
    a = torch.randn(64, 64)
    with TP.device_trace(str(tmp_path / "trace")) as prof:
        b = torch.mm(a, a).relu()
    assert b.shape == (64, 64)
    assert prof.trace_path == str(tmp_path / "trace" / "trace.json")
    events = json.loads(open(prof.trace_path).read())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names and "aten::relu" in names


def test_device_trace_raises_what_the_block_raises(tmp_path):
    with pytest.raises(ValueError, match="inside"):
        with TP.device_trace(str(tmp_path / "t")):
            raise ValueError("inside")
