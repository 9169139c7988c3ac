"""The port's timing and tracing helpers (`utils/profiler.py`): `wallclock`
prints the JAX package's line, and `device_trace` writes a Chrome trace of
the block's CPU events (the CUDA ones too on a card) and does not swallow
an error."""
import json
import re

import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from dgq_tpu.utils import profiler as JP  # noqa: E402
from dgq_tpu_torch.utils import profiler as TP  # noqa: E402


def test_wallclock_prints_the_jax_packages_line():
    lines = {"jax": [], "port": []}
    with JP.wallclock("shard 0", sink=lines["jax"].append):
        pass
    with TP.wallclock("shard 0", sink=lines["port"].append):
        sum(range(1000))
    for key in lines:
        assert len(lines[key]) == 1 and re.fullmatch(r"shard 0: \d+\.\d{3}s", lines[key][0])


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
