"""Timing and tracing helpers (port of `dgq_tpu/utils/profiler.py`; the
reference has only perf_counter printouts, src/gen4eval_SD.py:239,260).

`device_trace` records `torch.profiler` (CPU and, where there is a card,
CUDA activity) and writes a Chrome trace. Unlike the JAX package's, it does
not swallow an error: a trace that cannot start or be written raises
(ROADMAP queue 3). The JAX package's `compiled_stats` reads XLA's compiled
cost and memory analysis and has no counterpart here.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def wallclock(label: str, sink=print):
    """perf_counter timing context (the reference's eval-shard timing): on
    exit sink('<label>: <seconds>s'). The caller synchronises the card."""
    t0 = time.perf_counter()
    yield
    sink(f"{label}: {time.perf_counter() - t0:.3f}s")


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the block with `torch.profiler` and write its Chrome trace
    (open it in chrome://tracing or Perfetto) to `logdir`/trace.json, or
    trace_rank<r>.json in a process group. Yields the profiler, whose
    `trace_path` names the file it writes when the block ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    name = "trace.json"
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        name = f"trace_rank{torch.distributed.get_rank()}.json"
    prof = torch.profiler.profile(activities=activities)
    prof.trace_path = os.path.join(logdir, name)
    with prof:
        yield prof
    prof.export_chrome_trace(prof.trace_path)
