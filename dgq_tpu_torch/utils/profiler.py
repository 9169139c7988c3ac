"""Tracing helpers (port of `dgq_tpu/utils/profiler.py`; the reference has
only perf_counter printouts, src/gen4eval_SD.py:239,260).

`span` marks a piece of the program (the UNet and its stages, the
activation quantizers, the sampler's steps, the decode, the reconstruction
loop's phases) while a `torch.profiler` records, and does nothing else
otherwise: there is no switch of its own, so a run that no profiler watches
pays one module-global check a span. A recording span is a plain CPU
operation of the profiler (`torch._C._profiler._RecordFunctionFast`, not
`record_function`, whose user annotations the profiler also copies onto the
device's timeline as CUDA-typed events), so it sits on kineto's clock
beside the device's operations and never among them. Each recording span
counts itself; one opened with `device=True` on a card also times its
stream extent with a pair of CUDA events, which `device_counters` resolves
(the pending pairs are bounded, and their events reused).

`device_trace` records `torch.profiler` (CPU and, where there is a card,
CUDA activity) and writes a Chrome trace, which carries the spans. Unlike
the JAX package's, it does not swallow an error: a trace that cannot start
or be written raises (ROADMAP queue 3). The JAX package's `compiled_stats`
reads XLA's compiled cost and memory analysis and has no counterpart here.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

# The process's span counters, as the kernels' LAUNCHES are the process's:
# spans by name, resolved device ms by name, (name, start, end) event pairs
# not yet resolved (at most _PENDING_MAX: past it the older half is
# resolved), resolved events that later spans record again, and whether
# device=True spans time their extents (not inside an untimed span).
_SPANS: Dict[str, int] = {}
_DEVICE_MS: Dict[str, float] = {}
_PENDING: list = []
_POOL: list = []
_PENDING_MAX = 1024
_TIMED = [True]


class _Off:
    """The span of a run that no profiler records: one shared object."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stream():
    """The current CUDA stream where a card is in use, else None."""
    return torch.cuda.current_stream() if torch.cuda.is_initialized() else None


def _event():
    return _POOL.pop() if _POOL else torch.cuda.Event(enable_timing=True)


def _resolve(n: int) -> None:
    """Fold the oldest n pending pairs into _DEVICE_MS (waiting for the card
    to pass their ends) and return their events to the pool."""
    for name, start, end in _PENDING[:n]:
        end.synchronize()
        _DEVICE_MS[name] = _DEVICE_MS.get(name, 0.0) + start.elapsed_time(end)
        _POOL.extend((start, end))
    del _PENDING[:n]


class _Span:
    __slots__ = ("name", "device", "untimed", "record", "start", "stream", "was_timed")

    def __init__(self, name: str, device: bool, untimed: bool = False):
        self.name, self.device, self.untimed = name, device, untimed
        self.record = _RecordFunctionFast(name)

    def __enter__(self):
        self.record.__enter__()
        self.start = None
        if self.untimed:
            self.was_timed, _TIMED[0] = _TIMED[0], False
        elif self.device and _TIMED[0]:
            self.stream = _stream()
            if self.stream is not None:
                self.start = _event()
                self.start.record(self.stream)
        return self

    def __exit__(self, *exc):
        if self.untimed:
            _TIMED[0] = self.was_timed
        # a span the profiler stopped inside is left out: its extent would
        # hold the profiler's own stop, where the device waits
        if _autograd_profiler._is_profiler_enabled:
            _SPANS[self.name] = _SPANS.get(self.name, 0) + 1
            if self.start is not None:
                end = _event()
                end.record(self.stream)
                _PENDING.append((self.name, self.start, end))
                if len(_PENDING) > _PENDING_MAX:
                    _resolve(_PENDING_MAX // 2)
        elif self.start is not None:
            _POOL.append(self.start)
        self.record.__exit__(*exc)
        return False


def span(name: str, device: bool = False):
    """A context manager that marks `name` while a torch profiler records
    (a CPU operation of the profiler, counted by `device_counters` when the
    profiler still records at its exit); with device=True and a card in
    use, its stream extent is timed too: the time from an event recorded on
    the current stream at entry to one at exit, idle time inside included
    (not inside an `untimed_every_other` span). With no profiler recording
    at entry it returns one shared object that does nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def untimed_every_other(name: str):
    """For a span `name` that repeats while a profiler records (a UNet
    call): entered inside every second one, counted from the first since
    `reset_counters`, a span `<name>.untimed` inside which device=True
    spans time no extent; elsewhere the shared no-op. Those calls show the
    host's path without the event pairs, whose records cost the host tens
    of us each under the profiler, and the others the device extents."""
    if not _autograd_profiler._is_profiler_enabled or _SPANS.get(name, 0) % 2 == 0:
        return _OFF
    return _Span(name + ".untimed", False, untimed=True)


def device_counters() -> Dict[str, Tuple[int, Optional[float]]]:
    """{span name: (spans recorded, their summed device ms or None)} since
    the last `reset_counters`. The ms are stream extents of the spans
    opened with device=True on a card and timed (None for the others, and
    on the CPU). Waits for the card to pass every span's end."""
    _resolve(len(_PENDING))
    return {name: (n, _DEVICE_MS.get(name)) for name, n in _SPANS.items()}


def reset_counters() -> None:
    _PENDING.clear()
    _POOL.clear()
    _SPANS.clear()
    _DEVICE_MS.clear()


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the block with `torch.profiler` and write its Chrome trace
    (open it in chrome://tracing or Perfetto) to `logdir`/trace.json, or
    trace_rank<r>.json in a process group; the trace carries the program's
    spans (`span`) as CPU operations. Yields the profiler, whose
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
