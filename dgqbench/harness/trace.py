"""Traced slices of a run: `torch.profiler` sessions around a stated piece
of the timed path, reduced at once to plain lists of device operations and
host operations (no Chrome trace is written), and the arithmetic on them:
busy time as the union of device intervals, device time by kernel family,
the idle gaps between device operations by what the host was doing.

Kernel families: the port's hand-written kernels by name, the library's
by the bucket table of the port's profiling script (convs, matmuls,
reductions), the rest "elementwise and copies".
"""
from __future__ import annotations

import bisect
import re
import time

import torch

PORT_KERNELS = ("quant_tf32_kernel", "quant_tc_kernel", "attention_kernel", "flash_tf32_kernel",
                "flash_tc_kernel", "group_conv_tf32_kernel", "group_conv_tc_kernel",
                "group_conv_kernel", "fold_oihw_kernel", "fold_kernel", "finish_kernel",
                "int8_wgmma_kernel")
LIBRARY = (("library convs", ("fprop", "implicit_gemm", "cudnn", "conv2d", "convolve")),
           ("library matmuls", ("gemm", "nvjet", "cutlass", "cublas", "splitk")),
           ("reductions", ("reduce",)))
ELEMENTWISE = "elementwise and copies"


def family(name: str) -> str:
    for k in PORT_KERNELS:
        if re.search(rf"\b{k}\b", name):
            return k
    low = name.lower()
    for label, keys in LIBRARY:
        if any(k in low for k in keys):
            return label
    return ELEMENTWISE


class Session:
    """One profiled piece: start() and stop() synchronise the device, so
    `wall_s` is the piece's wall time under the profiler; `units` counts the
    calls or steps it covers."""

    def __init__(self, label: str, units: int, device="cuda"):
        self.label, self.units, self.device = label, units, device
        self.device_ops: list = []   # (name, start_ns, end_ns)
        self.host_ops: list = []
        self.wall_s = 0.0
        self.wall_untraced_s = None
        self._prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device == "cuda" else [])
        _sync(self.device)
        self._prof = profile(activities=acts)
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self):
        _sync(self.device)
        self.wall_s = time.perf_counter() - self._t0
        self._prof.stop()
        for e in self._prof.profiler.kineto_results.events():
            start = e.start_ns()
            rec = (e.name(), start, start + e.duration_ns())
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                self.device_ops.append(rec)
            else:
                self.host_ops.append(rec)
        self._prof = None
        self.device_ops.sort(key=lambda r: r[1])
        self.host_ops.sort(key=lambda r: r[1])

    def merged(self) -> list:
        """The union of the device intervals, as sorted (start, end)."""
        out = []
        for _, s, e in self.device_ops:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged()) / 1e9

    def time_s(self, families) -> float:
        """Summed device time of the operations of these kernel families."""
        return sum(e - s for n, s, e in self.device_ops if family(n) in families) / 1e9

    def gaps(self) -> list:
        m = self.merged()
        return [(a[1], b[0]) for a, b in zip(m, m[1:]) if b[0] > a[1]]


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def by_family(sessions) -> list:
    """[[family, seconds], ...] over the sessions, largest first."""
    acc: dict = {}
    for s in sessions:
        for n, a, b in s.device_ops:
            acc[family(n)] = acc.get(family(n), 0.0) + (b - a) / 1e9
    return sorted(([k, v] for k, v in acc.items()), key=lambda kv: -kv[1])


def idle_by_host(sessions, longest: int = 200) -> list:
    """[[host operation, seconds], ...]: the longest idle gaps of the device,
    each named by the innermost host operation running at its middle,
    summed by name, largest first."""
    gaps = sorted(((b - a, a, b, s) for s in sessions for a, b in s.gaps()), key=lambda g: -g[0])
    acc: dict = {}
    for length, a, b, s in gaps[:longest]:
        mid = (a + b) // 2
        starts = [h[1] for h in s.host_ops]
        i = bisect.bisect_right(starts, mid)
        name, best = "no host operation", None
        for h in reversed(s.host_ops[max(0, i - 2000):i]):
            if h[2] >= mid and (best is None or h[2] - h[1] < best):
                name, best = h[0], h[2] - h[1]
        acc[name] = acc.get(name, 0.0) + length / 1e9
    return sorted(([k, v] for k, v in acc.items()), key=lambda kv: -kv[1])
