"""The benchmark's runner: one run of one cell.

Everything particular to a cell is found by name:
  * BENCHMARK.json's workload names its configuration (whose entry names
    the file under dgqbench/configs/) and its traffic mix,
    dgqbench/traffic/<mix>.json, whose "kind" names the driver,
    dgqbench/drivers/<kind>.py;
  * dgqbench/limits/<workload>.json holds the limit of each number the
    driver's check compares;
  * each per-layer metric of BENCHMARK.json that applies to the cell is read
    by dgqbench/metrics/<name>.py, a `read(ctx)` that returns the value or
    None (then the metric is left out of the line).

A driver module gives setup(ctx) -> cell, window(cell, seconds) -> summary,
trace(cell) -> profiler sessions, check(cell) -> {number: value}; the cell
carries `info`, what the metric readers need of its shapes.

A run: set-up (timed from the process's start to the window's start), the
window, the peak of device memory, with --trace 1 the traced slice and the
per-layer metrics, then the check, after the window, once the peak has been
read. Its result is the last line of standard output.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import re
import sys
import time
import traceback

import torch

FOREIGN = ("jax", "jaxlib", "flax", "dgq_tpu")


@dataclasses.dataclass
class Context:
    """What a driver's set-up is given."""
    config: dict
    traffic: dict
    seed: int
    device: str


@dataclasses.dataclass
class ReadContext:
    """What a per-layer metric reader sees."""
    sessions: list
    window: dict
    info: dict
    costs: object


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(root: str, name: str):
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = _load_json(os.path.join(root, conf["file"]))
    traffic = _load_json(os.path.join(root, "dgqbench", "traffic", work["traffic"] + ".json"))
    limits = _load_json(os.path.join(root, "dgqbench", "limits", name + ".json"))
    return bench, work, config, traffic, limits


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def read_metric(root: str, name: str, rc: ReadContext):
    path = os.path.join(root, "dgqbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("dgqbench_metric_" + re.sub(r"\W", "_", name),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rc)


def foreign_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FOREIGN))


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool, t0: float,
             device: str = "cuda") -> dict:
    """One run; returns the result object (with its extra lines under "_lines")."""
    from dgqbench import costs

    bench, work, config, traffic, limits = load_cell(root, name)
    driver = importlib.import_module(f"dgqbench.drivers.{traffic['kind']}")
    ctx = Context(config, traffic, seed, device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cell = driver.setup(ctx)
    _sync(device)
    setup_s = time.perf_counter() - t0
    summary = driver.window(cell, seconds)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    e2e = {"setup_s": setup_s, "peak_gib": peak / 2 ** 30, **summary["e2e"]}
    metrics, out = {}, {}
    if not trace:
        for m in bench["end_to_end"]:
            if applies(m, name):
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        sessions = driver.trace(cell)
        rc = ReadContext(sessions, summary, cell.info, costs)
        for m in bench["per_layer"]:
            if applies(m, name):
                v = read_metric(root, m["name"], rc)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        from dgqbench.harness import trace as tr

        out["busy_s"] = sum(s.busy_s() for s in sessions)
        out["window_s"] = sum(s.wall_s for s in sessions)
        out["breakdown"] = {"device_ops": tr.by_family(sessions)[:10],
                            "idle_gaps": tr.idle_by_host(sessions)[:10]}
    try:
        nums = driver.check(cell)
    except Exception:  # noqa: BLE001 (a check that cannot finish finds the run not correct)
        traceback.print_exc()
        nums = {}
    correct = all(k in nums and nums[k] <= v for k, v in limits.items())
    # a gap that is not finite (a unit at other shapes) prints as null
    checks = {k: {"value": nums[k] if k in nums and math.isfinite(nums[k]) else None, "limit": v}
              for k, v in limits.items()}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"], dev["window_s"] = out["busy_s"], out["window_s"]
    result = {"correct": correct, "attempted": summary["attempted"], "failed": summary["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    result["_lines"] = [f"{k}: {json.dumps(v)}" for k, v in summary["counters"].items()]
    return result


def main(argv, t0: float, root: str) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _, work, _, _, _ = load_cell(root, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
        print(f"needs {work['chips']} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    result = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace), t0)
    found = foreign_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: no result", file=sys.stderr)
        return 3
    for line in result.pop("_lines"):
        print(line, flush=True)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
