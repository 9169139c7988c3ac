"""Readings that set the limits of a cell's check: the numbers the check
compares for a sound run of the program on each seed, and with --control
the same numbers for the control, the reference in bfloat16 put in the
program's place, on the same inputs. Each seed runs the cell's set-up, a
short window (a batch or a call) and the check, in one process:

    python3 dgqbench/readings.py --workload <name> --seeds 11,12,13 [--control 11,12] [--seconds 1]
        [--fault 'half the batch']

One JSON line a seed. Not part of a benchmark run.
"""
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["USE_FLAX"] = "0"

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    import argparse

    import torch

    from dgqbench.harness.bench import Context, load_cell
    import importlib

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="", help="seeds that also read the control")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--fault", default=None, help="read the sound numbers with this fault planted")
    args = ap.parse_args()
    _, work, config, traffic, limits = load_cell(ROOT, args.workload)
    driver = importlib.import_module(f"dgqbench.drivers.{traffic['kind']}")
    from contextlib import nullcontext

    from dgqbench import faults

    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        with faults.plant(traffic["kind"], args.fault) if args.fault else nullcontext():
            cell = driver.setup(Context(config, traffic, seed, "cuda"))
            driver.window(cell, args.seconds)
            kept = getattr(cell, "kept", None)
            line = {"seed": seed, "fault": args.fault, "sound": driver.check(cell)}
        line["detail"] = getattr(cell, "detail", None)
        if str(seed) in args.control.split(","):
            if kept is not None:
                cell.kept = kept
            line["control"] = driver.check(cell, control=True)
            line["control_detail"] = getattr(cell, "detail", None)
        line["seconds"] = time.perf_counter() - t0
        line["limits"] = limits
        print(json.dumps(line), flush=True)
        del cell, kept
        gc.collect()
        torch.cuda.empty_cache()
