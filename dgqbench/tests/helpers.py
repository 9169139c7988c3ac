"""Shared by the CPU tests of the benchmark: a checkout of its own in a
temporary directory, holding BENCHMARK.json and a copy of dgqbench/ with
the tiny configurations, traffic mixes and limits of tests/data beside the
real ones, and tiny cells that name them."""
from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DATA = os.path.join(REPO, "dgqbench", "tests", "data")
TINY = {"tiny_gen": ("tiny-sd", "tiny_generate"), "tiny_recon": ("tiny-sdxl", "tiny_reconstruct")}


def tiny_checkout(tmp) -> str:
    root = str(tmp)
    shutil.copytree(os.path.join(REPO, "dgqbench"), os.path.join(root, "dgqbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    for sub in ("configs", "traffic", "limits"):
        for f in os.listdir(os.path.join(DATA, sub)):
            shutil.copy(os.path.join(DATA, sub, f), os.path.join(root, "dgqbench", sub, f))
    for work, (conf, traffic) in TINY.items():
        bench["configs"].append({"name": conf, "source": "https://example.org/tiny",
                                 "file": f"dgqbench/configs/{conf}.json", "reduced": ["unet"],
                                 "why": "tiny"})
        bench["workloads"].append({"name": work, "config": conf, "traffic": traffic, "chips": 1,
                                   "why": "tiny"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            gen = "sd14_gen_b4" in m["workloads"]
            m["workloads"].append("tiny_gen" if gen else "tiny_recon")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
