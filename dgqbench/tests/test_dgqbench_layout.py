"""The benchmark's files: BENCHMARK.json against its contract, every cell's
pieces found by name, a new configuration, traffic mix, limits and metric
taken with no edit to a file that is there, the run refused without a card,
and the imports of the benchmark's modules."""
from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from dgqbench.harness import bench
from dgqbench.tests.helpers import REPO, tiny_checkout

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _bench():
    return json.load(open(os.path.join(REPO, "BENCHMARK.json")))


def test_benchmark_json_keeps_to_its_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["dgqbench"] and b["command"] == ["python3", "dgqbench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    cells = 24  # the most a later benchmark may hold
    assert (2 + 14 * cells) * (b["run_seconds"] + 60) + cells * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.isfile(os.path.join(REPO, c["file"])) and c["file"].startswith("dgqbench/")
        assert json.load(open(os.path.join(REPO, c["file"])))["name"] == c["name"]
    works = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and set(m["workloads"]) <= works and UNIT.match(m["unit"])
        moved = next(e for e in b["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", works))
    assert len(json.dumps(b)) <= 64 * 1024


def test_every_cell_finds_its_pieces_by_name():
    b = _bench()
    for w in b["workloads"]:
        _, _, config, traffic, limits = bench.load_cell(REPO, w["name"])
        assert os.path.isfile(os.path.join(REPO, "dgqbench", "drivers", traffic["kind"] + ".py"))
        assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    for m in b["per_layer"]:
        assert os.path.isfile(os.path.join(REPO, "dgqbench", "metrics", m["name"] + ".py"))


def test_new_files_are_taken_without_an_edit(tmp_path):
    """A configuration, a traffic mix, limits and a per-layer metric dropped
    into a copy as files of their own, and entries in BENCHMARK.json, make a
    cell the runner takes as it stands."""
    root = tiny_checkout(tmp_path)
    with open(os.path.join(root, "dgqbench", "metrics", "batches_seen.gen.py"), "w") as f:
        f.write("def read(rc):\n    return float(rc.window['batches'])\n")
    b = json.load(open(os.path.join(root, "BENCHMARK.json")))
    b["per_layer"].append({"name": "batches_seen.gen", "unit": "batches", "better": "higher",
                           "source": "host_clock", "layer": "UNet step",
                           "moves": "images_per_s", "workloads": ["tiny_gen"]})
    json.dump(b, open(os.path.join(root, "BENCHMARK.json"), "w"))
    r = bench.run_cell(root, "tiny_gen", 2 ** 33 + 7, 0.1, True, 0.0, device="cpu")
    assert r["metrics"]["batches_seen.gen"]["value"] >= 1
    assert r["correct"] is True and list(r)[-2:] == ["checks", "_lines"]


def test_run_refuses_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    p = subprocess.run([sys.executable, "dgqbench/run.py", "--workload", "sd14_gen_b4",
                        "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_fails_without_the_port(tmp_path):
    """A directory with only BENCHMARK.json and dgqbench/ has no program."""
    shutil.copytree(os.path.join(REPO, "dgqbench"), tmp_path / "dgqbench")
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from dgqbench.harness import bench; "
            "bench.run_cell(sys.argv[1], 'sd14_gen_b4', 1, 1, False, 0.0, device='cpu')")
    p = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120,
                       env={"PATH": os.environ["PATH"]})
    assert p.returncode != 0 and "dgq_tpu_torch" in p.stderr and p.stdout.strip() == ""


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    base = os.path.join(REPO, "dgqbench")
    for dirpath, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                names = set(_imports(path))
                assert not names & {"jax", "jaxlib", "flax", "dgq_tpu"}, path
                if os.sep + "reference" + os.sep in path:
                    assert "dgq_tpu_torch" not in names, path


def test_foreign_modules_are_compared_by_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "dgq_tpu_torchish", object())
    assert "dgq_tpu" not in bench.foreign_modules()
    monkeypatch.setitem(sys.modules, "dgq_tpu.ops", object())
    assert "dgq_tpu" in bench.foreign_modules()
