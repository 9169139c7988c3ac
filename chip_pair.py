#!/usr/bin/env python3
"""Paired runs on one CUDA card: a part of `chip_smoke.py` run from another
checkout (the parent) and from this one in turns, parent, this, this,
parent, each in a process of its own.

    python3 chip_pair.py DIR           # main_paths and cli_path: s a step
    python3 chip_pair.py DIR --walk    # recon_path's (h) command: ms an Adam step by unit kind

DIR is a checkout of the other commit, unpacked under the gitignored build/
(`git archive <commit> | tar -x -C build/parent`). The kernels are built once
into this checkout's build/ and copied into DIR's (their file names hash the
sources, so a checkout whose sources differ builds its own). Each process's
output goes to chiprun_out/pair_<paths|walk>_<side><i>.log, and its
readings are printed, a line each. `--walk` times
`calib.reconstruction.reconstruct_unit` from outside (the card synchronised
around each call), after one warm-up Adam step, so it reads any tree that
has that function.
"""
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "chiprun_out")

PRELUDE = r"""
import os, subprocess, tempfile, time, torch
import chip_smoke as c
from dgq_tpu_torch.ops import build
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
tag = "card: " + card
build.build_kernels(); build.load_kernels()
"""

PATHS = PRELUDE + r"""
c.main_paths(tag); torch.cuda.empty_cache(); c.cli_path(tag)
"""

WALK = PRELUDE + r"""
from dgq_tpu_torch.calib import reconstruction as TR
from dgq_tpu_torch.cli import quantize_weight
w = torch.zeros(1, device="cuda", requires_grad=True)  # the optimiser's first-step setup
opt = torch.optim.Adam([w]); (w * w).sum().backward(); opt.step(); torch.cuda.synchronize()
real, steps = TR.reconstruct_unit, {}
def timed(key, unit, *args, **kw):
    torch.cuda.synchronize(); t0 = time.perf_counter()
    out = real(key, unit, *args, **kw)
    torch.cuda.synchronize()
    steps.setdefault(unit.kind, []).append((time.perf_counter() - t0) / kw["iters"])
    return out
TR.reconstruct_unit = timed
tmp = tempfile.mkdtemp(dir="build")
argv = ["--model", "sd", "--wq", "4", "--cali", "--cali_prompt_data_n", str(c.CALI_PROMPTS),
        "--step_size", str(c.CALI_STEPS), "--iters", str(c.RECON_ITERS), "--cali_data_path",
        os.path.join(tmp, "cali"), "--outdir", os.path.join(tmp, "h")]
t0 = time.perf_counter(); quantize_weight.main(argv); torch.cuda.synchronize()
print(f"PAIR walk {time.perf_counter() - t0:.2f} s | {tag}", flush=True)
for kind, s in sorted(steps.items()):
    print(f"PAIR {kind}: {len(s)} units, {1e3 * sum(s) / len(s):.2f} ms an Adam step | {tag}",
          flush=True)
"""


def reading(line):
    """A process's reading in `line`, shortened to a label and its number, or None."""
    if line.startswith("PAIR"):
        return line
    if "s per step" not in line or "steps: packed" in line:
        return None
    m = re.match(r"(cli_path \(\S+\)).*(w4a8g\d+: \S+ s per step)", line)
    if m:
        return f"{m.group(1)} {m.group(2)}"
    m = re.match(r"([^:]+):.*?\((\S+ s per step)", line)
    return f"{m.group(1)}: {m.group(2)}" if m else line


def run(label, cwd, code):
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True)
    with open(os.path.join(OUT, f"pair_{label}.log"), "w") as f:
        f.write(p.stdout + "\n--- stderr ---\n" + p.stderr)
    print(f"== {label} ({cwd}): exit {p.returncode}, {time.perf_counter() - t0:.1f} s", flush=True)
    for line in filter(None, map(reading, p.stdout.splitlines())):
        print(line, flush=True)
    if p.returncode:
        print(p.stderr[-3000:], flush=True)
    return p.returncode


def main():
    if len(sys.argv) < 2 or not os.path.isfile(os.path.join(sys.argv[1], "chip_smoke.py")):
        raise SystemExit("usage: python3 chip_pair.py DIR [--walk]  (DIR: another checkout)")
    other = os.path.abspath(sys.argv[1])
    walk = "--walk" in sys.argv[2:]
    os.makedirs(OUT, exist_ok=True)
    rc = run("build", HERE, "from dgq_tpu_torch.ops import build; build.build_kernels()")
    shutil.copytree(os.path.join(HERE, "build", "dgq_tpu_torch"),
                    os.path.join(other, "build", "dgq_tpu_torch"), dirs_exist_ok=True)
    mode, code = ("walk", WALK) if walk else ("paths", PATHS)
    for i, (side, cwd) in enumerate((("parent", other), ("this", HERE), ("this", HERE),
                                     ("parent", other))):
        rc |= run(f"{mode}_{side}{i}", cwd, code)
    sys.exit(rc)


if __name__ == "__main__":
    main()
