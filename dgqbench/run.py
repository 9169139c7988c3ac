"""Run one cell of the benchmark of the PyTorch/CUDA port once:

    python3 dgqbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (`dgq_tpu_torch/`). The
last line of standard output is the result (JSON); the numbers the check
compared, each with its limit, are the last lines of standard error.
See dgqbench/README.md.
"""
import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache of the run inside the checkout, at fixed paths (the port's
# kernels build into build/dgq_tpu_torch/ by themselves)
for var, sub in (("CUDA_CACHE_PATH", "nv"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", "dgqbench", sub)
os.environ["USE_FLAX"] = "0"

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from dgqbench.harness.bench import main

    sys.exit(main(sys.argv[1:], T0, ROOT))
