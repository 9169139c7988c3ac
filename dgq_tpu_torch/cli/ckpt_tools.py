"""Checkpoint tools (port of `dgq_tpu/cli/ckpt_tools.py`).

  merge:  python -m dgq_tpu_torch.cli.ckpt_tools merge W_CKPT ACT_CKPT OUT
  check:  python -m dgq_tpu_torch.cli.ckpt_tools check AGGREGATE_CKPT PARTIAL_DIR
          (the per-unit saves of `quantize_weight --partial_dir`, whose
          offsets are in the JAX package's layout and whose lone layers are
          keyed 'layer', are read as such)
  clean:  python -m dgq_tpu_torch.cli.ckpt_tools clean RUN_DIR
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys

import numpy as np


def cmd_merge(args):
    """The activation checkpoint with the weight dict injected (dtypes kept)."""
    from dgq_tpu_torch.io.dgq_ckpt import merge_ckpts

    merge_ckpts(args.weight, args.act, args.out)
    print(f"merged -> {args.out}")


def _partial_key(block: str, key: str) -> str:
    """The aggregate key of a partial save's entry: '<rel>.wqtizer.alpha'
    under the unit, 'layer' standing for a lone layer's own name."""
    if key.startswith("model."):
        return key
    if key.startswith("layer."):
        return f"model.{block}.{key[len('layer.'):]}"
    return f"model.{block}.{key}"


def _as_reference_layout(key: str, v: np.ndarray) -> np.ndarray:
    """A partial save's array in the aggregate's layout: the reconstruction
    saves offsets ('.wqtizer.alpha') in the JAX package's layout (HWIO conv,
    (I, O) linear); the weight file holds them out channel first."""
    if not key.endswith(".wqtizer.alpha"):
        return v
    if v.ndim == 4:
        return np.transpose(v, (3, 2, 0, 1))
    return v.T if v.ndim == 2 else v


def cmd_check(args):
    """Check per-block partial saves against the aggregate state dict."""
    from dgq_tpu_torch.io.dgq_ckpt import load_pth

    agg = load_pth(args.ckpt)
    if "weight" in agg:
        agg = agg["weight"]
    bad = 0
    for fn in sorted(os.listdir(args.partial_dir)):
        if not fn.endswith(".pth"):
            continue
        block = fn[: -len(".pth")]
        part = load_pth(os.path.join(args.partial_dir, fn))
        for k, v in part.items():
            full_key = _partial_key(block, k)
            if full_key not in agg:
                print(f"MISSING {full_key}")
                bad += 1
                continue
            ref = np.asarray(agg[full_key])
            v = _as_reference_layout(k, np.asarray(v))
            if v.shape != ref.shape or not np.allclose(v, ref, atol=1e-6):
                print(f"MISMATCH {full_key}")
                bad += 1
    print("OK" if bad == 0 else f"{bad} mismatches")
    return 1 if bad else 0


def cmd_clean(args):
    """Remove run directories that hold no checkpoint."""
    removed = 0
    for d in sorted(os.listdir(args.run_dir)):
        path = os.path.join(args.run_dir, d)
        if not os.path.isdir(path):
            continue
        if not any(f.endswith((".pth", ".pth_weight_only", "_merged", ".npz"))
                   for f in os.listdir(path)):
            shutil.rmtree(path)
            removed += 1
            print(f"removed {path}")
    print(f"{removed} empty run dirs removed")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="DGQ checkpoint tools (PyTorch port)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    m = sub.add_parser("merge")
    m.add_argument("weight")
    m.add_argument("act")
    m.add_argument("out")
    c = sub.add_parser("check")
    c.add_argument("ckpt")
    c.add_argument("partial_dir")
    cl = sub.add_parser("clean")
    cl.add_argument("run_dir")
    args = ap.parse_args(argv)
    return {"merge": cmd_merge, "check": cmd_check, "clean": cmd_clean}[args.cmd](args) or 0


if __name__ == "__main__":
    sys.exit(main())
