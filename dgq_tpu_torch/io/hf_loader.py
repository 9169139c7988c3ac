"""Local HF snapshot loading (port of `dgq_tpu/io/hf_loader.py`): state dicts
from .safetensors / .bin / .pth files or snapshot directories. Nothing is
downloaded.

`safetensors` is imported only when a .safetensors file is read, so the
package imports (and reads .bin / .pth files) where it is not installed.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

_CANDIDATES = (
    "diffusion_pytorch_model.safetensors",
    "diffusion_pytorch_model.bin",
    "model.safetensors",
    "pytorch_model.bin",
    "unet.pth",
)


def resolve_state_file(path: str) -> str:
    if os.path.isfile(path):
        return path
    if os.path.isdir(path):
        for cand in _CANDIDATES:
            p = os.path.join(path, cand)
            if os.path.exists(p):
                return p
        hits = [f for f in os.listdir(path)
                if f.endswith((".safetensors", ".bin", ".pth"))]
        if hits:
            return os.path.join(path, sorted(hits)[0])
    raise FileNotFoundError(f"no state dict found at {path}")


def load_state_dict_any(path: str) -> Dict[str, np.ndarray]:
    """Load a torch / safetensors state dict as {name: numpy}: every
    floating tensor as float32 (fp16 and bf16 upcast exactly); a
    safetensors file's integer tensors keep their dtype, a torch file's
    become float32 too, as in the JAX package."""
    f = resolve_state_file(path)
    if f.endswith(".safetensors"):
        try:
            from safetensors import safe_open
        except ImportError as exc:
            raise ImportError(f"reading {f} needs the safetensors package, which is not "
                              "installed") from exc
        out = {}
        with safe_open(f, framework="pt") as sf:
            for k in sf.keys():
                v = sf.get_tensor(k)
                out[k] = (v.float() if v.is_floating_point() else v).numpy()
        return out
    state = torch.load(f, map_location="cpu", weights_only=False)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    if "state_dict" in state and isinstance(state["state_dict"], dict):
        state = state["state_dict"]
    return {k: v.float().numpy() for k, v in state.items() if hasattr(v, "numpy")}
