"""Build and load the hand-written CUDA kernels of `dgq_tpu_torch/csrc/`.

`nvcc` compiles each `csrc/*.cu` into a shared library of its own with a
plain C interface (no PyTorch headers, so a build takes seconds), one
compiler process per source, all started together; `ctypes` loads them. The
libraries are built at first use into `build/dgq_tpu_torch/` at the
repository root, under names keyed on a hash of the source, the shared
headers (`csrc/*.cuh`) and the flags; each is written under a temporary name
and renamed into place, so concurrent processes never load a half-written
file. A missing `nvcc` or a failed build raises: there is no fallback.

`refuse_grad` is the guard every public kernel entry calls first: a kernel
writes into a fresh tensor through ctypes, so its result has no grad_fn and
a gradient through it would be zero without a word.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dgq_tpu_torch"
# --split-compile=0: each compiler optimizes the kernels of its source in parallel, on
# every core (attention.cu holds most of the instances and bounds the build)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0",
)

def refuse_grad(entry: str, *tensors) -> None:
    """Raise RuntimeError, naming `entry`, when grad mode is on and one of
    `tensors` requires grad: the kernels have no backward."""
    if torch.is_grad_enabled() and any(torch.is_tensor(t) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{entry}: an input requires grad, and the kernel has no backward (its result "
            f"would carry no gradient). Call it under torch.no_grad(), or differentiate the "
            f"plain layers (QConfig(use_pallas_attention=False), no fused group conv or int8 "
            f"matmul)")


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_S = ctypes.POINTER(ctypes.c_longlong)  # host array of strides
# source stem -> {C function: argument types}
_SIGNATURES = {
    "attention": {
        # q, k, v, o, bh, t, s, d, scale, is_bf16, form, stream
        "dgq_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P),
        # q, k, v, o, bh, t, s, d, scale, delta, sm_bits, is_bf16, form, stream
        "dgq_uniform_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _I, _I, _I, _P),
        # q, k, z, red, bh, t, s, d, scale, start_peak, is_bf16, form, stream
        "dgq_rt_stats": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _P),
        # q, k, v, o, z, red, bh, t, s, d, scale, sm_bits, start_peak, is_bf16, form, stream
        "dgq_quant_accum": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P),
        # q, k, v, o, bh, t, s, d, scale, delta, sm_bits, uniform, start_peak, is_bf16, form,
        # stream
        "dgq_static_quant_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _I, _I, _I, _I,
                                       _I, _P),
        # the packed head-slot forms: (bh, t, s, d) becomes (b, heads, t, s, d, slot, strides)
        "dgq_flash_attention_packed": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _S, _F, _I, _I,
                                       _P),
        "dgq_uniform_attention_packed": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _S, _F, _P, _I,
                                         _I, _I, _P),
        "dgq_rt_stats_packed": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _S, _F, _I, _I, _I, _P),
        "dgq_quant_accum_packed": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _S, _F, _I, _I,
                                   _I, _I, _P),
        "dgq_static_quant_attention_packed": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _S, _F, _P,
                                              _I, _I, _I, _I, _I, _P),
    },
    "group_conv": {
        # x, w_t, rd, z, bias, out, partial, b, h, w, c, o, kh, kw, pad, a_bits, is_bf16,
        # form, splits, steps_per_split, stream
        "dgq_group_quant_conv": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _P),
        # w, s_t, s_c, s_o, dm, zm, s_dt, s_dc, dl, zl, w_t, rd, z, taps, c, o, is_bf16,
        # scales_bf16, stream
        "dgq_group_conv_fold": (_P, _L, _L, _L, _P, _P, _L, _L, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _I, _P),
        # w, s_t, s_c, s_o, dm, zm, s_dt, s_dc, dl, zl, panels, rd, z, taps, c, o,
        # scales_bf16, stream
        "dgq_group_conv_fold_panels": (_P, _L, _L, _L, _P, _P, _L, _L, _P, _P, _P, _P, _P, _I, _I,
                                       _I, _I, _P),
    },
    "int8_matmul": {
        # x, wq, dx, zx, wsum, dw, zw, bias, out, dbg_codes, dbg_xsum, ws, counters, m, n,
        # k, a_bits, is_bf16, bias_bf16, form, splits, steps_per_split, stream
        "dgq_int8_matmul": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _P),
    },
}

_kernels = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (not on PATH, no CUDA_HOME): cannot build "
                       "the dgq_tpu_torch CUDA kernels")


def library_paths() -> dict:
    """{source stem: path of its shared library} for the current sources,
    headers and flags."""
    shared = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for hdr in sorted(CSRC.glob("*.cuh")):
        shared.update(hdr.name.encode())
        shared.update(hdr.read_bytes())
    paths = {}
    for src in sorted(CSRC.glob("*.cu")):
        h = shared.copy()
        h.update(src.read_bytes())
        paths[src.stem] = BUILD_DIR / f"libdgq_{src.stem}_{h.hexdigest()[:16]}.so"
    return paths


def build_kernels() -> dict:
    """Compile the libraries that are not built yet, in parallel; return
    `library_paths()`. Each compiler's resource report (`-Xptxas -v`) is kept
    beside its library as `<library>.log`."""
    paths = library_paths()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for stem, out in paths.items():
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(CSRC / f"{stem}.cu")]
        running.append((stem, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failures = []
    for stem, out, tmp, proc in running:
        try:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{stem}.cu: nvcc failed ({proc.returncode}):\n{stderr}")
                continue
            out.with_suffix(".log").write_text(stdout + stderr)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


class _Kernels:
    """The C functions of every library, by name."""


def load_kernels() -> _Kernels:
    """The kernels, built on first use, with argument types declared."""
    global _kernels
    if _kernels is None:
        kernels = _Kernels()
        for stem, path in build_kernels().items():
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES[stem].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                setattr(kernels, name, fn)
        _kernels = kernels
    return _kernels
