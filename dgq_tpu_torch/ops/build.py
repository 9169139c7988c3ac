"""Build and load the hand-written CUDA kernels of `dgq_tpu_torch/csrc/`.

`nvcc` compiles every `csrc/*.cu` into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), which `ctypes`
loads. The library is built at first use into `build/dgq_tpu_torch/` at the
repository root, under a name keyed on a hash of the sources and flags; it is
written under a temporary name and renamed into place, so concurrent
processes never load a half-written file. A missing `nvcc` or a failed build
raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dgq_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # q, k, v, o, bh, t, s, d, scale, is_bf16, stream
    "dgq_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    # q, k, v, o, bh, t, s, d, scale, delta, sm_bits, is_bf16, stream
    "dgq_uniform_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _I, _I, _P),
}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (not on PATH, no CUDA_HOME): cannot build "
                       "the dgq_tpu_torch CUDA kernels")


def library_path() -> Path:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdgq_kernels_{h.hexdigest()[:16]}.so"


def build_kernels() -> Path:
    """Compile the kernels if this version is not built yet; return the
    library path. The compiler's resource report (`-Xptxas -v`) is kept
    beside it as `<library>.log`."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sorted(CSRC.glob("*.cu")))]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
        out.with_suffix(".log").write_text(res.stdout + res.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_kernels() -> ctypes.CDLL:
    """The kernel library, built on first use, with argument types declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_kernels()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
