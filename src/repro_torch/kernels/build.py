"""Build and bind the CUDA kernels of ``csrc/`` at first use.

``nvcc`` compiles ``csrc/maxmin.cu`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, which ``ctypes`` loads (no PyTorch
headers, so the build takes seconds).  The library lands in ``_build/``
beside this module, named by a hash of the source and the flags, so a
rebuilt source never loads a stale library and a second process reuses
the first one's build.  Nothing is compiled when the module is imported:
the CPU tests import every module on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "maxmin.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

#: -fmad=false keeps every a*b+c rounding twice, as the plain PyTorch
#: versions (one op per expression) do
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: compiler output of the build this process loaded (``-Xptxas -v``:
#: registers, shared memory and spills per kernel); empty on a cache hit
BUILD_LOG: list = []

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double
_FILL_ARGS = [_P, _I, _I, _I, _P, _L, _I, _P, _P, _P, _P, _P, _P, _P,
              _I, _D, _I, _I, _P]
_LOSS_ARGS = [_P, _I, _I, _I, _P, _P, _P, _L, _I, _P, _P, _P, _P, _P, _P,
              _P, _D, _D, _D, _I, _P]


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``$CUDA_HOME``
    or the toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "need the CUDA toolkit (set CUDA_HOME)")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"maxmin_{digest[:16]}.so"


def build() -> Path:
    """Compile the library unless this source's build already exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                               str(SOURCE)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        BUILD_LOG[:] = (proc.stdout + proc.stderr).splitlines()
        os.replace(tmp, out)             # atomic: readers never see a part
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name in ("maxmin_fill_f32", "maxmin_fill_f64"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = _FILL_ARGS, ctypes.c_int
    for name in ("loss_factors_f32", "loss_factors_f64"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = _LOSS_ARGS, ctypes.c_int
    lib.kernels_error_string.argtypes = [ctypes.c_int]
    lib.kernels_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().kernels_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
