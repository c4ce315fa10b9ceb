"""Build and bind the CUDA kernels of ``csrc/`` at first use.

``nvcc`` compiles each ``csrc/*.cu`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface, which ``ctypes`` loads (no
PyTorch headers, so a build takes seconds).  ``build()`` starts one
``nvcc`` per missing library, all at once, and waits for them.  Each
library lands in ``_build/`` beside this module, named by a hash of its
source and flags, so a rebuilt source never loads a stale library and a
second process reuses the first one's build.  Nothing is compiled when
the module is imported: the CPU tests import every module on a machine
without ``nvcc``.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: library name -> (source under csrc/, flags beyond NVCC_FLAGS).
#: maxmin builds with -fmad=false, which keeps every a*b+c rounding twice
#: as the plain PyTorch versions (one op per expression) do: its kernels
#: are bit-exact with them.  flash_decode keeps fused multiply-add: its
#: sums run in another order than the plain version's anyway, and it is
#: held to a tolerance, as are flash_attention and ssd_scan.
LIBRARIES = {
    "maxmin": ("maxmin.cu", ("-fmad=false",)),
    "flash_decode": ("flash_decode.cu", ()),
    "flash_attention": ("flash_attention.cu", ()),
    "ssd_scan": ("ssd_scan.cu", ()),
}

#: compiler output of the builds this process made, by library
#: (``-Xptxas -v``: registers, shared memory and spills per kernel);
#: empty for a library found already built
BUILD_LOG: dict = {}

_P, _I, _L, _D, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double, ctypes.c_float
_FILL_ARGS = [_P, _I, _I, _I, _P, _L, _I, _P, _I, _P, _P, _P, _P, _P, _L,
              _I, _D, _I, _I, _I, _I, _P]
_LOSS_ARGS = [_P, _I, _I, _I, _P, _P, _P, _L, _I, _P, _P, _P, _P, _P, _P,
              _L, _D, _D, _D, _I, _I, _P]
_DECODE_ARGS = [_I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P,
                _P, _P, _P]
_ATTN_ARGS = [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
              _P]
_ATTN_WG_ARGS = _ATTN_ARGS[2:]  # no dtype codes: bf16 only
_PROBE_ARGS = [_P, _P, _P, _P, _P, _I, _P]
_SSD_ARGS = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
             _P]
_SIGNATURES = {
    "maxmin": {"maxmin_fill_f32": _FILL_ARGS, "maxmin_fill_f64": _FILL_ARGS,
               "loss_factors_f32": _LOSS_ARGS,
               "loss_factors_f64": _LOSS_ARGS,
               "maxmin_variant": [_I, _I, _I, _I, _I, _I, _I]},
    "flash_decode": {"flash_decode": _DECODE_ARGS},
    "flash_attention": {"flash_attention": _ATTN_ARGS,
                        "flash_attention_wgmma": _ATTN_WG_ARGS,
                        "flash_attention_wgmma_probe": _PROBE_ARGS},
    "ssd_scan": {"ssd_scan": _SSD_ARGS},
}
#: library -> its count of device kernels launched (no arguments, long
#: long): kernels a call without a tracer
KERNEL_COUNT = {"maxmin": "maxmin_kernels_launched",
                "flash_decode": "flash_decode_kernels_launched",
                "ssd_scan": "ssd_scan_kernels_launched"}
_ERROR_STRING = {"maxmin": "kernels_error_string",
                 "flash_decode": "flash_decode_error_string",
                 "flash_attention": "flash_attention_error_string",
                 "ssd_scan": "ssd_scan_error_string"}


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


def source(name: str) -> Path:
    return CSRC / LIBRARIES[name][0]


def flags(name: str) -> tuple:
    return NVCC_FLAGS + LIBRARIES[name][1]


def library_path(name: str) -> Path:
    digest = hashlib.sha256(source(name).read_bytes()
                            + " ".join(flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"{name}_{digest[:16]}.so"


def build(names=None) -> dict:
    """Compile every named library (all by default) whose build does not
    exist yet, one ``nvcc`` each, in parallel; returns name -> path."""
    names = tuple(LIBRARIES) if names is None else tuple(names)
    todo = [n for n in names if not library_path(n).exists()]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for name in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            procs[name] = (tmp, subprocess.Popen(
                [nvcc_path(), *flags(name), "-o", tmp, str(source(name))],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc failed ({proc.returncode}):\n"
                              f"{out}")
                continue
            BUILD_LOG[name] = out.splitlines()
            os.replace(tmp, library_path(name))  # readers never see a part
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for tmp, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return {n: library_path(n) for n in names}


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on first call."""
    lib = ctypes.CDLL(str(build((name,))[name]))
    for fn_name, argtypes in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    err = getattr(lib, _ERROR_STRING[name])
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    if name in KERNEL_COUNT:
        count = getattr(lib, KERNEL_COUNT[name])
        count.argtypes, count.restype = [], ctypes.c_longlong
    return lib


def kernels_launched(name: str) -> int:
    """Device kernels library ``name`` (one of ``KERNEL_COUNT``) has
    launched in this process, by its own count."""
    return getattr(library(name), KERNEL_COUNT[name])()


def check(name: str, code: int, what: str) -> None:
    """Raise when a C entry point of library ``name`` reported a CUDA
    error."""
    if code != 0:
        msg = getattr(library(name), _ERROR_STRING[name])(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
