"""Where the device time of the decode and SSD-scan kernels goes.

    python3 tools/kernel_cuts.py          # on a machine with a card

Builds copies of ``csrc/flash_decode.cu`` and ``csrc/ssd_scan.cu`` with one
part of the work cut out (a ``-D`` flag on a copy of the source under the
build directory; the checkout's sources are not touched) and times each
copy with torch.profiler at the main path's shapes, on random inputs:

- ``flash_decode`` on a bf16 (8, 4096, 8, 64) cache with q (8, 32, 64), at
  the serve path's step-0 and last-step kv_len: as built; without the
  merge of the splits (each CTA stops after its partial); without the
  products (the tiles are still copied and waited for); without both;
- ``ssd_scan`` at mamba2_370m's prefill shape (x (8, 4096, 32, 64) bf16,
  N 128, chunk 256, y f32), each of its three kernels: as built; without
  the intra-chunk term (the causal C B^T and its product with x); without
  the inter-chunk term (C S_prev); without both.

Prints one JSON line per row.  A cut copy computes a wrong result; only
its time is read.  The difference between two rows is what the cut part
costs where it is not hidden behind the rest.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

#: library -> (text in its source, the text with a cut switch)
HOOKS = {
    "flash_decode": [
        ("  cg::cluster_group cluster = cg::this_cluster();\n",
         "#ifdef CUT_MERGE\n  return;\n#endif\n"
         "  cg::cluster_group cluster = cg::this_cluster();\n"),
        ("    if (kw0 >= nk) continue;  // this warp's 16 keys are past kv_len\n",
         "    if (kw0 >= nk) continue;  // this warp's 16 keys are past kv_len\n"
         "#ifdef CUT_PRODUCTS\n    continue;\n#endif\n"),
    ],
    "ssd_scan": [
        ("  for (int j0 = 0; j0 <= i0; j0 += 16) {",
         "#ifdef CUT_INTRA\n  for (int j0 = 0; j0 < 0; j0 += 16) {\n#else\n"
         "  for (int j0 = 0; j0 <= i0; j0 += 16) {\n#endif"),
        ("      if (k * 16 < n16) {\n        mma_rows",
         "#ifdef CUT_INTER\n      if (false) {\n#else\n"
         "      if (k * 16 < n16) {\n#endif\n        mma_rows"),
    ],
}


def cut_library(name, cuts):
    """The library ``name`` built from its source with ``cuts`` switched
    on, loaded and typed as ``build.library`` does."""
    src = build.source(name).read_text()
    for old, new in HOOKS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"kernel_cuts: {name} source has changed; "
                               f"no single {old.strip()[:40]!r}")
        src = src.replace(old, new)
    tag = "_".join((name,) + cuts).lower()
    path = build.BUILD_DIR / f"cut_{tag}.cu"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    lib_path = path.with_suffix(".so")
    subprocess.run([build.nvcc_path(), *build.flags(name),
                    *(f"-D{c}" for c in cuts), "-o", str(lib_path), str(path)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn_name, argtypes in build._SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    err = getattr(lib, build._ERROR_STRING[name])
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


def timed_with(lib, fn, reps):
    """Each device kernel's ms per call while ``build.library`` returns
    ``lib``."""
    real = build.library
    build.library = lambda name: lib
    try:
        return {a.key[:40]: a.self_device_time_total / 1e3 / reps
                for a in cs.device_kernels(fn, reps)[0] or ()}
    finally:
        build.library = real


def main():
    if not torch.cuda.is_available():
        sys.exit("kernel_cuts: needs a CUDA card")
    print(f"[cuts] card {cs.gpu_name_power()}", flush=True)
    rng = np.random.default_rng(0)
    b, s, h, kvh, d = 8, 4096, 32, 8, 64
    q = torch.tensor(rng.standard_normal((b, h, d)), device="cuda",
                     dtype=torch.bfloat16)
    k, v = (torch.tensor(rng.standard_normal((b, s, kvh, d)), device="cuda",
                         dtype=torch.bfloat16) for _ in range(2))
    lens = {"step 0": [1] * 8,
            "step 1489": [903, 863, 1033, 834, 518, 670, 241, 433]}
    for cuts in ((), ("CUT_MERGE",), ("CUT_PRODUCTS",),
                 ("CUT_MERGE", "CUT_PRODUCTS")):
        lib = cut_library("flash_decode", cuts)
        for label, kv in lens.items():
            kv_len = torch.tensor(kv, dtype=torch.int32, device="cuda")
            times = timed_with(lib, lambda: fd.flash_decode(q, k, v, kv_len),
                               50)
            print(json.dumps({"kernel": "flash_decode", "cuts": list(cuts),
                              "inputs": label,
                              "device_us": sum(times.values()) * 1e3}),
                  flush=True)
    b, s, h, p, n = 8, 4096, 32, 64, 128
    x = torch.tensor(rng.standard_normal((b, s, h, p)), device="cuda",
                     dtype=torch.bfloat16)
    dt = torch.tensor(np.logaddexp(rng.standard_normal((b, s, h)), 0),
                      device="cuda", dtype=torch.float32)
    B_, C_ = (torch.tensor(rng.standard_normal((b, s, n)), device="cuda",
                           dtype=torch.bfloat16) for _ in range(2))
    args = (x, dt, -0.05 * dt, B_, C_)
    for cuts in ((), ("CUT_INTRA",), ("CUT_INTER",),
                 ("CUT_INTRA", "CUT_INTER")):
        lib = cut_library("ssd_scan", cuts)
        times = timed_with(lib, lambda: ssd.ssd_scan(
            *args, chunk=256, y_dtype=torch.float32), 5)
        print(json.dumps({"kernel": "ssd_scan", "cuts": list(cuts),
                          "ms_by_kernel": times}), flush=True)


if __name__ == "__main__":
    main()
