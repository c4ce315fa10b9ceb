"""Build and check the port's flash-decode and SSD-scan kernels on the card,
then time them at the main path's shapes.

    python3 tools/probe_decode_scan.py [--src DIR] [--tag NAME]

on a machine with a card.  ``--src`` imports ``repro_torch`` from
``DIR/src`` instead of this checkout's (an unpacked earlier commit, so
that two versions of the kernels are timed in one call, in turns) and
skips step 2; the case lists, checks and timers are this checkout's
``chip_smoke.py``'s.

1. builds both libraries and prints what ``-Xptxas -v`` reports for each
   kernel (registers, shared memory, spill bytes);
2. runs ``chip_smoke.py``'s kernel-against-plain checks, untimed, at its
   decode and SSD cases and edge cases (``check_decode``,
   ``check_ssd``);
3. times ``flash_decode`` on random inputs at the shapes, dtypes and
   kv_len of ``chip_smoke.py``'s captured rows (granite_3_2b's serve path
   at steps 0, 745 and 1489: q (8, 32, 64) on a (8, 4096, 8, 64) bf16
   cache; the cross path's smoke config, f32 q on a bf16 cache, at steps
   0, 19 and 37), and ``ssd_scan`` at mamba2_370m's
   prefill shape (x (8, 4096, 32, 64) bf16, N 128, y f32) at chunks 64,
   128 and 256: CUDA-event ms through the wrapper, device ms and device
   kernels per call from torch.profiler, each device kernel's share, and
   ``scaled_dot_product_attention`` beside the decode rows.

Prints chip_smoke's ``[kernels]`` line for each check and one JSON line
for each timed row (redirect the output to keep them).
``chip_smoke.py`` is the full check; this is the quick one.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

#: the captured decode rows of chip_smoke.py's serve and cross paths:
#: (path, step, (B, S, H, KVH, D), q dtype, cache dtype, kv_len)
BF16, F32 = torch.bfloat16, torch.float32
CAPTURED = (("serve", 0, (8, 4096, 32, 8, 64), BF16, BF16, [1] * 8),
            ("serve", 745, (8, 4096, 32, 8, 64), BF16, BF16,
             [746, 119, 746, 746, 518, 670, 241, 373]),
            ("serve", 1489, (8, 4096, 32, 8, 64), BF16, BF16,
             [903, 863, 1033, 834, 518, 670, 241, 433]),
            ("cross", 0, (4, 64, 4, 2, 16), F32, BF16, [1] * 4),
            ("cross", 19, (4, 64, 4, 2, 16), F32, BF16, [20, 20, 20, 11]),
            ("cross", 37, (4, 64, 4, 2, 16), F32, BF16, [18, 23, 21, 19]))
MAMBA = (8, 4096, 32, 64, 128)  # B, S, H, P, N
ROWS = []


def emit(row):
    ROWS.append(row)
    print(json.dumps(row), flush=True)


def kernel_split(fn, reps):
    """Device ms per call, and launches per call, of each device kernel
    ``fn`` launches."""
    return {a.key[:60]: (a.self_device_time_total / 1e3 / reps,
                         a.count / reps)
            for a in cs.device_kernels(fn, reps)[0] or ()}


def checks(fd, ssd, ref, rng):
    for name, q, k, v, kv_len in cs.decode_case_inputs(rng):
        ROWS.append(cs.check_decode(name, q, k, v, kv_len, fd, ref,
                                    timed=False))
    for name, args, chunk, y_dtype in cs.ssd_case_inputs(rng):
        ROWS.append(cs.check_ssd(name, args, chunk, y_dtype, ssd, ref,
                                 timed=False)[0])


def decode_times(fd, rng):
    for path, step, (b, s, h, kvh, d), q_dt, kv_dt, lens in CAPTURED:
        q = torch.tensor(rng.standard_normal((b, h, d)), device="cuda",
                         dtype=q_dt)
        k, v = (torch.tensor(rng.standard_normal((b, s, kvh, d)),
                             device="cuda", dtype=kv_dt) for _ in range(2))
        kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")

        def call():
            return fd.flash_decode(q, k, v, kv_len)
        dev_ms, per_call, _ = cs.device_time(call, 50)
        (bound_ms, _, _), n_keys = cs.decode_bound(q, k, kv_len)
        emit({"time": "flash_decode", "path": path, "step": step,
              "kv_keys": n_keys, "ms": cs.cuda_ms(call, 200),
              "device_ms": dev_ms,
              "kernels_per_call": per_call, "bound_ms": bound_ms,
              "bound_share": bound_ms / dev_ms if dev_ms else None,
              "sdpa_ms": cs.sdpa_ms(q, k, v, kv_len),
              "kernels": kernel_split(call, 50)})


def ssd_args(rng, b, s, h, p, n, dtype):
    """Random SSD inputs on the card, x, B_ and C_ in ``dtype``."""
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0)
    a = -np.abs(rng.standard_normal((b, s, h))) * 0.1
    B_, C_ = (rng.standard_normal((b, s, n)) for _ in range(2))
    return (torch.tensor(x, device="cuda").to(dtype),
            torch.tensor(dt, device="cuda", dtype=torch.float32),
            torch.tensor(a, device="cuda", dtype=torch.float32),
            torch.tensor(B_, device="cuda").to(dtype),
            torch.tensor(C_, device="cuda").to(dtype))


def ssd_times(ssd, ref, rng):
    b, s, h, p, n = MAMBA
    args = ssd_args(rng, b, s, h, p, n, torch.bfloat16)
    args = (args[0], args[1], -args[1] * 0.05, args[3], args[4])
    want = None
    for chunk in (64, 128, 256):
        def call():
            return ssd.ssd_scan(*args, chunk=chunk, y_dtype=torch.float32)
        row = {"time": "ssd_scan", "chunk": chunk, "ms": cs.cuda_ms(call, 5)}
        row["device_ms"], row["kernels_per_call"], _ = cs.device_time(call,
                                                                      5)
        row["bound_ms"] = cs.ssd_bound(args[0], args[3], chunk,
                                       torch.float32)[0][0]
        row["kernels"] = kernel_split(call, 3)
        if chunk == 256:
            y, st = call()
            if want is None:
                want = ref.ssd_reference(*args)
            row["y_err"] = float((y - want[0]).abs().max())
            row["state_err"] = float((st - want[1]).abs().max())
            row["ok"] = torch.allclose(y, want[0], rtol=3e-2, atol=3e-2) \
                and torch.allclose(st, want[1], rtol=1e-3, atol=1e-3)
        emit(row)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", default=ROOT)
    parser.add_argument("--tag", default="tree")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_decode_scan: needs a CUDA card")
    sys.path.insert(0, os.path.join(os.path.abspath(opts.src), "src"))
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ssd_scan as ssd
    print(f"[probe] {opts.tag}: repro_torch from {fd.__file__}; card "
          f"{cs.gpu_name_power()}", flush=True)
    build.build(("flash_decode", "ssd_scan"))
    for name, lines in build.BUILD_LOG.items():
        for line in lines:
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)
    rng = np.random.default_rng(0)
    if os.path.samefile(opts.src, ROOT):
        checks(fd, ssd, ref, rng)
    decode_times(fd, rng)
    ssd_times(ssd, ref, rng)
    bad = [r for r in ROWS if r.get("ok") is False]
    print(f"[probe] {opts.tag}: {len(ROWS)} rows, {len(bad)} failed",
          flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
