"""Build and check the port's prefill kernels on the card, then time them.

    python3 tools/probe_prefill_kernels.py        # on a machine with a card

A short first call for the flash-attention and SSD-scan kernels of
``src/repro_torch/kernels/csrc/``: builds both (``-Xptxas -v`` lines
printed), holds each against its plain version at
``tests/test_kernels.py``'s cases plus a few head shapes of the prefill
path, in float32 and bf16, then times one call at granite_3_2b-,
h2o_danube_3_4b- and mamba2_370m-shaped random inputs by CUDA events.
``chip_smoke.py`` is the full check; this is the quick one.
"""
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

ATTN = [(1, 128, 128, 4, 4, 64, True, 0), (2, 256, 256, 8, 2, 64, True, 0),
        (1, 128, 128, 4, 2, 32, False, 0), (2, 256, 256, 4, 4, 64, True, 128),
        (1, 384, 384, 4, 2, 64, True, 96), (1, 192, 192, 2, 1, 16, True, 0),
        (1, 100, 100, 2, 2, 64, True, 0), (1, 200, 200, 32, 8, 120, True, 64),
        (1, 300, 300, 24, 8, 128, False, 50)]
SSD = [(1, 256, 2, 64, 64, 128), (2, 128, 4, 32, 64, 64),
       (1, 384, 2, 64, 128, 128), (1, 100, 2, 16, 32, 64),
       (2, 700, 3, 64, 128, 256)]


def ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def main():
    if not torch.cuda.is_available():
        sys.exit("probe_prefill_kernels: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    t0 = time.time()
    build.build(("flash_attention", "ssd_scan"))
    print("build", time.time() - t0)
    for name, lines in build.BUILD_LOG.items():
        for line in lines:
            if "registers" in line or "spill" in line or "entry" in line:
                print(name, line.strip())
    rng = np.random.default_rng(0)
    for b, sq, skv, h, kvh, d, causal, w in ATTN:
        arrays = [rng.standard_normal(s).astype(np.float32)
                  for s in ((b, sq, h, d), (b, skv, kvh, d), (b, skv, kvh, d))]
        for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            q, k, v = (torch.tensor(a, device="cuda").to(dt) for a in arrays)
            got = fa.flash_attention(q, k, v, causal=causal, window=w)
            want = ref.mha_reference(q, k, v, causal=causal, window=w)
            print("attn", (b, sq, skv, h, kvh, d, causal, w), dt,
                  float((got.float() - want.float()).abs().max()),
                  torch.allclose(got.float(), want.float(), rtol=tol,
                                 atol=tol))
    for b, s, h, p, n, ch in SSD:
        x = rng.standard_normal((b, s, h, p)).astype(np.float32)
        dtv = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(
            np.float32)
        a = (-np.abs(rng.standard_normal((b, s, h))) * 0.1).astype(np.float32)
        B = rng.standard_normal((b, s, n)).astype(np.float32)
        C = rng.standard_normal((b, s, n)).astype(np.float32)
        for dt, tol, yd in ((torch.float32, 1e-4, None),
                            (torch.bfloat16, 3e-2, None),
                            (torch.bfloat16, 3e-2, torch.float32)):
            X, Bt, Ct = (torch.tensor(t, device="cuda").to(dt)
                         for t in (x, B, C))
            D, A = torch.tensor(dtv, device="cuda"), torch.tensor(
                a, device="cuda")
            y, S = ssd.ssd_scan(X, D, A, Bt, Ct, chunk=ch, y_dtype=yd)
            yr, Sr = ref.ssd_reference(X, D, A, Bt, Ct)
            print("ssd", (b, s, h, p, n, ch), dt, yd,
                  float((y.float() - yr).abs().max()),
                  float((S - Sr).abs().max()),
                  torch.allclose(y.float(), yr, rtol=tol, atol=tol),
                  torch.allclose(S, Sr, rtol=1e-3, atol=1e-3))
    bf = dict(device="cuda", dtype=torch.bfloat16)
    q = torch.randn(4, 4096, 32, 64, **bf)
    k = torch.randn(4, 4096, 8, 64, **bf)
    v = torch.randn_like(k)
    print("granite-shaped attention ms",
          ms(lambda: fa.flash_attention(q, k, v, causal=True)))
    q = torch.randn(1, 8192, 32, 120, **bf)
    k = torch.randn(1, 8192, 8, 120, **bf)
    v = torch.randn_like(k)
    print("danube-shaped attention ms",
          ms(lambda: fa.flash_attention(q, k, v, causal=True, window=4096)))
    x = torch.randn(8, 4096, 32, 64, **bf)
    dtv = torch.nn.functional.softplus(torch.randn(8, 4096, 32, device="cuda"))
    a = -torch.rand(8, 4096, 32, device="cuda") * 0.1
    B = torch.randn(8, 4096, 128, **bf)
    C = torch.randn_like(B)
    print("mamba-shaped scan ms",
          ms(lambda: ssd.ssd_scan(x, dtv, a, B, C, chunk=256,
                                  y_dtype=torch.float32)))


if __name__ == "__main__":
    main()
