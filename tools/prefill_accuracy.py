"""Distance of the prefill kernels and their plain versions from float64.

    python3 tools/prefill_accuracy.py             # on a machine with a card

Prefills granite_3_2b (1 x 4096), h2o_danube_3_4b (1 x 8192) and
mamba2_370m (2 x 4096) at full width on seed-0 weights through
``chip_smoke.py``'s phase, keeps the first and last layer's kernel
inputs, and prints for each, in float32: the inputs' largest magnitudes,
and the max abs distance of the kernel and of the plain version from the
plain version run in float64 (SSD at chunks 64 and 256).  It shows how
far any float32 evaluation lands from the exact result at the path's
activations, which sets the kernel-vs-plain check of ``chip_smoke.py``'s
float32 rows at captured inputs.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

PHASES = (("granite", "granite_3_2b", 1, 4096, "flash_attention"),
          ("danube", "h2o_danube_3_4b", 1, 8192, "flash_attention"),
          ("mamba", "mamba2_370m", 2, 4096, "ssd_scan"))


def dist(a, exact):
    return float((a.double() - exact).abs().max())


def main():
    if not torch.cuda.is_available():
        sys.exit("prefill_accuracy: needs a CUDA card")
    build.build(("flash_attention", "ssd_scan"))
    rec = cs.PrefillRecorder(ops)
    for label, arch, b, s, kernel in PHASES:
        cs.prefill_phase(label, get_config(arch), b, s, kernel, rec)
        torch.cuda.empty_cache()
    for (phase, kernel, layer), (t, kw) in sorted(rec.inputs.items()):
        if kernel == "flash_attention":
            q, k, v = (x.float() for x in t)
            print(phase, layer, "absmax q, k, v", float(q.abs().max()),
                  float(k.abs().max()), float(v.abs().max()))
            exact = ref.mha_reference(q.double(), k.double(), v.double(),
                                      **kw)
            got = fa.flash_attention(q, k, v, **kw)
            want = ref.mha_reference(q, k, v, **kw)
            print("  from float64: kernel", dist(got, exact), "plain",
                  dist(want, exact), "out absmax", float(exact.abs().max()))
            continue
        x, dt, a, B, C = t
        x, B, C = x.float(), B.float(), C.float()
        print(phase, layer, "absmax x, B", float(x.abs().max()),
              float(B.abs().max()), "dt max", float(dt.max()))
        ey, es = ref.ssd_reference(x.double(), dt, a, B, C)
        wy, ws = ref.ssd_reference(x, dt, a, B, C)
        for chunk in (64, 256):
            y, st = ssd.ssd_scan(x, dt, a, B, C, chunk=chunk,
                                 y_dtype=torch.float32)
            print(f"  chunk {chunk} from float64: y kernel {dist(y, ey)} "
                  f"plain {dist(wy, ey)}; state kernel {dist(st, es)} plain "
                  f"{dist(ws, es)}; y absmax {float(ey.abs().max())}")


if __name__ == "__main__":
    main()
