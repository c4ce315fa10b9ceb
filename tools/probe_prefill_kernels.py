"""Build and check the port's prefill kernels on the card, then time them.

    python3 tools/probe_prefill_kernels.py        # on a machine with a card
    python3 tools/probe_prefill_kernels.py --times [--src DIR] [--tag NAME]

A short first call for the flash-attention and SSD-scan kernels of
``src/repro_torch/kernels/csrc/``:

1. builds both and prints, for each kernel, the registers and spill
   bytes ``-Xptxas -v`` reports and, in the SASS of each kernel of the
   attention library (``cuobjdump --dump-sass``), the count of ``HGMMA``
   (wgmma) and ``UTMALDG`` (TMA load) instructions;
2. the one-tile probe of the wgmma variant: one TMA load of q (64, D),
   k and v (128, D), s = q k^T from the shared-memory wgmma and
   o = bf16(s) v from the register-A wgmma, each against
   ``torch.matmul`` of the same tile, at D = 16, 32, 64, 120, 128;
3. holds each kernel against its plain version at
   ``tests/test_kernels.py``'s cases, the prefill path's head shapes and
   the wgmma variant's edge cases, in float32 (SIMT) and bf16 (wgmma);
4. times one call at granite_3_2b-, h2o_danube_3_4b- and
   mamba2_370m-shaped random inputs by CUDA events: the wgmma variant on
   bf16 inputs, the SIMT variant on float32 inputs of the same shape, and
   ``scaled_dot_product_attention``.

``--times`` does only the build's register and spill report and the
wgmma variant's times at the bf16 prefill path's shapes (``SHAPES``),
five rounds of 50 calls each; ``--src DIR`` imports ``repro_torch``
from ``DIR/src`` instead of this checkout's (an unpacked earlier commit),
so two versions can be timed in turns in one call, ``--tag`` names the
version in the output.

``chip_smoke.py`` is the full check; this is the quick one.
"""
import glob
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = ROOT if "--src" not in sys.argv else \
    os.path.abspath(sys.argv[sys.argv.index("--src") + 1])
sys.path.insert(0, os.path.join(SRC, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

#: (B, Sq, Skv, H, KVH, D, causal, window): tests/test_kernels.py's cases,
#: the prefill path's heads, then the wgmma variant's edge cases
ATTN = [(1, 128, 128, 4, 4, 64, True, 0), (2, 256, 256, 8, 2, 64, True, 0),
        (1, 128, 128, 4, 2, 32, False, 0), (2, 256, 256, 4, 4, 64, True, 128),
        (1, 384, 384, 4, 2, 64, True, 96), (1, 192, 192, 2, 1, 16, True, 0),
        (1, 100, 100, 2, 2, 64, True, 0), (1, 200, 200, 32, 8, 120, True, 64),
        (1, 300, 300, 24, 8, 128, False, 50),
        (1, 300, 300, 24, 8, 128, True, 0), (1, 333, 333, 32, 8, 120, True, 40),
        (2, 200, 260, 8, 2, 64, False, 0), (1, 77, 300, 4, 1, 128, True, 0),
        (3, 160, 160, 4, 1, 64, True, 0), (1, 64, 64, 64, 1, 32, True, 0)]
#: (label, q shape, k/v shape, window): the bf16 prefill path's attention
#: layers (all causal)
SHAPES = (("granite", (4, 4096, 32, 64), (4, 4096, 8, 64), 0),
          ("danube", (1, 8192, 32, 120), (1, 8192, 8, 120), 4096),
          ("mixtral", (1, 8192, 32, 128), (1, 8192, 8, 128), 4096),
          ("internvl2", (2, 4352, 48, 128), (2, 4352, 8, 128), 0))
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


def cuobjdump():
    found = shutil.which("cuobjdump")
    if found:
        return found
    for path in ["/usr/local/cuda/bin/cuobjdump"] + glob.glob(
            os.path.join(os.path.dirname(torch.__file__), "..", "triton",
                         "backends", "nvidia", "bin", "cuobjdump")):
        if os.path.exists(path):
            return path
    return None


def sass(lib_path):
    """{kernel: {opcode: count}} from the library's SASS (static
    instruction counts, without the predicate or modifiers)."""
    tool = cuobjdump()
    if tool is None:
        print("sass: no cuobjdump found")
        return {}
    text = subprocess.run([tool, "--dump-sass", str(lib_path)],
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                     line)
        if name and m:
            out[name][m.group(2)] = out[name].get(m.group(2), 0) + 1
    return out


def ptxas(lines):
    """[(kernel, registers, spill store bytes, spill load bytes)] from
    ``-Xptxas -v`` lines, in the order ptxas reports them."""
    out, name, spill = [], None, (0, 0)
    for line in lines:
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), *spill))
            name, spill = None, (0, 0)
    return out


def tile_probe(lib, d, rng):
    """One tile through the wgmma variant's TMA maps and both products."""
    q, k, v = (torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                            device="cuda").to(torch.bfloat16)
               for s in ((64, d), (128, d), (128, d)))
    n = 64 * ((d + 63) // 64)
    s = torch.empty(64, 128, device="cuda")
    o = torch.empty(64, n, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    build.check("flash_attention", lib.flash_attention_wgmma_probe(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), s.data_ptr(),
        o.data_ptr(), d, stream), "tile probe")
    torch.cuda.synchronize()
    want_s = q.float() @ k.float().T
    want_o = s.to(torch.bfloat16).float() @ v.float()
    err_s = float((s - want_s).abs().max())
    err_o = float((o[:, :d] - want_o).abs().max())
    pad = float(o[:, d:].abs().max()) if n > d else 0.0
    ok = err_s <= 1e-3 * float(want_s.abs().max()) and \
        err_o <= 1e-3 * float(want_o.abs().max()) and pad == 0.0
    print(f"tile probe D={d}: s err {err_s:.3e} (|s| max "
          f"{float(want_s.abs().max()):.2f}), o err {err_o:.3e} (|o| max "
          f"{float(want_o.abs().max()):.2f}), padded columns {pad} -> "
          f"{'ok' if ok else 'WRONG'}")
    return ok


def time_versions(tag):
    """``--times``: registers and spills, then the wgmma variant's ms."""
    build.build(("flash_attention",))
    for kernel, regs, stores, loads in ptxas(
            build.BUILD_LOG.get("flash_attention", ())):  # () if built before
        print(f"[{tag}] ptxas {kernel}: {regs} registers, spill stores "
              f"{stores} B, spill loads {loads} B")
    bf = dict(device="cuda", dtype=torch.bfloat16)
    torch.manual_seed(0)
    for label, shape_q, shape_kv, window in SHAPES:
        q = torch.randn(*shape_q, **bf)
        k = torch.randn(*shape_kv, **bf)
        v = torch.randn_like(k)
        got = [ms(lambda: fa.flash_attention(q, k, v, causal=True,
                                             window=window), 50)
               for _ in range(5)]
        print(f"[{tag}] {label} wgmma ms {got}", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("probe_prefill_kernels: needs a CUDA card")
    if "--times" in sys.argv:
        tag = sys.argv[sys.argv.index("--tag") + 1] \
            if "--tag" in sys.argv else "tree"
        print(f"[{tag}] repro_torch from {fa.__file__}")
        return time_versions(tag)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print("python", sys.version.split()[0], "torch", torch.__version__,
          "cuda", torch.version.cuda)
    t0 = time.time()
    paths = build.build(("flash_attention", "ssd_scan"))
    print("build", time.time() - t0)
    for name, lines in build.BUILD_LOG.items():
        for line in lines:
            if "warning" in line or "setmaxnreg" in line:
                print(name, line.strip())
        for kernel, regs, stores, loads in ptxas(lines):
            print(f"ptxas {name} {kernel}: {regs} registers, spill stores "
                  f"{stores} B, spill loads {loads} B")
    for kernel, ops in sass(paths["flash_attention"]).items():
        print(f"sass {kernel}: HGMMA {ops.get('HGMMA', 0)}, UTMALDG "
              f"{ops.get('UTMALDG', 0)}")
        if "wgmma" in kernel:
            print("  opcodes:", sorted(ops.items(), key=lambda x: -x[1])[:24])
    lib = build.library("flash_attention")
    rng = np.random.default_rng(0)
    probes = [tile_probe(lib, d, rng) for d in (16, 32, 64, 120, 128)]
    if not all(probes):
        print("probe_prefill_kernels: the one-tile probe disagrees")
    for b, sq, skv, h, kvh, d, causal, w in ATTN:
        arrays = [rng.standard_normal(s).astype(np.float32)
                  for s in ((b, sq, h, d), (b, skv, kvh, d), (b, skv, kvh, d))]
        for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            q, k, v = (torch.tensor(a, device="cuda").to(dt) for a in arrays)
            fa.reset_launches()
            got = fa.flash_attention(q, k, v, causal=causal, window=w)
            want = ref.mha_reference(q, k, v, causal=causal, window=w)
            kind = [n for n, c in fa.LAUNCHES.items()
                    if c and n != "flash_attention"]
            print("attn", (b, sq, skv, h, kvh, d, causal, w), dt, kind,
                  float((got.float() - want.float()).abs().max()),
                  torch.allclose(got.float(), want.float(), rtol=tol,
                                 atol=tol))
    bf = dict(device="cuda", dtype=torch.bfloat16)
    for label, shape_q, shape_kv, window in SHAPES[:2]:
        q = torch.randn(*shape_q, **bf)
        k = torch.randn(*shape_kv, **bf)
        v = torch.randn_like(k)
        times = {"wgmma": ms(lambda: fa.flash_attention(
            q, k, v, causal=True, window=window))}
        times["simt f32"] = ms(lambda: fa.flash_attention(
            q.float(), k.float(), v.float(), causal=True, window=window), 2)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if not window:
            times["sdpa"] = ms(lambda: torch.nn.functional.
                               scaled_dot_product_attention(
                                   qt, kt, vt, is_causal=True,
                                   enable_gqa=True))
        print(f"{label}-shaped attention ms", times)
    x = torch.randn(8, 4096, 32, 64, **bf)
    dtv = torch.nn.functional.softplus(torch.randn(8, 4096, 32, device="cuda"))
    a = -torch.rand(8, 4096, 32, device="cuda") * 0.1
    B = torch.randn(8, 4096, 128, **bf)
    C = torch.randn_like(B)
    print("mamba-shaped scan ms",
          ms(lambda: ssd.ssd_scan(x, dtv, a, B, C, chunk=256,
                                  y_dtype=torch.float32)))
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

if __name__ == "__main__":
    main()
