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
float32 rows at captured inputs.  The attention inputs are also run in
bf16 through the wgmma kernel (P multiplied as bf16 hi + lo) and through
a plain version that rounds P once to bf16 before P V: distance from
float64 and from the plain version, and whether the 2e-2 check holds,
which is why the kernel splits P.  The SSD inputs are also run in bf16
through the chunk-parallel kernel (every f32 operand of a tensor-core
product split into bf16 hi + lo) and through a plain chunked version
that rounds one such operand once to bf16 instead (``G`` = (C B^T) o L o
dt against x, ``S`` = the carried state against C, ``wx`` = the decayed
dt x against B): distance from the plain recurrence and from float64,
and whether the 3e-2 (y) and 1e-3 (state) checks hold, which is why the
kernel splits each of them.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

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


def p_rounded_once(q, k, v, *, causal, window=0):
    """``ref.mha_reference`` on bf16 inputs with the probabilities
    exp(s - max) rounded once to bf16 before P V, the sum l kept in f32:
    what the wgmma kernel would give without its hi + lo split."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    kf, vf = k.float(), v.float()
    kpos = torch.arange(skv, device=q.device)
    out = torch.empty_like(q)
    for q0 in range(0, sq, ref.MHA_BLOCK_Q):
        qg = q[:, q0:q0 + ref.MHA_BLOCK_Q].float()
        n = qg.shape[1]
        qg = qg.reshape(b, n, kvh, h // kvh, d)
        s = torch.einsum("bqkrd,bskd->bkrqs", qg, kf) * d ** -0.5
        qpos = torch.arange(q0, q0 + n, device=q.device)[:, None]
        mask = torch.ones((n, skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos
        if window:
            mask &= kpos[None, :] > qpos - window
        s = torch.where(mask, s, -torch.inf)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        o = torch.einsum("bkrqs,bskd->bqkrd", p.bfloat16().float(), vf)
        l = p.sum(-1).permute(0, 3, 1, 2)[..., None]
        out[:, q0:q0 + n] = (o / l).reshape(b, n, h, d).to(q.dtype)
    return out


def ssd_rounded_once(x, dt, a, B, C, chunk, once=()):
    """The chunked SSD scan in plain PyTorch, f32 with the chunk's cumsum
    in f64, as the chunk-parallel kernel orders it, with the operands
    named in ``once`` ("G", "S", "wx") rounded once to bf16 before their
    product.  x (B, S, H, P) and B, C (B, S, N) bf16; y and the final
    state f32."""
    def rnd(t, name):
        return t.bfloat16().float() if name in once else t
    b, s, h, p = x.shape
    state = torch.zeros((b, h, B.shape[-1], p), device=x.device)
    y = torch.empty((b, s, h, p), device=x.device)
    for c0 in range(0, s, chunk):
        xs, Bs, Cs = (t[:, c0:c0 + chunk].float() for t in (x, B, C))
        dts = dt[:, c0:c0 + chunk]
        cum = torch.cumsum(a[:, c0:c0 + chunk].double(), 1)   # (b, q, h)
        last = cum[:, -1]
        q = xs.shape[1]
        w = torch.exp((last[:, None] - cum).float()) * dts
        own = torch.einsum("bqn,bqhp->bhnp", Bs,
                           rnd(xs * w[..., None], "wx"))
        tri = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                    device=x.device))[None, :, :, None]
        L = torch.exp((cum[:, :, None] - cum[:, None]).float())
        G = torch.einsum("bin,bjn->bij", Cs, Bs)[..., None] * L \
            * dts[:, None]
        G = rnd(torch.where(tri, G, 0.0), "G")                 # (b, i, j, h)
        y1 = torch.einsum("bijh,bjhp->bihp", G, xs)
        y2 = torch.einsum("bin,bhnp->bihp", Cs, rnd(state, "S")) \
            * torch.exp(cum.float())[..., None]
        y[:, c0:c0 + chunk] = y1 + y2
        state = torch.exp(last.float())[..., None, None] * state + own
    return y, state


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
            q, k, v = t
            want = ref.mha_reference(q, k, v, **kw)
            for name, fn in (("wgmma kernel, P = hi + lo",
                              fa.flash_attention),
                             ("plain, P rounded once", p_rounded_once)):
                got = fn(q, k, v, **kw)
                diff = (got.float() - want.float()).abs()
                print(f"  bf16 {name}: from float64 "
                      f"{dist(got, exact)} (plain {dist(want, exact)}); vs "
                      f"plain max {float(diff.max())}, within 2e-2: "
                      f"{bool((diff <= 2e-2 + 2e-2 * want.float().abs()).all())}")
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
        x, B, C = t[0], t[3], t[4]  # bf16, as the model calls the scan
        ey, es = ref.ssd_reference(x.double(), dt, a, B.double(),
                                   C.double())
        wy, ws = ref.ssd_reference(x, dt, a, B, C)
        for name, fn in (
                ("chunk-parallel kernel, hi + lo", lambda: ssd.ssd_scan(
                    x, dt, a, B, C, chunk=256, y_dtype=torch.float32)),
                ("plain chunked, nothing rounded",
                 lambda: ssd_rounded_once(x, dt, a, B, C, 256)),
                *((f"plain chunked, {op} rounded once",
                   lambda op=op: ssd_rounded_once(x, dt, a, B, C, 256,
                                                  (op,)))
                  for op in ("G", "S", "wx"))):
            y, st = fn()
            dy, ds = (y - wy).abs(), (st - ws).abs()
            print(f"  bf16 {name}: y vs plain max {float(dy.max())}, "
                  f"within 3e-2: "
                  f"{bool((dy <= 3e-2 + 3e-2 * wy.abs()).all())}; state vs "
                  f"plain max {float(ds.max())}, within 1e-3: "
                  f"{bool((ds <= 1e-3 + 1e-3 * ws.abs()).all())}; from "
                  f"float64 y {dist(y, ey)} (plain {dist(wy, ey)}), state "
                  f"{dist(st, es)} (plain {dist(ws, es)})")
            del y, st


if __name__ == "__main__":
    main()
