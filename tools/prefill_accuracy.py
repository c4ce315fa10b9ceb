"""Distance of the prefill kernels and their plain versions from float64.

    python3 tools/prefill_accuracy.py                 # on a machine with a card
    python3 tools/prefill_accuracy.py --large-logits  # mixtral and internvl2

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

``--large-logits`` studies instead the bf16 attention inputs whose logits
reach ~1000 (mixtral_8x7b at 8 layers, 1 x 8192; internvl2_26b at 24
layers, 2 x 4096 text + 256 vision positions): where the wgmma kernel's
distance from float64 arises.  First the kernel's P V adder, through the
one-tile probe (``adder_probe``).  Then, per input, each output's
distance beyond its own bf16 rounding (half an ulp, 2^-8 of the exact
value) for the kernel and for plain versions that each take one of its
arithmetic choices (the logits S = q k^T on the tensor cores, TF32
holding the bf16 values exactly; P split into bf16 hi + lo), and the
largest ratio of each one's distance from the plain float32 version to
the 2e-2 band.  Then, at the kernel's worst outputs, the row's logits
from the kernel's own S product (the probe: the same descriptors and
instruction sequence), from float32 FMAs and from TF32, each through a
float64 softmax and P V; and the kernel's order emulated on the probe's
logits (``emulate_kernel``), with the rescale fused or not and the sums
rounded to nearest or toward zero: the variant that gives the kernel's
output names the step where its distance arises.
"""
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

PHASES = (("granite", "granite_3_2b", 1, 4096),
          ("danube", "h2o_danube_3_4b", 1, 8192),
          ("mamba", "mamba2_370m", 2, 4096))
#: (label, arch, layers, batch, prompt length): chip_smoke.py's phases
LARGE = (("mixtral", "mixtral_8x7b", 8, 1, 8192),
         ("internvl2", "internvl2_26b", 24, 2, 4096))


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


def beyond(a, exact):
    """Max distance from float64 beyond each output's bf16 rounding."""
    return float(((a.double() - exact).abs() - 2.0 ** -8 * exact.abs())
                 .max())


def band(a, want, tol=2e-2):
    """Largest |a - want| / (tol + tol |want|): above 1 misses the band."""
    a, want = a.float(), want.float()
    return float(((a - want).abs() / (tol + tol * want.abs())).max())


def on_tensor_cores(on, eq, *xs):
    """``torch.einsum(eq, *xs)`` with TF32 on (the tensor cores) or off
    (float32 FMAs)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        return torch.einsum(eq, *xs)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def plain_variant(q, k, v, *, causal, window=0, s_tc=False, p_split=False):
    """``ref.mha_reference`` on bf16 inputs with the logits formed on the
    tensor cores (``s_tc``) and/or P = exp(s - max) multiplied as bf16
    hi + lo (``p_split``), the rest in float32 FMAs."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    kf, vf = k.float(), v.float()
    kpos = torch.arange(skv, device=q.device)
    out = torch.empty_like(q)
    for q0 in range(0, sq, ref.MHA_BLOCK_Q):
        qg = q[:, q0:q0 + ref.MHA_BLOCK_Q].float()
        n = qg.shape[1]
        qg = qg.reshape(b, n, kvh, h // kvh, d)
        s = on_tensor_cores(s_tc, "bqkrd,bskd->bkrqs", qg, kf) * d ** -0.5
        qpos = torch.arange(q0, q0 + n, device=q.device)[:, None]
        mask = torch.ones((n, skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos
        if window:
            mask &= kpos[None, :] > qpos - window
        s = torch.where(mask, s, -torch.inf)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        del s
        parts = (p,)
        if p_split:
            hi = p.bfloat16().float()
            parts = (hi, (p - hi).bfloat16().float())
        o = sum(torch.einsum("bkrqs,bskd->bqkrd", x, vf) for x in parts)
        l = p.sum(-1).permute(0, 3, 1, 2)[..., None]
        out[:, q0:q0 + n] = (o / l).reshape(b, n, h, d).to(q.dtype)
        del p, parts, o
    return out


def probe(lib, q, k, v):
    """The one-tile probe: (q k^T, bf16(q k^T) v) in f32 for q (64, D),
    k and v (128, D) bf16."""
    d = q.shape[1]
    s = torch.empty(64, 128, device="cuda")
    o = torch.empty(64, 64 * ((d + 63) // 64), device="cuda")
    build.check("flash_attention", lib.flash_attention_wgmma_probe(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), s.data_ptr(),
        o.data_ptr(), d, torch.cuda.current_stream().cuda_stream),
        "tile probe")
    torch.cuda.synchronize()
    return s, o[:, :d]


def adder_probe(lib):
    """How the kernel's P V product (wgmma, f32 accumulator) sums: with
    k the identity the probe's o is q v, so each row of q is a row of P.
    Against a term of 128 (2^7; a float32 ulp there is 2^-16): a second
    term 2^-r in the same 16-key instruction or in the next one (the
    accumulator carried), +-0.75 ulp (round to nearest or toward zero),
    and fifteen half-ulp terms in one instruction (summed before one
    rounding, or each rounded).  Prints each row's sum by the probe, by
    float32 FMAs and exactly."""
    d = 128
    eye = torch.eye(128, d, device="cuda").bfloat16()
    v = torch.zeros(128, d, device="cuda")
    v[0], v[1:] = 128.0, 1.0
    p = torch.zeros(64, 128, device="cuda", dtype=torch.float64)
    p[:, 0] = 1.0
    rows = []
    for r in range(12, 28):
        p[len(rows), 1] = 2.0 ** -r
        rows.append(f"2^-{r} in the same instruction")
    for r in range(12, 28):
        p[len(rows), 16] = 2.0 ** -r
        rows.append(f"2^-{r} in the next instruction")
    for sign in (1, -1):
        p[len(rows), 1] = sign * 0.75 * 2.0 ** -16
        rows.append(f"{sign * 0.75:+} ulp in the same instruction")
    p[len(rows), 1:16] = 2.0 ** -17
    rows.append("fifteen half-ulp terms in the same instruction")
    p[len(rows), 16:31] = 2.0 ** -17
    rows.append("fifteen half-ulp terms in the next instruction")
    q = p.bfloat16()
    assert torch.equal(q.double(), p), "a probe term is not a bf16 value"
    _, o = probe(lib, q, eye, v.bfloat16())
    fma = on_tensor_cores(False, "qs,sd->qd", q.float(), v)
    exact = p @ v.double()
    ulp = 2.0 ** -16
    for i, name in enumerate(rows):
        print(f"  adder: {name}: exact 128 + {(exact[i, 0] - 128) / ulp:g} "
              f"ulp, wgmma 128 + {(float(o[i, 0]) - 128) / ulp:g}, float32 "
              f"FMAs 128 + {(float(fma[i, 0]) - 128) / ulp:g}")


def f32_toward_zero(x):
    """x (float64) to the float32 next to it on zero's side."""
    y = np.float32(x)
    if abs(float(y)) > abs(x):
        y = np.nextafter(y, np.float32(0))
    return y


def emulate_kernel(s_row, vcol, d, toward_zero=False, fused=True):
    """One output of the wgmma kernel from its own logits ``s_row`` (S,
    float32, -inf where masked) and one value column ``vcol`` (S,), in
    its order: 128-key tiles, the online softmax in float32 (scale and
    log2 e folded into one factor c, p = 2^(s c - ms) with ms = m c
    rounded, the rescale), P split into bf16 hi + lo, then 8 16-key
    products of hi and 8 of lo, each step's 16 products summed exactly
    and added to the float32 accumulator, rounded to nearest (as an FMA
    rounds) or ``toward_zero``.  The rescale is 2^(m_old c - ms_new) with
    m_old c exact (``fused``: one FMA) or rounded first."""
    c = np.float32(np.float32(d ** -0.5) * np.float32(1.4426950408889634))
    s_row = s_row.double().cpu()
    vcol = vcol.double().cpu()
    m, l, acc = -math.inf, np.float32(0), np.float32(0)
    for t0 in range(0, s_row.shape[0], 128):
        st, vt = s_row[t0:t0 + 128], vcol[t0:t0 + 128]
        mx = max(m, float(st.max()))
        if mx == -math.inf:
            continue
        ms = np.float32(np.float32(mx) * c)
        mc = m * float(c) if fused else float(np.float32(m) * c)
        corr = np.float32(2.0 ** float(np.float32(mc - float(ms))))
        arg = (st * float(c) - float(ms)).float()
        pt = torch.exp2(arg.double()).float()
        l = np.float32(l * corr + np.float32(float(pt.double().sum())))
        acc = np.float32(acc * corr)
        hi = pt.bfloat16().float()
        lo = (pt - hi).bfloat16().float()
        for part in (hi, lo):
            for g in range(0, pt.shape[0], 16):
                x = float(acc) + float((part[g:g + 16].double()
                                        * vt[g:g + 16]).sum())
                acc = f32_toward_zero(x) if toward_zero else np.float32(x)
        m = mx
    return float(np.float32(acc / l))


def probe_logits(lib, qrows, krows):
    """q k^T of 64 query rows (64, D) against every key (S, D), both bf16,
    through the wgmma kernel's one-tile probe, 128 keys a launch."""
    d, skv = qrows.shape[1], krows.shape[0]
    s = torch.empty(64, skv, device="cuda")
    for t0 in range(0, skv, 128):
        kt = torch.zeros(128, d, dtype=torch.bfloat16, device="cuda")
        kt[:min(128, skv - t0)] = krows[t0:t0 + 128]
        s[:, t0:t0 + 128] = probe(lib, qrows, kt, kt)[0][
            :, :min(128, skv - t0)]
    return s


def worst_outputs(lib, q, k, v, kw, got, exact, n=3):
    """At the kernel's ``n`` worst outputs beyond rounding: the row's
    logits by the probe, float32 FMAs and TF32, their largest distance
    and mean signed distance (toward larger |s| > 0) from float64, and
    the output each gives through a float64 softmax and P V."""
    b_, sq, h, d = q.shape
    kvh = k.shape[2]
    err = (got.double() - exact).abs() - 2.0 ** -8 * exact.abs()
    for flat in torch.topk(err.flatten(), n).indices.tolist():
        b, rest = divmod(flat, sq * h * d)
        pos, rest = divmod(rest, h * d)
        hh, dd = divmod(rest, d)
        g = hh // (h // kvh)
        q0 = min(pos - pos % 64, sq - 64)
        qrows = q[b, q0:q0 + 64, hh].contiguous()
        krows = k[b, :, g].contiguous()
        kpos = torch.arange(k.shape[1], device=q.device)
        valid = torch.ones_like(kpos, dtype=torch.bool)
        if kw.get("causal"):
            valid &= kpos <= pos
        if kw.get("window"):
            valid &= kpos > pos - kw["window"]
        s64 = krows.double() @ qrows[pos - q0].double()
        row = {"probe": probe_logits(lib, qrows, krows)[pos - q0]}
        for name, tc in (("f32", False), ("tf32", True)):
            row[name] = on_tensor_cores(tc, "qd,sd->qs", qrows.float(),
                                        krows.float())[pos - q0]
        print(f"  worst output (b {b}, pos {pos}, head {hh}, dim {dd}): "
              f"kernel {float(got[b, pos, hh, dd])}, float64 "
              f"{float(exact[b, pos, hh, dd])}; |s| max "
              f"{float(s64[valid].abs().max())}")
        vrows = v[b, :, g].double()
        for name, s in row.items():
            diff = (s.double() - s64)[valid]
            sign = torch.sign(s64[valid])
            x = torch.where(valid, s.double() / math.sqrt(d), -torch.inf)
            out = torch.softmax(x, 0) @ vrows[:, dd]
            print(f"    S by {name}: max |s - s64| {float(diff.abs().max())}"
                  f", mean signed {float((diff * sign).mean())}; output "
                  f"through float64 softmax and P V {float(out)}")
        sk = torch.where(valid, row["probe"], -torch.inf)
        for name, opts in (
                ("fused rescale, sums rounded to nearest", {}),
                ("fused rescale, sums rounded toward zero",
                 dict(toward_zero=True)),
                ("rescale from the rounded maxima", dict(fused=False))):
            print(f"    the kernel's order on the probe's S, {name}: "
                  f"{emulate_kernel(sk, v[b, :, g, dd], d, **opts)}")


def large_logits():
    """The study of ``--large-logits`` (module docstring)."""
    rec = cs.PrefillRecorder(ops)
    lib = build.library("flash_attention")
    adder_probe(lib)
    for label, arch, layers, b, s in LARGE:
        cfg = get_config(arch).replace(n_layers=layers)
        cs.prefill_phase(label, cfg, b, s, rec)
        torch.cuda.empty_cache()
        for (phase, kernel, layer), (t, kw) in sorted(rec.inputs.items()):
            if phase != label or kernel != "flash_attention":
                continue
            q, k, v = t
            print(phase, layer, list(q.shape), list(k.shape), kw,
                  "absmax q, k, v", *(float(x.float().abs().max())
                                      for x in t))
            exact = ref.mha_reference(q.double(), k.double(), v.double(),
                                      **kw)
            got = fa.flash_attention(q, k, v, **kw)
            want = ref.mha_reference(q, k, v, **kw)
            print(f"  kernel: beyond rounding {beyond(got, exact)}, vs "
                  f"plain / band {band(got, want)}")
            print(f"  plain float32: beyond rounding {beyond(want, exact)}")
            for name, opts in (
                    ("S on tensor cores", dict(s_tc=True)),
                    ("P = hi + lo", dict(p_split=True)),
                    ("both", dict(s_tc=True, p_split=True))):
                alt = plain_variant(q, k, v, **kw, **opts)
                print(f"  plain, {name}: beyond rounding "
                      f"{beyond(alt, exact)}, vs plain / band "
                      f"{band(alt, want)}, kernel vs it / band "
                      f"{band(got, alt)}")
                del alt
            worst_outputs(lib, q, k, v, kw, got, exact)
            del exact, got, want
        rec.inputs.clear()
        torch.cuda.empty_cache()


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
    print(cs.gpu_name_power())
    if "--large-logits" in sys.argv[1:]:
        return large_logits()
    rec = cs.PrefillRecorder(ops)
    for label, arch, b, s in PHASES:
        cs.prefill_phase(label, get_config(arch), b, s, rec)
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
