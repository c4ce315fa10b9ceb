"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the Hopper kernels of ``src/repro_torch/kernels/csrc/`` from the
checkout, drives the port's main path — the fluid flow engine,
``make_engine("flow", topo)`` — through the paper-figure sweeps at full
width, and holds every kernel against its plain PyTorch version on the
card:

1. **build**   ``nvcc`` for ``sm_90a`` (``-Xptxas -v`` printed), the
   card's name and power limit;
2. **paths**   each with the launch counts set to 0 just before it and
   read just after:
   - fig14: HPL gleam vs ring/long on the 1024-host fat tree (scales 8,
     16, 32) and on the 16,384-host fat tree (scales 64, 128);
   - fig15: 4096-member bcasts on the 4096-host fat tree, gleam and
     multiunicast, loss 0 and 1e-3;
   - matrix: churn x loss x link-flap grid, 8 groups x 32 members on the
     4096-host fat tree (dynamic segments, float64 lanes);
   every JCT is held against the port's numpy solver (``flow-np``) at
   rtol 1e-3, and against the JAX package's recorded values where
   ``BENCH_flowsim.json`` has them; segment rates against the numpy
   ``LinkMap.segment_rates_many`` at 1e-6;
3. **kernels** every kernel input the paths produced, in float32 and
   float64, plus random many-round problems: the kernel against its
   plain version (freeze set and rates per round for the first 256
   rounds, then the whole filling, rtol 1e-6 in float32 and 1e-12 in
   float64; loss factors within 1e-6 and exactly 1 on
   all-zero rows), with times from CUDA events.

It prints one ``{"kernels": [...]}`` line, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``; any failed phase exits
non-zero without that line.  Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, non-tensor FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}

KERNELS = {
    "maxmin_fill": "src/repro/kernels/maxmin.py:69",
    "loss_factors": "src/repro/kernels/maxmin.py:232",
}
SOURCE = "src/repro_torch/kernels/csrc/maxmin.cu"

HPL_VOLUME = 8 << 20
HPL_CHUNKS = 8
FIG15_NBYTES = 1 << 20
MATRIX_NBYTES = 1 << 20

#: the fabrics of the path phases: (label, fat_tree kwargs, HPL scales)
FIG14 = (("fig14_1024", dict(n_pods=8, leaves_per_pod=8, hosts_per_leaf=16,
                             aggs_per_pod=8), (8, 16, 32)),
         ("fig14_16384", dict(n_pods=32, leaves_per_pod=16,
                              hosts_per_leaf=32, aggs_per_pod=16), (64, 128)))
FIG15 = dict(n_pods=16, leaves_per_pod=16, hosts_per_leaf=16, aggs_per_pod=16)
#: fat_tree kwargs, groups, members per group
MATRIX = (dict(n_pods=16, leaves_per_pod=16, hosts_per_leaf=16,
               aggs_per_pod=4), 8, 32)
#: rounds held one by one against the plain round (the whole filling is
#: compared however many rounds it takes)
ROUNDS_CHECKED = 256
FAILURES: list = []


def log(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str) -> None:
    FAILURES.append(msg)
    log(f"FAIL {msg}")


def close(got: float, want: float, rtol: float, atol: float = 0.0) -> bool:
    return abs(got - want) <= rtol * abs(want) + atol


# ------------------------------------------------------------- workloads

def hpl_workloads(Workload, hosts, n):
    """fig14: N PB groups (rows) + N RS groups (columns) as gleam
    bcasts; the baseline is ring PB plus the `long` unicast exchange."""
    wg = Workload(f"fig14/gleam_{n}x{n}")
    for row in range(n):
        wg.bcast(hosts[row * n:(row + 1) * n], HPL_VOLUME, key=row)
    for col in range(n):
        wg.bcast([hosts[row * n + col] for row in range(n)], HPL_VOLUME,
                 key=n + col)
    wb = Workload(f"fig14/ring_long_{n}x{n}")
    for row in range(n):
        wb.bcast(hosts[row * n:(row + 1) * n], HPL_VOLUME, transport="ring",
                 chunks=HPL_CHUNKS, key=row)
    for col in range(n):
        members = [hosts[row * n + col] for row in range(n)]
        for i in range(n - 1):
            wb.unicast(members[i], members[i + 1],
                       HPL_VOLUME * (n - 1) // n, key=n + col)
    return wg, wb


def hpl_values(n, g_recs, b_recs):
    jg = max(r.jct(n - 1) for r in g_recs)
    pb = max(r.jct(n - 1) for r in b_recs[:n])
    long_jct = max(r.jct(1) for r in b_recs[n:])
    return jg, max(pb, long_jct)


def matrix_ops(wl, hosts, n_groups, group, churn, n_flaps):
    """One churn x flaps cell: contending bcasts over disjoint host
    blocks, each with leave/join events and plane-0 uplink flaps."""
    spares = n_events = 4
    stride = group + spares
    ops = []
    for g in range(n_groups):
        block = hosts[g * stride:(g + 1) * stride]
        members, spare = block[:group], block[group:]
        events = []
        if churn > 0:
            dt = 1.0 / churn
            for i in range(n_events):
                kind, who = (("leave", members[-1 - i // 2]) if i % 2 == 0
                             else ("join", spare[i // 2]))
                events.append(wl.MemberEvent(kind, who, (i + 1) * dt))
        racks = []
        for m in members[1:]:
            pod, leaf, _ = m[1:].split(".")
            la = (f"L{pod}.{leaf}", f"A{pod}.0")
            if la not in racks:
                racks.append(la)
        faults = tuple(
            wl.FaultEvent("link_flap", 3e-6 + i * 5e-6,
                          node=racks[i % len(racks)][0],
                          peer=racks[i % len(racks)][1], duration=20e-6)
            for i in range(n_flaps))
        ops.append(wl.GroupOp("bcast", members, MATRIX_NBYTES,
                              events=tuple(events), faults=faults))
    return ops


# -------------------------------------------------------------- recording

class Recorder:
    """Wraps the kernel wrappers the solver calls to keep one copy of
    each distinct input (by shape, dtype and solve options) per phase."""

    def __init__(self, mm):
        self.mm = mm
        self.phase = None
        self.inputs: dict = {}
        self._fill, self._loss = mm.maxmin_rates, mm.loss_factors

        def rates(fl, cap, active, **kw):
            key = ("maxmin_fill", self.phase, tuple(fl.shape),
                   tuple(cap.shape), str(cap.dtype), kw.get("tol", 1e-6),
                   kw.get("max_rounds"))
            if self.phase and key not in self.inputs:
                self.inputs[key] = (fl.clone(), cap.clone(),
                                    active.clone(), dict(kw))
            return self._fill(fl, cap, active, **kw)

        def loss(fl, rates_, active, cap, q, wsq, wnd, ecn, **kw):
            key = ("loss_factors", self.phase, tuple(fl.shape),
                   tuple(cap.shape), str(cap.dtype),
                   bool(self.phase and (q != 0).any()))
            if self.phase and key not in self.inputs:
                self.inputs[key] = tuple(t.clone() for t in (
                    fl, rates_, active, cap, q, wsq, wnd, ecn)) + (dict(kw),)
            return self._loss(fl, rates_, active, cap, q, wsq, wnd, ecn, **kw)

        mm.maxmin_rates, mm.loss_factors = rates, loss


class Phase:
    """One main-path phase: launch counts zeroed before, read after."""

    def __init__(self, name, rec, mm, fts, lossy):
        self.name, self.rec, self.mm, self.fts = name, rec, mm, fts
        self.lossy = lossy

    def __enter__(self):
        torch.cuda.synchronize()
        self.fts.reset_solve_stats()
        self.rec.phase = self.name
        self.mm.reset_launches()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.wall = time.perf_counter() - self.t0
        self.launches = dict(self.mm.LAUNCHES)
        self.rec.phase = None
        st = self.fts.SOLVE_STATS
        self.stats = {"wall_s": self.wall, "solve_s": st["solve_s"],
                      "solve_calls": st["calls"], "host_syncs": st["syncs"],
                      "shapes": [list(s) for s in st["shapes"]],
                      "launches": self.launches}
        log(f"[paths] {self.name}: wall {self.wall:.3f} s, solve "
            f"{st['solve_s']:.3f} s in {st['calls']} calls, "
            f"{st['syncs']} host syncs, shapes {st['shapes']}, "
            f"launches {self.launches}")
        if exc[0] is None:
            if self.launches["maxmin_fill"] == 0:
                fail(f"{self.name}: maxmin_fill was never launched")
            if self.lossy and self.launches["loss_factors"] == 0:
                fail(f"{self.name}: loss_factors was never launched")
        return False


def recorded_values():
    """The JAX package's recorded flow JCTs (ms), read as data."""
    try:
        with open(os.path.join(REPO, "BENCH_flowsim.json")) as fh:
            bench = json.load(fh)
    except (OSError, ValueError):
        return {}
    rows = dict(bench.get("after_warm", {}).get("pass1", {}).get("rows", []))
    rows.update(dict(bench.get("loss_sweep", {}).get("rows", [])))
    return rows


def check_jct(label, got_ms, want_ms, recorded):
    ok = close(got_ms, want_ms, 1e-3)
    ref = recorded.get(label)
    note = ""
    if ref is not None:
        # recorded to 4 decimals: allow half a unit of the last digit
        rec_ok = close(got_ms, ref, 1e-3, 5e-5)
        ok = ok and rec_ok
        note = f", JAX package recorded {ref}"
    log(f"[paths]   {label}: {got_ms!r} ms (flow-np {want_ms!r}{note})"
        f"{'' if ok else '  MISMATCH'}")
    if not ok:
        fail(f"{label}: {got_ms} ms vs flow-np {want_ms} ms{note}")
    return {"label": label, "ms": got_ms, "flow_np_ms": want_ms,
            "recorded_ms": ref}


def run_paths(rec, fig14=FIG14, fig15=FIG15, matrix=MATRIX):
    from repro_torch.core import fattree, flowsim_torch as fts
    from repro_torch.core import workload as wl
    from repro_torch.core.engine import make_engine
    from repro_torch.core.flowsim import LinkMap
    from repro_torch.kernels import maxmin as mm
    recorded = recorded_values()
    out = {}

    # fig14: HPL at 1024 and 16,384 hosts
    for label, fabric, scales in fig14:
        t0 = time.perf_counter()
        topo = fattree.fat_tree(bw=200 * fattree.GBPS, **fabric)
        wls = []
        for n in scales:
            wls.extend(hpl_workloads(wl.Workload, topo.hosts, n))
        log(f"[paths] {label}: {len(topo.hosts)} hosts, "
            f"{sum(len(p) for p in topo.ports.values())} directed links, "
            f"built in {time.perf_counter() - t0:.1f} s")
        with Phase(label, rec, mm, fts, lossy=False) as ph:
            recss = make_engine("flow", topo).run_workloads(wls)
        t0 = time.perf_counter()
        want = make_engine("flow-np", topo).run_workloads(wls)
        log(f"[paths]   flow-np oracle in {time.perf_counter() - t0:.1f} s")
        rows = []
        for i, n in enumerate(scales):
            got = hpl_values(n, recss[2 * i], recss[2 * i + 1])
            ref = hpl_values(n, want[2 * i], want[2 * i + 1])
            for name, g, w in (("gleam", got[0], ref[0]),
                               ("ring_long", got[1], ref[1])):
                rows.append(check_jct(f"fig14/hpl_{n}x{n}/{name}_ms",
                                      g * 1e3, w * 1e3, recorded))
        out[label] = dict(ph.stats, rows=rows)

    # fig15: the loss grid's 4096-member points on the 4096-host tree
    topo = fattree.fat_tree(bw=200 * fattree.GBPS, **fig15)
    n_hosts = len(topo.hosts)
    for loss in (0.0, 1e-3):
        label = f"fig15_loss{loss:g}"
        kw = dict(loss_rate=loss, seed=11, group_kw={"window": 512},
                  relay_kw={"window": 512})
        rows = []
        with Phase(label, rec, mm, fts, lossy=loss > 0) as ph:
            got = {}
            for transport in ("gleam", "multiunicast"):
                eng = make_engine("flow", topo, **kw)
                r = eng.stage(wl.GroupOp("bcast", topo.hosts, FIG15_NBYTES,
                                         transport=transport, chunks=8))
                eng.run()
                got[transport] = r.jct(len(topo.hosts) - 1)
        for transport in ("gleam", "multiunicast"):
            eng = make_engine("flow-np", topo, **kw)
            r = eng.stage(wl.GroupOp("bcast", topo.hosts, FIG15_NBYTES,
                                     transport=transport, chunks=8))
            eng.run()
            tag = f"{loss:.0e}" if loss else "0"
            rows.append(check_jct(
                f"fig15/scale_g{n_hosts}_loss{tag}/{transport}_ms",
                got[transport] * 1e3, r.jct(len(topo.hosts) - 1) * 1e3,
                recorded))
        out[label] = dict(ph.stats, rows=rows)

    # matrix: churn x loss x flaps, dynamic segments on float64 lanes
    fabric, n_groups, group = matrix
    topo = fattree.fat_tree(**fabric)
    cells = [(c, f) for c in (0.0, 5e4) for f in (0, 2)]
    label = "matrix"
    rows, seg_err = [], 0.0
    problems = []
    with Phase(label, rec, mm, fts, lossy=True) as ph:
        got = {}
        for loss in (0.0, 1e-3):
            eng = make_engine("flow", topo,
                              **({"loss_rate": loss} if loss else {}))
            inner = eng._sim.segment_rates_many

            def seg(probs, inner=inner):
                vals = inner(probs)
                problems.append((probs, vals))
                return vals
            eng._sim.segment_rates_many = seg
            got[loss] = sweep_cells(eng, wl, topo, cells, n_groups, group)
    want = {}
    for loss in (0.0, 1e-3):
        eng = make_engine("flow-np", topo,
                          **({"loss_rate": loss} if loss else {}))
        want[loss] = sweep_cells(eng, wl, topo, cells, n_groups, group)
    for loss in (0.0, 1e-3):
        for cell, g, w in zip(cells, got[loss], want[loss]):
            rows.append(check_jct(f"matrix c{cell[0]:g} l{loss:g} "
                                  f"f{cell[1]}", g * 1e3, w * 1e3, {}))
    sim = LinkMap(topo)
    n_probs = 0
    for probs, vals in problems:
        oracle = LinkMap.segment_rates_many(sim, probs)
        n_probs += len(probs)
        for g, w in zip(vals, oracle):
            seg_err = max(seg_err, abs(g - w) / abs(w))
    log(f"[paths]   {n_probs} segment problems: max rel err {seg_err:.3g} "
        f"vs numpy LinkMap.segment_rates_many (limit 1e-6)")
    if not n_probs or seg_err > 1e-6:
        fail(f"matrix: segment rates {n_probs} problems, err {seg_err}")
    out[label] = dict(ph.stats, rows=rows, segment_problems=n_probs,
                      segment_max_rel_err=seg_err)
    return out


def sweep_cells(eng, wl, topo, cells, n_groups, group):
    """Mean group JCT of every (churn, flaps) cell, one run_many."""
    all_ops = [matrix_ops(wl, topo.hosts, n_groups, group, c, f)
               for c, f in cells]
    recss = []

    def scenario(ops):
        return lambda e: recss.append([e.stage(op) for op in ops])

    eng.run_many([scenario(ops) for ops in all_ops])
    return [sum(r.jct(len(op.surviving_receivers()))
                for op, r in zip(ops, recs)) / len(ops)
            for ops, recs in zip(all_ops, recss)]


# ---------------------------------------------------------------- kernels

def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes, ops, dtype):
    """The least time for the work: (bound ms, bound by, byte bound ms)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, ops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", t_bytes * 1e3)


def fill_bound(fl, cap, rounds, dtype):
    """Each input read once (link ids, capacities, active mask), the
    rates written once; per round a scatter, a gather-min and a scatter
    over the link ids plus three passes over the links."""
    b, f, _ = fl.shape
    es = torch.finfo(dtype).bits // 8
    n_bytes = fl.numel() * 4 + cap.numel() * es + 2 * b * f * es
    ops = rounds * (3 * fl.numel() + 3 * b * cap.shape[-1] + b * f)
    return bound(n_bytes, ops, dtype)


def loss_bound(fl, cap, dtype):
    """Link ids, capacities and six per-flow vectors read once, the
    factors written once; two scatters, a hot test per link id and ~20
    operations per flow."""
    b, f, _ = fl.shape
    es = torch.finfo(dtype).bits // 8
    n_bytes = fl.numel() * 4 + cap.numel() * es + 7 * b * f * es
    ops = 5 * fl.numel() + 20 * b * f
    return bound(n_bytes, ops, dtype)


def check_fill(name, fl, cap, active, kw, dtype, mm, ref, launches=0):
    """Kernel vs plain filling: per round, then whole; times."""
    cap = cap.to(dtype)
    active = active.to(dtype)
    tol = kw.get("tol", 1e-6)
    rtol = 1e-6 if dtype == torch.float32 else 1e-12
    b = fl.shape[0]
    frozen = 1.0 - active
    rates = torch.zeros_like(active)
    cap_rem = cap.expand(b, -1).contiguous() if cap.dim() == 1 else cap
    rounds, round_err, freeze_ok = 0, 0.0, True
    bound = fl.shape[1] if kw.get("max_rounds") is None \
        else kw["max_rounds"] - 1
    while rounds <= bound:
        live = (frozen < 0.5).any(-1)
        if not bool(live.any()):
            break
        pr, pf, pc = ref.maxmin_round_reference(fl, frozen, rates, cap_rem,
                                                tol=tol)
        if rounds < ROUNDS_CHECKED:
            kr, kf, kc = mm.maxmin_round(fl, frozen, rates, cap_rem, tol=tol)
            freeze_ok &= bool((kf == pf)[live].all())
            round_err = max(round_err, rel_err(kr[live], pr[live]),
                            rel_err(kc[live], pc[live]))
        keep = live[:, None]
        rates = torch.where(keep, pr, rates)
        frozen = torch.where(keep, pf, frozen)
        cap_rem = torch.where(keep, pc, cap_rem)
        rounds += 1
    got = mm.maxmin_rates(fl, cap, active, **kw)
    want = ref.maxmin_rates_reference(fl, cap, active, **kw)
    err_abs = float((got - want).abs().max())
    err_rel = rel_err(got, want)
    ok = freeze_ok and round_err <= rtol and err_rel <= rtol
    ms = cuda_ms(lambda: mm.maxmin_rates(fl, cap, active, **kw), 20)
    plain_ms = cuda_ms(lambda: ref.maxmin_rates_reference(fl, cap, active,
                                                          **kw), 3)
    bound_ms, bound_by, bytes_ms = fill_bound(fl, cap, max(rounds, 1), dtype)
    row = {"kernel": "maxmin_fill", "phase": name, "shape": list(fl.shape),
           "caps": cap.shape[-1], "dtype": str(dtype).split(".")[-1],
           "rounds": rounds, "freeze_sets_equal": freeze_ok,
           "round_max_rel_err": round_err, "max_abs_err": err_abs,
           "max_rel_err": err_rel, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes_bound_ms": bytes_ms, "phase_launches": launches, "ok": ok}
    log(f"[kernels] {json.dumps(row)}")
    if not ok:
        fail(f"maxmin_fill {name} {list(fl.shape)} {dtype}: freeze "
             f"{freeze_ok}, round err {round_err}, rates err {err_rel}")
    return row


def rel_err(got, want):
    if got.numel() == 0:
        return 0.0
    den = want.abs().clamp(min=1e-30)
    diff = (got - want).abs()
    diff = torch.where(torch.isinf(want) & (got == want),
                       torch.zeros_like(diff), diff)
    return float((diff / den).max())


def check_loss(name, args, kw, dtype, mm, ref, launches=0):
    fl, rates, active, cap, q, wsq, wnd, ecn = (
        a.to(dtype) if a.is_floating_point() else a for a in args)
    got = mm.loss_factors(fl, rates, active, cap, q, wsq, wnd, ecn, **kw)
    want = ref.loss_factors_reference(fl, rates, active, cap, q, wsq, wnd,
                                      ecn, **kw)
    err = float((got - want).abs().max())
    zero = (q == 0) & (wsq == 0) & (wnd == 0) & (ecn == 0)
    ones_ok = bool((got[zero] == 1.0).all())
    ok = err <= 1e-6 and ones_ok
    ms = cuda_ms(lambda: mm.loss_factors(fl, rates, active, cap, q, wsq,
                                         wnd, ecn, **kw), 20)
    plain_ms = cuda_ms(lambda: ref.loss_factors_reference(
        fl, rates, active, cap, q, wsq, wnd, ecn, **kw), 5)
    bound_ms, bound_by, bytes_ms = loss_bound(fl, cap, dtype)
    row = {"kernel": "loss_factors", "phase": name, "shape": list(fl.shape),
           "caps": cap.shape[-1], "dtype": str(dtype).split(".")[-1],
           "zero_rows": int(zero.sum()), "zero_rows_exactly_one": ones_ok,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes_bound_ms": bytes_ms, "phase_launches": launches, "ok": ok}
    log(f"[kernels] {json.dumps(row)}")
    if not ok:
        fail(f"loss_factors {name} {list(fl.shape)} {dtype}: err {err}, "
             f"all-zero rows exactly 1: {ones_ok}")
    return row


def random_fill_problem(rng, b, f, h, n_links, per_lane, device):
    """Random flows with ragged rows over ``n_links`` links: many rounds."""
    fl = rng.integers(0, n_links, (b, f, h)).astype(np.int32)
    lens = rng.integers(1, h + 1, (b, f))
    fl[np.arange(h)[None, None, :] >= lens[..., None]] = n_links
    cap = np.append(rng.uniform(1e9, 2.5e10, n_links), np.inf)
    if per_lane:
        cap = np.stack([cap] * b)
    active = (rng.random((b, f)) < 0.9).astype(np.float64)
    return (torch.tensor(fl, device=device), torch.tensor(cap, device=device),
            torch.tensor(active, device=device))


def run_kernels(rec, paths):
    from repro_torch.kernels import maxmin as mm
    from repro_torch.kernels import ref
    rows = []
    for key, val in rec.inputs.items():
        kernel, phase = key[0], key[1]
        for dtype in (torch.float32, torch.float64):
            launches = paths[phase]["launches"][kernel]
            if kernel == "maxmin_fill":
                fl, cap, active, kw = val
                row = check_fill(phase, fl, cap, active, kw, dtype, mm, ref,
                                 launches)
            else:
                row = check_loss(phase, val[:8], val[8], dtype, mm, ref,
                                 launches)
            row["path_dtype"] = str(dtype) == key[4]
            rows.append(row)
    # many-round problems: one lane over a 16k-host fabric's link count
    # (the cross-CTA variant) and 80 float64 segment-shaped lanes
    rng = np.random.default_rng(0)
    for shape, n_links, per_lane, kw in (
            ((1, 8192, 8), 50176, False, {}),
            ((80, 16, 64), 300, True, {"tol": 1e-12, "max_rounds": 64})):
        fl, cap, active = random_fill_problem(rng, *shape, n_links,
                                              per_lane, "cuda")
        for dtype in (torch.float32, torch.float64):
            rows.append(check_fill("random", fl, cap, active, kw, dtype,
                                   mm, ref))
    return rows


def kernels_line(rows, paths):
    """One entry per kernel: launches summed over the path phases, the
    worst error of any comparison, and the times of its largest
    main-path input in the dtype the path used."""
    out = []
    for name, replaces in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        path_rows = [r for r in mine if r.get("path_dtype")]
        launches = sum(p["launches"][name] for p in paths.values())
        rep = max(path_rows or mine,
                  key=lambda r: np.prod(r["shape"]) * r["caps"])
        out.append({"name": name, "route": "cuda", "source": SOURCE,
                    "replaces": replaces, "launches": launches,
                    "max_abs_err": max(r["max_abs_err"] for r in mine),
                    "ms": rep["ms"], "plain_ms": rep["plain_ms"],
                    "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
                    "library_ms": None, "phase": rep["phase"],
                    "shape": rep["shape"], "dtype": rep["dtype"]})
    return {"kernels": out}


def gpu_name_power() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    return proc.stdout.strip().splitlines()[0] if proc.stdout.strip() \
        else "unknown"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import maxmin as mm
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    build.library()
    log(f"[build] {os.path.basename(str(build.library_path()))} in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in build.BUILD_LOG:
        if "registers" in line or "spill" in line or "entry function" in line:
            log(f"[build]   {line.strip()}")
    card = gpu_name_power()
    log(f"[build] card: {card}")

    rec = Recorder(mm)
    paths = run_paths(rec)
    rows = run_kernels(rec, paths)
    line = kernels_line(rows, paths)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"),
              "w") as fh:
        json.dump({"card": card, "paths": paths, "kernel_rows": rows,
                   "kernels": line["kernels"], "failures": FAILURES,
                   "seconds": time.perf_counter() - t_start}, fh, indent=1)
    if FAILURES:
        for msg in FAILURES:
            print(f"chip_smoke: {msg}", file=sys.stderr)
        return 1
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
