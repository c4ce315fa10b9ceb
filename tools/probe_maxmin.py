"""Time the port's max-min kernels on the card at the flow engine's own
shapes.

    python3 tools/probe_maxmin.py [--src DIR] [--tag NAME] [--inputs FILE]
                                  [--variants]

on a machine with a card.  ``--src`` imports ``repro_torch`` from
``DIR/src`` instead of this checkout's (an earlier commit unpacked by
``git archive``), so that two versions of ``maxmin_fill`` and
``loss_factors`` are timed in turns in one call; the inputs, timers and
bounds are this checkout's ``chip_smoke.py``'s.

1. builds the ``maxmin`` library and prints what ``-Xptxas -v`` reports
   for each kernel (registers, shared memory, spill bytes);
2. takes the kernel inputs of the flow engine's main path from FILE when
   it exists; else runs ``chip_smoke.py``'s flow phases (fig14 at 1024
   and 16,384 hosts, fig15, matrix) and its packet-vs-flow gates
   (packet_frozen, packet_fig15, packet_vs_flow, fleet, apps) with its
   ``Recorder`` and saves each phase's distinct inputs and launch counts
   to FILE (about 3 minutes, most of it the 16k-host staging and the
   packet engine);
3. times each input in float32 and float64, then ``chip_smoke.py``'s two
   random many-round problems: ``ms`` through the wrapper (CUDA events),
   ``device_ms`` and the device operations a call from torch.profiler
   (``traced_kernels_per_call``: memsets count), ``kernels_per_call``
   from the library's own count where it has one, the bound, the
   distance from the plain version (rates relative, factors absolute)
   and the freeze rounds the plain filling takes.  With ``--variants``
   (a checkout whose ``maxmin._fill`` and ``_loss`` take ``variant=``)
   each input whose lanes fit shared memory is also timed on the kernel
   the wrapper did not choose (the lane kernel or the cooperative grid);
4. splits the host time of a call at the smallest input: the whole
   call, the wrapper with no lane (all but the launch), its checks, one
   allocation (``torch.empty`` and ``torch.empty_like``) and the stream
   lookup (wall clock, 2,000 calls each).

One JSON line a row on stdout.  Parent and change in turns:

    for t in parent tree tree parent; do python3 tools/probe_maxmin.py \\
        --src $([ $t = parent ] && echo .scratch/parent || echo .) \\
        --tag $t --inputs .scratch/maxmin_inputs.pt; done
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

DTYPES = (torch.float32, torch.float64)


def capture(path):
    """Run the flow phases and packet gates once; save their inputs."""
    from repro_torch.kernels import maxmin as mm
    rec = cs.Recorder(mm)
    paths = cs.run_paths(rec)
    paths.update(cs.run_packet(rec))
    mm.maxmin_rates, mm.loss_factors = rec._fill, rec._loss
    inputs = {key: tuple(v.cpu() if torch.is_tensor(v) else v for v in val)
              for key, val in rec.inputs.items()}
    launches = {phase: p["launches"] for phase, p in paths.items()}
    torch.save({"inputs": inputs, "launches": launches}, path)
    print(f"[probe] captured {len(inputs)} inputs into {path}; failures "
          f"{cs.FAILURES}", flush=True)


def plain_rounds(ref, fl, cap, active, kw):
    """Freeze rounds the plain filling takes (its loop, counted)."""
    b = fl.shape[0]
    frozen = 1.0 - active
    rates = torch.zeros_like(active)
    cap_rem = cap.expand(b, -1).contiguous() if cap.dim() == 1 else cap
    bound = fl.shape[1] if kw.get("max_rounds") is None \
        else kw["max_rounds"] - 1
    rounds = 0
    while rounds <= bound:
        live = (frozen < 0.5).any(-1)
        if not bool(live.any()):
            break
        r, f, c = ref.maxmin_round_reference(fl, frozen, rates, cap_rem,
                                             tol=kw.get("tol", 1e-6))
        keep = live[:, None]
        rates = torch.where(keep, r, rates)
        frozen = torch.where(keep, f, frozen)
        cap_rem = torch.where(keep, c, cap_rem)
        rounds += 1
    return rounds


def timed(mm, call, bound_ms):
    ms = cs.cuda_ms(call, 20)
    reps = max(2, min(50, int(20.0 / max(ms, 1e-3))))
    if reps >= 50:
        ms = cs.cuda_ms(call, 200)
    dev_ms, traced, _ = cs.device_time(call, reps)
    per_call = cs.kernels_per_call(mm.kernels_launched, call,
                                   min(10, reps)) \
        if hasattr(mm, "kernels_launched") else None
    return {"ms": ms, "device_ms": dev_ms,
            "kernels_per_call": per_call, "traced_kernels_per_call": traced,
            "bound_ms": bound_ms,
            "bound_share": bound_ms / dev_ms if dev_ms else None}


#: the kernel the wrapper did not choose, timed beside it (``--variants``)
OTHER = {"lane": "grid", "grid, lane fits": "lane"}


def chosen(mm, kernel, fl, cap):
    """The kernel variant the wrapper launches (None: a checkout that
    does not say)."""
    return mm.variant_of(kernel, fl, cap) if hasattr(mm, "variant_of") \
        else None


def fill_rows(tag, mm, ref, phase, fl, cap, active, kw, launches,
              variants):
    bound = fl.shape[1] if kw.get("max_rounds") is None \
        else kw["max_rounds"] - 1
    for dtype in DTYPES:
        c, a = cap.to(dtype), active.to(dtype)
        rounds = plain_rounds(ref, fl, c, a, kw)
        want = ref.maxmin_rates_reference(fl, c, a, **kw)
        got = mm.maxmin_rates(fl, c, a, **kw)
        row = {"tag": tag, "kernel": "maxmin_fill", "phase": phase,
               "shape": list(fl.shape), "caps": cap.shape[-1],
               "dtype": str(dtype).split(".")[-1], "rounds": rounds,
               "variant": chosen(mm, "maxmin_fill", fl, c),
               "max_rel_err": cs.rel_err(got, want),
               "phase_launches": launches,
               **timed(mm, lambda: mm.maxmin_rates(fl, c, a, **kw),
                       cs.fill_bound(fl, c, max(rounds, 1), dtype)[0])}
        print(json.dumps(row), flush=True)
        other = OTHER.get(row["variant"]) if variants else None
        if other:
            def call():
                return mm._fill(fl, c, a, None, tol=kw.get("tol", 1e-6),
                                bound=bound, one_round=False,
                                floor_rates=True, variant=other)[0]
            print(json.dumps({**row, "variant": other,
                              "max_rel_err": cs.rel_err(call(), want),
                              **timed(mm, call, row["bound_ms"])}),
                  flush=True)


def loss_rows(tag, mm, ref, phase, args, kw, launches, variants):
    for dtype in DTYPES:
        t = [a.to(dtype) if a.is_floating_point() else a for a in args]
        want = ref.loss_factors_reference(*t, **kw)
        got = mm.loss_factors(*t, **kw)
        row = {"tag": tag, "kernel": "loss_factors", "phase": phase,
               "shape": list(t[0].shape), "caps": t[3].shape[-1],
               "dtype": str(dtype).split(".")[-1],
               "variant": chosen(mm, "loss_factors", t[0], t[3]),
               "max_abs_err": cs.abs_err(got, want),
               "phase_launches": launches,
               **timed(mm, lambda: mm.loss_factors(*t, **kw),
                       cs.loss_bound(t[0], t[3], dtype)[0])}
        print(json.dumps(row), flush=True)
        other = OTHER.get(row["variant"]) if variants else None
        if other:
            def call():
                return mm._loss(*t, **kw, variant=other)
            print(json.dumps({**row, "variant": other,
                              "max_abs_err": cs.abs_err(call(), want),
                              **timed(mm, call, row["bound_ms"])}),
                  flush=True)


def host_split(tag, mm, saved, reps=2000):
    """Host ms of one ``maxmin_rates`` call at the smallest captured input
    (wall clock over ``reps`` back-to-back calls) beside its parts: the
    wrapper with no lane (everything but the launch), its checks, one
    output allocation and the stream lookup."""
    import time
    key = min((k for k in saved["inputs"] if k[0] == "maxmin_fill"),
              key=lambda k: np.prod(k[2]))
    fl, cap, active, kw = (v.cuda() if torch.is_tensor(v) else v
                           for v in saved["inputs"][key])
    cap, active = cap.float(), active.float()
    cap0 = cap[:0] if cap.dim() == 2 else cap

    def per(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3
    row = {"tag": tag, "host_split": list(fl.shape),
           "call_ms": per(lambda: mm.maxmin_rates(fl, cap, active))}
    if hasattr(mm, "_stream"):
        none = fl[:0]
        row.update({
            "no_lane_ms": per(lambda: mm.maxmin_rates(none, cap0,
                                                      active[:0])),
            "checks_ms": per(lambda: mm._check("maxmin_fill", fl, cap,
                                               [active], masks=(0,))),
            "empty_ms": per(lambda: torch.empty(
                fl.shape[:2], dtype=cap.dtype, device=fl.device)),
            "empty_like_ms": per(lambda: torch.empty_like(active)),
            "stream_ms": per(lambda: mm._stream(fl.device))})
    print(json.dumps(row), flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", default=ROOT)
    parser.add_argument("--tag", default="tree")
    parser.add_argument("--inputs",
                        default=os.path.join(ROOT, ".scratch",
                                             "maxmin_inputs.pt"))
    parser.add_argument("--variants", action="store_true")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_maxmin: needs a CUDA card")
    sys.path.insert(0, os.path.join(os.path.abspath(opts.src), "src"))
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import maxmin as mm
    print(f"[probe] {opts.tag}: repro_torch from {mm.__file__}; card "
          f"{cs.gpu_name_power()}", flush=True)
    build.build(("maxmin",))
    for line in build.BUILD_LOG.get("maxmin", ()):
        if "registers" in line or "spill" in line or "entry" in line:
            print(f"[build] {line.strip()}", flush=True)
    if not os.path.exists(opts.inputs):
        os.makedirs(os.path.dirname(os.path.abspath(opts.inputs)),
                    exist_ok=True)
        capture(opts.inputs)
    saved = torch.load(opts.inputs)
    for key, val in saved["inputs"].items():
        kernel, phase = key[0], key[1]
        val = tuple(v.cuda() if torch.is_tensor(v) else v for v in val)
        launches = saved["launches"][phase][kernel]
        if kernel == "maxmin_fill":
            fill_rows(opts.tag, mm, ref, phase, *val, launches,
                      opts.variants)
        else:
            loss_rows(opts.tag, mm, ref, phase, val[:8], val[8], launches,
                      opts.variants)
    host_split(opts.tag, mm, saved)
    rng = np.random.default_rng(0)
    for shape, n_links, per_lane, kw in (
            ((1, 8192, 8), 50176, False, {}),
            ((80, 16, 64), 300, True, {"tol": 1e-12, "max_rounds": 64})):
        fl, cap, active = cs.random_fill_problem(rng, *shape, n_links,
                                                 per_lane, "cuda")
        fill_rows(opts.tag, mm, ref, "random", fl, cap, active, kw, 0,
                  opts.variants)
    return 0


if __name__ == "__main__":
    sys.exit(main())
