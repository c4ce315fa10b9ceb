"""Multi-pod dry run of the port: every cell's step traced for one rank.

The port of the reference package's ``launch/dryrun.py``.  For every
(architecture x input shape x mesh) cell it builds rank 0 of the
production world (``launch/mesh.fake_world``: the 16 x 16 pod, 256
ranks, or the 2 x 16 x 16 multipod, 512) on torch's ``fake``
process-group backend, and runs the cell's step once on fake tensors of
that rank's blocks (``launch/steps.lower_cell``): the train step with
its microbatches, the prefill step, or one decode step against a full
cache.  It allocates nothing and launches nothing, so it is the one
entry point of the port that needs no card: it runs on a CPU host.

Where the reference lowers and compiles through XLA and extrapolates
FLOPs and bytes from two unrolled probes (XLA counts a scan body once),
the port traces eagerly: every layer and every microbatch runs, so the
counts are those of the whole step and no probe is taken.  Each cell's
record holds the ``launch/roofline.Roofline`` terms at the H100's
datasheet peaks, and ``memory_stats`` from the trace: the bytes of the
step's arguments and the peak of live bytes, arguments included.

Usage:
    python -m repro_torch.launch.dryrun --arch mixtral_8x7b \\
        --shape train_4k --mesh pod --out results/dryrun_torch
    python -m repro_torch.launch.dryrun --all --mesh both \\
        --out results/dryrun_torch

Each cell writes one JSON file (``tools/roofline_table.py`` renders a
directory of them); a failing cell is recorded with ``status: "error"``
and its traceback, the sweep goes on, and the exit code is 1.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
import traceback

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.launch import steps
from repro_torch.launch.mesh import fake_world, production_shape
from repro_torch.launch.roofline import summarize


def run_cell(arch: str, shape: str, mesh_name: str, out_dir: pathlib.Path,
             *, schedule: str | None = None, overrides: dict | None = None,
             tag: str = "") -> dict:
    """Trace one cell, write its record and return it."""
    cfg = get_config(arch)
    if schedule:
        cfg = cfg.replace(collective_schedule=schedule)
    if overrides:
        cfg = cfg.replace(**overrides)
    suffix = f"-{tag}" if tag else ""
    cell_id = f"{arch}-{shape}-{mesh_name}{suffix}"
    out_path = out_dir / f"{cell_id}.json"
    rec: dict = {"arch": arch, "shape": shape, "mesh": mesh_name,
                 "tag": tag, "status": "running"}

    ok, why = steps.shape_runnable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        out_path.write_text(json.dumps(rec, indent=1))
        print(f"[dryrun] {cell_id}: SKIP ({why})")
        return rec

    try:
        with fake_world(*production_shape(mesh_name == "multipod")) as mesh:
            t0 = time.time()
            counts, spec = steps.lower_cell(cfg, shape, mesh)
            t_trace = time.time() - t0
        rl = summarize(counts, cfg, shape, steps.SHAPE_TABLE[shape],
                       mesh_name, mesh.size, spec.n_params)
        rec.update(status="ok", t_trace_s=t_trace, n_params=spec.n_params,
                   kind=spec.kind, accum=spec.accum,
                   kernels=counts["kernels"],
                   collectives=counts["collectives"],
                   aten_flops=counts["aten_flops"], roofline=rl.to_dict())
        print(f"[dryrun] {cell_id}: OK trace={t_trace:.1f}s "
              f"bottleneck={rl.bottleneck} "
              f"frac={rl.roofline_fraction:.3f} "
              f"peak={counts['peak_bytes'] / 1e9:.2f}GB")
    except Exception as e:  # noqa: BLE001 — the sweep records every cell
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        print(f"[dryrun] {cell_id}: FAIL {type(e).__name__}: {e}")
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(steps.SHAPE_TABLE))
    ap.add_argument("--mesh", choices=("pod", "multipod", "both"),
                    default="pod")
    ap.add_argument("--all", action="store_true",
                    help="sweep every (arch x shape)")
    ap.add_argument("--schedule", default=None,
                    help="override cfg.collective_schedule")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (repeatable)")
    ap.add_argument("--tag", default="", help="suffix for output files")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-done", action="store_true",
                    help="skip cells whose JSON already says ok/skipped")
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    meshes = ("pod", "multipod") if args.mesh == "both" else (args.mesh,)
    cells = ([(a, s) for a in ARCH_IDS for s in steps.SHAPE_TABLE]
             if args.all else [(args.arch, args.shape)])
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v

    n_fail = 0
    for arch, shape in cells:
        if arch is None or shape is None:
            ap.error("--arch/--shape required unless --all")
        for m in meshes:
            suffix = f"-{args.tag}" if args.tag else ""
            f = out_dir / f"{arch}-{shape}-{m}{suffix}.json"
            if args.skip_done and f.exists():
                try:
                    if json.loads(f.read_text())["status"] in (
                            "ok", "skipped"):
                        continue
                except (json.JSONDecodeError, KeyError):
                    pass
            rec = run_cell(arch, shape, m, out_dir,
                           schedule=args.schedule, overrides=overrides,
                           tag=args.tag)
            n_fail += rec["status"] == "error"
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
