"""Where a full-width train step's gradient norm comes from, on the card.

    python3 tools/probe_grad_norm.py [--arch granite_3_2b] [--layers 0]
        [--dtype bfloat16] [--batch 2] [--seq 4096] [--accum 2]

One ``make_train_step`` step from the seed-0 float32 state (``Model``)
on ``chip_smoke.train_batches``' first batch; the gradient handed to
AdamW is read leaf by leaf: its largest magnitude, its sum of squares in
float32 and in float64, and whether it is finite; then whether every
updated parameter is finite.  One JSON line a leaf and one for the step.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models.blocks import tree_leaves  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite_3_2b")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--accum", type=int, default=2)
    args = ap.parse_args()
    cfg = get_config(args.arch).replace(compute_dtype=args.dtype)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    params = Model(cfg, seed=0, device="cuda").params
    batch = chip_smoke.train_batches(cfg, args.batch, args.seq, 1,
                                     "cuda")[0]
    rows, apply = [], adamw.apply

    def recorded(opt_cfg, p, state, grads, **kw):
        for name, g in tree_leaves(grads):
            rows.append({"leaf": name, "shape": list(g.shape),
                         "max_abs": float(g.abs().max()),
                         "sumsq_f32": float(torch.sum(torch.square(
                             g.float()))),
                         "sumsq_f64": float(torch.sum(torch.square(
                             g.double()))),
                         "finite": bool(torch.isfinite(g).all())})
        return apply(opt_cfg, p, state, grads, **kw)
    adamw.apply = recorded
    step = make_train_step(cfg, adamw.AdamWConfig(), args.accum,
                           device="cuda")
    params, _, m = step(params, adamw.init(params), batch)
    for r in rows:
        print(json.dumps(r))
    print(json.dumps({
        "arch": cfg.name, "layers": cfg.n_layers, "dtype": args.dtype,
        "batch": args.batch, "seq": args.seq, "accum": args.accum,
        "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
        "grad_norm_f64": sum(r["sumsq_f64"] for r in rows) ** 0.5,
        "params_finite": all(bool(torch.isfinite(t).all())
                             for _, t in tree_leaves(params))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
