"""How far a random-weight model's decode moves when its cache moves by
one rounding: the yardstick for comparing two evaluations of the port
that round differently (a kernel variant, a summation order).

    PYTHONPATH=src python tools/decode_sensitivity.py --arch granite_3_2b \\
        --layers 8 [--dtype float32 --eps 1e-6] [--device cuda]

Draws the config's weights from seed 0 (``blocks.init_sharded_params``)
and a bf16 (or ``--dtype``) cache of 4 rows x 32,768 slots filled with
N(0, 1) below slot 32,752, copies the cache, multiplies 1% of layer 0's
cached k and v elements by (1 + eps) in the copy (eps one bf16 ulp,
2^-7, by default), and decodes 4 steps from 32,752 on both; prints each
step's largest logit and the largest distance between the two runs.
Runs on one device (the CPU here takes a few minutes at 8 layers).
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch.mesh import single_device_mesh  # noqa: E402
from repro_torch.launch.steps import make_serve_step  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.models.blocks import init_sharded_params  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="granite_3_2b")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--eps", type=float, default=2 ** -7)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    dtype = getattr(torch, args.dtype)
    cfg = get_config(args.arch).replace(n_layers=args.layers,
                                        compute_dtype=args.dtype)
    one = single_device_mesh(args.device)
    step = make_serve_step(cfg, one, batch_shardable=False)
    params = init_sharded_params(mdl.model_defs(cfg), step.plan, one,
                                 seed=0, dtype=dtype)
    b, s, fill = 4, 32768, 32752
    gen = torch.Generator(device=one.device).manual_seed(0)
    caches = mdl.init_caches(cfg, b, s, dtype=dtype, device=one.device)
    for t in caches["layers"]["sub0"].values():
        for i in range(cfg.n_blocks):
            x = torch.randn(b, s, cfg.n_kv_heads, cfg.hd, generator=gen,
                            device=one.device)
            x[:, fill:] = 0
            t[i].copy_(x)
    moved = {"layers": {"sub0": {n: t.clone() for n, t in
                                 caches["layers"]["sub0"].items()}}}
    for t in moved["layers"]["sub0"].values():
        pick = torch.rand(t[0].shape, generator=gen,
                          device=one.device) < 0.01
        t[0].copy_(torch.where(pick, (t[0].float() * (1 + args.eps))
                               .to(dtype), t[0]))
    toks = torch.randint(0, cfg.vocab_size, (4, b, 1), generator=gen,
                         device=one.device)
    for i in range(4):
        a, _ = step(params, caches, toks[i], fill + i)
        c, _ = step(params, moved, toks[i], fill + i)
        print(f"{args.arch} {args.layers} layers {args.dtype} eps "
              f"{args.eps:g} step {i}: max |logit| {float(a.abs().max())!r},"
              f" max |diff| {float((a - c).abs().max())!r}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
