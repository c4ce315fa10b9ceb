"""Serving launcher: continuous-batching server over a config.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \
        --smoke --device cpu

The port of the reference package's ``launch/serve.py``; it serves every
configuration.  Weights are drawn from seed 0 on ``--device`` (``cuda``
by default, which needs a card); prompts of random length in [2,
max_seq / 4) come from ``numpy.random.default_rng(0)``.  ``--layers``
cuts the depth (a multiple of the config's pattern), for models whose
float32 weights do not fit one card at full depth (mixtral_8x7b,
jamba_v0_1_52b and internvl2_26b need 8, 8 and 24 layers on 80 GB).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.runtime.serve import Server


def make_prompts(n: int, vocab_size: int, max_seq: int, seed: int = 0):
    """``n`` prompts of random length in [2, max_seq // 4)."""
    rng = np.random.default_rng(seed)
    prompts = []
    for _ in range(n):
        plen = int(rng.integers(2, max_seq // 4))
        prompts.append(rng.integers(0, vocab_size, plen))
    return prompts


def serve(cfg, *, requests: int, pool: int, max_new: int, max_seq: int,
          device="cuda", sampler=None, model=None) -> dict:
    """Serve ``requests`` prompts to completion on ``model`` (a seed-0
    ``Model`` drawn on the device when None); the wall clock ends after
    the device has finished."""
    dev = resolve_device(device)
    model = Model(cfg, seed=0, device=dev) if model is None else model
    srv = Server(cfg, model, pool=pool, max_seq=max_seq, sampler=sampler,
                 device=dev)
    reqs = [srv.submit(p, max_new_tokens=max_new)
            for p in make_prompts(requests, cfg.vocab_size, max_seq)]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    stats = srv.run_until_drained()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"stats": stats, "requests": reqs,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--pool", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the config's)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    out = serve(cfg, requests=args.requests, pool=args.pool,
                max_new=args.max_new, max_seq=args.max_seq,
                device=args.device)
    stats, dt = out["stats"], out["seconds"]
    print(f"[launch.serve] {stats.completed} done, "
          f"{stats.tokens_generated} tokens, "
          f"{stats.tokens_generated / dt:.1f} tok/s, "
          f"{stats.steps} pool steps")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
