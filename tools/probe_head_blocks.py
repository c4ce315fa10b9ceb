"""``flash_attention`` on the head blocks of a mesh against the whole
call, on one card.

    python3 tools/probe_head_blocks.py [--arch mixtral_8x7b] [--ranks 4]
        [--seq 2048] [--dtype float32]

A mesh with ``ranks`` ranks on ``model`` gives rank r query heads
[r H / m, (r + 1) H / m) and their kv heads; each rank's call is one
launch of the kernel on its block.  The blocks' outputs, side by side,
are held to the whole call (the one device's), bit for bit where the
kernel's arithmetic on a head does not depend on the other heads, and
both to the plain version in float64.  Random q, k, v from seed 0 at
the config's head counts and ``head_dim``, causal, with its window.
One JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral_8x7b")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--dtype", default="float32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_head_blocks: no CUDA device", file=sys.stderr)
        return 2
    cfg = get_config(args.arch)
    h, kvh, d, m = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, args.ranks
    dt = getattr(torch, args.dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((1, args.seq, n, d), generator=gen,
                           device="cuda").to(dt) for n in (h, kvh, kvh))
    kw = dict(causal=True, window=cfg.window)
    whole = fa.flash_attention(q, k, v, **kw)
    hb, kb = h // m, kvh // m
    blocks = torch.cat([fa.flash_attention(
        q[:, :, r * hb:(r + 1) * hb].contiguous(),
        k[:, :, r * kb:(r + 1) * kb].contiguous(),
        v[:, :, r * kb:(r + 1) * kb].contiguous(), **kw)
        for r in range(m)], dim=2)
    plain = ref.mha_reference(q.double(), k.double(), v.double(), **kw)
    scale = float(plain.abs().max())
    print(json.dumps({
        "arch": cfg.name, "ranks": m, "seq": args.seq, "dtype": args.dtype,
        "heads": [h, kvh, d], "launches": dict(fa.LAUNCHES),
        "blocks_vs_whole_max_abs": float((blocks - whole).abs().max()),
        "blocks_equal_whole": bool(torch.equal(blocks, whole)),
        "whole_vs_float64_rel": float((whole.double() - plain).abs().max())
        / scale,
        "blocks_vs_float64_rel": float((blocks.double() - plain).abs().max())
        / scale}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
