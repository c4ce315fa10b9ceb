"""Where a serve step's device memory goes, on one card.

    python3 tools/probe_serve_memory.py --arch jamba_v0_1_52b --layers 8

Draws the configuration's bf16 weights (``blocks.init_sharded_params``
on ``single_device_mesh``), its caches for ``--batch`` rows of ``--seq``
slots, fills every cache leaf as ``tools/chip_mesh.py`` does
(``fill_every_leaf``: each layer drawn whole in float32) and runs three
serve steps through ``make_serve_step``; prints the memory allocated
after each stage and the peak inside the fill and inside the steps
(``torch.cuda.max_memory_allocated``, reset before each), one line each,
with the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))
sys.path.insert(0, os.path.join(REPO, "tools"))

from chip_mesh import fill_every_leaf  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch.mesh import single_device_mesh  # noqa: E402
from repro_torch.launch.steps import make_serve_step  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.models.blocks import init_sharded_params  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="jamba_v0_1_52b")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seq", type=int, default=32768)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_serve_memory: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    build.build(["flash_decode"])

    def report(stage):
        torch.cuda.synchronize()
        print(f"{args.arch} ({args.layers} layers, {args.batch} x "
              f"{args.seq}) {stage}: allocated "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
              flush=True)

    cfg = get_config(args.arch).replace(n_layers=args.layers)
    one = single_device_mesh("cuda")
    step = make_serve_step(cfg, one, False)
    params = init_sharded_params(mdl.model_defs(cfg), step.plan, one,
                                 seed=0)
    report("weights")
    caches = mdl.init_caches(cfg, args.batch, args.seq, mesh=one,
                             batch_shardable=False, device="cuda")
    report("weights + caches")
    torch.cuda.reset_peak_memory_stats()
    fill = args.seq - 16
    fill_every_leaf(caches, cfg, args.batch, args.seq, fill, 1, one, False)
    report("after the fill (peak: inside it)")
    torch.cuda.reset_peak_memory_stats()
    tok = torch.zeros(args.batch, 1, dtype=torch.long, device="cuda")
    for i in range(3):
        _, caches = step(params, caches, tok, fill + i)
    report("after three serve steps (peak: inside them)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
