"""Training launcher: config-driven entry point over the FT runtime.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b \
        --smoke --steps 50 --device cpu

The port of the reference package's ``launch/train.py``, with
``--device`` (``cuda`` by default, which needs a card).  Re-running the
same command resumes from the latest checkpoint in ``--ckpt-dir``;
``--ckpt-every 0`` writes none (at granite_3_2b's full width the state
is 42.1 GB).  Every ``--arch`` whose inputs are tokens trains; the
encoder-decoder and the VLM raise, since the data pipeline carries no
``frames`` or ``vision_embed`` (``runtime/train.check_pipeline_inputs``).
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.runtime.train import Trainer, TrainerConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--grad-compression", default="none",
                    choices=("none", "int8_ef"))
    ap.add_argument("--data", default=None,
                    help="token file (int32); default synthetic")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch, path=args.data)
    tc = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir, accum_steps=args.accum,
                       grad_compression=args.grad_compression)
    out = Trainer(cfg, dc, tc, device=args.device).run()
    print(f"[launch.train] final loss {out['final_loss']:.4f}; "
          f"{len(out['stragglers'])} stragglers flagged")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
