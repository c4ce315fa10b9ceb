"""Step functions of the port: prefill.

The port of the reference package's ``launch/steps.py``, prefill half.
``make_prefill_step(cfg)`` returns ``prefill_step(params, batch)``,
which runs ``models.model.forward_hidden`` over the whole prompt — every
attention layer on the flash-attention kernel, every Mamba-2 layer on
the SSD-scan kernel, when the parameters are on the card — and gives
only the last position's logits, which is what serving needs to start
decoding (a (B, S, V) logits buffer would be pointless).  The train and
serve steps, the abstract input specs and the dry-run lowering belong
to later slices (ROADMAP queue 1).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as mdl

#: the reference's (arch x shape) cells, as data: sequence, batch and
#: step kind of each
SHAPE_TABLE = {
    "train_4k": dict(seq=4096, batch=256, kind="train", accum=8),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}


def make_prefill_step(cfg: ArchConfig, *, device="cuda"):
    """``prefill_step(params, batch) -> (B, 1, V) f32`` logits of the
    last prompt position.  ``params`` is ``Model.params`` on ``device``
    (``cuda`` by default, which needs a card); ``batch["tokens"]`` is a
    (B, S) integer array or tensor."""
    dev = resolve_device(device)
    mdl.check_forward_supported(cfg)

    @torch.no_grad()
    def prefill_step(params, batch):
        x, _ = mdl.forward_hidden(params, batch, cfg, device=dev)
        cd = getattr(torch, cfg.compute_dtype)
        last = x[:, -1:]
        logits = torch.einsum("bsd,dv->bsv", last.to(cd),
                              params["lm_head"].to(cd))
        return logits.float()

    return prefill_step
