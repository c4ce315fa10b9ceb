"""Public wrappers around the kernels of the adapted layer.

The port of the reference package's ``kernels/ops.py``.  Its
``flash_decode`` pads the cache to a multiple of the Pallas block; the
Hopper kernel masks its ragged last tile itself, so here nothing is
padded, and the tile size and interpret mode are not arguments (the
kernel has its own tile, and a CUDA kernel has no interpret mode: a CPU
tensor takes the plain version).  The ``flash_attention`` and
``ssd_scan`` wrappers come with their kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_decode as fd


def flash_decode(q, k, v, kv_len):
    """Split-KV decode.  q (B, H, D); k, v (B, S, KVH, D); kv_len (B,)
    integers.  Returns ``(out, m, l)`` — see ``kernels/flash_decode.py``."""
    return fd.flash_decode(q, k, v, kv_len.to(q.device, torch.int32))
