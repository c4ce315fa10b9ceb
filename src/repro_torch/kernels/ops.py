"""Public wrappers around the kernels of the adapted layer.

The port of the reference package's ``kernels/ops.py``.  The reference's
wrappers pad ragged sequences to a multiple of the Pallas block (KV for
``flash_decode`` and ``flash_attention``, chunks with a = 0 for
``ssd_scan``); the Hopper kernels mask their ragged tiles themselves, so
here nothing is padded, and the tile sizes and interpret mode are not
arguments (each kernel has its own tile, and a CUDA kernel has no
interpret mode: a CPU tensor takes the plain version).  ``flash_attention``
and ``ssd_scan`` go through their autograd Functions, so a loss
differentiates through them; under ``torch.no_grad()`` each is the
wrapper's call alone.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ssd_scan as ssd


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Flash attention.  q (B, Sq, H, D); k, v (B, Skv, KVH, D) ->
    (B, Sq, H, D) in q's dtype, query row s at position ``q_offset + s``
    — see ``kernels/flash_attention.py``."""
    return fa.FlashAttention.apply(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal, window, q_offset)


def flash_decode(q, k, v, kv_len, out_dtype=None):
    """Split-KV decode.  q (B, H, D); k, v (B, S, KVH, D); kv_len (B,)
    integers.  Returns ``(out, m, l)`` — see ``kernels/flash_decode.py``
    (``out_dtype``: a float32 ``out`` of bf16 q on a bf16 cache)."""
    if kv_len.dtype != torch.int32 or kv_len.device != q.device:
        kv_len = kv_len.to(q.device, torch.int32)
    return fd.flash_decode(q, k, v, kv_len, out_dtype)


def ssd_scan(x, dt, a, B_, C_, *, chunk=128, y_dtype=None):
    """Chunked SSD scan.  Returns ``(y, final_state)`` — see
    ``kernels/ssd_scan.py``.  The chunk is capped at the sequence length
    (at least 16), as the reference caps it; ``y_dtype`` (x's by
    default) is the output's dtype.  dt and a go in float32 (float64 with
    a float64 x)."""
    chunk = min(chunk, max(x.shape[1], 16))
    acc = torch.promote_types(x.dtype, torch.float32)
    return ssd.SSDScan.apply(x.contiguous(), dt.to(acc).contiguous(),
                             a.to(acc).contiguous(), B_.contiguous(),
                             C_.contiguous(), chunk,
                             x.dtype if y_dtype is None else y_dtype)
