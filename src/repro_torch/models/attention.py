"""Attention: GQA with causal / bidirectional / sliding-window variants.

The port of the reference package's ``models/attention.py``:

- ``dense_attention``   — O(S^2)-memory attention, the oracle of the
  tests (causal / bidirectional / sliding-window);
- ``attention``         — the train/prefill dispatch.  Every shape runs
  ``kernels/ops.flash_attention`` (the hand-written Hopper kernel on a
  CUDA tensor, its plain version on a CPU tensor), which takes the place
  of the reference's ``dense_attention``, ``chunked_attention`` and
  ``swa_attention`` alike, so those two are not ported;
- ``decode_attention``  — single-query attention against a partially
  filled cache.  It runs ``kernels/ops.flash_decode`` the same way;
- ``cross_attention``   — bidirectional attention of the decoder over the
  encoder memory: ``flash_decode`` over the whole memory for one query,
  ``flash_attention(causal=False)`` for more.

``attention(q_offset=)`` is the reference's sequence-parallel branch: a
block of query rows at global positions against the whole K/V, which a
mesh's ``model`` ranks take when the heads do not split
(``models/model.attn_core``).

Shapes: q (B, Sq, H, hd); k, v (B, Skv, KVH, hd); H = KVH * rep (GQA).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops

NEG_INF = -1e30


def _split_gqa(q, n_kv):
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def dense_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Reference O(S^2)-memory attention.  Small seqs / oracle only."""
    b, sq, h, d = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    qg = _split_gqa(q, n_kv)
    logits = torch.einsum("bqkrd,bskd->bkrqs", qg.float(), k.float()) \
        / math.sqrt(d)
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrqs,bskd->bqkrd", w.to(v.dtype), v)
    return out.reshape(b, sq, h, d)


def attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Train/prefill attention.  The reference picks ``dense_attention``,
    ``swa_attention`` or ``chunked_attention`` by shape; the kernel
    computes all three, and applies the window at every length (the
    reference's ``chunked_attention`` branch drops it: ROADMAP queue
    3).  Query row s stands at position ``q_offset + s`` (the reference's
    ``q_offset`` branch, which applies the window at every length)."""
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)


def decode_attention(q, k, v, *, kv_len=None, window=0):
    """Single-query attention against a (possibly partially filled) cache.

    q: (B, 1, H, hd); k, v: (B, S_cache, KVH, hd).
    kv_len: (B,) integers — number of valid cache entries (<= S_cache);
    None attends the whole cache.  ``window``: the model's sliding window.
    The port's windowed caches hold at most ``window`` slots (a rolling
    buffer whose valid slots are the prefix ``kv_len``), where the window
    excludes nothing; a longer cache, whose window would cut the middle
    of a linear cache, raises.
    """
    if window and k.shape[1] > window:
        raise ValueError(f"decode_attention: a {k.shape[1]}-slot cache is "
                         f"longer than the window {window}; windowed "
                         f"caches are rolling buffers of at most the "
                         f"window")
    b = q.shape[0]
    if kv_len is None:
        kv_len = torch.full((b,), k.shape[1], dtype=torch.int32,
                            device=q.device)
    out, _, _ = ops.flash_decode(q[:, 0].contiguous(), k.contiguous(),
                                 v.contiguous(), kv_len)
    return out[:, None]


def cross_attention(q, mem_k, mem_v):
    """Bidirectional cross-attention (decoder -> encoder memory): q (B,
    Sq, H, hd) over every position of mem_k, mem_v (B, S_mem, KVH, hd),
    in q's dtype."""
    if q.shape[1] == 1:
        return decode_attention(q, mem_k, mem_v)
    return ops.flash_attention(q, mem_k, mem_v, causal=False)
