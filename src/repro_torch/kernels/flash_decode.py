"""Flash decode: single-query GQA attention over a KV cache.

The port of the reference package's ``kernels/flash_decode.py``.
``flash_decode(q, k, v, kv_len)`` dispatches by the device of ``q``: a
CPU tensor takes the plain PyTorch version (``ref.decode_reference``); a
CUDA tensor launches the hand-written Hopper kernel of
``csrc/flash_decode.cu`` — a split-KV partial pass and a combine pass,
counted as one launch in ``LAUNCHES["flash_decode"]`` — or raises;
nothing falls back.  The public entry with the reference's name is
``kernels/ops.py:flash_decode``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.device import on_card
from repro_torch.kernels import ref

#: kernel launches since the last ``reset_launches()``
LAUNCHES = {"flash_decode": 0}

#: keys per shared-memory tile (``kTile`` of the .cu)
TILE = 64
#: the kernel's limits: head dim a multiple of 8, at most 256, and at
#: most 2048 accumulator elements (q heads per kv head x head dim)
MAX_HEAD_DIM = 256
MAX_GROUP_ELEMS = 2048
#: dtype codes of the C entry point
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    LAUNCHES["flash_decode"] = 0


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def n_splits(b: int, kvh: int, s: int, sms: int) -> int:
    """Splits of the KV axis: enough CTAs (one per row, kv head and
    split) for four on every SM, and no more splits than tiles."""
    tiles = -(-s // TILE)
    return max(1, min(tiles, -(-4 * sms // max(b * kvh, 1))))


def _check(q, k, v, kv_len):
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_decode: q must be (B, H, D) and k, v "
                         f"(B, S, KVH, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, d = q.shape
    kvh = k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kvh < 1 or h % kvh:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} does not fit "
                         f"k/v {tuple(k.shape)}")
    if d % 8 or d > MAX_HEAD_DIM or (h // kvh) * d > MAX_GROUP_ELEMS:
        raise ValueError(f"flash_decode: head dim {d} with {h // kvh} q "
                         f"heads per kv head is outside the kernel's "
                         f"limits")
    if q.dtype not in _DTYPE_CODE or k.dtype not in _DTYPE_CODE \
            or v.dtype != k.dtype:
        raise ValueError(f"flash_decode: q, k, v must be float32 or "
                         f"bfloat16 (k and v alike), got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if kv_len.shape != (b,) or kv_len.dtype != torch.int32:
        raise ValueError(f"flash_decode: kv_len must be ({b},) int32, got "
                         f"{tuple(kv_len.shape)} {kv_len.dtype}")
    for t in (k, v, kv_len):
        if t.device != q.device:
            raise ValueError(f"flash_decode: tensors on {t.device} and "
                             f"{q.device}")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_decode: q, k, v must be contiguous and "
                             "16-byte aligned")


def flash_decode(q, k, v, kv_len):
    """q (B, H, D); k, v (B, S, KVH, D); kv_len (B,) int32.

    Returns ``(out (B, H, D) in q's dtype, m (B, H) f32, l (B, H) f32)``:
    ``out`` normalised, ``(m, l)`` the softmax statistics for combining
    partials across shards (``acc = out * l``).
    """
    if not on_card(q):
        return ref.decode_reference(q, k, v, kv_len)
    from repro_torch.kernels import build
    _check(q, k, v, kv_len)
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    dev = q.device
    splits = n_splits(b, kvh, s, _sm_count(dev.index or 0))
    out = torch.empty_like(q)
    m = torch.empty((b, h), dtype=torch.float32, device=dev)
    l = torch.empty((b, h), dtype=torch.float32, device=dev)
    m_part = torch.empty((b, h, splits), dtype=torch.float32, device=dev)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((b, h, splits, d), dtype=torch.float32,
                           device=dev)
    lib = build.library("flash_decode")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.flash_decode(
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype], q.data_ptr(),
            k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), b, s, h, kvh, d,
            splits, d ** -0.5, m_part.data_ptr(), l_part.data_ptr(),
            acc_part.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
            stream)
    build.check("flash_decode", code, "flash_decode")
    LAUNCHES["flash_decode"] += 1
    return out, m, l
