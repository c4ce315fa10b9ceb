"""Flash attention: tiled causal / sliding-window GQA attention, forward.

The port of the reference package's ``kernels/flash_attention.py``.
``flash_attention(q, k, v, causal=, window=)`` dispatches by the device
of ``q``: a CPU tensor takes the plain PyTorch version
(``ref.mha_reference``); a CUDA tensor launches the hand-written Hopper
kernel of ``csrc/flash_attention.cu``, counted in
``LAUNCHES["flash_attention"]``, or raises; nothing falls back.  The
kernel masks its own ragged tiles, so nothing is padded.  The public
entry with the reference's name is ``kernels/ops.py:flash_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.device import on_card
from repro_torch.kernels import ref

#: kernel launches since the last ``reset_launches()``
LAUNCHES = {"flash_attention": 0}

#: query rows a CTA holds: 64 / rep positions of one kv head's rep q heads
ROWS = 64
#: the kernel's limits: head dim a multiple of 8, at most 128; at most 64
#: q heads per kv head
MAX_HEAD_DIM = 128
#: dtype codes of the C entry point
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q must be (B, Sq, H, D) and k, "
                         f"v (B, Skv, KVH, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    kvh = k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kvh < 1 or h % kvh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k/v {tuple(k.shape)}")
    if d % 8 or d > MAX_HEAD_DIM or h // kvh > ROWS:
        raise ValueError(f"flash_attention: head dim {d} with {h // kvh} q "
                         f"heads per kv head is outside the kernel's "
                         f"limits")
    if q.dtype not in _DTYPE_CODE or k.dtype not in _DTYPE_CODE \
            or v.dtype != k.dtype:
        raise ValueError(f"flash_attention: q, k, v must be float32 or "
                         f"bfloat16 (k and v alike), got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"flash_attention: tensors on {t.device} and "
                             f"{q.device}")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention: q, k, v must be contiguous "
                             "and 16-byte aligned")


def flash_attention(q, k, v, *, causal=True, window=0):
    """q (B, Sq, H, D); k, v (B, Skv, KVH, D) -> (B, Sq, H, D) in q's
    dtype.  ``window > 0`` keeps keys with ``kpos > qpos - window``."""
    if not on_card(q):
        return ref.mha_reference(q, k, v, causal=causal, window=window)
    from repro_torch.kernels import build
    _check(q, k, v, window)
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = build.library("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention(
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype], q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv, h, kvh,
            d, int(bool(causal)), int(window), d ** -0.5, stream)
    build.check("flash_attention", code, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
