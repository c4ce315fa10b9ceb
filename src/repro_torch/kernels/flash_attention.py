"""Flash attention: tiled causal / sliding-window GQA attention, forward.

The port of the reference package's ``kernels/flash_attention.py``.
``flash_attention(q, k, v, causal=, window=, q_offset=)`` dispatches by
the device
of ``q``: a CPU tensor takes the plain PyTorch version
(``ref.mha_reference``); a CUDA tensor launches one of the hand-written
Hopper kernels of ``csrc/flash_attention.cu``, or raises; nothing falls
back.  The kernels mask their own ragged tiles, so nothing is padded.
The public entry with the reference's name is
``kernels/ops.py:flash_attention``.  A fake tensor (the dry run's,
``device.traced``) launches nothing: the call adds ``cost`` to the dry
run's count (``trace.kernel``) and returns an empty output.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import trace
from repro_torch.device import on_card, traced
from repro_torch.kernels import ref

#: kernel launches since the last ``reset_launches()``: the total, and
#: each variant's share of it
LAUNCHES = {"flash_attention": 0, "flash_attention_wgmma": 0,
            "flash_attention_simt": 0}

#: the kernels' limits: head dim a multiple of 8, at most 128; at most 64
#: q heads per kv head
ROWS = 64
MAX_HEAD_DIM = 128
#: the tensor maps of the wgmma variant take byte strides below 2**40
#: (the batch stride of q and of k/v)
MAX_TMA_STRIDE = 1 << 40
#: dtype codes of the SIMT entry point
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def variant(q, k) -> str:
    """The kernel a pair of dtypes takes: ``"wgmma"`` (tensor cores, TMA)
    for bf16 q with bf16 k/v, ``"simt"`` (f32 FMAs) for every other
    pair.  Chosen by dtype alone, never by trying one and catching."""
    if q.dtype == torch.bfloat16 and k.dtype == torch.bfloat16:
        return "wgmma"
    return "simt"


def attn_pairs(sq, skv, causal, window, q_offset=0) -> int:
    """(query, key) pairs inside the mask: what the kernel must compute
    (query row s at position ``q_offset + s``)."""
    qpos = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(qpos + 1, skv) if causal else np.full_like(qpos, skv)
    lo = np.maximum(qpos - window + 1, 0) if window \
        else np.zeros_like(qpos)
    return int(np.maximum(hi - lo, 0).sum())


def cost(q, k, causal, window, q_offset=0) -> tuple[int, int]:
    """``(operations, bytes)`` of one call at q's and k's shapes and
    dtypes: q, k, v read once and out written once; 4 D operations per
    head and (query, key) pair inside the causal band or window (the two
    products), at the peak of q's dtype (bf16 on the tensor cores)."""
    b, sq, h, d = q.shape
    n_bytes = 2 * q.numel() * q.element_size() \
        + 2 * k.numel() * k.element_size()
    return 4 * d * b * h * attn_pairs(sq, k.shape[1], causal, window,
                                      q_offset), n_bytes


def _check(q, k, v, window, q_offset=0):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q must be (B, Sq, H, D) and k, "
                         f"v (B, Skv, KVH, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
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
    if window < 0 or q_offset < 0:
        raise ValueError(f"flash_attention: window {window} or q_offset "
                         f"{q_offset} < 0")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"flash_attention: tensors on {t.device} and "
                             f"{q.device}")
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError("flash_attention: q, k, v must be contiguous")
    if variant(q, k) == "wgmma" \
            and max(sq * h, skv * kvh) * d * 2 >= MAX_TMA_STRIDE:
        raise ValueError(f"flash_attention: a batch stride of "
                         f"{max(sq * h, skv * kvh) * d * 2} bytes is beyond "
                         f"the bf16 kernel's tensor maps")


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """q (B, Sq, H, D); k, v (B, Skv, KVH, D) -> (B, Sq, H, D) in q's
    dtype.  ``window > 0`` keeps keys with ``kpos > qpos - window``.
    Query row s stands at position ``qpos = q_offset + s``: a block of the
    query rows of a longer sequence against its whole K/V (the
    sequence-parallel attention of a mesh); 0 for a whole sequence.

    On the card, bf16 q with bf16 k/v launches ``flash_attention_wgmma``
    (wgmma products fed by TMA, P multiplied as bf16 hi + lo parts);
    every other dtype pair (float32, and float32 mixed with bf16)
    launches the SIMT kernel ``flash_attention_fwd``, whose f32 FMAs keep
    the float32 checks free of TF32 or bf16 rounding.  A bf16 input the
    wgmma kernel cannot take raises in ``_check``; it is never sent to
    the SIMT kernel.  Each call counts one launch in
    ``LAUNCHES["flash_attention"]`` and one in its variant's entry."""
    if not on_card(q):
        return ref.mha_reference(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    _check(q, k, v, window, q_offset)
    if traced(q):
        trace.kernel("flash_attention",
                     *cost(q, k, causal, window, q_offset))
        return torch.empty_like(q)
    from repro_torch.kernels import build
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("flash_attention: q, k, v must be 16-byte "
                             "aligned")
    kind = variant(q, k)
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = build.library("flash_attention")
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            skv, h, kvh, d, int(bool(causal)), int(window), int(q_offset),
            d ** -0.5)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if kind == "wgmma":
            code = lib.flash_attention_wgmma(*args, stream)
        else:
            code = lib.flash_attention(_DTYPE_CODE[q.dtype],
                                       _DTYPE_CODE[k.dtype], *args, stream)
    build.check("flash_attention", code, f"flash_attention ({kind})")
    LAUNCHES["flash_attention"] += 1
    LAUNCHES[f"flash_attention_{kind}"] += 1
    return out


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient.  The forward is the wrapper's
    call as it stands (the kernel on the card, ``ref.mha_reference`` on
    the CPU), and under ``torch.no_grad()`` nothing else runs.  The
    backward is ``ref.mha_backward`` from the saved q, k, v and output:
    plain PyTorch over blocks of query rows, because the TPU kernel has
    no backward to port (a kernel for it is ROADMAP queue 2 item 3)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset=0):
        out = flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window, ctx.q_offset = causal, window, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        return (*ref.mha_backward(q, k, v, out, dout, causal=ctx.causal,
                                  window=ctx.window, q_offset=ctx.q_offset),
                None, None, None)
