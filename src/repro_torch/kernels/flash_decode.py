"""Flash decode: single-query GQA attention over a KV cache.

The port of the reference package's ``kernels/flash_decode.py``.
``flash_decode(q, k, v, kv_len)`` dispatches by the device of ``q``: a
CPU tensor takes the plain PyTorch version (``ref.decode_reference``); a
CUDA tensor launches the hand-written Hopper kernel of
``csrc/flash_decode.cu`` — one launch, the splits of the KV axis of each
(row, kv head) one thread-block cluster that merges its partials in
shared memory — counted in ``LAUNCHES["flash_decode"]`` and in its
variant's count, or raises; nothing falls back.  A call allocates only
its outputs and keeps no state between calls (a CUDA graph can capture
it).  The public entry with the reference's name is
``kernels/ops.py:flash_decode``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch import trace
from repro_torch.device import on_card, traced
from repro_torch.kernels import ref

#: kernel launches since the last ``reset_launches()``: the total, and
#: each variant's share of it
LAUNCHES = {"flash_decode": 0, "flash_decode_mma": 0,
            "flash_decode_simt": 0}

#: keys per tile of the tensor-core variant (``kMmaTile`` of the .cu);
#: the split rule counts tiles of this size whatever the variant
TILE = 64
#: q heads one CTA of the tensor-core variant holds (``kMmaHeads``)
MMA_HEADS = 16
#: CTAs the split rule aims at for every SM, and the most splits a call
#: may have (``kMaxSplits``: the splits of a group are one portable
#: cluster)
CTAS_PER_SM = 2
MAX_SPLITS = 8
#: the kernel's limits: head dim a multiple of 8, at most 256, and at
#: most 2048 accumulator elements (q heads per kv head x head dim)
MAX_HEAD_DIM = 256
MAX_GROUP_ELEMS = 2048
#: dtype codes of the C entry point
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernels_launched() -> int:
    """Device kernels the CUDA library has launched in this process, by
    its own count (one added beside each launch): a wrapper call's share
    is the kernels per call, with no tracer to lose any."""
    from repro_torch.kernels import build
    return build.kernels_launched("flash_decode")


def variant(q, k) -> str:
    """The kernel a pair of dtypes takes: ``"mma"`` (tensor cores) for
    bf16 q on a bf16 cache, ``"simt"`` (f32 FMAs) for every other pair.
    Chosen by dtype alone."""
    if q.dtype == torch.bfloat16 and k.dtype == torch.bfloat16:
        return "mma"
    return "simt"


def head_groups(rep: int, kind: str) -> int:
    """CTAs along the q heads of one kv head: groups of 16 in the
    tensor-core variant, all rep heads in one CTA in the FMA one."""
    return -(-rep // MMA_HEADS) if kind == "mma" else 1


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def n_splits(b: int, groups: int, s: int, sms: int) -> int:
    """Splits of the KV axis: enough CTAs (one per row, CTA group and
    split; ``groups`` = kv heads x head groups) for two on every SM, no
    more splits than 64-key tiles of the cache, and at most 8."""
    tiles = -(-s // TILE)
    return max(1, min(tiles, MAX_SPLITS,
                      -(-CTAS_PER_SM * sms // max(b * groups, 1))))


@functools.lru_cache(maxsize=None)
def _plan(q_shape, k_shape, v_shape, q_dtype, k_dtype, v_dtype, sms):
    """What a call's shapes and dtypes decide, worked out once per
    combination: raises where the kernel cannot take them, else returns
    ``(q code, kv code, variant, splits, scale)``."""
    if len(q_shape) != 3 or len(k_shape) != 4 or v_shape != k_shape:
        raise ValueError(f"flash_decode: q must be (B, H, D) and k, v "
                         f"(B, S, KVH, D), got {tuple(q_shape)}, "
                         f"{tuple(k_shape)}, {tuple(v_shape)}")
    b, h, d = q_shape
    s, kvh = k_shape[1], k_shape[2]
    if k_shape[0] != b or k_shape[3] != d or kvh < 1 or h % kvh:
        raise ValueError(f"flash_decode: q {tuple(q_shape)} does not fit "
                         f"k/v {tuple(k_shape)}")
    if d % 8 or d > MAX_HEAD_DIM or (h // kvh) * d > MAX_GROUP_ELEMS:
        raise ValueError(f"flash_decode: head dim {d} with {h // kvh} q "
                         f"heads per kv head is outside the kernel's "
                         f"limits")
    if q_dtype not in _DTYPE_CODE or k_dtype not in _DTYPE_CODE \
            or v_dtype != k_dtype:
        raise ValueError(f"flash_decode: q, k, v must be float32 or "
                         f"bfloat16 (k and v alike), got {q_dtype}, "
                         f"{k_dtype}, {v_dtype}")
    kind = "mma" if q_dtype == k_dtype == torch.bfloat16 else "simt"
    groups = kvh * head_groups(h // kvh, kind)
    splits = n_splits(b, groups, s, sms)
    return (_DTYPE_CODE[q_dtype], _DTYPE_CODE[k_dtype], kind, splits,
            d ** -0.5)


def cost(q, k, n_keys: int) -> tuple[int, int]:
    """``(operations, bytes)`` of one call over ``n_keys`` valid cache
    positions in all (the sum of kv_len): those keys and values read
    once, q read and out, m, l written once; ~4 float32 operations per
    (key, q head, dim)."""
    b, h, d = q.shape
    n_bytes = (n_keys * k.shape[2] * d * 2 * k.element_size()
               + 2 * q.numel() * q.element_size() + 2 * b * h * 4)
    return 4 * n_keys * h * d, n_bytes


def _check(q, k, v, kv_len):
    """What may change between calls of one plan: kv_len, the devices,
    the layout."""
    if kv_len.shape != q.shape[:1] or kv_len.dtype != torch.int32:
        raise ValueError(f"flash_decode: kv_len must be ({q.shape[0]},) "
                         f"int32, got {tuple(kv_len.shape)} {kv_len.dtype}")
    for t in (k, v, kv_len):
        if t.device != q.device:
            raise ValueError(f"flash_decode: tensors on {t.device} and "
                             f"{q.device}")
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError("flash_decode: q, k, v must be contiguous")


def flash_decode(q, k, v, kv_len, out_dtype=None):
    """q (B, H, D); k, v (B, S, KVH, D); kv_len (B,) int32.

    Returns ``(out (B, H, D) in out_dtype, m (B, H) f32, l (B, H) f32)``:
    ``out`` normalised, ``(m, l)`` the softmax statistics for combining
    partials across shards (``acc = out * l``).  ``out_dtype`` is q's
    dtype by default; bf16 q on a bf16 cache may ask for a float32
    ``out``, the sum before its last rounding, for a caller that merges
    the partials of several calls and rounds once.
    """
    out_dtype = q.dtype if out_dtype is None else out_dtype
    if out_dtype != q.dtype and not (
            q.dtype == k.dtype == torch.bfloat16
            and out_dtype == torch.float32):
        raise ValueError(f"flash_decode: a {out_dtype} out takes bf16 q on "
                         f"a bf16 cache, got {q.dtype} q, {k.dtype} cache")
    if not on_card(q):
        return ref.decode_reference(q, k, v, kv_len, out_dtype)
    dev = q.device
    b, h, d = q.shape
    if traced(q):
        # the splits, which the SM count decides, do not change the work
        _plan(q.shape, k.shape, v.shape, q.dtype, k.dtype, v.dtype, 1)
        _check(q, k, v, kv_len)
        trace.kernel("flash_decode", *cost(q, k, b * k.shape[1]))
        m, l = torch.empty((2, b, h), dtype=torch.float32,
                           device=dev).unbind(0)
        return torch.empty_like(q, dtype=out_dtype), m, l
    from repro_torch.kernels import build
    q_code, kv_code, kind, splits, scale = _plan(
        q.shape, k.shape, v.shape, q.dtype, k.dtype, v.dtype,
        _sm_count(dev.index))
    _check(q, k, v, kv_len)
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("flash_decode: q, k, v must be 16-byte "
                             "aligned")
    out = torch.empty_like(q, dtype=out_dtype)
    m, l = torch.empty((2, b, h), dtype=torch.float32, device=dev).unbind(0)
    args = (q_code, kv_code, _DTYPE_CODE[out_dtype], q.data_ptr(),
            k.data_ptr(), v.data_ptr(),
            kv_len.data_ptr(), b, k.shape[1], h, k.shape[2], d, splits,
            scale, out.data_ptr(), m.data_ptr(), l.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    lib = build.library("flash_decode")
    if dev.index == torch.cuda.current_device():
        code = lib.flash_decode(*args)
    else:
        with torch.cuda.device(dev):
            code = lib.flash_decode(*args)
    build.check("flash_decode", code, "flash_decode")
    LAUNCHES["flash_decode"] += 1
    LAUNCHES["flash_decode_" + kind] += 1
    return out, m, l
