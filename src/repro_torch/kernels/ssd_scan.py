"""Chunked SSD scan (Mamba-2 state-space duality), forward.

The port of the reference package's ``kernels/ssd_scan.py``.
``ssd_scan(x, dt, a, B_, C_, chunk=, y_dtype=)`` dispatches by the
device of ``x``: a CPU tensor takes the plain PyTorch version
(``ref.ssd_reference``, the exact sequential recurrence, whatever the
chunk); a CUDA tensor launches the hand-written Hopper kernels of
``csrc/ssd_scan.cu``, or raises; nothing falls back.  bf16 x takes the
chunk-parallel variant on tensor cores (three kernels: the chunks' own
states, the carry across chunks, the outputs), f32 x the FMA variant
(one kernel); either way one call counts one launch in
``LAUNCHES["ssd_scan"]`` and in its variant's count.  The kernels mask
the ragged last chunk, so nothing is padded.  ``SSDScan`` gives y a
gradient (plain PyTorch: the TPU kernel has no backward).  The public
entry with the reference's name, ``kernels/ops.py:ssd_scan``, goes
through it.  A fake tensor (the dry run's, ``device.traced``) launches
nothing: the call adds ``cost`` to the dry run's count
(``trace.kernel``) and returns empty outputs, after allocating the
scratch the kernels would.
"""
from __future__ import annotations

import torch

from repro_torch import trace
from repro_torch.device import on_card, traced
from repro_torch.kernels import ref

#: kernel launches since the last ``reset_launches()``: the total, and
#: each variant's share of it
LAUNCHES = {"ssd_scan": 0, "ssd_scan_mma": 0, "ssd_scan_simt": 0}

#: the kernel's limits: state size N and head dim P multiples of 8,
#: N <= 128, P <= 64; chunks of at most 256 positions
MAX_STATE = 128
MAX_HEAD_DIM = 64
MAX_CHUNK = 256
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
    return build.kernels_launched("ssd_scan")


def variant(x) -> str:
    """The kernel x's dtype takes: ``"mma"`` (chunk-parallel, tensor
    cores) for bf16, ``"simt"`` (one CTA per row and head walking the
    chunks on f32 FMAs) for float32."""
    return "mma" if x.dtype == torch.bfloat16 else "simt"


def chunk_states_shape(b: int, s: int, h: int, n: int, p: int,
                       chunk: int) -> tuple:
    """The chunk-parallel variant's f32 scratch: every chunk's state
    (B, chunks, H, N, P), then each chunk's decay (B, chunks, H)."""
    nc = -(-s // chunk)
    return (b, nc, h, n, p), (b, nc, h)


def ssd_ops(b, s, h, p, n, chunk) -> int:
    """Operations of the scan's products: per (row, chunk of L) C Bᵀ
    over the causal half, L(L+1) N operations (shared by the heads), and
    per (row, head, chunk) its product with x, L(L+1) P, plus C S_prev
    and Bᵀ x, 2 L N P each."""
    lens = [min(chunk, s - c0) for c0 in range(0, s, chunk)]
    return sum(b * ln * (ln + 1) * n + b * h * (ln * (ln + 1) * p
                                               + 4 * ln * n * p)
               for ln in lens)


def cost(x, B_, chunk, y_dtype) -> tuple[int, int]:
    """``(operations, bytes)`` of one call at x's and B_'s shapes and
    dtypes: x, dt, a, B_, C_ read once, y (in ``y_dtype``) and the final
    state written once; ``ssd_ops`` operations."""
    b, s, h, p = x.shape
    n = B_.shape[-1]
    es = torch.finfo(y_dtype).bits // 8
    n_bytes = (x.numel() * x.element_size() + 2 * B_.numel()
               * B_.element_size() + 2 * b * s * h * 4 + x.numel() * es
               + b * h * n * p * 4)
    return ssd_ops(b, s, h, p, n, chunk), n_bytes


def _check(x, dt, a, B_, C_, chunk, y_dtype):
    if x.dim() != 4 or dt.dim() != 3 or a.shape != dt.shape \
            or B_.dim() != 3 or C_.shape != B_.shape:
        raise ValueError(f"ssd_scan: x must be (B, S, H, P), dt and a "
                         f"(B, S, H), B_ and C_ (B, S, N); got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(a.shape)}, {tuple(B_.shape)}, "
                         f"{tuple(C_.shape)}")
    b, s, h, p = x.shape
    n = B_.shape[-1]
    if dt.shape != (b, s, h) or B_.shape[:2] != (b, s):
        raise ValueError(f"ssd_scan: x {tuple(x.shape)} does not fit dt "
                         f"{tuple(dt.shape)} or B_ {tuple(B_.shape)}")
    if n % 8 or n > MAX_STATE or p % 8 or p > MAX_HEAD_DIM \
            or not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: N {n}, P {p}, chunk {chunk} are "
                         f"outside the kernel's limits")
    if x.dtype not in _DTYPE_CODE or B_.dtype != x.dtype \
            or C_.dtype != x.dtype or y_dtype not in _DTYPE_CODE:
        raise ValueError(f"ssd_scan: x, B_, C_ must share float32 or "
                         f"bfloat16, y float32 or bfloat16; got {x.dtype}, "
                         f"{B_.dtype}, {C_.dtype}, y {y_dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"ssd_scan: dt and a must be float32, got "
                         f"{dt.dtype}, {a.dtype}")
    for t in (dt, a, B_, C_):
        if t.device != x.device:
            raise ValueError(f"ssd_scan: tensors on {t.device} and "
                             f"{x.device}")
    for t in (x, dt, a, B_, C_):
        if not t.is_contiguous():
            raise ValueError("ssd_scan: inputs must be contiguous")


def ssd_scan(x, dt, a, B_, C_, *, chunk=128, y_dtype=None):
    """x (B, S, H, P); dt, a (B, S, H) f32; B_, C_ (B, S, N) in x's dtype.

    Returns ``(y (B, S, H, P) in y_dtype (x's by default), final state
    (B, H, N, P) f32)``.
    """
    y_dtype = x.dtype if y_dtype is None else y_dtype
    if not on_card(x):
        y, state = ref.ssd_reference(x, dt, a, B_, C_)
        return y.to(y_dtype), state
    _check(x, dt, a, B_, C_, chunk, y_dtype)
    b, s, h, p = x.shape
    n = B_.shape[-1]
    kind = variant(x)
    y = torch.empty((b, s, h, p), dtype=y_dtype, device=x.device)
    state = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    states = decay = None
    if kind == "mma":
        st_shape, dec_shape = chunk_states_shape(b, s, h, n, p, chunk)
        states = torch.empty(st_shape, dtype=torch.float32, device=x.device)
        decay = torch.empty(dec_shape, dtype=torch.float32, device=x.device)
    if traced(x):
        trace.kernel("ssd_scan", *cost(x, B_, chunk, y_dtype))
        return y, state
    from repro_torch.kernels import build
    for t in (x, dt, a, B_, C_):
        if t.data_ptr() % 16:
            raise ValueError("ssd_scan: inputs must be 16-byte aligned")
    lib = build.library("ssd_scan")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.ssd_scan(
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[y_dtype], x.data_ptr(),
            dt.data_ptr(), a.data_ptr(), B_.data_ptr(), C_.data_ptr(),
            y.data_ptr(), state.data_ptr(),
            None if states is None else states.data_ptr(),
            None if decay is None else decay.data_ptr(), b, s, h, p, n,
            chunk, stream)
    build.check("ssd_scan", code, "ssd_scan")
    LAUNCHES["ssd_scan"] += 1
    LAUNCHES[f"ssd_scan_{kind}"] += 1
    return y, state


class SSDScan(torch.autograd.Function):
    """``ssd_scan`` with a gradient for y.  The forward is the wrapper's
    call as it stands (the kernels on the card, ``ref.ssd_reference`` on
    the CPU), and under ``torch.no_grad()`` nothing else runs.  The
    backward is ``ref.ssd_backward``: the plain chunked scan recomputed
    from the saved inputs at the forward's chunk and differentiated by
    autograd, because the TPU kernel has no backward to port (a kernel
    for it is ROADMAP queue 2 item 3).  The final state, which decode
    would carry on, gets no gradient."""

    @staticmethod
    def forward(ctx, x, dt, a, B_, C_, chunk, y_dtype):
        y, state = ssd_scan(x, dt, a, B_, C_, chunk=chunk, y_dtype=y_dtype)
        ctx.save_for_backward(x, dt, a, B_, C_)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(state)
        return y, state

    @staticmethod
    def backward(ctx, dy, _dstate):
        return (*ref.ssd_backward(*ctx.saved_tensors, dy, ctx.chunk), None,
                None)
