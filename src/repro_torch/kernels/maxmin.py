"""Max-min filling and loss factors: CUDA kernels with plain twins.

The port of the reference package's ``kernels/maxmin.py``.  Three
wrappers, each dispatched by the device of the tensors it is given:

- ``maxmin_round``  — one progressive-filling round;
- ``maxmin_rates``  — the whole filling loop, then the 1e-9 rate floor;
- ``loss_factors``  — the expected-value loss/DCQCN rate factors.

A CPU tensor takes the plain PyTorch version (``kernels/ref.py``).  A
CUDA tensor launches the hand-written Hopper kernel of
``csrc/maxmin.cu`` — ``maxmin_fill`` for the first two, ``loss_factors``
for the third — or raises; nothing falls back.  Each launch adds one to
``LAUNCHES[name]`` so a run can show which kernels its path went
through.

Inputs follow ``ref.py``: one lane (F, H) or a batch (B, F, H) of int32
link ids whose last capacity entry is the +inf sentinel; capacities are
(L+1,) shared or (B, L+1) per lane; per-flow vectors and masks are in
the capacity dtype, float32 or float64 (``maxmin_rates``' active mask
may also be bool).  A call allocates its outputs and nothing else: the
kernels keep their state in shared memory or in a scratch buffer kept
per device and stream (``_scratch``), and the card's attributes are
looked up once.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.device import on_card
from repro_torch.kernels import ref

#: kernel launches since the last ``reset_launches()``, by kernel name
LAUNCHES = {"maxmin_fill": 0, "loss_factors": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernels_launched() -> int:
    """Kernels the CUDA library has launched in this process, by its own
    count (one added beside each launch): a wrapper call's share is its
    kernels per call, with no tracer to lose any."""
    from repro_torch.kernels import build
    return build.kernels_launched("maxmin")


#: scratch buffers the kernels may use, one per (device, stream), grown
#: when a call needs more (``_scratch``)
_SCRATCH: dict = {}
#: kernel variants by name (the C entry's ``variant`` argument): "auto"
#: lets the library choose (``variant_of``); tests and the probe name one
_VARIANTS = {"auto": 0, "lane": 1, "grid": 2}
_ALIGN = 256


def _regions(*counts) -> int:
    """Bytes of scratch regions of ``counts`` bytes each, every one
    ``_ALIGN``-aligned (the kernel carves them in this order)."""
    return sum(-(-n // _ALIGN) * _ALIGN for n in counts)


@functools.lru_cache(maxsize=256)
def _fill_bytes(b, f, n_caps, es):
    """frozen, cap_out, tight, used, share, cnt and 4 B + 1 lane slots."""
    return _regions(b * f * es, b * n_caps * es, b * f * es, b * n_caps * es,
                    b * n_caps * es, b * n_caps * 4, (4 * b + 1) * 8)


@functools.lru_cache(maxsize=256)
def _loss_bytes(b, n_caps, es):
    """util and cnt of the grid kernel."""
    return _regions(b * n_caps * es, b * n_caps * 4)


def _stream(device) -> int:
    """The raw handle of the current stream on ``device``: what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without
    building a Stream object on every call."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _scratch(device, stream, n_bytes):
    """A byte buffer of at least ``n_bytes`` on ``device`` for calls on
    ``stream``: kept between calls, grown (doubled) when too small; the
    kernels reset what they use of it."""
    key = (device.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < n_bytes:
        size = max(n_bytes, 2 * buf.numel() if buf is not None else 0)
        buf = torch.empty(size, dtype=torch.uint8, device=device)
        _SCRATCH[key] = buf
    return buf


def variant_of(kernel, flow_links, cap) -> str:
    """The kernel a call of ``kernel`` ("maxmin_fill" or "loss_factors")
    takes on the card: ``"lane"`` (one CTA a lane, its state in shared
    memory) or ``"grid"`` (a cooperative grid over all lanes: lanes whose
    links do not fit, or a few lanes of 32k+ ids each); ``"grid, lane
    fits"`` when the grid was chosen for a lane the lane kernel could
    take."""
    from repro_torch.kernels import build
    fl = flow_links if flow_links.dim() == 3 else flow_links[None]
    code = build.library("maxmin").maxmin_variant(
        0 if kernel == "maxmin_fill" else 1, *fl.shape, cap.shape[-1],
        cap.element_size(), flow_links.device.index)
    if code < 0:
        build.check("maxmin", -code, "maxmin_variant")
    return {1: "lane", 2: "grid", 3: "grid, lane fits"}[code]


def _check(name, fl, cap, vecs, masks=()):
    """Validate what the kernel takes; returns (single, fl, cap, vecs)
    with one lane promoted to a batch of one.  ``masks`` are indices of
    vecs that may also be bool."""
    single = fl.dim() == 2
    if single:
        fl = fl[None]
        vecs = [v[None] for v in vecs]
    if fl.dim() != 3 or fl.dtype != torch.int32:
        raise ValueError(f"{name}: flow_links must be (F, H) or (B, F, H) "
                         f"int32, got {tuple(fl.shape)} {fl.dtype}")
    dtype = cap.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: capacities must be float32 or float64, "
                         f"got {dtype}")
    b, f, _ = fl.shape
    if cap.dim() not in (1, 2) or (cap.dim() == 2 and cap.shape[0] != b):
        raise ValueError(f"{name}: capacities must be (L+1,) or "
                         f"({b}, L+1), got {tuple(cap.shape)}")
    device = fl.device
    for i, v in enumerate(vecs):
        if v.shape != (b, f) or (v.dtype != dtype and not (
                i in masks and v.dtype == torch.bool)):
            raise ValueError(f"{name}: per-flow vectors must be ({b}, {f}) "
                             f"{dtype}, got {tuple(v.shape)} {v.dtype}")
    for t in (fl, cap, *vecs):
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return single, fl, cap, vecs


def _fill(fl, cap, state, rates, *, tol, bound, one_round, floor_rates,
          variant="auto"):
    """Launch ``maxmin_fill`` once: rounds while a flow is live and the
    round index is <= ``bound`` (``one_round``: exactly one).  ``state``
    is the active mask (bool or the capacity dtype; ``rates`` None) or
    the frozen mask with ``rates`` the rates to start from.  Returns
    (rates, frozen, cap_rem); the last two None unless ``one_round``."""
    from repro_torch.kernels import build
    vecs = [state] if rates is None else [state, rates]
    single, fl, cap, vecs = _check("maxmin_fill", fl, cap, vecs,
                                   masks=(0,) if rates is None else ())
    b, f, h = fl.shape
    n_caps = cap.shape[-1]
    dtype, device = cap.dtype, fl.device
    # outputs shaped and placed like the inputs (cheaper than torch.empty)
    out = torch.empty_like(vecs[-1]) if vecs[-1].dtype == dtype \
        else torch.empty((b, f), dtype=dtype, device=device)
    frozen = cap_out = None
    if one_round:
        frozen = torch.empty_like(vecs[0])
        cap_out = torch.empty_like(cap) if cap.dim() == 2 \
            else torch.empty((b, n_caps), dtype=dtype, device=device)
    stream = _stream(device)
    n_bytes = _fill_bytes(b, f, n_caps, cap.element_size())
    scratch = _scratch(device, stream, n_bytes)
    kind = 2 if rates is not None else \
        1 if vecs[0].dtype == torch.bool else 0
    lib = build.library("maxmin")
    fn = lib.maxmin_fill_f64 if dtype == torch.float64 \
        else lib.maxmin_fill_f32
    code = fn(fl.data_ptr(), b, f, h, cap.data_ptr(),
              n_caps if cap.dim() == 2 else 0, n_caps, vecs[0].data_ptr(),
              kind, vecs[1].data_ptr() if kind == 2 else None,
              out.data_ptr(), frozen.data_ptr() if one_round else None,
              cap_out.data_ptr() if one_round else None, scratch.data_ptr(),
              n_bytes, int(bound), float(tol), int(one_round),
              int(floor_rates), _VARIANTS[variant], device.index, stream)
    build.check("maxmin", code, "maxmin_fill")
    LAUNCHES["maxmin_fill"] += 1
    if not one_round:
        return (out[0] if single else out), None, None
    if single:
        return out[0], frozen[0], cap_out[0]
    return out, frozen, cap_out


def maxmin_round(flow_links, frozen, rates, cap_rem, *, tol: float = 1e-6):
    """One progressive-filling round; returns (rates, frozen, cap_rem)."""
    if not on_card(flow_links):
        return ref.maxmin_round_reference(flow_links, frozen, rates, cap_rem,
                                          tol=tol)
    return _fill(flow_links, cap_rem, frozen, rates, tol=tol, bound=0,
                 one_round=True, floor_rates=False)


def maxmin_rates(flow_links, cap, active, *, tol: float = 1e-6,
                 max_rounds=None):
    """Max-min fair rates by progressive filling, floored at 1e-9.

    ``active`` is a 0/1 mask (bool or the capacity dtype).  Rounds run
    while a flow is live and the round index is <= F (``max_rounds - 1``
    when given: the dynamic-segment lanes pass ``tol=1e-12,
    max_rounds=64`` to mirror the numpy ``static_maxmin`` filling).
    """
    if not on_card(flow_links):
        return ref.maxmin_rates_reference(flow_links, cap, active, tol=tol,
                                          max_rounds=max_rounds)
    bound = flow_links.shape[-2] if max_rounds is None else max_rounds - 1
    return _fill(flow_links, cap, active, None, tol=tol, bound=bound,
                 one_round=False, floor_rates=True)[0]


def loss_factors(flow_links, rates, active, cap, q, wsq, wnd, ecn, *,
                 dcqcn_num: float, dcqcn_min: float, util_eps: float = 1e-3):
    """Expected-value loss/DCQCN rate factors, (F,) or (B, F) in (0, 1]."""
    if not on_card(flow_links):
        return ref.loss_factors_reference(
            flow_links, rates, active, cap, q, wsq, wnd, ecn,
            dcqcn_num=dcqcn_num, dcqcn_min=dcqcn_min, util_eps=util_eps)
    return _loss(flow_links, rates, active, cap, q, wsq, wnd, ecn,
                 dcqcn_num=dcqcn_num, dcqcn_min=dcqcn_min,
                 util_eps=util_eps)


def _loss(flow_links, rates, active, cap, q, wsq, wnd, ecn, *, dcqcn_num,
          dcqcn_min, util_eps=1e-3, variant="auto"):
    """Launch ``loss_factors`` once."""
    from repro_torch.kernels import build
    single, fl, cap, vecs = _check("loss_factors", flow_links, cap,
                                   [rates, active, q, wsq, wnd, ecn])
    b, f, h = fl.shape
    n_caps = cap.shape[-1]
    dtype, device = cap.dtype, fl.device
    fac = torch.empty_like(vecs[0])
    stream = _stream(device)
    n_bytes = _loss_bytes(b, n_caps, cap.element_size())
    scratch = _scratch(device, stream, n_bytes)
    lib = build.library("maxmin")
    fn = lib.loss_factors_f64 if dtype == torch.float64 \
        else lib.loss_factors_f32
    code = fn(fl.data_ptr(), b, f, h, *(v.data_ptr() for v in vecs[:2]),
              cap.data_ptr(), n_caps if cap.dim() == 2 else 0, n_caps,
              *(v.data_ptr() for v in vecs[2:]), fac.data_ptr(),
              scratch.data_ptr(), n_bytes, float(dcqcn_num),
              float(dcqcn_min), float(util_eps), _VARIANTS[variant],
              device.index, stream)
    build.check("maxmin", code, "loss_factors")
    LAUNCHES["loss_factors"] += 1
    return fac[0] if single else fac
