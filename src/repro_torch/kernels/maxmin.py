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
the capacity dtype, float32 or float64.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

#: kernel launches since the last ``reset_launches()``, by kernel name
LAUNCHES = {"maxmin_fill": 0, "loss_factors": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; other devices raise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"repro_torch kernels take CPU or CUDA tensors, "
                     f"not {t.device}")


def _group(n_hops: int) -> int:
    """Threads per flow: H rounded up to a power of two, at most a warp."""
    return min(32, 1 << max(n_hops - 1, 0).bit_length())


def _check(name, fl, cap, vecs):
    """Validate what the kernel takes; returns (single, fl, cap, vecs)
    with one lane promoted to a batch of one."""
    single = fl.dim() == 2
    if single:
        fl = fl[None]
        vecs = [v[None] for v in vecs]
    if fl.dim() != 3 or fl.dtype != torch.int32:
        raise ValueError(f"{name}: flow_links must be (F, H) or (B, F, H) "
                         f"int32, got {tuple(fl.shape)} {fl.dtype}")
    if cap.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: capacities must be float32 or float64, "
                         f"got {cap.dtype}")
    b, f, _ = fl.shape
    if cap.dim() not in (1, 2) or (cap.dim() == 2 and cap.shape[0] != b):
        raise ValueError(f"{name}: capacities must be (L+1,) or "
                         f"({b}, L+1), got {tuple(cap.shape)}")
    for v in vecs:
        if v.shape != (b, f) or v.dtype != cap.dtype:
            raise ValueError(f"{name}: per-flow vectors must be ({b}, {f}) "
                             f"{cap.dtype}, got {tuple(v.shape)} {v.dtype}")
    for t in (fl, cap, *vecs):
        if t.device != fl.device:
            raise ValueError(f"{name}: tensors on {t.device} and "
                             f"{fl.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return single, fl, cap, vecs


def _fill(fl, cap, frozen, rates, *, tol, bound, floor_rates):
    """Launch ``maxmin_fill``: rounds from the (frozen, rates, cap) state
    while a flow is live and the round index is <= ``bound``."""
    from repro_torch.kernels import build
    single, fl, cap, (frozen, rates) = _check("maxmin_fill", fl, cap,
                                              [frozen, rates])
    b, f, h = fl.shape
    n_caps = cap.shape[-1]
    dtype = cap.dtype
    rates, frozen = rates.clone(), frozen.clone()
    cap_out = torch.empty((b, n_caps), dtype=dtype, device=fl.device)
    tight = torch.empty((b, f), dtype=dtype, device=fl.device)
    used = torch.empty(n_caps, dtype=dtype, device=fl.device)
    cnt = torch.empty(n_caps, dtype=torch.int32, device=fl.device)
    scal = torch.empty(4, dtype=torch.int64, device=fl.device)
    fn = build.library().maxmin_fill_f64 if dtype == torch.float64 \
        else build.library().maxmin_fill_f32
    with torch.cuda.device(fl.device):
        stream = torch.cuda.current_stream(fl.device).cuda_stream
        code = fn(fl.data_ptr(), b, f, h, cap.data_ptr(),
                  n_caps if cap.dim() == 2 else 0, n_caps, rates.data_ptr(),
                  frozen.data_ptr(), cap_out.data_ptr(), tight.data_ptr(),
                  used.data_ptr(), cnt.data_ptr(), scal.data_ptr(),
                  int(bound), float(tol), int(floor_rates), _group(h),
                  stream)
    build.check(code, "maxmin_fill")
    LAUNCHES["maxmin_fill"] += 1
    if single:
        return rates[0], frozen[0], cap_out[0]
    return rates, frozen, cap_out


def maxmin_round(flow_links, frozen, rates, cap_rem, *, tol: float = 1e-6):
    """One progressive-filling round; returns (rates, frozen, cap_rem)."""
    if not _on_card(flow_links):
        return ref.maxmin_round_reference(flow_links, frozen, rates, cap_rem,
                                          tol=tol)
    return _fill(flow_links, cap_rem, frozen, rates, tol=tol, bound=0,
                 floor_rates=False)


def maxmin_rates(flow_links, cap, active, *, tol: float = 1e-6,
                 max_rounds=None):
    """Max-min fair rates by progressive filling, floored at 1e-9.

    ``active`` is a 0/1 mask (bool or the capacity dtype).  Rounds run
    while a flow is live and the round index is <= F (``max_rounds - 1``
    when given: the dynamic-segment lanes pass ``tol=1e-12,
    max_rounds=64`` to mirror the numpy ``static_maxmin`` filling).
    """
    if not _on_card(flow_links):
        return ref.maxmin_rates_reference(flow_links, cap, active, tol=tol,
                                          max_rounds=max_rounds)
    frozen = 1.0 - active.to(cap.dtype)
    rates = torch.zeros_like(frozen)
    bound = flow_links.shape[-2] if max_rounds is None else max_rounds - 1
    return _fill(flow_links, cap, frozen, rates, tol=tol, bound=bound,
                 floor_rates=True)[0]


def loss_factors(flow_links, rates, active, cap, q, wsq, wnd, ecn, *,
                 dcqcn_num: float, dcqcn_min: float, util_eps: float = 1e-3):
    """Expected-value loss/DCQCN rate factors, (F,) or (B, F) in (0, 1]."""
    if not _on_card(flow_links):
        return ref.loss_factors_reference(
            flow_links, rates, active, cap, q, wsq, wnd, ecn,
            dcqcn_num=dcqcn_num, dcqcn_min=dcqcn_min, util_eps=util_eps)
    from repro_torch.kernels import build
    single, fl, cap, vecs = _check("loss_factors", flow_links, cap,
                                   [rates, active, q, wsq, wnd, ecn])
    rates, active, q, wsq, wnd, ecn = vecs
    b, f, h = fl.shape
    n_caps = cap.shape[-1]
    fac = torch.empty((b, f), dtype=cap.dtype, device=fl.device)
    util = torch.empty((b, n_caps), dtype=cap.dtype, device=fl.device)
    cnt = torch.empty((b, n_caps), dtype=torch.int32, device=fl.device)
    fn = build.library().loss_factors_f64 if cap.dtype == torch.float64 \
        else build.library().loss_factors_f32
    with torch.cuda.device(fl.device):
        stream = torch.cuda.current_stream(fl.device).cuda_stream
        code = fn(fl.data_ptr(), b, f, h, rates.data_ptr(),
                  active.data_ptr(), cap.data_ptr(),
                  n_caps if cap.dim() == 2 else 0, n_caps, q.data_ptr(),
                  wsq.data_ptr(), wnd.data_ptr(), ecn.data_ptr(),
                  fac.data_ptr(), util.data_ptr(), cnt.data_ptr(),
                  float(dcqcn_num), float(dcqcn_min), float(util_eps),
                  _group(h), stream)
    build.check(code, "loss_factors")
    LAUNCHES["loss_factors"] += 1
    return fac[0] if single else fac
