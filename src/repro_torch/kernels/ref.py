"""Plain PyTorch versions of the max-min and loss-factor kernels.

Counterparts of the reference package's ``kernels/ref.py``
(``maxmin_round_reference`` and ``loss_factors_reference``), written with
``index_add_`` scatters and ``gather``s in the working dtype (float32 or
float64), plus the filling loop of the reference's ``maxmin_rates``.
They run on any device: the wrappers in ``kernels/maxmin.py`` take them
for CPU tensors, and ``chip_smoke.py`` holds the CUDA kernels against
them on the card.

Every function takes one lane — ``flow_links`` (F, H) — or a batch of
lanes — (B, F, H), the reference's vmap axis written out.  Link ids
index the last axis of the capacity vector, (L+1,) shared by every lane
or (B, L+1) per lane; its last entry is the +inf sentinel that pads
short rows.
"""
from __future__ import annotations

import math

import torch


def _batched(flow_links, *vecs):
    """(single, flow_links (B,F,H), vecs (B,F)...) from one lane or many."""
    if flow_links.dim() == 2:
        return True, flow_links[None], [v[None] for v in vecs]
    return False, flow_links, list(vecs)


def _lanes(cap, n_lanes):
    return cap.expand(n_lanes, -1) if cap.dim() == 1 else cap


def flat_ids(flow_links, n_caps):
    """Link ids of every (lane, flow, hop) into a flat (B * n_caps,) vector."""
    lane = torch.arange(flow_links.shape[0], device=flow_links.device)
    return (flow_links.long() + lane[:, None, None] * n_caps).reshape(-1)


def link_sum(flow_links, ids, per_flow, n_caps):
    """Scatter-add a (B, F) per-flow value onto every link of the flow."""
    b = flow_links.shape[0]
    out = torch.zeros(b * n_caps, dtype=per_flow.dtype,
                      device=per_flow.device)
    out.index_add_(0, ids, per_flow[..., None].expand(flow_links.shape)
                   .reshape(-1))
    return out.view(b, n_caps)


def link_gather(vec, flow_links):
    """(B, n_caps) per-link values -> (B, F, H) at each flow's links."""
    b, f, h = flow_links.shape
    return torch.gather(vec, 1, flow_links.long().view(b, f * h)) \
        .view(b, f, h)


def maxmin_round_reference(flow_links, frozen, rates, cap_rem, *,
                           tol: float = 1e-6):
    """One progressive-filling round; returns (rates, frozen, cap_rem).

    ``frozen`` is a 0/1 mask in the capacity dtype (padding rows enter
    frozen); ``tol`` the relative freeze slack (1e-6 for float32 solves,
    1e-12 for the float64 dynamic-segment lanes).  Same expressions as
    the reference's ``ref.py:maxmin_round_reference``.
    """
    single, fl, (frozen, rates) = _batched(flow_links, frozen, rates)
    cap_rem = _lanes(cap_rem, fl.shape[0])
    n_caps = cap_rem.shape[-1]
    dtype = cap_rem.dtype
    ids = flat_ids(fl, n_caps)
    inf = torch.tensor(math.inf, dtype=dtype, device=cap_rem.device)
    live = 1.0 - frozen
    cnt = link_sum(fl, ids, live, n_caps)
    share = torch.where(cnt > 0.0, cap_rem / torch.clamp(cnt, min=1.0), inf)
    tightest = link_gather(share, fl).amin(-1)
    limit = torch.where(frozen > 0.5, inf, tightest)
    b = limit.amin(-1, keepdim=True)
    newly = (frozen < 0.5) & (limit <= b * (1.0 + tol))
    newf = newly.to(dtype)
    rates = torch.where(newly, b, rates)
    used = link_sum(fl, ids, newf * b, n_caps)
    cap_rem = torch.clamp(cap_rem - used, min=0.0)
    frozen = torch.clamp(frozen + newf, max=1.0)
    if single:
        return rates[0], frozen[0], cap_rem[0]
    return rates, frozen, cap_rem


def maxmin_rates_reference(flow_links, cap, active, *, tol: float = 1e-6,
                           max_rounds=None):
    """Max-min fair rates by repeated rounds (the reference's
    ``maxmin.py:maxmin_rates`` loop): rounds run while a flow is live and
    the round index is <= F (or ``max_rounds - 1``); rates floor at
    1e-9.  Lanes that are done sit out later rounds, as under vmap."""
    single, fl, (active,) = _batched(flow_links, active)
    dtype = cap.dtype
    n_flows = fl.shape[1]
    bound = n_flows if max_rounds is None else max_rounds - 1
    rates = torch.zeros(active.shape, dtype=dtype, device=cap.device)
    frozen = 1.0 - active.to(dtype)
    cap_rem = _lanes(cap, fl.shape[0])
    it = 0
    while it <= bound:
        lane_live = (frozen < 0.5).any(-1)
        if not bool(lane_live.any()):
            break
        r, f, c = maxmin_round_reference(fl, frozen, rates, cap_rem, tol=tol)
        keep = lane_live[:, None]
        rates = torch.where(keep, r, rates)
        frozen = torch.where(keep, f, frozen)
        cap_rem = torch.where(keep, c, cap_rem)
        it += 1
    rates = torch.clamp(rates, min=1e-9)
    return rates[0] if single else rates


def loss_factors_reference(flow_links, rates, active, cap, q, wsq, wnd, ecn,
                           *, dcqcn_num: float, dcqcn_min: float,
                           util_eps: float = 1e-3):
    """Expected-value loss/DCQCN rate factors in (0, 1] (the reference's
    ``ref.py:loss_factors_reference``): go-back-N goodput
    ``(1-q) / (1-q+qW)`` with ``W = min(sqrt(rate*wsq), wnd)``, times the
    DCQCN undershoot on shared saturated links, floored at the DCQCN
    minimum rate.  All-zero loss rows give exactly 1."""
    single, fl, (rates, active, q, wsq, wnd, ecn) = _batched(
        flow_links, rates, active, q, wsq, wnd, ecn)
    cap = _lanes(cap, fl.shape[0])
    n_caps = cap.shape[-1]
    dtype = cap.dtype
    ids = flat_ids(fl, n_caps)
    util = link_sum(fl, ids, active * rates, n_caps)
    cnt = link_sum(fl, ids, active, n_caps)
    hot = ((cnt >= 2.0) & (util >= cap * (1.0 - util_eps))).to(dtype)
    flow_hot = link_gather(hot, fl).amax(-1)
    w = torch.minimum(torch.sqrt(torch.clamp(rates * wsq, min=0.0)), wnd)
    gbn = (1.0 - q) / torch.clamp(1.0 - q + q * w, min=1e-30)
    alpha = torch.clamp(dcqcn_num / torch.clamp(rates, min=1e-30), 0.0, 1.0)
    dc = 1.0 - 0.25 * alpha * ecn * flow_hot
    floor = torch.clamp(dcqcn_min / torch.clamp(rates, min=1e-30), max=1.0)
    dc = torch.maximum(dc, floor)
    fac = torch.clamp(gbn * dc, 1e-9, 1.0)
    return fac[0] if single else fac
