"""Plain PyTorch versions of the kernels of ``csrc/``.

Counterparts of the reference package's ``kernels/ref.py``:
``maxmin_round_reference`` and ``loss_factors_reference``, written with
``index_add_`` scatters and ``gather``s in the working dtype (float32 or
float64), plus the filling loop of the reference's ``maxmin_rates``; and
``decode_reference``, the flash-decode function with its softmax
statistics; ``mha_reference``, causal / sliding-window GQA attention
(the flash-attention function); and ``ssd_reference``, the exact
sequential Mamba-2 recurrence (the SSD-scan function).  They run on any
device: the wrappers in
``kernels/maxmin.py`` and ``kernels/ops.py`` take them for CPU tensors,
and ``chip_smoke.py`` holds the CUDA kernels against them on the card.

The gradients of the two prefill functions, which no TPU kernel has:
``mha_backward`` (blocked, from the forward's output, as a flash
backward computes them) and ``ssd_backward`` (autograd of
``ssd_chunked``, the reference's plain chunked scan).  The autograd
Functions of ``kernels/flash_attention.py`` and ``kernels/ssd_scan.py``
run them on either device.

The max-min functions take one lane — ``flow_links`` (F, H) — or a
batch of lanes — (B, F, H), the reference's vmap axis written out.  Link
ids index the last axis of the capacity vector, (L+1,) shared by every
lane or (B, L+1) per lane; its last entry is the +inf sentinel that pads
short rows.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


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


NEG_INF = -1e30


def decode_reference(q, k, v, kv_len, out_dtype=None):
    """Single-query GQA attention over a KV cache, with its statistics.

    q (B, H, D); k, v (B, S, KVH, D); kv_len (B,) valid prefix lengths.
    Returns ``(out, m, l)`` as the flash-decode kernel does: ``out`` in
    ``out_dtype`` (q's by default), ``m`` the f32 max of the valid logits
    ``q.k / sqrt(D)``,
    ``l = sum exp(s - m)`` over the valid keys, ``out = acc / max(l,
    1e-30)``.  A row with ``kv_len = 0`` gives out 0, m -1e30, l 0.
    Float64 inputs are computed in float64, m and l too (an exact
    oracle, as ``mha_reference`` is).
    """
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    acc_t = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(b, kvh, h // kvh, d).to(acc_t)
    logits = torch.einsum("bkrd,bskd->bkrs", qg, k.to(acc_t)) \
        * (1.0 / math.sqrt(d))
    valid = (torch.arange(s, device=q.device)[None, :]
             < kv_len.to(q.device)[:, None])[:, None, None, :]
    logits = torch.where(valid, logits, NEG_INF)
    m = logits.amax(-1)
    p = torch.where(valid, torch.exp(logits - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bkrs,bskd->bkrd", p, v.to(acc_t))
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return (out.reshape(b, h, d).to(q.dtype if out_dtype is None
                                     else out_dtype),
            m.reshape(b, h), l.reshape(b, h))


#: query rows the plain attention takes at a time
MHA_BLOCK_Q = 1024


def mha_reference(q, k, v, *, causal, window=0, q_offset=0):
    """Multi-head attention oracle (the reference's ``mha_reference``).

    q (B, Sq, H, D); k, v (B, Skv, KVH, D); GQA: q head h reads kv head
    ``h // (H / KVH)``.  Masks compare absolute positions: causal keeps
    ``kpos <= qpos``, a window ``kpos > qpos - window``; query row s
    stands at ``qpos = q_offset + s`` (a block of a longer sequence's
    rows against its whole K/V, as the reference's sequence-parallel
    attention passes it).  Logits in f32
    with -1e30 where masked, softmax in f32, the result in q's dtype
    (float64 inputs are computed in float64: an exact-arithmetic oracle
    for both the kernel and this version).

    The query axis goes in blocks of ``MHA_BLOCK_Q`` rows: each row's
    softmax is its own, so blocking changes no number, and at full width
    (granite prefill, 4 x 4096 x 32 heads) it keeps the f32 logits to a
    block's share instead of B * H * S^2 (8.6 GB).
    """
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    acc = torch.promote_types(q.dtype, torch.float32)
    kf, vf = k.to(acc), v.to(acc)
    kpos = torch.arange(skv, device=q.device)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for q0 in range(0, sq, MHA_BLOCK_Q):
        qb = q[:, q0:q0 + MHA_BLOCK_Q]
        n = qb.shape[1]
        qg = qb.reshape(b, n, kvh, rep, d).to(acc)
        logits = torch.einsum("bqkrd,bskd->bkrqs", qg, kf) / math.sqrt(d)
        qpos = torch.arange(q0, q0 + n, device=q.device)[:, None] + q_offset
        mask = torch.ones((n, skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos
        if window:
            mask &= kpos[None, :] > qpos - window
        logits = torch.where(mask, logits, NEG_INF)
        w = torch.softmax(logits, dim=-1)
        o = torch.einsum("bkrqs,bskd->bqkrd", w, vf)
        out[:, q0:q0 + n] = o.reshape(b, n, h, d).to(q.dtype)
    return out


def ssd_reference(x, dt, a, B_, C_):
    """Sequential SSD (Mamba-2) oracle: the exact recurrence of the
    reference's ``ssd_reference``.

    x (B, S, H, P); dt, a (B, S, H); B_, C_ (B, S, N), every input taken
    to f32:  S_t = exp(a_t) S_{t-1} + dt_t B_t x_t^T,  y_t = C_t . S_t.
    Returns ``(y (B, S, H, P) f32, final state (B, H, N, P) f32)``; with
    a float64 x everything is float64 (an exact-arithmetic oracle).
    """
    b, s, h, p = x.shape
    n = B_.shape[-1]
    acc = torch.promote_types(x.dtype, torch.float32)
    x, dt, a, B_, C_ = (t.to(acc) for t in (x, dt, a, B_, C_))
    state = torch.zeros((b, h, n, p), dtype=acc, device=x.device)
    y = torch.empty((b, s, h, p), dtype=acc, device=x.device)
    for t in range(s):
        state = state * torch.exp(a[:, t])[:, :, None, None] + torch.einsum(
            "bn,bh,bhp->bhnp", B_[:, t], dt[:, t], x[:, t])
        y[:, t] = torch.einsum("bn,bhnp->bhp", C_[:, t], state)
    return y, state


def key_band(q0, n, skv, *, causal, window):
    """The keys ``[lo, hi)`` that query positions ``q0 .. q0 + n - 1`` may see
    under the mask: every other key's probability is exactly 0.  A band
    with no key (rows past the last key and its window; no path has
    them) is the whole key range, where ``mha_reference`` spreads such a
    row evenly."""
    hi = min(skv, q0 + n) if causal else skv
    lo = max(0, q0 - window + 1) if window else 0
    return (lo, hi) if lo < hi else (0, skv)


def mha_backward(q, k, v, out, dout, *, causal, window=0, q_offset=0):
    """``(dq, dk, dv)`` of ``mha_reference`` at ``out`` (its result, or
    the kernel's) for the output gradient ``dout``, query row s at
    position ``q_offset + s``.

    Query rows go in blocks of ``MHA_BLOCK_Q`` against the keys of their
    band (``key_band``).  Each block recomputes its masked probabilities
    P in f32 from q and k (the forward keeps no log-sum-exp), then
    dV += Pᵀ dO, dP = dO Vᵀ, dS = P ∘ (dP − rowsum(dO ∘ O)) / √D,
    dQ = dS K and dK += dSᵀ Q, each kv head summing its ``rep`` q heads.
    Memory stays at one block's logits, where autograd through
    ``mha_reference`` would keep B·H·S² f32 a layer (8.6 GB at granite's
    4 x 4096).  Gradients come back in the inputs' dtypes.
    """
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / math.sqrt(d)
    kf, vf = k.to(acc), v.to(acc)
    dk = torch.zeros(kf.shape, dtype=acc, device=q.device)
    dv = torch.zeros(vf.shape, dtype=acc, device=q.device)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for q0 in range(0, sq, MHA_BLOCK_Q):
        n = min(MHA_BLOCK_Q, sq - q0)
        lo, hi = key_band(q_offset + q0, n, skv, causal=causal,
                          window=window)
        kb, vb = kf[:, lo:hi], vf[:, lo:hi]
        qg, og, dog = (t[:, q0:q0 + n].reshape(b, n, kvh, rep, d).to(acc)
                       for t in (q, out, dout))
        logits = torch.einsum("bqkrd,bskd->bkrqs", qg, kb) / math.sqrt(d)
        qpos = torch.arange(q0, q0 + n, device=q.device)[:, None] + q_offset
        kpos = torch.arange(lo, hi, device=q.device)[None, :]
        mask = torch.ones((n, hi - lo), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        p = torch.softmax(logits.masked_fill_(~mask, NEG_INF), dim=-1)
        del logits
        dv[:, lo:hi] += torch.einsum("bkrqs,bqkrd->bskd", p, dog)
        delta = (dog * og).sum(-1).permute(0, 2, 3, 1)[..., None]
        ds = torch.einsum("bqkrd,bskd->bkrqs", dog, vb)
        ds.sub_(delta).mul_(p).mul_(scale)
        del p
        dq[:, q0:q0 + n] = torch.einsum("bkrqs,bskd->bqkrd", ds, kb) \
            .reshape(b, n, h, d).to(q.dtype)
        dk[:, lo:hi] += torch.einsum("bkrqs,bqkrd->bskd", ds, qg)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def ssd_chunked(x, dt, a, B_, C_, chunk):
    """Plain chunked SSD scan (the reference's ``models/ssm.ssd_chunked``).
    x (B, S, H, P); dt, a (B, S, H); B_, C_ (B, S, N).  Returns y and the
    final state (B, H, N, P), all f32 (f64 for a float64 x); a chunk that
    does not divide S becomes S, as in the reference.  The reference's
    three-operand einsums are written as products of two, in the order
    that never forms a (B, chunks, L, L, H, P) tensor."""
    b, s, h, p = x.shape
    n = B_.shape[-1]
    if s % chunk != 0:
        chunk = s
    nc = s // chunk
    acc = torch.promote_types(x.dtype, torch.float32)
    xc = x.reshape(b, nc, chunk, h, p).to(acc)
    dtc = dt.reshape(b, nc, chunk, h).to(acc)
    ac = a.reshape(b, nc, chunk, h).to(acc)
    Bc = B_.reshape(b, nc, chunk, n).to(acc)
    Cc = C_.reshape(b, nc, chunk, n).to(acc)
    xdt = xc * dtc[..., None]
    cum = torch.cumsum(ac, dim=2)                          # (b,nc,q,h)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (b,nc,q,k,h)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    # masked before the exp (the reference masks after it): the same L,
    # but the masked cum_q - cum_k > 0 above the diagonal, which overflow
    # to inf over a long chunk, no longer turn its gradient into inf * 0
    L = torch.exp(torch.where(tri[None, None, :, :, None], diff, -math.inf))
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    y_diag = torch.einsum("bcqkh,bckhp->bcqhp", scores[..., None] * L, xdt)
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)      # (b,nc,q,h)
    chunk_states = torch.einsum("bcqn,bcqhp->bchnp", Bc,
                                (decay_states * dtc)[..., None] * xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])              # (b,nc,h)
    state = torch.zeros((b, h, n, p), dtype=acc, device=x.device)
    prevs = []
    for c in range(nc):                                    # state BEFORE c
        prevs.append(state)
        state = state * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    s_prevs = torch.stack(prevs, dim=1)                    # (b,nc,h,n,p)
    y_off = torch.einsum("bcqn,bchnp->bcqhp", Cc, s_prevs) \
        * torch.exp(cum)[..., None]
    return (y_diag + y_off).reshape(b, s, h, p), state


def ssd_backward(x, dt, a, B_, C_, dy, chunk):
    """``(dx, ddt, da, dB, dC)`` of the scan's y for the gradient ``dy``:
    ``ssd_chunked`` recomputed from the inputs under autograd, at
    ``chunk`` (the sequence padded to a multiple of it with x = dt = a =
    B = C = 0, which leaves every real position's y as it is), then
    ``torch.autograd.grad``.  Never the sequential ``ssd_reference``,
    which would take S Python steps a layer.  Gradients come back in the
    inputs' dtypes; the final state gets none."""
    s = x.shape[1]
    pad = -s % chunk
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (x, dt, a, B_, C_)]
        y, _ = ssd_chunked(*(F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                             for t in ins), chunk)
        return torch.autograd.grad(y[:, :s], ins, dy.to(y.dtype))
