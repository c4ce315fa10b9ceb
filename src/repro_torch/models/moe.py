"""Mixture-of-Experts ffn: top-k routing, capacity-bucketed experts.

The port of the reference package's ``models/moe.py`` on one device.  The
reference runs ``moe_train`` and ``moe_decode`` under ``shard_map`` with
experts sharded over the "model" axis ("ep"); on one device that axis has
size 1, every expert is local (``e_local = n_experts``) and its
all_to_alls and psums are identities, so what is left is plain tensor
code, here plain PyTorch (the reference's is jnp; no kernel of the
reference computes it):

- ``_router``: float32 router logits, softmax, top-k (equal
  probabilities to the lower expert id first, as the reference's top-k
  orders them), gates renormalised over the k, and the load-balancing
  aux loss;
- ``_bucket_ffn``: each (token, k) row goes to a dense (E, cap_e, D)
  buffer at its expert and its rank within that expert (the stable order
  of the flattened (token, k) index); rows past ``cap_e`` are dropped and
  give 0; the experts' SwiGLU is three batched products;
- ``moe_decode`` (``cap_e = _cap(T k, E, 2 cf)``, gates applied inside
  the bucket ffn) and ``moe_train`` (``cap = max(8, ⌈cf T k / 8⌉ 8)``
  rows sent, ``cap_e = _cap(cap, E, 1)``, gates applied after the
  return), each summing a token's k contributions in k order in the
  compute dtype, as the reference's scatter-add does on the CPU.

The capacity drops are part of the result.  Under autograd (training)
the gradient reaches the gates (the top-k probabilities renormalised),
the aux loss through the mean probability (the top-1 density is a count
and carries none), the router and the experts through the (E, cap_e, D)
buffer; a dropped row and the buffer's sentinel row get exactly none, as
in the reference.  The reference's other
grouping, ``moe_impl == "ragged"`` (no capacity, a grouped GEMM), is not
ported: no configuration selects it, and ``moe_apply`` raises for it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.blocks import ParamDef, silu


def moe_defs(cfg):
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    return {
        "router": ParamDef((d, e), (None, None), scale=0.02),
        "we_i": ParamDef((e, d, f), ("experts", "embed", "mlp")),
        "we_g": ParamDef((e, d, f), ("experts", "embed", "mlp")),
        "we_o": ParamDef((e, f, d), ("experts", "mlp", "embed")),
    }


def _top_k(probs, k):
    """The reference's top-k over the last axis: the k largest, in
    descending order, equal values in ascending index order (a stable
    sort)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _router(x2, wr, top_k):
    """x2 (T, D) -> (gates (T, k) f32, ids (T, k), aux loss f32 scalar)."""
    logits = x2.float() @ wr.float()
    probs = torch.softmax(logits, dim=-1)                 # (T, E)
    gates, ids = _top_k(probs, top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    e = logits.shape[-1]
    density = F.one_hot(ids[:, 0], e).float().mean(0)
    aux = e * torch.sum(density * probs.mean(0))
    return gates, ids, aux


def _cap(n_tokens, n_exp, cf, floor=8):
    return max(floor, int(math.ceil(cf * n_tokens / n_exp / floor)) * floor)


def _bucket_ffn(rows, eids, n_exp, cap_e, we_i, we_g, we_o, cd):
    """The capacity-bucketed expert ffn.  rows (M, D); eids (M,) in
    [0, n_exp], n_exp marking a row sent nowhere.  A row's rank within its
    expert counts the earlier rows of that expert (the reference's stable
    argsort); rows of rank ``cap_e`` or more are dropped.  Returns y
    (M, D) in ``cd``, 0 on dropped rows."""
    m, d = rows.shape
    hot = F.one_hot(eids, n_exp + 1)
    rank = (hot.cumsum(0) * hot).sum(-1) - 1
    valid = (eids < n_exp) & (rank < cap_e)
    slot = torch.where(valid, eids * cap_e + rank,
                       torch.full_like(eids, n_exp * cap_e))
    # every dropped row lands in the extra last row, which is cut off
    buf = torch.zeros((n_exp * cap_e + 1, d), dtype=cd, device=rows.device)
    buf.index_copy_(0, slot, rows.to(cd))
    xb = buf[:-1].reshape(n_exp, cap_e, d)
    h = silu(torch.bmm(xb, we_g.to(cd))) * torch.bmm(xb, we_i.to(cd))
    yb = torch.bmm(h, we_o.to(cd)).reshape(n_exp * cap_e, d)
    yb = torch.cat([yb, yb.new_zeros((1, d))])
    return yb[slot]


def _combine(y, k):
    """(T k, D) -> (T, D): each token's k rows summed in k order, each sum
    rounded to y's dtype (the reference's scatter-add from zero)."""
    y = y.reshape(-1, k, y.shape[-1])
    out = y[:, 0]
    for j in range(1, k):
        out = out + y[:, j]
    return out


def moe_train(p, x, cfg):
    """Forward over a sequence.  x (B, S, D) -> (y (B, S, D), aux)."""
    cd = getattr(torch, cfg.compute_dtype)
    b, s, d = x.shape
    k, e = cfg.top_k, cfg.n_experts
    x2 = x.reshape(b * s, d)
    gates, ids, aux = _router(x2, p["router"], k)
    n = ids.numel()
    cap = max(8, int(math.ceil(cfg.capacity_factor * n / 8)) * 8)
    idx = torch.arange(n, device=x.device)
    # rows past the cap rows sent to the experts are sent nowhere
    eids = torch.where(idx < cap, ids.reshape(-1), e)
    y = _bucket_ffn(x2[idx // k], eids, e, _cap(cap, e, 1.0),
                    p["we_i"], p["we_g"], p["we_o"], cd)
    y = y * gates.reshape(-1, 1).to(y.dtype)
    return _combine(y, k).reshape(b, s, d).to(x.dtype), aux


def moe_decode(p, x, cfg):
    """Few-token step.  x (B, S, D) -> (y (B, S, D), aux)."""
    cd = getattr(torch, cfg.compute_dtype)
    b, s, d = x.shape
    k, e = cfg.top_k, cfg.n_experts
    x2 = x.reshape(b * s, d)
    gates, ids, aux = _router(x2, p["router"], k)
    n = ids.numel()
    tok = torch.arange(n, device=x.device) // k
    y = _bucket_ffn(x2[tok], ids.reshape(-1), e,
                    _cap(n, e, cfg.capacity_factor * 2),
                    p["we_i"], p["we_g"], p["we_o"], cd)
    y = y * gates.reshape(-1, 1).to(y.dtype)
    return _combine(y, k).reshape(b, s, d).to(x.dtype), aux


def moe_apply(p, x, cfg, decode=False):
    """``moe_decode`` for a decode step, else ``moe_train`` (on one device
    the reference's sequence-divisibility test always holds)."""
    if cfg.moe_impl != "bucket":
        raise NotImplementedError(
            f"{cfg.name}: moe_impl {cfg.moe_impl!r} is not ported; the "
            f"port groups experts by capacity buckets only (ROADMAP queue "
            f"1 item 7)")
    return (moe_decode if decode else moe_train)(p, x, cfg)
