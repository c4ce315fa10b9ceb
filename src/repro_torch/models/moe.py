"""Mixture-of-Experts ffn: top-k routing, capacity-bucketed experts.

The port of the reference package's ``models/moe.py``.  The reference
runs ``moe_train`` and ``moe_decode`` under ``shard_map`` over the
"model" axis; on one device that axis has size 1, every expert is local
(``e_local = n_experts``) and its all_to_alls and psums are identities,
so what is left is plain tensor code, here plain PyTorch (the
reference's is jnp; no kernel of the reference computes it):

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

``moe_decode`` also runs on a mesh of ranks (``launch/mesh.Mesh``), each
rank on its blocks of the experts as the sharding plan places them
(``expert_mode``, ``_specs``): in ``"ep"`` mode (the model axis divides
the experts) a rank runs its ``n_experts / model`` experts on every
token of its batch block, expert ids shifted by ``rank * e_local`` and
foreign ones sent to the sentinel, with ``cap_e = _cap(T k, e_local, 2
cf)``; in ``"etp"`` mode every expert runs on the rank's slice of
``moe_d_ff``.  The rank's outputs, in the compute dtype, are added over
"model" in float32 and rounded once: the reference's ``psum`` of its
bf16 ``out``, which XLA adds so (the paper's many-to-one aggregation;
the profiler range ``moe_combine``).  An ``embed`` dim split over the
batch axes (FSDP) is gathered first, as the reference's ``_gather``
does.  The batch goes over the batch axes that divide it
(``_batch_spec``), rows whole on a rank taken to its block and gathered
back.

``moe_train`` runs on a mesh too (prefill and training), as the
reference's ``shard_map`` body does, under autograd.  In ``"ep"`` mode
each rank routes its slice of the sequence (the rank's rows, its
``S / model`` positions), cuts its (token, k) rows into one buffer of
``cap = max(8, ⌈cf n / ep / 8⌉ 8)`` slots a destination rank (the rows
stably sorted by owner, rows past ``cap`` dropped, empty slots the
sentinel), sends each rank its part with ``core/collectives.all_to_all``
(the one-to-many dispatch, the profiler range ``moe_dispatch``), runs its
experts on what it received (``_bucket_ffn`` at ``_cap(ep cap, e_local,
1)``), sends the outputs back the same way (the many-to-one return,
``moe_return``), and adds each token's gate-weighted rows; the sequence
is then all-gathered whole over ``model``.  In ``"etp"`` mode every rank
runs every expert on its slice of ``moe_d_ff`` over all its rows, the
partial rows added over ``model`` in float32 and rounded once.  A
sequence that ``model`` does not divide takes ``moe_decode``'s body, as
the reference's ``moe_apply`` chooses.  The router loss is averaged over
``model`` and the batch axes.  Under autograd the input and the router,
which every ``model`` rank holds alike, enter through
``collectives.grad_psum``: each rank's gradient of them is the part of
its tokens or its experts.

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

from repro_torch.core import collectives as coll
from repro_torch.models.blocks import ParamDef, silu
from repro_torch.parallel import sharding as shd


def expert_mode(cfg, model_axis_size: int) -> str:
    """``"ep"`` where the model axis divides the experts (experts split
    over it), else ``"etp"`` (every expert on every rank, its ``moe_d_ff``
    split)."""
    return "ep" if cfg.n_experts % model_axis_size == 0 else "etp"


def moe_defs(cfg):
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    return {
        "router": ParamDef((d, e), (None, None), scale=0.02),
        "we_i": ParamDef((e, d, f), ("experts", "embed", "mlp")),
        "we_g": ParamDef((e, d, f), ("experts", "embed", "mlp")),
        "we_o": ParamDef((e, f, d), ("experts", "mlp", "embed")),
    }


def _fsdp_axes(mesh, enabled: bool = True):
    """The batch axes of more than one rank: those an FSDP weight's
    ``embed`` dim is split over."""
    if not enabled:
        return ()
    return tuple(a for a in shd.BATCH_AXES if a in mesh.axis_names
                 and mesh.shape[a] > 1)


def _entry(axes):
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def _trim(spec):
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _specs(cfg, mesh):
    """``(mode, router, we_i / we_g, we_o)`` specs, the reference's
    ``shard_map`` in-specs (trailing whole dims dropped, as
    ``ShardingPlan.spec`` drops them)."""
    fspec = _entry(_fsdp_axes(mesh, cfg.fsdp_weights))
    mode = expert_mode(cfg, mesh.shape["model"])
    if mode == "ep":
        ig, o = ("model", fspec, None), ("model", None, fspec)
    else:
        ig, o = (None, fspec, "model"), (None, "model", fspec)
    return mode, (), _trim(ig), _trim(o)


def _batch_spec(mesh, batch_axes, batch: int) -> tuple:
    """The batch axes of more than one rank the batch splits over: none
    where ``batch`` does not divide their product."""
    bs = tuple(a for a in batch_axes if a in mesh.axis_names
               and mesh.shape[a] > 1)
    return bs if batch % math.prod(mesh.shape[a] for a in bs) == 0 else ()


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


def moe_train(p, x, cfg, *, sp=None, mesh=None):
    """Forward over a sequence.  x (B, S, D) -> (y (B, S, D), aux).  On a
    mesh ``p`` holds this rank's blocks (``sp`` their specs) and ``x``
    this rank's rows, whole over the sequence and alike on every rank of
    ``model``; y is too (``_dispatch`` in ``"ep"`` mode, ``_expert_tp``
    in ``"etp"``)."""
    if mesh is not None:
        mode, _, ig, _ = _specs(cfg, mesh)
        _check_placement(cfg, sp, mode, ig, mesh)
        body = _dispatch if mode == "ep" else _expert_tp
        return body(p, x, cfg, sp, mesh)
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


def _check_placement(cfg, sp, mode, ig, mesh):
    if mesh.shape["model"] > 1 and "model" not in shd.entry_axes(
            sp["we_i"], 0 if mode == "ep" else 2):
        raise ValueError(f"{cfg.name}: the plan places the experts as "
                         f"{sp['we_i']}, {mode!r} mode needs {ig}")


def _mesh_router(p, x2, cfg, mesh):
    """The router of a mesh body: ``(gates, ids, aux)`` of ``x2`` (T, D),
    the router weight taken in through ``grad_psum`` over ``model`` (each
    rank's gradient of it is the part of its tokens and experts) and the
    aux loss averaged over ``model`` and the batch axes (the reference's
    pmeans; its gradient is each rank's share)."""
    wr = coll.grad_psum(p["router"], mesh, ("model",))
    gates, ids, aux = _router(x2, wr, cfg.top_k)
    axes = ("model",) + _fsdp_axes(mesh)
    n = math.prod(mesh.shape[a] for a in axes)
    return gates, ids, coll.psum(aux, mesh, axes) / n


def _experts(p, sp, mesh):
    """The rank's expert weights, whole along their FSDP dims."""
    return {n: shd.fsdp_whole(p[n], sp[n], mesh)
            for n in ("we_i", "we_g", "we_o")}


def _dispatch(p, x, cfg, sp, mesh):
    """``moe_train``'s ``"ep"`` body (the reference's expert-parallel
    dispatch, ``models/moe.py:moe_train``): the rank's slice of the
    sequence routed, its (token, k) rows sent to their experts' owners
    (two ``all_to_all``s: the rows, then their expert ids) and the
    outputs brought back (one).  The slots of a destination are the
    rows stably sorted by owner, ``rank < cap`` kept; an empty or dropped
    slot carries token -1 and the sentinel expert ``e_local``, and gives
    nothing.  Each token's k rows are weighted by their gates and added
    in k order (``_combine``, the one-device order; the reference
    scatter-adds them in slot order, which is the same sum for top-k 2).
    """
    cd = getattr(torch, cfg.compute_dtype)
    b, s, d = x.shape
    ep, index = mesh.shape["model"], mesh.axis_index("model")
    k, e_local = cfg.top_k, cfg.n_experts // mesh.shape["model"]
    s_l = s // ep
    xl = coll.grad_psum(x, mesh, ("model",)).narrow(1, index * s_l, s_l)
    x2 = xl.reshape(b * s_l, d)
    gates, ids, aux = _mesh_router(p, x2, cfg, mesh)
    n = ids.numel()
    cap = max(8, int(math.ceil(cfg.capacity_factor * n / ep / 8)) * 8)
    flat_e = ids.reshape(-1)
    dest = flat_e // e_local
    order = torch.sort(dest, stable=True).indices
    sorted_dest = dest[order]
    # a shape-static count (bincount's shape depends on the data)
    counts = torch.zeros(ep, dtype=dest.dtype, device=x.device).scatter_add_(
        0, dest, torch.ones_like(dest))
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=x.device) - offsets[sorted_dest]
    slot = torch.where(rank < cap, sorted_dest * cap + rank, ep * cap)
    # every dropped row lands in the extra last slot, which is cut off
    buf_src = torch.full((ep * cap + 1,), n, dtype=torch.long,
                         device=x.device).index_copy_(0, slot, order)[:-1]
    buf_eid = torch.full((ep * cap + 1,), e_local, dtype=torch.long,
                         device=x.device).index_copy_(
                             0, slot, flat_e[order] % e_local)[:-1]
    sent = buf_src < n
    buf_tok = torch.where(sent, buf_src // k, -1)
    send_x = torch.where(sent[:, None], x2[torch.clamp(buf_tok, min=0)],
                         0).to(cd)
    with torch.profiler.record_function("moe_dispatch"):
        recv_x = coll.all_to_all(send_x.reshape(ep, cap, d), mesh, "model",
                                 0, 0)
        recv_eid = coll.all_to_all(buf_eid.reshape(ep, cap), mesh, "model",
                                   0, 0)
    w = _experts(p, sp, mesh)
    y = _bucket_ffn(recv_x.reshape(ep * cap, d), recv_eid.reshape(-1),
                    e_local, _cap(ep * cap, e_local, 1.0), w["we_i"],
                    w["we_g"], w["we_o"], cd)
    with torch.profiler.record_function("moe_return"):
        back = coll.all_to_all(y.reshape(ep, cap, d), mesh, "model", 0, 0)
    # each slot's output to its (token, k) row; unsent rows stay 0
    rows = torch.zeros((n + 1, d), dtype=back.dtype, device=x.device)
    rows = rows.index_copy(0, torch.where(sent, buf_src, n),
                           back.reshape(ep * cap, d))[:-1]
    rows = rows * gates.reshape(-1, 1).to(rows.dtype)
    out = _combine(rows, k).reshape(b, s_l, d).to(x.dtype)
    return coll.all_gather(out, mesh, ("model",), 1, replicated=True), aux


def _expert_tp(p, x, cfg, sp, mesh):
    """``moe_train``'s ``"etp"`` body: every rank's rows on every expert's
    slice of ``moe_d_ff`` (``_bucket_ffn`` at ``_cap(T k, E, cf)``), each
    (token, k) row weighted by its gate; the rows' partial sums added
    over ``model`` in float32 (at least) and rounded once, then each
    token's k rows added in k order."""
    cd = getattr(torch, cfg.compute_dtype)
    b, s, d = x.shape
    k, e = cfg.top_k, cfg.n_experts
    x2 = coll.grad_psum(x, mesh, ("model",)).reshape(b * s, d)
    gates, ids, aux = _mesh_router(p, x2, cfg, mesh)
    n = ids.numel()
    tok = torch.arange(n, device=x.device) // k
    w = _experts(p, sp, mesh)
    y = _bucket_ffn(x2[tok], ids.reshape(-1), e,
                    _cap(n, e, cfg.capacity_factor), w["we_i"], w["we_g"],
                    w["we_o"], cd)
    y = y * gates.reshape(-1, 1).to(y.dtype)
    wide = torch.promote_types(y.dtype, torch.float32)
    with torch.profiler.record_function("moe_combine"):
        y = coll.psum(y.to(wide), mesh, ("model",)).to(y.dtype)
    return _combine(y, k).reshape(b, s, d).to(x.dtype), aux


def expert_block(p, x2, gates, ids, cfg, *, rank=0, n_ranks=1):
    """The decode body of one rank: the k contributions of each of the T
    rows of ``x2`` (T, D) that its experts ``p["we_*"]`` (whole ``embed``
    dims) compute, weighted by ``gates`` and summed per row (T, D) in the
    compute dtype.  In ``"ep"`` mode ``p`` holds experts ``rank *
    e_local`` onward and an id outside them goes to the sentinel; in
    ``"etp"`` mode (``n_ranks`` not dividing the experts) every expert's
    ``moe_d_ff`` slice, and the result is the rank's partial sum.  On one
    device (``rank`` 0 of 1) it is the whole MoE output."""
    cd = getattr(torch, cfg.compute_dtype)
    k = cfg.top_k
    e_local = p["we_i"].shape[0]
    if expert_mode(cfg, n_ranks) == "ep":
        lids = ids - rank * e_local
        lids = torch.where((lids >= 0) & (lids < e_local), lids, e_local)
    else:
        lids = ids
    n = ids.numel()
    tok = torch.arange(n, device=x2.device) // k
    y = _bucket_ffn(x2[tok], lids.reshape(-1), e_local,
                    _cap(n, e_local, cfg.capacity_factor * 2),
                    p["we_i"], p["we_g"], p["we_o"], cd)
    y = y * gates.reshape(-1, 1).to(y.dtype)
    return _combine(y, k)


def moe_decode(p, x, cfg, *, sp=None, mesh=None, batch_axes=(),
               train=False):
    """Few-token step.  x (B, S, D) -> (y (B, S, D), aux).  On a mesh
    ``p`` holds this rank's blocks (``sp`` their specs), ``x`` this
    rank's rows (split over ``batch_axes``, whole where that is empty);
    y is the same on every rank of "model".  aux is the router loss of
    the rows the rank routes, not averaged over the ranks: no decode
    step reads it (the reference's ``pmean`` of it is dead code under
    ``jit``), and that average would be an all-reduce a layer.  With
    ``train`` (``moe_train``'s branch for a sequence that ``model`` does
    not divide) it is averaged over ``model`` and the batch axes, and the
    input and router enter through ``grad_psum`` (``_mesh_router``).  A
    mesh of one rank runs the mesh code, every collective on an axis of
    one rank."""
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    if mesh is None:
        gates, ids, aux = _router(x2, p["router"], cfg.top_k)
        out = expert_block(p, x2, gates, ids, cfg)
        return out.reshape(b, s, d).to(x.dtype), aux
    m = mesh.shape["model"]
    mode, _, ig, o = _specs(cfg, mesh)
    _check_placement(cfg, sp, mode, ig, mesh)
    rows = _batch_spec(mesh, shd.BATCH_AXES, b * math.prod(
        mesh.shape[a] for a in batch_axes))
    if tuple(batch_axes) not in ((), rows):
        raise ValueError(f"rows split over {batch_axes}, the MoE splits "
                         f"them over {rows}")
    split = rows if not batch_axes else ()
    if split:                       # this rank's block of whole rows
        index, count = shd.block(mesh, split)
        x2 = x2.narrow(0, index * (b * s // count), b * s // count)
    if train:
        x2 = coll.grad_psum(x2, mesh, ("model",))
        gates, ids, aux = _mesh_router(p, x2, cfg, mesh)
    else:
        gates, ids, aux = _router(x2, p["router"], cfg.top_k)
    w = _experts(p, sp, mesh)
    out = expert_block(w, x2, gates, ids, cfg, rank=mesh.axis_index("model"),
                       n_ranks=m)
    # the many-to-one combine: the ranks' outputs in the compute dtype,
    # added in float32 (at least) and rounded once, as the reference's
    # psum of its bf16 out adds them
    wide = torch.promote_types(out.dtype, torch.float32)
    with torch.profiler.record_function("moe_combine"):
        out = coll.psum(out.to(wide), mesh, ("model",)).to(out.dtype)
    out = coll.all_gather(out, mesh, split, 0)
    return out.reshape(b, s, d).to(x.dtype), aux


def moe_apply(p, x, cfg, decode=False, *, sp=None, mesh=None,
              batch_axes=()):
    """``moe_decode`` for a decode step, else ``moe_train``, as the
    reference chooses: a sequence that the ``model`` axis does not divide
    takes ``moe_decode``'s body (always divided on one device).  On a
    mesh ``sp``, ``mesh`` and ``batch_axes`` are as ``moe_decode`` takes
    them; ``moe_train`` takes x's rows as they come (split over the batch
    axes)."""
    if cfg.moe_impl != "bucket":
        raise NotImplementedError(
            f"{cfg.name}: moe_impl {cfg.moe_impl!r} is not ported; the "
            f"port groups experts by capacity buckets only (ROADMAP queue "
            f"1 item 7)")
    if decode:
        return moe_decode(p, x, cfg, sp=sp, mesh=mesh, batch_axes=batch_axes)
    if mesh is not None and x.shape[1] % mesh.shape["model"]:
        return moe_decode(p, x, cfg, sp=sp, mesh=mesh, batch_axes=batch_axes,
                          train=True)
    return moe_train(p, x, cfg, sp=sp, mesh=mesh)
