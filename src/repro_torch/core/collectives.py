"""Gleam collectives on a mesh of ranks (the adapted layer).

The port of the reference package's ``core/collectives.py``.  The
paper's two data-plane primitives map onto mesh collectives:

- one-to-many *in-fabric multicast*  -> ``tree_broadcast`` (a binomial
  tree of point-to-point rounds: the sender transmits O(log n) times
  instead of n - 1, interior ranks forward);
- many-to-one *feedback aggregation* -> ``tree_reduce`` /
  ``butterfly_allreduce`` with any associative combine, Algorithm 2/3's
  min-PSN aggregation generalised to any monoid.  The flagship use is
  ``softmax_combine``: merging the split-KV decode partials (m, l, acc)
  of a sequence-sharded cache up the aggregation tree.

Baselines mirror the paper's design space: ``unicast_broadcast``
("multiple unicasts", the root sends n - 1 times) and ``ring_broadcast``
(overlay multicast, store and forward).

Where the reference names an axis inside ``shard_map``, these take the
``launch/mesh.Mesh`` and an axis name, and run on the process group of
this rank's line along the axis.  Each round of the reference's
``ppermute`` is one ``dist.batch_isend_irecv`` of the round's pairs
(``ppermute``), waited on before the next round; a rank that receives
nothing in a round keeps its value, as the reference's ``jnp.where``
does.  They take a tensor or a tuple (list, dict) of tensors.  The tree
and butterfly schedules need a power-of-two axis (``_log2``), and every
function returns its input untouched on an axis of size 1, with no
process group used.

``psum``, ``pmax``, ``all_gather``, ``reduce_scatter`` and
``all_to_all`` are the library's own collectives, the counterparts of
the reference's ``psum`` / ``pmax`` / ``all_gather`` / ``psum_scatter`` /
``all_to_all``: the ``xla`` schedule, and the communication GSPMD would
place around the model's sharded products (``all_to_all`` is the MoE's
expert-parallel dispatch and return, ``models/moe.py``).  The other
schedules never call a library collective.  Under autograd (prefill and
training on a mesh) each has the backward ``shard_map`` gives it:
``psum`` identity (its result is used alike on every rank),
``all_gather`` the reduce-scatter of the gradient (or this rank's block
of it, ``replicated=True``), ``reduce_scatter`` the all-gather,
``all_to_all`` the same exchange back, ``pmax`` none; and ``grad_psum``
is the identity whose backward is the psum, for a tensor every rank
holds alike entering a computation split over the axes.

While a dry run counts (``trace.counting``), every call that moves data
adds the bytes of its result on this rank to ``trace.collective``, by
the reference's kind: ``all-reduce`` (``psum``, ``psum_``, ``pmax``),
``all-gather``, ``reduce-scatter``, ``all-to-all``, and
``collective-permute`` for each round of ``ppermute`` (the tree, ring
and butterfly schedules), by the bytes this rank receives; each with
the ranks of the axis line it ran on.  A fake tensor (``device.traced``)
takes the card's path, so the library reduce-scatter.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch import trace
from repro_torch.device import on_card
# The analytic alpha-beta JCT model lives in core/metrics.py with the
# rest of the accounting; re-exported here as the reference does.
from repro_torch.core.metrics import schedule_cost  # noqa: F401


def _log2(n: int) -> int:
    k = int(math.log2(n))
    assert 2 ** k == n, f"axis size {n} must be a power of two"
    return k


def _flat(x):
    """``(leaves, rebuild)`` of a tensor or a tuple / list / dict of them
    (dict keys sorted)."""
    if isinstance(x, torch.Tensor):
        return [x], lambda leaves: leaves[0]
    if isinstance(x, dict):
        keys = sorted(x)
        return [x[k] for k in keys], lambda leaves: dict(zip(keys, leaves))
    kind = type(x)
    return list(x), lambda leaves: kind(leaves)


def _ranks(mesh, axis: str):
    """The global ranks of this rank's line along ``axis``."""
    return mesh.lines[mesh.axis_names.index(axis)]


def _tree_map(fn, *trees):
    leaves, rebuild = _flat(trees[0])
    others = [_flat(t)[0] for t in trees[1:]]
    return rebuild([fn(*parts) for parts in zip(leaves, *others)])


# ---------------------------------------------------------------- rounds

def _pack(leaves):
    """The leaves as one flat buffer where they share a dtype (one message
    a round instead of one a leaf), else as they are; and the inverse."""
    if len(leaves) > 1 and len({t.dtype for t in leaves}) == 1:
        shapes = [t.shape for t in leaves]
        flat = torch.cat([t.reshape(-1) for t in leaves])

        def unpack(bufs):
            parts = bufs[0].split([math.prod(sh) for sh in shapes])
            return [p.view(sh) for p, sh in zip(parts, shapes)]
        return [flat], unpack
    return [t.contiguous() for t in leaves], lambda bufs: bufs


def ppermute(x, mesh, axis: str, perm):
    """One round of point-to-point sends along ``axis``: for each pair
    ``(src, dst)`` of axis coordinates, ``src`` sends ``x`` to ``dst``.
    Returns what this rank received, or None when it received nothing
    (the reference's ``ppermute`` gives zeros there, which its callers
    never keep).  All of the round's sends and receives are one
    ``batch_isend_irecv``; the leaves of ``x`` go as one message where
    they share a dtype, else one each with its own tag."""
    idx = mesh.axis_index(axis)
    group = mesh.group(axis)
    leaves, rebuild = _flat(x)
    bufs, unpack = _pack(leaves)
    ops, recv = [], None
    for src, dst in perm:
        if src == idx:
            ops += [dist.P2POp(dist.isend, buf, mesh.peer(axis, dst), group,
                               tag)
                    for tag, buf in enumerate(bufs)]
        if dst == idx:
            recv = [torch.empty_like(buf) for buf in bufs]
            ops += [dist.P2POp(dist.irecv, buf, mesh.peer(axis, src), group,
                               tag)
                    for tag, buf in enumerate(recv)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if recv is None:
        return None
    trace.collective("collective-permute",
                     sum(trace.nbytes(b) for b in recv), _ranks(mesh, axis))
    return rebuild(unpack(recv))


# ---------------------------------------------------------------- schedules

def tree_broadcast(x, mesh, axis: str, root: int = 0):
    """Binomial-tree one-to-many multicast (Gleam in-fabric forwarding).

    Round j: ranks [0, 2^j) forward to ranks [2^j, 2^{j+1}) (rank space
    rotated so ``root`` is rank 0).  log2(n) rounds; each value crosses
    each link once.
    """
    n = mesh.shape[axis]
    if n == 1:
        return x
    rank = (mesh.axis_index(axis) - root) % n
    for j in range(_log2(n)):
        half = 2 ** j
        perm = [((r + root) % n, (r + half + root) % n) for r in range(half)]
        recv = ppermute(x, mesh, axis, perm)
        if half <= rank < 2 * half:
            x = recv
    return x


def unicast_broadcast(x, mesh, axis: str, root: int = 0):
    """'Multiple unicasts' baseline: the root sends to every receiver in
    turn (n - 1 serialised rounds; the sender's link is the bottleneck)."""
    n = mesh.shape[axis]
    if n == 1:
        return x
    idx = mesh.axis_index(axis)
    for t in range(1, n):
        dst = (root + t) % n
        recv = ppermute(x, mesh, axis, [(root, dst)])
        if idx == dst:
            x = recv
    return x


def ring_broadcast(x, mesh, axis: str, root: int = 0, chunks: int = 1):
    """Overlay-multicast baseline: store and forward around a ring.  In
    round t every rank sends its value to the next, and rank t + 1 keeps
    what it received.  ``chunks > 1`` splits every leaf along its first
    dim (``tensor_split``, numpy's ``array_split``) and sends the chunks
    one after another, as the reference does."""
    n = mesh.shape[axis]
    if n == 1:
        return x
    rank = (mesh.axis_index(axis) - root) % n
    perm = [((r + root) % n, (r + 1 + root) % n) for r in range(n - 1)]

    def fwd_rounds(val):
        for t in range(n - 1):
            recv = ppermute(val, mesh, axis, perm)
            if rank == t + 1:
                val = recv
        return val

    if chunks <= 1:
        return fwd_rounds(x)
    leaves, rebuild = _flat(x)
    split = [torch.tensor_split(leaf, chunks) for leaf in leaves]
    outs = [_flat(fwd_rounds(rebuild([s[c] for s in split])))[0]
            for c in range(chunks)]
    return rebuild([torch.cat([o[i] for o in outs])
                    for i in range(len(leaves))])


def tree_reduce(x, mesh, axis: str, combine: Callable, root: int = 0):
    """Binomial-tree many-to-one aggregation (Algorithm 2/3 generalised).

    Mirror of ``tree_broadcast``: round j, ranks [2^j, 2^{j+1}) send to
    ranks [0, 2^j), which combine ``combine(own, received)``.  After
    log2(n) rounds the root holds the whole reduction; other ranks hold
    partials.
    """
    n = mesh.shape[axis]
    if n == 1:
        return x
    rank = (mesh.axis_index(axis) - root) % n
    for j in reversed(range(_log2(n))):
        half = 2 ** j
        perm = [((r + half + root) % n, (r + root) % n) for r in range(half)]
        recv = ppermute(x, mesh, axis, perm)
        if rank < half:
            x = combine(x, recv)
    return x


def butterfly_allreduce(x, mesh, axis: str, combine: Callable):
    """Recursive-doubling allreduce with any associative combine: log2(n)
    full-exchange rounds (reduce and multicast fused)."""
    n = mesh.shape[axis]
    for j in range(_log2(n)) if n > 1 else []:
        mask = 2 ** j
        recv = ppermute(x, mesh, axis, [(i, i ^ mask) for i in range(n)])
        x = combine(x, recv)
    return x


def tree_allreduce(x, mesh, axis: str, combine: Callable, root: int = 0):
    """Gleam round trip: many-to-one aggregation, then one-to-many
    multicast of the result."""
    x = tree_reduce(x, mesh, axis, combine, root)
    return tree_broadcast(x, mesh, axis, root)


# ---------------------------------------------------------------- library

def _split_on(mesh, axes) -> bool:
    return any(mesh.shape[a] > 1 for a in axes)


def _reduce(x, mesh, axes, op):
    out = None
    for ax in axes:
        if mesh.shape[ax] > 1:
            if out is None:
                out = x.detach().clone(memory_format=torch.contiguous_format)
            dist.all_reduce(out, op=op, group=mesh.group(ax))
            trace.collective("all-reduce", trace.nbytes(out),
                             _ranks(mesh, ax))
    return x if out is None else out


def _gather(x, mesh, axes, dim):
    for ax in reversed(tuple(axes)):
        n = mesh.shape[ax]
        if n == 1:
            continue
        x = x.detach().contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=mesh.group(ax))
        x = torch.cat(parts, dim=dim)
        trace.collective("all-gather", trace.nbytes(x), _ranks(mesh, ax))
    return x


def _own(x, mesh, axes, dim):
    """This rank's block of ``x`` along ``dim``, split over ``axes`` (the
    first the major one)."""
    index, count = 0, 1
    for a in axes:
        index = index * mesh.shape[a] + mesh.axis_index(a)
        count *= mesh.shape[a]
    n = x.shape[dim] // count
    return x.narrow(dim, index * n, n)


def _scatter(x, mesh, axes, dim):
    """The sum of ``x`` over ``axes``, this rank's block of it along
    ``dim``: a library reduce-scatter on each axis of more than one rank
    (the major axis first), an all-reduce and a cut on gloo (a real CPU
    tensor)."""
    for ax in axes:
        n = mesh.shape[ax]
        if n == 1:
            continue
        if on_card(x):
            src = x.detach().movedim(dim, 0).contiguous()
            out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
            dist.reduce_scatter_tensor(out, src, group=mesh.group(ax))
            trace.collective("reduce-scatter", trace.nbytes(out),
                             _ranks(mesh, ax))
            x = out.movedim(0, dim)
        else:
            x = _own(_reduce(x, mesh, (ax,), dist.ReduceOp.SUM), mesh,
                     (ax,), dim)
    return x


def _grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


class _PSum(torch.autograd.Function):
    """psum of partial sums whose result every rank uses alike: the
    gradient of each rank's part is the result's own (identity)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _reduce(x, mesh, axes, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GradPSum(torch.autograd.Function):
    """Identity forward, psum backward (the conjugate of ``_PSum``)."""

    @staticmethod
    def forward(ctx, mesh, axes, *xs):
        ctx.mesh, ctx.axes = mesh, axes
        ctx.meta = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        # every rank runs the same graph, so an unused output is unused on
        # all of them: its zeros keep the all-reduce the same everywhere
        leaves = [torch.zeros(sh, dtype=dt, device=dev) if g is None else g
                  for g, (sh, dt, dev) in zip(gs, ctx.meta)]
        with torch.profiler.record_function("grad_psum"):
            bufs, unpack = _pack([g.contiguous() for g in leaves])
            out = unpack([_reduce(b, ctx.mesh, ctx.axes, dist.ReduceOp.SUM)
                          for b in bufs])
        return (None, None) + tuple(
            None if g is None else o for g, o in zip(gs, out))


class _AllGather(torch.autograd.Function):
    """all_gather; backward the reduce-scatter of the gradient, or (for a
    result every rank uses alike) this rank's block of it."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim, replicated):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        ctx.replicated = replicated
        return _gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.replicated:
            return _own(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None, None
        with torch.profiler.record_function("grad_reduce_scatter"):
            out = _scatter(g, ctx.mesh, ctx.axes, ctx.dim)
        return out, None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    """The sum over the axes, this rank's block kept; backward the
    all-gather of the blocks' gradients."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


def psum(x, mesh, axes: Sequence[str]):
    """The sum of ``x`` over the mesh axes ``axes`` (the reference's
    ``psum``): a library all-reduce on each axis of more than one rank.
    Under autograd the result is taken as used alike on every rank of
    ``axes`` (partial sums of a product whose contracted dim is split,
    the logsumexp's sums, the loss's sums), so each rank's part gets the
    result's gradient: identity backward, as ``shard_map`` transposes a
    psum whose output is replicated."""
    axes = tuple(axes)
    if _grad(x) and _split_on(mesh, axes):
        return _PSum.apply(x, mesh, axes)
    return _reduce(x, mesh, axes, dist.ReduceOp.SUM)


def psum_(x, mesh, axes: Sequence[str]):
    """``psum`` IN PLACE on the contiguous tensor ``x`` (a gradient
    buffer), no autograd; returns ``x``."""
    for ax in axes:
        if mesh.shape[ax] > 1:
            dist.all_reduce(x, group=mesh.group(ax))
            trace.collective("all-reduce", trace.nbytes(x), _ranks(mesh, ax))
    return x


def pmax(x, mesh, axes: Sequence[str]):
    """The elementwise max over ``axes`` (the reference's ``pmax``); no
    gradient flows through it."""
    return _reduce(x.detach(), mesh, axes, dist.ReduceOp.MAX)


def all_gather(x, mesh, axes: Sequence[str], dim: int, *,
               replicated: bool = False):
    """The blocks of ``x`` along ``dim`` from every rank of ``axes``,
    concatenated in block order (the reference's tiled ``all_gather``).
    The first axis is the major one, as in a ``PartitionSpec`` entry
    that names several axes; axes of size 1 are skipped.

    Under autograd the backward is the conjugate reduce-scatter: the
    gradient summed over ``axes``, this rank's block kept (an FSDP
    weight gathered whole, each rank's use of it a part of the loss).
    ``replicated=True`` is a result every rank of ``axes`` uses alike and
    whose gradient each holds whole (an activation gathered over
    ``model``): the backward keeps this rank's block of it."""
    axes = tuple(axes)
    if _grad(x) and _split_on(mesh, axes):
        return _AllGather.apply(x, mesh, axes, dim, replicated)
    return _gather(x, mesh, axes, dim)


def reduce_scatter(x, mesh, axes: Sequence[str], dim: int):
    """The sum of ``x`` over ``axes``, this rank's block of it along
    ``dim`` (the reference's ``psum_scatter``); its backward all-gathers
    the blocks' gradients."""
    axes = tuple(axes)
    if _grad(x) and _split_on(mesh, axes):
        return _ReduceScatter.apply(x, mesh, axes, dim)
    return _scatter(x, mesh, axes, dim)


def _exchange(x, mesh, axis, split_dim, concat_dim):
    """``x`` cut into the axis's n blocks along ``split_dim``, block i
    sent to rank i, and the n blocks received concatenated along
    ``concat_dim`` in rank order: one ``all_to_all_single`` on the axis's
    group (gloo and NCCL both take it)."""
    n = mesh.shape[axis]
    src = x.detach().movedim(split_dim, 0).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group(axis))
    trace.collective("all-to-all", trace.nbytes(out), _ranks(mesh, axis))
    blocks = out.view(n, src.shape[0] // n, *src.shape[1:]).unbind(0)
    return torch.cat([b.movedim(0, split_dim) for b in blocks],
                     dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    """all_to_all; backward the same exchange back (split and concat
    dims swapped), as ``shard_map`` transposes it."""

    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, concat_dim, split_dim)
        return _exchange(x, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, *ctx.args), None, None, None, None


def all_to_all(x, mesh, axis: str, split_dim: int, concat_dim: int):
    """The reference's ``all_to_all(x, axis, split_dim, concat_dim)``:
    ``x`` cut into ``mesh.shape[axis]`` equal blocks along ``split_dim``,
    block i sent to the axis's rank i, the blocks received from ranks 0,
    1, ... concatenated along ``concat_dim``.  Under autograd its
    backward is the exchange back.  An axis of one rank returns ``x``."""
    if mesh.shape[axis] == 1:
        return x
    if x.shape[split_dim] % mesh.shape[axis]:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"split over the {mesh.shape[axis]} ranks of "
                         f"{axis!r}")
    if _grad(x):
        return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)
    return _exchange(x, mesh, axis, split_dim, concat_dim)


def grad_psum(x, mesh, axes: Sequence[str]):
    """``x`` unchanged, its gradient summed over ``axes``: where a tensor
    every rank of ``axes`` holds alike enters a computation split over
    them (a product whose weight is split over ``model``, this rank's
    block of rows or heads), each rank's gradient is a part of the whole
    and the backward all-reduces it (Megatron's ``f``, the conjugate of
    ``psum``).  ``x`` is a tensor or a tuple of tensors (their gradients
    summed in one all-reduce where they share a dtype)."""
    axes = tuple(axes)
    many = isinstance(x, (tuple, list))
    xs = tuple(x) if many else (x,)
    if not (_grad(*xs) and _split_on(mesh, axes)):
        return x
    out = _GradPSum.apply(mesh, axes, *xs)
    return out if many else out[0]


# ---------------------------------------------------------------- combines

def _softmax_merge(a, b):
    """Associative merge of split-KV softmax partials (m, l, acc)."""
    m_a, l_a, acc_a = a
    m_b, l_b, acc_b = b
    m = torch.maximum(m_a, m_b)
    sa = torch.exp(m_a - m)
    sb = torch.exp(m_b - m)
    l = l_a * sa + l_b * sb
    acc = acc_a * sa[..., None] + acc_b * sb[..., None]
    return m, l, acc


def _add(a, b):
    return _tree_map(torch.add, a, b)


def softmax_combine(parts, mesh, axis_names: Sequence[str],
                    schedule: str = "xla"):
    """Merge (m, l, acc) decode-attention partials across the seq-shard
    axes ``axis_names``.

    schedule:
      "xla"        — the library's all-reduce (max of m, then sums of the
                     rescaled l and acc), the reference's pmax / psum;
      "gleam_tree" — the explicit butterfly aggregation tree of
                     point-to-point rounds (the paper's in-fabric
                     feedback aggregation, adapted).
    Any other schedule is taken as "xla", as the reference takes it.  Both
    are exact up to floating-point rounding (the merge is associative).
    """
    m, l, acc = parts
    if schedule == "gleam_tree":
        for ax in axis_names:
            m, l, acc = butterfly_allreduce((m, l, acc), mesh, ax,
                                            _softmax_merge)
        return m, l, acc
    m_g = pmax(m, mesh, axis_names)
    scale = torch.exp(m - m_g)
    l_s, acc_s = l * scale, acc * scale[..., None]
    # l and acc summed by one all-reduce (the reference's two psums)
    both = psum(torch.cat([l_s.reshape(-1), acc_s.reshape(-1)]), mesh,
                axis_names)
    return m_g, both[:l_s.numel()].view_as(l_s), \
        both[l_s.numel():].view_as(acc_s)


def allreduce_sum(x, mesh, axis_names: Sequence[str], schedule: str = "xla"):
    """Gradient-sync allreduce with a selectable schedule (data-parallel
    sync): ``xla`` / ``psum`` the library's all-reduce, ``gleam_tree`` the
    butterfly, ``ring`` and ``unicast`` a tree reduce followed by the
    ring or unicast broadcast (the overlay baselines)."""
    if schedule in ("xla", "psum"):
        return _tree_map(lambda a: psum(a, mesh, axis_names), x)
    for ax in axis_names:
        if schedule == "gleam_tree":
            x = butterfly_allreduce(x, mesh, ax, _add)
        elif schedule == "ring":
            x = tree_reduce(x, mesh, ax, _add)
            x = ring_broadcast(x, mesh, ax)
        elif schedule == "unicast":
            x = tree_reduce(x, mesh, ax, _add)
            x = unicast_broadcast(x, mesh, ax)
        else:
            raise ValueError(schedule)
    return x
