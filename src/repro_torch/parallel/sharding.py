"""Logical-axis sharding planner.

The port of the reference package's ``parallel/sharding.py``.  Every
parameter and activation is annotated with *logical* axis names (e.g.
``("embed", "heads", "head_dim")``).  The planner maps them onto mesh
axes with a rules table and a divisibility-checked fallback chain: if the
preferred mesh axis does not evenly divide the dimension (llama3.2's 24
heads on a 16-way model axis), the next logical axis of the tensor gets a
chance to absorb the mesh axis instead, else the dim is replicated.

This mirrors the Gleam control plane: the *registration* step decides,
per group member (tensor), how traffic (data) is addressed on the fabric
(mesh) -- one logical value, per-rank physical addressing.

``ShardingPlan.spec`` returns the tuple the reference's ``PartitionSpec``
holds: one entry per dim, ``None`` (whole), a mesh axis name, or a tuple
of names (the first the major one), trailing ``None`` entries dropped.
No JAX type is involved, and a plan needs only the mesh's names and
sizes (``launch/mesh.abstract_mesh``).  ``shard`` cuts this rank's block
of a whole tensor under a spec and ``gather`` puts the whole back
together from every rank's block (library all-gathers).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence

import torch

from repro_torch.core import collectives as coll

#: the mesh axes a batch (and an FSDP weight's ``embed`` dim) splits over
BATCH_AXES = ("pod", "data")

# Logical axis -> ordered candidate mesh-axis tuples.  Each candidate is a
# tuple of mesh axes (a logical dim may be sharded by several mesh axes at
# once, e.g. batch over (pod, data)).  First candidate whose axes are all
# free in this tensor and whose product divides the dim wins.
DEFAULT_RULES: dict[Any, Sequence[Sequence[str]]] = {
    # activations
    "batch": (("pod", "data"), ("data",)),
    "seq": ((),),                       # replicated by default
    "kv_seq": (("pod", "data"), ("data",),),  # long-context KV sharding
    "act_embed": ((),),
    "act_heads": (("model",),),
    "act_kv_heads": (("model",),),
    "act_head_dim": (("model",),),      # fallback when heads don't divide
    "act_mlp": (("model",),),
    "act_experts": (("model",),),
    "act_vocab": (("model",),),
    # weights -- "model" tensor parallelism + FSDP over (pod, data)
    "vocab": (("model",),),
    # embedding-table vocab dim: sharded over the FSDP axes (NOT model);
    # odd vocabs fall back to replicated
    "vocab_table": (("pod", "data"), ("data",)),
    "embed_table": ((),),       # feature dim of the embed table: replicated
    "embed": (("pod", "data"), ("data",)),   # FSDP / ZeRO-3 axis
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "head_dim": (("model",),),
    "mlp": (("model",),),
    "experts": (("model",),),
    "ssm_inner": (("model",),),
    "ssm_heads": (("model",),),
    "ssm_state": ((),),
    "conv_k": ((),),
    "norm": ((),),
    "layers": ((),),                    # stacked scan-over-layers dim
    None: ((),),
}

# Inference plan: weights replicated across the batch axes (pure tensor
# parallelism), so no per-step FSDP gathers on the decode path.  Used when
# the bf16 parameters over the model-axis size fit the memory budget
# (``launch/steps.serve_plan``).
INFERENCE_RULES = dict(DEFAULT_RULES)
INFERENCE_RULES.update({
    "embed": ((),),                 # weight embed dims: replicated
    "vocab_table": (("data",),),    # token table may stay vocab-sharded
})

# The logical axes that compete for the model axis, in order.
_MODEL_AXIS_PRIORITY = (
    "experts", "heads", "kv_heads", "mlp", "vocab", "ssm_heads",
    "ssm_inner", "head_dim", "act_experts", "act_heads", "act_kv_heads",
    "act_mlp", "act_vocab", "act_head_dim",
)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""
    mesh: Any
    spec: tuple


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Resolved sharding rules for one mesh (+ optional per-run
    overrides)."""

    mesh: Any
    rules: Mapping[Any, Sequence[Sequence[str]]] = dataclasses.field(
        default_factory=lambda: DEFAULT_RULES)

    def _mesh_size(self, axes: Sequence[str]) -> int:
        return math.prod(self.mesh.shape[a] for a in axes)

    def spec(self, logical_axes: Sequence[str | None],
             shape: Sequence[int] | None = None) -> tuple:
        """Resolve logical axes to a spec with divisibility fallback."""
        used: set[str] = set()
        out: list[tuple[str, ...] | None] = []
        for i, name in enumerate(logical_axes):
            dim = None if shape is None else shape[i]
            cands = self.rules.get(name, self.rules.get(None, ((),)))
            placed: tuple[str, ...] | None = None
            for cand in cands:
                cand = tuple(a for a in cand if a in self.mesh.axis_names)
                if not cand:
                    continue
                if any(a in used for a in cand):
                    continue
                if dim is not None and dim % self._mesh_size(cand) != 0:
                    continue
                placed = cand
                break
            if placed:
                used.update(placed)
            out.append(placed or None)
        # single-axis tuples -> str, for readable specs
        norm = [(p[0] if (p is not None and len(p) == 1) else p)
                for p in out]
        while norm and norm[-1] is None:
            norm.pop()
        return tuple(norm)

    def sharding(self, logical_axes: Sequence[str | None],
                 shape: Sequence[int] | None = None) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(logical_axes, shape))

    def tree_shardings(self, spec_tree, shape_tree):
        """Matching nested dicts of logical-axes tuples and shapes (or
        anything with a ``shape``) -> ``NamedSharding``s."""
        if isinstance(spec_tree, dict):
            return {k: self.tree_shardings(v, shape_tree[k])
                    for k, v in spec_tree.items()}
        return self.sharding(spec_tree, getattr(shape_tree, "shape",
                                                shape_tree))


def with_overrides(plan: ShardingPlan, **overrides) -> ShardingPlan:
    """A new plan with some logical-axis rules replaced, e.g.
    ``with_overrides(plan, embed=((),))`` disables FSDP."""
    rules = dict(plan.rules)
    for k, v in overrides.items():
        rules[k] = v
    return ShardingPlan(plan.mesh, rules)


# ---------------------------------------------------------------- blocks

def entry_axes(spec: tuple, dim: int) -> tuple:
    """The mesh axes of dim ``dim`` of ``spec`` (a trailing dim the spec
    leaves out is whole)."""
    entry = spec[dim] if dim < len(spec) else None
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def block(mesh, axes: Sequence[str]) -> tuple[int, int]:
    """``(index, count)``: this rank's block of a dim split over ``axes``
    (the first the major one)."""
    index, count = 0, 1
    for a in axes:
        index = index * mesh.shape[a] + mesh.axis_index(a)
        count *= mesh.shape[a]
    return index, count


def block_shape(shape: Sequence[int], spec: tuple, mesh) -> tuple:
    """The shape of one rank's block (every rank's is the same)."""
    out = []
    for d, n in enumerate(shape):
        count = math.prod(mesh.shape[a] for a in entry_axes(spec, d))
        if n % count:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"{count} ways ({spec})")
        out.append(n // count)
    return tuple(out)


def shard(t, spec: tuple, mesh):
    """This rank's block of the whole tensor ``t`` under ``spec``: a new
    tensor where it is a strict part of ``t`` (so the whole can be
    freed), ``t`` itself where the spec keeps it whole here."""
    out = t
    for d in range(t.dim()):
        axes = entry_axes(spec, d)
        if not axes:
            continue
        index, count = block(mesh, axes)
        if count == 1:
            continue
        size = t.shape[d] // count
        if size * count != t.shape[d]:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split "
                             f"{count} ways ({spec})")
        out = out.narrow(d, index * size, size)
    return out if out is t else out.clone(
        memory_format=torch.contiguous_format)


def gather(t, spec: tuple, mesh):
    """The whole tensor from every rank's block ``t`` under ``spec``
    (library all-gathers along each sharded dim)."""
    for d in range(t.dim()):
        t = coll.all_gather(t, mesh, entry_axes(spec, d), d)
    return t


def fsdp_whole(t, spec: tuple, mesh):
    """``t`` whole along every dim the spec splits over the batch axes
    (the FSDP per-step gathers, the profiler range ``fsdp_gather``; under
    autograd their backward reduce-scatters the gradient, the range
    ``grad_reduce_scatter``); model-axis dims stay split."""
    for d in range(t.dim()):
        axes = entry_axes(spec, d)
        if axes and all(a in BATCH_AXES for a in axes):
            if any(mesh.shape[a] > 1 for a in axes):
                with torch.profiler.record_function("fsdp_gather"):
                    t = coll.all_gather(t, mesh, axes, d)
        elif any(a in BATCH_AXES for a in axes):
            raise ValueError(f"dim {d} of spec {spec} mixes batch and model "
                             f"axes")
    return t
