"""Parameter machinery and elementwise blocks (norms, MLP, RoPE,
sinusoidal positions).

The port of the reference package's ``models/blocks.py``.  Parameters are
described by ``ParamDef(shape, axes)`` trees (nested dicts);
``init_params`` draws them from a ``torch.Generator`` with the reference's
scheme.  The two frameworks' generators give different numbers from one
seed, so the parity tests carry the reference's weights across
(``repro_torch.convert.params_from_reference``) instead.
``param_specs`` / ``param_shardings`` resolve the definitions against a
``parallel/sharding.ShardingPlan``; ``shard_params`` keeps this rank's
block of every leaf of a whole tree, and ``init_sharded_params`` draws
each leaf (one layer at a time) from its own seed and keeps only this
rank's block, so that the weights are the same bits on any mesh.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import on_card, resolve_device
from repro_torch.parallel.sharding import block_shape, shard


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    axes: tuple                    # logical axis names, len == len(shape)
    init: str = "normal"           # normal | zeros | ones | small
    scale: float | None = None     # stddev override for "normal"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_leaves(tree, prefix: str = ""):
    """``(dotted name, leaf)`` pairs of a nested dict, keys sorted at every
    level (the reference's pytree order); a list's items in order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_leaves(tree[key], f"{prefix}{key}.")
    elif isinstance(tree, list):
        for i, item in enumerate(tree):
            yield from tree_leaves(item, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def tree_map(fn, tree, other=None):
    """``fn(leaf)`` over a nested dict, or ``fn(leaf, other_leaf)`` with a
    second dict ``other`` shaped alike."""
    if isinstance(tree, dict):
        if other is None:
            return {k: tree_map(fn, v) for k, v in tree.items()}
        return {k: tree_map(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree) if other is None else fn(tree, other)


def init_params(defs, generator: torch.Generator):
    """Materialise a ``ParamDef`` tree in float32 on the generator's
    device.

    ``zeros``/``ones`` as named; otherwise ``normal * std`` with
    ``std = scale`` or ``1/sqrt(shape[-2])`` (``shape[-1]`` for vectors),
    drawn leaf by leaf in pytree order.
    """
    device = generator.device

    def make(d: ParamDef):
        if d.init == "zeros":
            return torch.zeros(d.shape, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, device=device)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale if d.scale is not None else 1.0 / math.sqrt(fan_in)
        return torch.randn(d.shape, generator=generator,
                           device=device) * std

    return unflatten({name: make(d) for name, d in tree_leaves(defs)})


def param_specs(defs, plan):
    """The spec of every leaf of a ``ParamDef`` tree under ``plan``."""
    return tree_map(lambda d: plan.spec(d.axes, d.shape), defs)


def param_shardings(defs, plan):
    """The ``NamedSharding`` of every leaf under ``plan``."""
    return tree_map(lambda d: plan.sharding(d.axes, d.shape), defs)


def shard_params(tree, defs, plan, mesh):
    """This rank's block of every leaf of the whole tree ``tree`` (shaped
    like ``defs``), as ``plan`` places it on ``mesh``."""
    return tree_map(lambda leaf, spec: shard(leaf, spec, mesh), tree,
                    param_specs(defs, plan))


def _leaf_seed(seed: int, leaf: int, layer: int) -> int:
    return ((seed * 1_000_003 + leaf) * 1_000_003 + layer) % (1 << 63)


def init_sharded_params(defs, plan, mesh, *, seed: int,
                        dtype=torch.bfloat16):
    """This rank's blocks of a ``ParamDef`` tree in ``dtype`` on
    ``mesh.device``, the weights the same bits on any mesh.

    Leaf i (in pytree order) is drawn with ``init_params``'s scheme in
    float32, a layer at a time where its first axis is ``"layers"``,
    from a generator seeded with (``seed``, i, layer); each draw is cast
    to ``dtype`` and cut to this rank's block at once, so at most one
    layer of one leaf is ever whole (1.6 GB in float32 at qwen1.5-110b's
    MLP).  The numbers differ from ``init_params``'s, which draws every
    leaf from one generator."""
    dev = mesh.device
    gen = torch.Generator(device=dev)

    def draw(d: ParamDef, shape, leaf, layer):
        if d.init == "zeros":
            return torch.zeros(shape, device=dev)
        if d.init == "ones":
            return torch.ones(shape, device=dev)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale if d.scale is not None else 1.0 / math.sqrt(fan_in)
        gen.manual_seed(_leaf_seed(seed, leaf, layer))
        return torch.randn(shape, generator=gen, device=dev) * std

    out = {}
    for i, (name, d) in enumerate(tree_leaves(defs)):
        spec = plan.spec(d.axes, d.shape)
        if d.axes and d.axes[0] == "layers":
            local = torch.empty(block_shape(d.shape, spec, mesh),
                                dtype=dtype, device=dev)
            for j in range(d.shape[0]):
                local[j] = shard(draw(d, d.shape[1:], i, j).to(dtype),
                                 spec[1:], mesh)
        else:
            local = shard(draw(d, d.shape, i, 0).to(dtype), spec, mesh)
        out[name] = local
    return unflatten(out)


def unflatten(flat: dict) -> dict:
    """``{"a.b": x}`` -> ``{"a": {"b": x}}``."""
    tree: dict = {}
    for name, leaf in flat.items():
        node = tree
        *path, last = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def count_params(defs) -> int:
    return sum(math.prod(d.shape) for _, d in tree_leaves(defs))


# ---------------------------------------------------------------- blocks

def rms_norm(x, scale, eps):
    """In float32 (float64 for a float64 x), back in x's dtype."""
    dt = x.dtype
    x = x.to(torch.promote_types(dt, torch.float32))
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.to(x.dtype)).to(dt)


def silu(x):
    """``x * sigmoid(x)`` with ``sigmoid = 1 / (1 + exp(-x))``, rounding to
    x's dtype after every op as the reference does (in bf16 a fused
    ``F.silu``, rounding once, differs from it in the last bit)."""
    return x * (1 / (1 + torch.exp(-x)))


def swiglu(x, wi, wg, wo, compute_dtype):
    """SwiGLU MLP: silu(x@wg) * (x@wi) @ wo, in the compute dtype."""
    cd = compute_dtype
    x = x.to(cd)
    h = silu(x @ wg.to(cd)) * (x @ wi.to(cd))
    return h @ wo.to(cd)


def wide_mm(a, b):
    """``a (..., K) @ b (K, N)`` with the products summed, and the result
    kept, in float32 (at least): the partial sums of a product whose
    contracted dim is split over ranks.  The all-reduce adds them in
    float32 and the sum is rounded to the compute dtype once, where the
    one-device product rounds once; a bf16 partial would round once more
    on every rank, and those roundings move bf16 logits by several ulps
    (on the CPU the mesh's bf16 logits are the one device's bits without
    them).  On the card (and in a dry run's trace, ``device.on_card``)
    cuBLAS writes the float32 result itself (``torch.mm(out_dtype=)``)."""
    wide = torch.promote_types(a.dtype, torch.float32)
    a2 = a.reshape(-1, a.shape[-1])
    if on_card(a2) and a2.dtype != wide:
        out = _WideMM.apply(a2, b, wide)
    else:
        out = a2.to(wide) @ b.to(wide)
    return out.reshape(*a.shape[:-1], b.shape[-1])


class _WideMM(torch.autograd.Function):
    """``torch.mm(a, b, out_dtype=wide)`` (which has no derivative) with
    the gradient autograd gives a product in the inputs' dtype: the
    incoming float32 gradient taken to that dtype (exact where it comes
    back through the cast to the compute dtype), then its two products."""

    @staticmethod
    def forward(ctx, a, b, wide):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=wide)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = g @ b.t() if ctx.needs_input_grad[0] else None
        db = a.t() @ g if ctx.needs_input_grad[1] else None
        return da, db, None


def mlp_defs(d_model, d_ff):
    return {
        "wi": ParamDef((d_model, d_ff), ("embed", "mlp")),
        "wg": ParamDef((d_model, d_ff), ("embed", "mlp")),
        "wo": ParamDef((d_ff, d_model), ("mlp", "embed")),
    }


def stack_defs(defs, n: int):
    """Prepend a (n, "layers") dimension to every ParamDef in a tree."""
    return tree_map(lambda d: ParamDef((n,) + d.shape, ("layers",) + d.axes,
                                       d.init, d.scale), defs)


def rope(x, positions, theta):
    """Rotary embedding over the last dim (rotate-half convention).

    x: (..., seq, heads..., head_dim); positions: (..., seq) integers.
    """
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[..., None] * freqs          # (..., seq, half)
    extra = x.dim() - positions.dim() - 1
    ang = ang.reshape(ang.shape[:-1] + (1,) * extra + (half,))
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:2 * half]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    if hd > 2 * half:
        rot = torch.cat([rot, x[..., 2 * half:]], dim=-1)
    return rot.to(x.dtype)


def sinusoidal_at(positions, d_model):
    """Sinusoidal absolute position encoding at arbitrary positions:
    (...,) integers -> (..., d_model) float32, sines at the even and
    cosines at the odd features."""
    pos = positions.float()[..., None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32,
                                 device=positions.device)
                    * (-math.log(10000.0) / d_model))
    pe = torch.zeros(positions.shape + (d_model,), dtype=torch.float32,
                     device=positions.device)
    pe[..., 0::2] = torch.sin(pos * div)
    pe[..., 1::2] = torch.cos(pos * div[: (d_model + 1) // 2])
    return pe


def sinusoidal_positions(seq_len, d_model, *, device="cuda"):
    """``sinusoidal_at`` of positions ``0 .. seq_len - 1`` on ``device``
    (the card unless the caller asks for the CPU)."""
    return sinusoidal_at(torch.arange(seq_len, device=resolve_device(device)),
                         d_model)
