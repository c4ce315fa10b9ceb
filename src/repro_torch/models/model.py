"""The LM: its decode path, its forward (prefill) and its loss.

The port of the reference package's ``models/model.py``: parameter
definitions for every architecture (so parameter counts agree
with the reference), the ``Model`` module holding them, the stacked decode
caches and ``decode_forward``; ``forward_hidden`` / ``forward`` over a
whole sequence; and ``chunked_xent`` / ``loss_fn``, which the train step
differentiates.  Every attention of a decode step (self-attention over
the KV cache, cross-attention over the encoder memory) runs
``models/attention.decode_attention`` (the flash-decode kernel on the
card); every attention of a forward (causal, windowed, the encoder's
bidirectional one and the decoder's cross-attention) runs
``attention.attention`` (the flash-attention kernel) and every Mamba-2
layer ``models/ssm.ssm_apply`` (the SSD-scan kernel), both
differentiable (``kernels/ops.py``).  The Mamba-2 decode step and the MoE
ffn are plain PyTorch (``models/ssm.ssm_decode_step``, ``models/moe.py``),
as the reference's are jnp.  Decode and prefill run under
``torch.no_grad()`` (``decode_forward``, ``forward``,
``launch/steps.make_prefill_step``); ``forward_hidden`` and the loss keep
gradients when the caller does.

Parameters keep the reference's names and layouts (``wq`` is (d, h, hd),
blocks are stacked on a leading ``n_blocks`` axis), so carrying weights
across is a copy (``repro_torch.convert.params_from_reference``).  The
matrix products the reference leaves to XLA are ``torch.einsum`` here,
with the parameters cast to the compute dtype inside every product, as
the reference casts them.

``Model`` holds every configuration, and every configuration decodes,
runs its forward and trains.  A sliding-window model's cache is a
rolling buffer of ``window`` slots (``cache_len``): position p writes
slot p mod window, and its valid slots are always the prefix ``[0,
min(p + 1, window))``, so the kernel attends that prefix (the
reference's sharded-branch mask; its single-shard mask is a fault,
ROADMAP queue 3).  A request's position in the encoder-decoder's
sinusoidal encoding is its own row's (the reference broadcasts one
position to the batch: queue 3).

On a mesh of ranks (``launch/mesh.Mesh``, through
``launch/steps.make_serve_step``) ``decode_forward`` runs the decode step
of every configuration SPMD, each rank on its own blocks of the
parameters (as a ``parallel/sharding.ShardingPlan`` places them) and of
the caches (``cache_specs``: the batch over the batch axes when it
shards, the KV cache's sequence over ``model`` and, when the batch does
not shard, over the batch axes too; a Mamba-2 state over ``model`` on
its heads, its conv window and the encoder memory whole over ``model``).
The KV cache is split along its sequence: each rank runs the
flash-decode kernel on its own block, and
``core/collectives.softmax_combine`` merges the partial statistics (m,
l, acc) over the sequence axes with ``cfg.collective_schedule`` (the
Gleam aggregation tree for ``gleam_tree``).  Where the reference leaves
the rest to GSPMD, the port places the communication itself, with the
library's collectives: dims of a weight sharded over the batch axes
(FSDP) are all-gathered before use; outputs of a product whose weight is
sharded over ``model`` stay sharded until a whole tensor is needed (the
new token's k and v before the cache write, q before the attention
core, a Mamba-2 layer's new conv column before its write, the logits at
the end, all-gathered over ``model``); products that contract a sharded
dim (``wo`` over heads, the cross-attention's ``xwo``, the MLP's down
projection, a Mamba-2 layer's ``wo``) all-reduce their partial sums over
``model``, and the gated norm of a Mamba-2 layer its sum of squares; the
MoE runs each rank's experts and adds their outputs over ``model``
(``models/moe.moe_decode``); the embedding is a masked lookup in the
rank's rows of the table, summed over the axes that split them.  One
code path serves both: on ``mesh=None`` or a (1, 1) mesh every
collective is on an axis of one rank and does nothing, so it is the
one-device path bit for bit.

Prefill and training run on a mesh too (``forward_hidden``,
``forward``, ``loss_fn`` with ``mesh=``; ``launch/steps.py``'s train and
prefill steps), each rank on its blocks under ``train_specs`` (the
reference's ``DEFAULT_RULES`` plan) and on its rows of the batch.  The
communication is the decode step's, made differentiable
(``core/collectives``: each collective with the backward ``shard_map``
gives it): the FSDP gathers reduce-scatter their gradient; the psums of
partial sums pass the gradient through; a tensor every ``model`` rank
holds alike enters the rank's split computation through ``grad_psum``,
whose backward sums the ranks' parts.  Attention runs ``attn_core``'s
branch for the split: heads, kv heads replicated, or the
sequence-parallel fallback with ``q_offset``.  The loss assembles a
vocabulary split over ``model`` across ranks and is that of the whole
batch.  Every configuration runs there: a MoE sublayer dispatches its
tokens to the experts' owners with ``all_to_all`` (``models/moe.py``), a
Mamba-2 one scans the rank's heads (``models/ssm.ssm_apply``), the
encoder's bidirectional blocks and the decoder's cross-attention run on
the rank's heads over the encoder memory of the rank's rows, and the
VLM's prefix is projected by its FSDP-gathered ``vis_proj``.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.core import collectives as coll
from repro_torch.kernels import ops
from repro_torch.models.blocks import (ParamDef, init_params, mlp_defs,
                                       param_specs, rms_norm, rope, silu,
                                       sinusoidal_at, sinusoidal_positions,
                                       stack_defs, swiglu, tree_leaves,
                                       tree_map, unflatten, wide_mm)
from repro_torch.parallel import sharding as shd

BATCH_AXES = shd.BATCH_AXES

# ================================================================ defs


def _attn_defs(cfg: ArchConfig, cross: bool = False):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    defs = {
        "norm": ParamDef((d,), ("norm",), init="ones"),
        "wq": ParamDef((d, h, hd), ("embed", "heads", None)),
        "wk": ParamDef((d, kv, hd), ("embed", "kv_heads", None)),
        "wv": ParamDef((d, kv, hd), ("embed", "kv_heads", None)),
        "wo": ParamDef((h, hd, d), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((h, hd), ("heads", None), init="zeros")
        defs["bk"] = ParamDef((kv, hd), ("kv_heads", None), init="zeros")
        defs["bv"] = ParamDef((kv, hd), ("kv_heads", None), init="zeros")
    if cross:
        defs["xnorm"] = ParamDef((d,), ("norm",), init="ones")
        defs["xwq"] = ParamDef((d, h, hd), ("embed", "heads", None))
        defs["xwk"] = ParamDef((d, kv, hd), ("embed", "kv_heads", None))
        defs["xwv"] = ParamDef((d, kv, hd), ("embed", "kv_heads", None))
        defs["xwo"] = ParamDef((h, hd, d), ("heads", None, "embed"))
    return defs


def _ffn_defs(cfg: ArchConfig, kind):
    d = cfg.d_model
    if kind is None:
        return {}
    norm = {"norm": ParamDef((d,), ("norm",), init="ones")}
    if kind == "mlp":
        return {**norm, **mlp_defs(d, cfg.d_ff)}
    if kind == "moe":
        return {**norm, **moe_mod.moe_defs(cfg)}
    raise ValueError(kind)


def _sublayer_defs(cfg: ArchConfig, mixer, ffn, cross=False):
    if mixer == "attn":
        mdefs = _attn_defs(cfg, cross=cross)
    elif mixer == "mamba":
        mdefs = {"norm": ParamDef((cfg.d_model,), ("norm",), init="ones"),
                 **ssm_mod.ssm_defs(cfg)}
    else:
        raise ValueError(mixer)
    return {"mixer": mdefs, "ffn": _ffn_defs(cfg, ffn)}


def model_defs(cfg: ArchConfig):
    d, v = cfg.d_model, cfg.vocab_size
    block = {f"sub{i}": _sublayer_defs(cfg, m, f,
                                       cross=(cfg.enc_layers > 0))
             for i, (m, f) in enumerate(cfg.pattern)}
    defs: dict[str, Any] = {
        "embed": ParamDef((v, d), ("vocab_table", "embed_table"),
                          scale=0.02),
        "blocks": stack_defs(block, cfg.n_blocks),
        "final_norm": ParamDef((d,), ("norm",), init="ones"),
        "lm_head": ParamDef((d, v), ("embed", "vocab")),
    }
    if cfg.enc_layers > 0:
        eblock = {"sub0": _sublayer_defs(cfg, "attn", "mlp")}
        defs["enc_blocks"] = stack_defs(eblock, cfg.enc_layers)
        defs["enc_in"] = ParamDef((d, d), ("embed", None))
        defs["enc_norm"] = ParamDef((d,), ("norm",), init="ones")
    if cfg.vision_prefix > 0:
        defs["vis_proj"] = ParamDef((d, d), ("embed", None))
    return defs


class Model(nn.Module):
    """The parameters of ``model_defs(cfg)``, named and laid out as in the
    reference: the state-dict key ``blocks.sub0.mixer.wq`` is the
    reference's ``params["blocks"]["sub0"]["mixer"]["wq"]``, shape
    (n_blocks, d, h, hd).  Float32 weights are drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed`` (``blocks.init_params``).

    No parameter requires a gradient: the train step
    (``launch/steps.make_train_step``) differentiates leaves of its own
    that share the parameters' storage.
    """

    def __init__(self, cfg: ArchConfig, *, seed: int = 0, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator(device=dev).manual_seed(seed)
        _register(self, init_params(model_defs(cfg), gen))
        #: the parameters as the reference's nested dict (same tensors)
        self.params = unflatten(dict(self.named_parameters()))


def _register(module: nn.Module, tree: dict) -> None:
    for key, val in tree.items():
        if isinstance(val, dict):
            child = nn.Module()
            _register(child, val)
            module.add_module(key, child)
        else:
            module.register_parameter(
                key, nn.Parameter(val, requires_grad=False))


# ================================================================ decode

def _weight(p, name, cd, sp=None, mesh=None):
    """``p[name]`` in the compute dtype; on a mesh (``sp`` the specs of
    this rank's blocks) whole along every dim its spec splits over the
    batch axes (``sharding.fsdp_whole``)."""
    w = p[name].to(cd)
    return shd.fsdp_whole(w, sp[name], mesh) if sp else w


def _axes(sp, name, dim):
    """The mesh axes that split dim ``dim`` of ``name`` (none off a
    mesh)."""
    return shd.entry_axes(sp[name], dim) if sp else ()


def _project_qkv(p, x, cfg, cd, prefix="", sp=None, mesh=None):
    """q, k, v of ``x`` through ``wq``/``wk``/``wv`` (``xwq``... with
    prefix "x", the cross-attention's, which have no bias); on a mesh
    this rank's heads of them.  Under autograd the products whose weight
    the plan splits over heads take ``x`` in through one ``grad_psum``:
    each rank's gradient of ``x`` there is the part of its heads."""
    names = [prefix + n for n in ("wq", "wk", "wv")]
    axes = [_axes(sp, n, 1) for n in names]
    split = [a for a in axes if _split(mesh, a)]
    xs = coll.grad_psum(x, mesh, split[0]) if split else x
    q, k, v = (torch.einsum("bsd,dhk->bshk", xs if _split(mesh, a) else x,
                            _weight(p, n, cd, sp, mesh))
               for n, a in zip(names, axes))
    if cfg.qkv_bias and prefix == "":
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    return q, k, v


def cache_len(cfg, seq_len):
    return min(seq_len, cfg.window) if cfg.window else seq_len


def cache_structs(cfg, batch, seq_len, *, dtype=torch.bfloat16):
    """``(shape, dtype)`` of every leaf of ``init_caches``' tree, nothing
    allocated (the reference's ``init_caches(abstract=True)``)."""
    sub = {}
    for i, (mixer, _) in enumerate(cfg.pattern):
        if mixer == "attn":
            shape = (cfg.n_blocks, batch, cache_len(cfg, seq_len),
                     cfg.n_kv_heads, cfg.hd)
            sub[f"sub{i}"] = {"k": (shape, dtype), "v": (shape, dtype)}
        else:
            d_in, h, p, n, k = ssm_mod.ssm_dims(cfg)
            sub[f"sub{i}"] = {
                "conv": ((cfg.n_blocks, batch, k - 1, d_in + 2 * n), dtype),
                "state": ((cfg.n_blocks, batch, h, n, p), torch.float32)}
    caches = {"layers": sub}
    if cfg.enc_layers > 0:
        enc_len = max(seq_len // max(cfg.audio_stride, 1), 8)
        caches["memory"] = ((batch, enc_len, cfg.d_model), dtype)
    return caches


def _is_struct(x):
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)


def init_caches(cfg, batch, seq_len, *, mesh=None, batch_shardable=True,
                dtype=torch.bfloat16, device="cuda"):
    """Per-layer decode caches stacked over n_blocks, zero-filled, the
    reference's tree: ``{"layers": {"sub<i>": ...}}`` with ``k``, ``v``
    (n_blocks, B, cache_len, KVH, hd) for an attention sublayer and
    ``conv`` (n_blocks, B, K - 1, d_in + 2N), ``state`` (n_blocks, B, H,
    N, P) float32 for a Mamba-2 one; plus ``memory`` (B, max(seq_len //
    audio_stride, 8), d_model) for an encoder-decoder (the encoder's
    output, zero until a caller fills it).  Every leaf but the state is
    in ``dtype``, bf16 by default as in the reference.  On a ``mesh``
    each leaf is this rank's block of it (``cache_specs``)."""
    dev = resolve_device(device)
    structs = cache_structs(cfg, batch, seq_len, dtype=dtype)
    if _on_one_device(mesh):
        return _map_structs(lambda sd: torch.zeros(
            sd[0], dtype=sd[1], device=dev), structs)
    specs = cache_specs(cfg, batch, seq_len, mesh, batch_shardable)
    return _map_structs(lambda sd, sp: torch.zeros(
        shd.block_shape(sd[0], sp, mesh), dtype=sd[1], device=dev),
        structs, specs)


def _map_structs(fn, tree, other=None):
    if _is_struct(tree):
        return fn(tree) if other is None else fn(tree, other)
    return {k: _map_structs(fn, v, None if other is None else other[k])
            for k, v in tree.items()}


def cache_insert(kc, vc, k_new, v_new, pos):
    """Write (B, 1, KVH, hd) into the (B, S, KVH, hd) cache IN PLACE at
    slot ``pos``: an int (one slot for every row) or a (B,) integer
    tensor (the serve runtime's per-row positions).  The caller has
    checked ``0 <= pos < S``."""
    if isinstance(pos, int):
        kc[:, pos] = k_new[:, 0].to(kc.dtype)
        vc[:, pos] = v_new[:, 0].to(vc.dtype)
    else:
        rows = torch.arange(kc.shape[0], device=kc.device)
        kc[rows, pos] = k_new[:, 0].to(kc.dtype)
        vc[rows, pos] = v_new[:, 0].to(vc.dtype)
    return kc, vc


def decode_attn_core(q, kc, vc, kv_len, cfg):
    """Single-shard decode attention: q (B, 1, H, hd) against the first
    ``kv_len[b]`` slots of row b of the cache (for a rolling buffer, the
    valid prefix ``min(pos + 1, window)``)."""
    return attn.decode_attention(q, kc, vc, kv_len=kv_len, window=cfg.window)


def _cross(p, x, memory, cfg, cd, core, sp=None, mesh=None):
    """The cross-attention of an encoder-decoder's sublayer: q from x
    through ``xnorm``/``xwq``, k and v from the encoder memory, ``core``
    the attention itself.  On a mesh (``sp`` the specs of this rank's
    blocks) it runs on the rank's heads of ``xwq`` / ``xwk`` / ``xwv``
    over the rank's rows of the memory (whole over its length), and
    ``xwo``'s partial sums are all-reduced.  Under autograd x's norm and
    the memory, which every rank of the heads' axes holds alike, enter
    the split products through ``grad_psum``."""
    hx = rms_norm(x, p["xnorm"], cfg.norm_eps).to(cd)
    mem = memory.to(cd)
    if _split(mesh, _axes(sp, "xwq", 1)):
        hx = coll.grad_psum(hx, mesh, _axes(sp, "xwq", 1))
    if _split(mesh, _axes(sp, "xwk", 1)):
        mem = coll.grad_psum(mem, mesh, _axes(sp, "xwk", 1))
    qx = torch.einsum("bsd,dhk->bshk", hx, _weight(p, "xwq", cd, sp, mesh))
    kx = torch.einsum("bsd,dhk->bshk", mem, _weight(p, "xwk", cd, sp, mesh))
    vx = torch.einsum("bsd,dhk->bshk", mem, _weight(p, "xwv", cd, sp, mesh))
    if _axes(sp, "xwq", 1) != _axes(sp, "xwk", 1):
        raise ValueError(f"{cfg.name}: the plan splits the cross-attention's "
                         f"q heads and kv heads differently")
    ox = core(qx, kx, vx)
    return _out_proj(x, ox, p, "xwo", cd, sp, mesh)


def attn_decode_apply(p, x, cache, positions, insert, core, cfg,
                      memory=None, *, sp=None, mesh=None):
    """The attention sublayer of one decode step (self-attention, then
    cross-attention over ``memory`` when given): ``insert(kc, vc, k, v)``
    writes the new token's k and v into ``cache``, ``core(q, kc, vc)``
    attends.  On a mesh ``p`` holds this rank's blocks (``sp`` their
    specs): q, k and v are gathered whole over the heads before the
    write, and the partial sums of ``wo`` over its heads all-reduced."""
    cd = getattr(torch, cfg.compute_dtype)
    h = rms_norm(x, p["norm"], cfg.norm_eps).to(cd)
    q, k, v = _project_qkv(p, h, cfg, cd, sp=sp, mesh=mesh)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q, k, v = _gather_heads((q, k, v), (_axes(sp, "wq", 1),)
                            + (_axes(sp, "wk", 1),) * 2, mesh)
    kc, vc = insert(cache["k"], cache["v"], k, v)
    o = core(q, kc, vc)
    wo, axes = _weight(p, "wo", cd, sp, mesh), _axes(sp, "wo", 0)
    if not _split(mesh, axes):
        x = x + torch.einsum("bshk,hkd->bsd", o.to(cd), wo)
    else:
        index, count = shd.block(mesh, axes)
        n = o.shape[2] // count
        part = wide_mm(o.narrow(2, index * n, n).to(cd).flatten(2),
                        wo.flatten(0, 1))
        x = x + coll.psum(part, mesh, axes).to(cd)
    if memory is not None:
        x = _cross(p, x, memory, cfg, cd, attn.cross_attention, sp, mesh)
    return x


def ffn_apply(p, x, kind, cfg, decode=False, *, sp=None, mesh=None,
              batch_axes=()):
    """The ffn sublayer: an MLP, a MoE (``models/moe.py``; its decode
    path when ``decode``) or nothing (``kind`` None).  Returns ``(x,
    aux)``, aux the MoE router loss (0.0 otherwise).  On a mesh the MLP
    runs on this rank's blocks (``sp`` their specs), the partial sums of
    its down projection all-reduced over the axes that split ``d_ff``;
    the MoE on the rank's experts (``moe.moe_decode``; ``batch_axes`` the
    axes that split x's rows)."""
    if kind is None:
        return x, 0.0
    cd = getattr(torch, cfg.compute_dtype)
    h = rms_norm(x, p["norm"], cfg.norm_eps).to(cd)
    if kind == "mlp":
        wi, wg, wo = (_weight(p, n, cd, sp, mesh) for n in ("wi", "wg", "wo"))
        axes = _axes(sp, "wo", 0)
        if not _split(mesh, axes):
            return x + swiglu(h, wi, wg, wo, cd), 0.0
        h = coll.grad_psum(h, mesh, axes)
        part = wide_mm(silu(h @ wg) * (h @ wi), wo)
        with torch.profiler.record_function("model_psum"):
            part = coll.psum(part, mesh, axes)
        return x + part.to(cd), 0.0
    y, aux = moe_mod.moe_apply(p, h, cfg, decode=decode, sp=sp, mesh=mesh,
                               batch_axes=batch_axes)
    return x + y, aux


def _mixer_params(p):
    return {k: v for k, v in p.items() if k != "norm"}


def run_blocks_decode(blocks, caches, x, positions, insert, core, cfg,
                      memory=None, specs=None, mesh=None, batch_axes=()):
    """One decode step through the stacked blocks, a Python loop in place
    of the reference's scan; the caches are updated in place (``insert``
    and ``core`` as ``attn_decode_apply`` takes them; a Mamba-2 layer's
    conv window and state written back).  On a mesh ``specs`` are those
    of this rank's blocks of ``blocks`` and of ``caches``, and
    ``batch_axes`` the axes that split x's rows."""
    layer_specs = tree_map(lambda sp: sp[1:], specs) if specs else {}
    for i, bp in enumerate(block_layers(blocks)):
        for j, (mixer, ffn) in enumerate(cfg.pattern):
            sub = bp[f"sub{j}"]
            sp = layer_specs.get(f"sub{j}", {})
            layer = caches["layers"][f"sub{j}"]
            cache = {name: t[i] for name, t in layer.items()}
            if mixer == "attn":
                x = attn_decode_apply(sub["mixer"], x, cache, positions,
                                      insert, core, cfg, memory,
                                      sp=sp.get("mixer"), mesh=mesh)
            else:
                hm = rms_norm(x, sub["mixer"]["norm"], cfg.norm_eps)
                msp = sp.get("mixer")
                y, new = ssm_mod.ssm_decode_step(
                    _mixer_params(sub["mixer"]), hm, cache, cfg,
                    sp=_mixer_params(msp) if msp else None, mesh=mesh)
                for name, t in new.items():
                    cache[name].copy_(t)
                x = x + y
            x, _ = ffn_apply(sub.get("ffn"), x, ffn, cfg, decode=True,
                             sp=sp.get("ffn"), mesh=mesh,
                             batch_axes=batch_axes)
    return x


def embed_tokens(params, tokens, cfg, cd, *, mesh=None, spec=(),
                 batch_axes=()):
    """Token embedding lookup (the reference's gather branch).  On a mesh
    (``spec`` that of this rank's block of the table) a masked lookup in
    the rank's rows of the table, summed over the axes that split them
    (exact: one row is nonzero).  With ``cfg.embed_impl == "psum"`` the
    rows are split over ``model`` too, the reference's mask + psum;
    tokens split over an axis that also splits the table (``batch_axes``,
    those that split the batch) are gathered over it first and the rank's
    rows taken back after the sum (a reduce-scatter).  Under autograd
    each rank's rows of the table get the gradient of every token that
    reads them: the reduce-scatter's backward all-gathers the rows'
    gradients, and the table's ``model`` block enters through
    ``grad_psum`` (every ``model`` rank holds the table alike)."""
    table = params["embed"]
    axes = shd.entry_axes(spec, 0)
    m = mesh.shape.get("model", 1) if mesh is not None else 1
    if (cfg.embed_impl == "psum" and m > 1 and "model" not in axes
            and table.shape[0] % m == 0):
        index, _ = shd.block(mesh, ("model",))
        rows = table.shape[0] // m
        table = coll.grad_psum(table, mesh, ("model",)).narrow(
            0, index * rows, rows)
        axes = axes + ("model",)
    axes = tuple(a for a in axes if mesh.shape[a] > 1)
    if not axes:
        return table[tokens].to(cd)
    index, _ = shd.block(mesh, axes)
    v_local = table.shape[0]
    shared = tuple(a for a in batch_axes if a in axes)
    toks = coll.all_gather(tokens, mesh, shared, 0)
    loc = toks - index * v_local
    ok = (loc >= 0) & (loc < v_local)
    rows = table.to(cd)[torch.clamp(loc, 0, v_local - 1)]
    rows = coll.psum(torch.where(ok[..., None], rows, 0), mesh,
                     tuple(a for a in axes if a not in shared))
    return coll.reduce_scatter(rows, mesh, shared, 0)


def _check_on(dev, tree, what):
    for name, t in tree_leaves(tree):
        if t.device != dev:
            raise ValueError(f"{what} on {dev}: {name} is on {t.device}")


def _kv_slots(cfg, caches):
    """Slots of the KV caches, and whether they are a rolling buffer (a
    windowed model's cache of ``window`` slots); (None, False) without
    attention."""
    for layer in caches["layers"].values():
        if "k" in layer:
            n = layer["k"].shape[2]
            return n, bool(cfg.window) and n >= cfg.window
    return None, False


def _steps(step, b, n_slots, rolling):
    """The host-side positions as an array, checked: a scalar or (b,),
    inside a linear cache of ``n_slots``."""
    steps = np.asarray(step.cpu() if torch.is_tensor(step) else step)
    if steps.ndim not in (0, 1) or (steps.ndim == 1 and steps.shape != (b,)):
        raise ValueError(f"step must be a scalar or ({b},), got "
                         f"{steps.shape}")
    if (steps < 0).any() or (n_slots is not None and not rolling
                             and (steps >= n_slots).any()):
        raise IndexError(f"decode positions {steps} outside the "
                         f"{n_slots}-slot cache")
    return steps


@torch.no_grad()
def decode_forward(params, caches, tokens, step, cfg, *, mesh=None,
                   batch_shardable=True, plan=None, device="cuda"):
    """Single-token serve forward: (B, 1) tokens -> (B, 1, V) f32 logits.

    ``params`` is ``Model.params``; ``caches`` comes from
    ``init_caches`` and is updated IN PLACE (returned as well, as the
    reference returns its new caches).  ``step`` is the host-side
    position: an int for every row, or a (B,) array of per-row positions
    (continuous batching).  A position must lie in a linear KV cache; a
    rolling buffer (sliding window) and a model without attention take
    any position.  Everything runs on ``device``, where the parameters
    and caches must be.

    On a ``mesh`` every tensor is this rank's block: the parameters as
    ``plan`` places them (``blocks.shard_params``; a mesh of more than
    one rank needs it, ``launch/steps.make_serve_step`` passes its own),
    the caches (``init_caches(mesh=, batch_shardable=)``), the tokens'
    rows and the returned logits' rows (the batch's block over the batch
    axes when ``batch_shardable``, else every row), the logits whole over
    the vocabulary.  ``step`` is the same on every rank; per-row
    positions need a KV cache whose sequence is not split.  A (1, 1) mesh
    runs the same code as ``mesh=None``: every collective on an axis of
    one rank does nothing.
    """
    dev = resolve_device(device)
    _check_on(dev, {"params": params, "caches": caches}, "decode_forward")
    if not _on_one_device(mesh):
        if plan is None:
            raise ValueError("decode_forward on a mesh of more than one rank "
                             "needs the plan that placed the parameters")
        if mesh.device != dev:
            raise ValueError(f"decode_forward on {dev}, the mesh's rank is "
                             f"on {mesh.device}")
    specs = (param_specs(model_defs(cfg), plan) if plan is not None
             else None)
    cd = getattr(torch, cfg.compute_dtype)
    b = tokens.shape[0]
    seq_axes = _seq_axes(mesh, batch_shardable) if mesh is not None else ()
    n_local, _ = _kv_slots(cfg, caches)
    n_slots = (n_local * math.prod(mesh.shape[a] for a in seq_axes)
               if n_local else None)
    if seq_axes and cfg.window and n_slots > cfg.window:
        raise ValueError(f"a {n_slots}-slot cache is longer than the window "
                         f"{cfg.window}; windowed caches are rolling buffers "
                         f"of at most the window")
    rolling = bool(cfg.window) and n_slots is not None \
        and n_slots >= cfg.window
    steps = _steps(step, b, n_slots, rolling)
    if steps.ndim == 1:
        if seq_axes and n_local:
            raise ValueError("per-row decode positions need a KV cache "
                             "whose sequence is not split over the mesh")
        positions = torch.tensor(steps, dtype=torch.long, device=dev)[:, None]
        slot = positions[:, 0] % n_slots if n_slots else None
    else:
        positions = torch.full((b, 1), int(steps), dtype=torch.long,
                               device=dev)
        slot = int(steps) % n_slots if n_slots else None
    kv_len = (torch.clamp(positions[:, 0] + 1, max=n_slots).to(torch.int32)
              if n_slots else None)
    if seq_axes and n_local:
        index, _ = shd.block(mesh, seq_axes)
        owner, local = divmod(slot, n_local)

        def insert(kc, vc, k, v):
            if owner == index:
                return cache_insert(kc, vc, k, v, local)
            return kc, vc

        def core(q, kc, vc):
            return split_kv_attention(q, kc, vc, int(steps), cfg, mesh,
                                      seq_axes)
    else:
        def insert(kc, vc, k, v):
            return cache_insert(kc, vc, k, v, slot)

        def core(q, kc, vc):
            return decode_attn_core(q, kc, vc, kv_len, cfg)
    tokens = torch.as_tensor(tokens).to(dev)
    batch_axes = tuple(a for a in BATCH_AXES if batch_shardable
                       and mesh is not None and a in mesh.axis_names
                       and mesh.shape[a] > 1)
    x = embed_tokens(params, tokens, cfg, cd, mesh=mesh,
                     spec=specs["embed"] if specs else (),
                     batch_axes=batch_axes)
    memory = caches.get("memory")
    if not cfg.use_rope and cfg.enc_layers > 0:
        x = x + sinusoidal_at(positions, cfg.d_model).to(cd)
    x = run_blocks_decode(params["blocks"], caches, x, positions, insert,
                          core, cfg, memory,
                          specs["blocks"] if specs else None, mesh,
                          batch_axes)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", x.to(cd),
                          _weight(params, "lm_head", cd, specs, mesh))
    logits = coll.all_gather(logits, mesh, _axes(specs, "lm_head", 1), 2)
    return logits.float(), caches


# ================================================================ mesh

def _on_one_device(mesh) -> bool:
    return mesh is None or all(n == 1 for n in mesh.dims)


def _bspec(mesh):
    """The batch axes of more than one rank, as a spec entry."""
    bs = tuple(a for a in BATCH_AXES if a in mesh.axis_names
               and mesh.shape[a] > 1)
    return bs if len(bs) > 1 else (bs[0] if bs else None)


def _seq_axes(mesh, batch_shardable):
    """Mesh axes available to shard the KV-cache sequence dim."""
    axes = []
    for a in mesh.axis_names:
        if mesh.shape[a] <= 1:
            continue
        if a == "model":
            axes.append(a)
        elif a in BATCH_AXES and not batch_shardable:
            axes.append(a)
    return tuple(axes)


def kv_cache_spec(mesh, batch_shardable: bool) -> tuple:
    """The spec of a (B, S, KVH, hd) KV cache: the batch over the batch
    axes when it shards, the sequence over ``_seq_axes``."""
    bspec = _bspec(mesh) if batch_shardable else None
    seq = _seq_axes(mesh, batch_shardable)
    seq = seq if len(seq) > 1 else (seq[0] if seq else None)
    return (bspec, seq, None, None)


def cache_specs(cfg, batch, seq_len, mesh, batch_shardable):
    """The spec of every leaf of ``init_caches``' tree."""
    kvspec = kv_cache_spec(mesh, batch_shardable)
    bspec = _bspec(mesh) if batch_shardable else None

    def model_ok(n):
        return "model" if (mesh.shape["model"] > 1
                           and n % mesh.shape["model"] == 0) else None
    sub = {}
    for i, (m, _) in enumerate(cfg.pattern):
        if m == "attn":
            sp = (None, *kvspec)
            sub[f"sub{i}"] = {"k": sp, "v": sp}
        else:
            _, h, _, _, _ = ssm_mod.ssm_dims(cfg)
            sub[f"sub{i}"] = {"conv": (None, bspec, None, None),
                              "state": (None, bspec, model_ok(h), None,
                                        None)}
    specs = {"layers": sub}
    if cfg.enc_layers > 0:
        specs["memory"] = (bspec, None, None)
    return specs


def split_kv_attention(q, kc, vc, step, cfg, mesh, seq_axes):
    """Split-KV decode attention on this rank's sequence block of the
    cache: the flash-decode kernel over the block's valid prefix
    (``clip(min(step + 1, window or inf) - base, 0, s_local)``, ``base``
    the block's first global slot), its ``(out, m, l)`` turned into
    ``acc = out * l`` and merged over ``seq_axes`` by ``softmax_combine``
    with ``cfg.collective_schedule``; ``out = acc / max(l, 1e-30)``.  q
    (B, 1, H, hd) -> (B, 1, H, hd) in q's dtype, the same on every rank
    of the sequence axes.  A block with no valid key gives m -1e30 and l
    0, which the merge scales to nothing.

    The kernel returns ``out`` in float32 (at least; the tensor-core
    variant writes it so for bf16 q on a bf16 cache): a bf16 ``out`` would
    be rounded once per block and again after the merge, where the
    one-device path rounds once.  The merge is the profiler range
    ``softmax_combine``."""
    index, _ = shd.block(mesh, seq_axes)
    s_local = kc.shape[1]
    limit = min(step + 1, cfg.window) if cfg.window else step + 1
    n_valid = max(0, min(limit - index * s_local, s_local))
    kv_len = torch.full((q.shape[0],), n_valid, dtype=torch.int32,
                        device=q.device)
    dtype, wide = q.dtype, torch.promote_types(q.dtype, torch.float32)
    if q.dtype != kc.dtype:
        q = q.to(wide)              # the FMA variant: its out is q's dtype
    out, m, l = ops.flash_decode(q[:, 0].contiguous(), kc.contiguous(),
                                 vc.contiguous(), kv_len, wide)
    acc = out * l[..., None]
    with torch.profiler.record_function("softmax_combine"):
        m, l, acc = coll.softmax_combine((m, l, acc), mesh, seq_axes,
                                         schedule=cfg.collective_schedule)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(dtype)[:, None]


def _gather_heads(parts, axes, mesh):
    """Each (B, 1, n_i, hd) block of ``parts`` whole along its heads, the
    blocks all-gathered over their axes: one collective for all of them
    where they share the axes (q, k and v under every plan that splits
    both), one each otherwise."""
    if len(set(axes)) > 1 or not _split(mesh, axes[0]):
        return tuple(coll.all_gather(t, mesh, ax, 2)
                     for t, ax in zip(parts, axes))
    sizes = [t.shape[2] for t in parts]
    whole = coll.all_gather(torch.cat(parts, 2), mesh, axes[0], 2)
    b, s, _, d = whole.shape
    blocks = whole.view(b, s, -1, sum(sizes), d).split(sizes, 3)
    return tuple(t.reshape(b, s, -1, d) for t in blocks)


def _split(mesh, axes) -> bool:
    return mesh is not None and any(mesh.shape[a] > 1 for a in axes)


# ================================================================ forward

def train_specs(cfg, mesh):
    """The spec of every parameter leaf of the train and prefill steps on
    ``mesh``: ``DEFAULT_RULES`` (FSDP over the batch axes; heads, the MLP
    and the vocabulary over ``model``), the plan the reference's
    ``lowering_spec`` gives them; None off a mesh."""
    if mesh is None:
        return None
    return param_specs(model_defs(cfg), shd.ShardingPlan(mesh))


def _batch_axes(mesh) -> tuple:
    """The batch axes of more than one rank: those that split the rows of
    a train or prefill batch."""
    if mesh is None:
        return ()
    return tuple(a for a in BATCH_AXES if a in mesh.axis_names
                 and mesh.shape[a] > 1)


def attn_core(q, k, v, cfg, *, causal, window, sp=None, mesh=None):
    """Train/prefill attention core: ``attention.attention``, whose CUDA
    path is the hand-written flash-attention kernel, in the four branches
    of the reference's ``attn_core`` on a ``model`` axis of m ranks
    (``sp`` the specs of this rank's blocks, which say what the plan
    split):

    - m = 1: the plain call;
    - heads split, kv heads split (KV % m == 0): the kernel on the rank's
      H/m q heads and KV/m kv heads;
    - heads split, kv heads whole (m % KV == 0, rep % h_l == 0): the rank
      slices the one kv head its h_l q heads read, ``(index * h_l) //
      rep``; with any other split the rank's q heads are gathered, the
      whole attention runs on every rank and each keeps its heads;
    - heads whole: the sequence-parallel fallback where m divides S (each
      rank's S/m query rows at ``q_offset = index * S / m`` against the
      whole K/V, the outputs all-gathered over ``model``), else the
      replicated call.

    Returns this rank's heads of the output where the plan splits ``wo``
    over them, all heads otherwise.  Every tensor the ``model`` ranks hold
    alike enters the rank's own part through ``grad_psum``."""
    m = mesh.shape.get("model", 1) if mesh is not None else 1
    if m == 1:
        return attn.attention(q, k, v, causal=causal, window=window)
    model = ("model",)
    index = mesh.axis_index("model")
    if not _split(mesh, _axes(sp, "wq", 1)):
        s = q.shape[1]
        if s % m:
            return attn.attention(q, k, v, causal=causal, window=window)
        n = s // m
        q, k, v = coll.grad_psum((q, k, v), mesh, model)
        o = attn.attention(q.narrow(1, index * n, n), k, v, causal=causal,
                           window=window, q_offset=index * n)
        return coll.all_gather(o, mesh, model, 1, replicated=True)
    if _split(mesh, _axes(sp, "wk", 1)):
        return attn.attention(q, k, v, causal=causal, window=window)
    h_l, rep = cfg.n_heads // m, cfg.n_heads // cfg.n_kv_heads
    if m % cfg.n_kv_heads == 0 and rep % h_l == 0:
        start = (index * h_l) // rep
        k, v = coll.grad_psum((k, v), mesh, model)
        return attn.attention(q, k.narrow(2, start, 1), v.narrow(2, start, 1),
                              causal=causal, window=window)
    q = coll.all_gather(q, mesh, model, 2, replicated=True)
    o = attn.attention(q, k, v, causal=causal, window=window)
    return coll.grad_psum(o, mesh, model).narrow(2, index * h_l, h_l)


def _out_proj(x, o, p, name, cd, sp, mesh):
    """``x + o @ p[name]`` over heads; where the plan splits the heads, a
    product over the rank's heads whose partial sums are all-reduced in
    float32 (``wide_mm``) and rounded to the compute dtype once."""
    w, axes = _weight(p, name, cd, sp, mesh), _axes(sp, name, 0)
    if not _split(mesh, axes):
        return x + torch.einsum("bshk,hkd->bsd", o.to(cd), w)
    part = wide_mm(o.to(cd).flatten(2), w.flatten(0, 1))
    with torch.profiler.record_function("model_psum"):
        part = coll.psum(part, mesh, axes)
    return x + part.to(cd)


def attn_apply(p, x, cfg, positions, *, causal=True, window=0,
               memory=None, sp=None, mesh=None):
    """The self-attention sublayer over a whole sequence, then the
    cross-attention over ``memory`` (bidirectional) when given.  On a mesh
    ``p`` holds this rank's blocks and ``sp`` their specs (``attn_core``
    for both, the cross-attention's branch chosen by ``xwq`` / ``xwk``;
    ``wo``'s and ``xwo``'s partial sums all-reduced over the heads'
    axes)."""
    cd = getattr(torch, cfg.compute_dtype)
    h = rms_norm(x, p["norm"], cfg.norm_eps).to(cd)
    q, k, v = _project_qkv(p, h, cfg, cd, sp=sp, mesh=mesh)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = attn_core(q, k, v, cfg, causal=causal, window=window, sp=sp,
                  mesh=mesh)
    x = _out_proj(x, o, p, "wo", cd, sp, mesh)
    if memory is not None:
        xsp = sp and {"wq": sp["xwq"], "wk": sp["xwk"]}
        x = _cross(p, x, memory, cfg, cd,
                   lambda qx, kx, vx: attn_core(qx, kx, vx, cfg,
                                                causal=False, window=0,
                                                sp=xsp, mesh=mesh),
                   sp, mesh)
    return x


def sublayer_apply(sub, x, mixer, ffn, cfg, positions, *, causal=True,
                   memory=None, sp=None, mesh=None):
    """One (mixer, ffn) sublayer: attention or Mamba-2, then an MLP, a
    MoE or nothing.  Returns ``(x, aux)``.  On a mesh ``sp`` holds the
    specs of this rank's blocks of ``sub`` and x's rows are split over
    the batch axes."""
    sp = sp or {}
    if mixer == "attn":
        x = attn_apply(sub["mixer"], x, cfg, positions, causal=causal,
                       window=cfg.window, memory=memory,
                       sp=sp.get("mixer"), mesh=mesh)
    else:
        hm = rms_norm(x, sub["mixer"]["norm"], cfg.norm_eps)
        msp = sp.get("mixer")
        y, _ = ssm_mod.ssm_apply(_mixer_params(sub["mixer"]), hm, cfg,
                                 sp=_mixer_params(msp) if msp else None,
                                 mesh=mesh)
        x = x + y
    return ffn_apply(sub.get("ffn"), x, ffn, cfg, sp=sp.get("ffn"),
                     mesh=mesh, batch_axes=_batch_axes(mesh))


def block_layers(blocks):
    """One parameter tree per block: views ``a[i]`` of the stacked tree,
    or ``blocks`` itself where it is already a list of per-block trees,
    which only the train step makes (``launch/steps.grad_leaves``)."""
    if isinstance(blocks, list):
        return blocks
    n = next(tree_leaves(blocks))[1].shape[0]
    return [tree_map(lambda a: a[i], blocks) for i in range(n)]


def _block(bp, x, cfg, positions, causal, pattern, memory, sp, mesh):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j, (mixer, ffn) in enumerate(pattern):
        x, a = sublayer_apply(bp[f"sub{j}"], x, mixer, ffn, cfg, positions,
                              causal=causal, memory=memory,
                              sp=sp.get(f"sub{j}"), mesh=mesh)
        aux = aux + a
    return x, aux


def run_blocks(blocks, x, cfg, positions, *, pattern=None, causal=True,
               memory=None, specs=None, mesh=None):
    """The stacked blocks over a whole sequence (``pattern`` the
    sublayers of a block, ``cfg.pattern`` by default), a Python loop in
    place of the reference's scan.  Returns ``(x, aux)``, aux a float32
    scalar tensor: the router loss summed over the MoE sublayers (0
    without), out of each block's checkpoint where it is rematerialised.
    On a mesh ``specs`` are those of this rank's (stacked) blocks.

    Where gradients are kept and ``cfg.remat != "none"``, each block runs
    under ``torch.utils.checkpoint`` (non-reentrant), the reference's
    ``_remat``: only its input is kept, and its forward (the kernel of
    its mixer included) runs again in the backward.  On a mesh that
    recompute issues the block's forward collectives again inside the
    backward; every rank runs the same graph, so each rank's sequence of
    collectives stays the same (no collective is in a branch that
    depends on the rank).  Granite's ``"dots"`` policy, which would keep
    the outputs of the block's products, is taken as a whole-block
    checkpoint too: at 2 x 4096 tokens those bf16 outputs (q, k, v, the
    output projection, the MLP's three) hold 0.39 GB a layer, 15.5 GB
    over 40 layers beside a 42 GB train state, and recomputing them costs
    one more forward of the block's products.  Neither choice changes a
    number.
    """
    pattern = cfg.pattern if pattern is None else pattern
    remat = cfg.remat != "none" and torch.is_grad_enabled()
    layer_specs = tree_map(lambda sp: sp[1:], specs) if specs else {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for bp in block_layers(blocks):
        args = (bp, x, cfg, positions, causal, pattern, memory, layer_specs,
                mesh)
        if remat:
            x, a = checkpoint(_block, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = _block(*args)
        aux = aux + a
    return x, aux


def build_inputs(params, batch, cfg, *, specs=None, mesh=None):
    """The decoder input sequence: the embedded ``batch["tokens"]`` (B,
    S), after the vision prefix ``batch["vision_embed"] @ vis_proj`` (B,
    P, D) where the model has one, plus sinusoidal positions for an
    encoder-decoder.  On a mesh the tokens and the prefix are this rank's
    rows (split over the batch axes), the table the rank's block and
    ``vis_proj`` gathered whole over its FSDP dim."""
    cd = getattr(torch, cfg.compute_dtype)
    x = embed_tokens(params, batch["tokens"], cfg, cd, mesh=mesh,
                     spec=specs["embed"] if specs else (),
                     batch_axes=_batch_axes(mesh))
    if cfg.vision_prefix > 0:
        vis = batch["vision_embed"].to(cd) @ _weight(params, "vis_proj", cd,
                                                     specs, mesh)
        x = torch.cat([vis, x], dim=1)
    if not cfg.use_rope and cfg.enc_layers > 0:
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                     device=x.device).to(cd)[None]
    return x


def encode(params, batch, cfg, *, specs=None, mesh=None):
    """The encoder of an encoder-decoder over ``batch["frames"]`` (B, F,
    D), the precomputed frame embeddings of the audio stub:
    bidirectional attention blocks, then ``enc_norm``.  On a mesh the
    frames and the memory are this rank's rows, whole over their length
    and alike on every ``model`` rank; ``enc_in`` is gathered whole over
    its FSDP dim and the blocks run on the rank's blocks (``specs`` those
    of the whole tree), their attention through ``attn_core``'s branches
    with ``causal=False``."""
    cd = getattr(torch, cfg.compute_dtype)
    x = batch["frames"].to(cd) @ _weight(params, "enc_in", cd, specs, mesh)
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                 device=x.device).to(cd)[None]
    pos = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    x, _ = run_blocks(params["enc_blocks"], x, cfg, pos,
                      pattern=(("attn", "mlp"),), causal=False,
                      specs=specs["enc_blocks"] if specs else None, mesh=mesh)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


#: the batch entries the forward reads
BATCH_INPUTS = ("tokens", "vision_embed", "frames")


def _forward_device(mesh, device):
    """The mesh's rank's device on a mesh, else ``device``."""
    return resolve_device(device) if mesh is None else mesh.device


def forward_hidden(params, batch, cfg, *, mesh=None, device="cuda"):
    """Forward up to the final norm: ``(hidden (B, S, D) in the compute
    dtype, aux)``, the vision prefix's positions cut off.  ``params`` is
    ``Model.params`` on ``device``; ``batch["tokens"]`` (B, S) integers,
    with ``vision_embed`` (B, vision_prefix, D) for a VLM and ``frames``
    (B, F, D) for an encoder-decoder, arrays or tensors.
    Gradients are kept unless the caller runs it under
    ``torch.no_grad()``.

    On a ``mesh`` (``launch/mesh.Mesh``) it runs SPMD on the rank's
    device (``mesh.device``): ``params`` are this rank's blocks under
    ``train_specs`` (``blocks.shard_params``), the batch and the hidden
    states the rank's rows (split over the batch axes), whole over the
    sequence and ``d_model``.  Dims of a weight split over the batch axes
    are all-gathered before use (their gradient reduce-scattered);
    products over weights split over ``model`` keep their outputs split
    (q, k, v over heads, the MLP's inner dim) and all-reduce the partial
    sums of the products that contract them (``wo``, the MLP's down
    projection); attention runs ``attn_core``'s branch for the split, a
    MoE sublayer its expert-parallel dispatch, a Mamba-2 one its scan on
    the rank's heads.  A (1, 1) mesh is the one-device path: every
    collective is on an axis of one rank."""
    dev = _forward_device(mesh, device)
    _check_on(dev, params, "forward")
    specs = train_specs(cfg, mesh)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()
             if k in BATCH_INPUTS}
    x = build_inputs(params, batch, cfg, specs=specs, mesh=mesh)
    memory = (encode(params, batch, cfg, specs=specs, mesh=mesh)
              if cfg.enc_layers > 0 else None)
    pos = torch.arange(x.shape[1], device=dev).expand(x.shape[:2])
    x, aux = run_blocks(params["blocks"], x, cfg, pos, causal=True,
                        memory=memory,
                        specs=specs["blocks"] if specs else None, mesh=mesh)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x[:, cfg.vision_prefix:], aux


@torch.no_grad()
def forward(params, batch, cfg, *, mesh=None, device="cuda"):
    """Teacher-forced forward: ``(logits (B, S, V) f32, aux)``; on a
    ``mesh`` the rank's rows, whole over the vocabulary (all-gathered
    over the axes that split ``lm_head``)."""
    x, aux = forward_hidden(params, batch, cfg, mesh=mesh, device=device)
    cd = getattr(torch, cfg.compute_dtype)
    specs = train_specs(cfg, mesh)
    logits = torch.einsum("bsd,dv->bsv", x.to(cd),
                          _weight(params, "lm_head", cd, specs, mesh))
    logits = coll.all_gather(logits, mesh, _axes(specs, "lm_head", 1), 2)
    return logits.float(), aux


# ================================================================ loss

def _xent_chunk(x, w, targets, mask):
    """Summed masked NLL of one chunk: its logits live only here, in the
    mask's dtype (float32, float64 for a float64 compute dtype)."""
    logits = torch.einsum("bcd,dv->bcv", x.to(w.dtype), w).to(mask.dtype)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return ((torch.logsumexp(logits, dim=-1) - gold) * mask).sum()


def _xent_chunk_split(x, w, targets, mask, mesh, axes, base):
    """``_xent_chunk`` where ``w`` is this rank's block of the vocabulary
    (columns ``base ..``) over ``axes``: the logsumexp assembled across
    the blocks (a ``pmax`` of the row maxima, no gradient, and a ``psum``
    of the exponential sums) and the gold logit from the block that holds
    it, ``psum``med."""
    logits = torch.einsum("bcd,dv->bcv", x.to(w.dtype), w).to(mask.dtype)
    top = coll.pmax(logits.amax(-1), mesh, axes)
    total = coll.psum(torch.exp(logits - top[..., None]).sum(-1), mesh, axes)
    n = logits.shape[-1]
    loc = targets - base
    mine = (loc >= 0) & (loc < n)
    gold = torch.gather(logits, -1, torch.clamp(loc, 0, n - 1)[..., None])
    gold = coll.psum(torch.where(mine, gold[..., 0], 0), mesh, axes)
    return ((torch.log(total) + top - gold) * mask).sum()


def _mask_total(mask, mesh, axes):
    """The loss's denominator: the mask's weight over the whole batch
    (summed over the batch axes)."""
    return coll.psum(mask.sum(), mesh, axes)


def chunked_xent(x, lm_head, targets, mask, cfg, *, spec=None, mesh=None):
    """Cross-entropy without a (B, S, V) logits tensor (the reference's
    ``chunked_xent``): the sequence goes in chunks of ``cfg.xent_chunk``
    tokens (all of it where that does not divide S), each chunk's logits
    made, reduced and, where gradients are kept, made again in the
    backward under a checkpoint, so that at most one chunk's (B, chunk,
    V) logits exist.  The gold logit is gathered (the reference reduces
    a one-hot product, which gives the same number).  Returns the mean
    NLL over the mask's weight (at least 1).

    On a ``mesh`` (``spec`` that of this rank's block of ``lm_head``)
    the rows are the rank's: the summed NLL and the mask's weight are
    both summed over the batch axes, so the loss is that of the whole
    batch.  Where ``lm_head``'s vocabulary splits over ``model`` each
    rank makes its block of a chunk's logits (``_xent_chunk_split``)."""
    cd = getattr(torch, cfg.compute_dtype)
    s = x.shape[1]
    chunk = min(cfg.xent_chunk, s)
    if s % chunk != 0:
        chunk = s
    acc = torch.promote_types(cd, torch.float32)
    mask = torch.ones(targets.shape, dtype=acc,
                      device=x.device) if mask is None else mask.to(acc)
    targets = targets.long()
    w = lm_head.to(cd)
    fn = _xent_chunk
    if spec:
        w = shd.fsdp_whole(w, spec, mesh)
        vocab = shd.entry_axes(spec, 1)
        if _split(mesh, vocab):
            x = coll.grad_psum(x, mesh, vocab)
            index, _ = shd.block(mesh, vocab)

            def fn(*part):
                return _xent_chunk_split(*part, mesh, vocab,
                                         index * w.shape[1])
    remat = torch.is_grad_enabled()
    nll = torch.zeros((), dtype=acc, device=x.device)
    for c0 in range(0, s, chunk):
        part = (x[:, c0:c0 + chunk], w, targets[:, c0:c0 + chunk],
                mask[:, c0:c0 + chunk])
        nll = nll + (checkpoint(fn, *part, use_reentrant=False,
                                preserve_rng_state=False) if remat
                     else fn(*part))
    rows = _batch_axes(mesh)
    return coll.psum(nll, mesh, rows) / torch.clamp(
        _mask_total(mask, mesh, rows), min=1.0)


def loss_fn(params, batch, cfg, *, mesh=None, device="cuda"):
    """``(total, metrics)``: the next-token loss of ``batch`` (``tokens``,
    ``targets``, optional ``loss_mask``, with ``vision_embed`` or
    ``frames`` where the model takes them; arrays or tensors) plus
    ``router_aux_coef`` times the MoE router loss, summed over the MoE
    sublayers and not divided by their number, as the reference's
    ``run_blocks`` sums it (0 without MoE); metrics ``loss``,
    ``aux_loss`` and ``perplexity = exp(min(loss, 20))``, detached.
    ``total`` carries the graph.  On a ``mesh`` (``forward_hidden``)
    the batch is this rank's rows and the loss that of the whole batch,
    the same on every rank; its gradient on each rank is the part of the
    rank's rows (``launch/steps.make_train_step`` sums the parts)."""
    dev = _forward_device(mesh, device)
    x, aux = forward_hidden(params, batch, cfg, mesh=mesh, device=dev)
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = torch.as_tensor(mask).to(dev)
    specs = train_specs(cfg, mesh)
    loss = chunked_xent(x, params["lm_head"],
                        torch.as_tensor(batch["targets"]).to(dev), mask, cfg,
                        spec=specs["lm_head"] if specs else None, mesh=mesh)
    total = loss + cfg.router_aux_coef * aux
    loss = loss.detach()
    return total, {"loss": loss, "aux_loss": aux.detach(),
                   "perplexity": torch.exp(torch.clamp(loss, max=20.0))}
