"""The LM: its decode path, its forward (prefill) and its loss.

The port of the reference package's ``models/model.py`` on one device:
parameter definitions for every architecture (so parameter counts agree
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
position to the batch: queue 3).  The multi-device
split-KV branches (``softmax_combine``) are not ported: the port serves on
one card.
"""
from __future__ import annotations

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
from repro_torch.models.blocks import (ParamDef, init_params, mlp_defs,
                                       rms_norm, rope, sinusoidal_at,
                                       sinusoidal_positions, stack_defs,
                                       swiglu, tree_leaves, tree_map,
                                       unflatten)

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

def _project_qkv(p, x, cfg, cd, prefix=""):
    """q, k, v of ``x`` through ``wq``/``wk``/``wv`` (``xwq``... with
    prefix "x", the cross-attention's, which have no bias)."""
    q = torch.einsum("bsd,dhk->bshk", x, p[prefix + "wq"].to(cd))
    k = torch.einsum("bsd,dhk->bshk", x, p[prefix + "wk"].to(cd))
    v = torch.einsum("bsd,dhk->bshk", x, p[prefix + "wv"].to(cd))
    if cfg.qkv_bias and prefix == "":
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    return q, k, v


def cache_len(cfg, seq_len):
    return min(seq_len, cfg.window) if cfg.window else seq_len


def init_caches(cfg, batch, seq_len, *, dtype=torch.bfloat16, device="cuda"):
    """Per-layer decode caches stacked over n_blocks, zero-filled, the
    reference's tree: ``{"layers": {"sub<i>": ...}}`` with ``k``, ``v``
    (n_blocks, B, cache_len, KVH, hd) for an attention sublayer and
    ``conv`` (n_blocks, B, K - 1, d_in + 2N), ``state`` (n_blocks, B, H,
    N, P) float32 for a Mamba-2 one; plus ``memory`` (B, max(seq_len //
    audio_stride, 8), d_model) for an encoder-decoder (the encoder's
    output, zero until a caller fills it).  Every leaf but the state is
    in ``dtype``, bf16 by default as in the reference."""
    dev = resolve_device(device)

    def zeros(shape, leaf_dtype=dtype):
        return torch.zeros(shape, dtype=leaf_dtype, device=dev)
    sub = {}
    for i, (mixer, _) in enumerate(cfg.pattern):
        if mixer == "attn":
            shape = (cfg.n_blocks, batch, cache_len(cfg, seq_len),
                     cfg.n_kv_heads, cfg.hd)
            sub[f"sub{i}"] = {"k": zeros(shape), "v": zeros(shape)}
        else:
            d_in, h, p, n, k = ssm_mod.ssm_dims(cfg)
            sub[f"sub{i}"] = {
                "conv": zeros((cfg.n_blocks, batch, k - 1, d_in + 2 * n)),
                "state": zeros((cfg.n_blocks, batch, h, n, p),
                               torch.float32)}
    caches = {"layers": sub}
    if cfg.enc_layers > 0:
        enc_len = max(seq_len // max(cfg.audio_stride, 1), 8)
        caches["memory"] = zeros((batch, enc_len, cfg.d_model))
    return caches


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


def _cross(p, x, memory, cfg, cd, core):
    """The cross-attention of an encoder-decoder's sublayer: q from x
    through ``xnorm``/``xwq``, k and v from the encoder memory, ``core``
    the attention itself."""
    hx = rms_norm(x, p["xnorm"], cfg.norm_eps).to(cd)
    qx = torch.einsum("bsd,dhk->bshk", hx, p["xwq"].to(cd))
    mem = memory.to(cd)
    kx = torch.einsum("bsd,dhk->bshk", mem, p["xwk"].to(cd))
    vx = torch.einsum("bsd,dhk->bshk", mem, p["xwv"].to(cd))
    ox = core(qx, kx, vx)
    return x + torch.einsum("bshk,hkd->bsd", ox.to(cd), p["xwo"].to(cd))


def attn_decode_apply(p, x, cache, slot, positions, kv_len, cfg,
                      memory=None):
    """The attention sublayer of one decode step (self-attention, then
    cross-attention over ``memory`` when given); updates ``cache``."""
    cd = getattr(torch, cfg.compute_dtype)
    h = rms_norm(x, p["norm"], cfg.norm_eps).to(cd)
    q, k, v = _project_qkv(p, h, cfg, cd)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    kc, vc = cache_insert(cache["k"], cache["v"], k, v, slot)
    o = decode_attn_core(q, kc, vc, kv_len, cfg)
    x = x + torch.einsum("bshk,hkd->bsd", o.to(cd), p["wo"].to(cd))
    if memory is not None:
        x = _cross(p, x, memory, cfg, cd, attn.cross_attention)
    return x


def ffn_apply(p, x, kind, cfg, decode=False):
    """The ffn sublayer: an MLP, a MoE (``models/moe.py``; its decode
    path when ``decode``) or nothing (``kind`` None).  Returns ``(x,
    aux)``, aux the MoE router loss (0.0 otherwise)."""
    if kind is None:
        return x, 0.0
    cd = getattr(torch, cfg.compute_dtype)
    h = rms_norm(x, p["norm"], cfg.norm_eps).to(cd)
    if kind == "mlp":
        return x + swiglu(h, p["wi"], p["wg"], p["wo"], cd), 0.0
    y, aux = moe_mod.moe_apply(p, h, cfg, decode=decode)
    return x + y, aux


def _mixer_params(p):
    return {k: v for k, v in p.items() if k != "norm"}


def run_blocks_decode(blocks, caches, x, slot, positions, kv_len, cfg,
                      memory=None):
    """One decode step through the stacked blocks, a Python loop in place
    of the reference's scan; the caches are updated in place."""
    for i, bp in enumerate(block_layers(blocks)):
        for j, (mixer, ffn) in enumerate(cfg.pattern):
            sub = bp[f"sub{j}"]
            layer = caches["layers"][f"sub{j}"]
            cache = {name: t[i] for name, t in layer.items()}
            if mixer == "attn":
                x = attn_decode_apply(sub["mixer"], x, cache, slot,
                                      positions, kv_len, cfg, memory)
            else:
                hm = rms_norm(x, sub["mixer"]["norm"], cfg.norm_eps)
                y, new = ssm_mod.ssm_decode_step(_mixer_params(sub["mixer"]),
                                                 hm, cache, cfg)
                for name, t in new.items():
                    cache[name].copy_(t)
                x = x + y
            x, _ = ffn_apply(sub.get("ffn"), x, ffn, cfg, decode=True)
    return x


def embed_tokens(params, tokens, cfg, cd):
    """Token embedding lookup (the reference's gather branch)."""
    return params["embed"][tokens].to(cd)


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


@torch.no_grad()
def decode_forward(params, caches, tokens, step, cfg, *, device="cuda"):
    """Single-token serve forward: (B, 1) tokens -> (B, 1, V) f32 logits.

    ``params`` is ``Model.params``; ``caches`` comes from
    ``init_caches`` and is updated IN PLACE (returned as well, as the
    reference returns its new caches).  ``step`` is the host-side
    position: an int for every row, or a (B,) array of per-row positions
    (continuous batching).  A position must lie in a linear KV cache; a
    rolling buffer (sliding window) and a model without attention take
    any position.  Everything runs on ``device``, where the parameters
    and caches must be.
    """
    dev = resolve_device(device)
    _check_on(dev, {"params": params, "caches": caches}, "decode_forward")
    cd = getattr(torch, cfg.compute_dtype)
    steps = np.asarray(step.cpu() if torch.is_tensor(step) else step)
    b = tokens.shape[0]
    if steps.ndim not in (0, 1) or (steps.ndim == 1 and steps.shape != (b,)):
        raise ValueError(f"step must be a scalar or ({b},), got "
                         f"{steps.shape}")
    n_slots, rolling = _kv_slots(cfg, caches)
    if (steps < 0).any() or (n_slots is not None and not rolling
                             and (steps >= n_slots).any()):
        raise IndexError(f"decode positions {steps} outside the "
                         f"{n_slots}-slot cache")
    if steps.ndim == 1:
        positions = torch.tensor(steps, dtype=torch.long, device=dev)[:, None]
        slot = positions[:, 0] % n_slots if n_slots else None
    else:
        positions = torch.full((b, 1), int(steps), dtype=torch.long,
                               device=dev)
        slot = int(steps) % n_slots if n_slots else None
    kv_len = (torch.clamp(positions[:, 0] + 1, max=n_slots).to(torch.int32)
              if n_slots else None)
    tokens = torch.as_tensor(tokens).to(dev)
    x = embed_tokens(params, tokens, cfg, cd)
    memory = caches.get("memory")
    if not cfg.use_rope and cfg.enc_layers > 0:
        x = x + sinusoidal_at(positions, cfg.d_model).to(cd)
    x = run_blocks_decode(params["blocks"], caches, x, slot, positions,
                          kv_len, cfg, memory)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", x.to(cd), params["lm_head"].to(cd))
    return logits.float(), caches


# ================================================================ forward

def attn_core(q, k, v, cfg, *, causal, window):
    """Train/prefill attention core on one device (the reference's
    ``m == 1`` branch): ``attention.attention``, whose CUDA path is the
    hand-written flash-attention kernel."""
    return attn.attention(q, k, v, causal=causal, window=window)


def attn_apply(p, x, cfg, positions, *, causal=True, window=0,
               memory=None):
    """The self-attention sublayer over a whole sequence, then the
    cross-attention over ``memory`` (bidirectional) when given."""
    cd = getattr(torch, cfg.compute_dtype)
    h = rms_norm(x, p["norm"], cfg.norm_eps).to(cd)
    q, k, v = _project_qkv(p, h, cfg, cd)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = attn_core(q, k, v, cfg, causal=causal, window=window)
    x = x + torch.einsum("bshk,hkd->bsd", o.to(cd), p["wo"].to(cd))
    if memory is not None:
        x = _cross(p, x, memory, cfg, cd,
                   lambda qx, kx, vx: attn_core(qx, kx, vx, cfg,
                                                causal=False, window=0))
    return x


def sublayer_apply(sub, x, mixer, ffn, cfg, positions, *, causal=True,
                   memory=None):
    """One (mixer, ffn) sublayer: attention or Mamba-2, then an MLP, a
    MoE or nothing.  Returns ``(x, aux)``."""
    if mixer == "attn":
        x = attn_apply(sub["mixer"], x, cfg, positions, causal=causal,
                       window=cfg.window, memory=memory)
    else:
        hm = rms_norm(x, sub["mixer"]["norm"], cfg.norm_eps)
        y, _ = ssm_mod.ssm_apply(_mixer_params(sub["mixer"]), hm, cfg)
        x = x + y
    return ffn_apply(sub.get("ffn"), x, ffn, cfg)


def block_layers(blocks):
    """One parameter tree per block: views ``a[i]`` of the stacked tree,
    or ``blocks`` itself where it is already a list of per-block trees,
    which only the train step makes (``launch/steps.grad_leaves``)."""
    if isinstance(blocks, list):
        return blocks
    n = next(tree_leaves(blocks))[1].shape[0]
    return [tree_map(lambda a: a[i], blocks) for i in range(n)]


def _block(bp, x, cfg, positions, causal, pattern, memory):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j, (mixer, ffn) in enumerate(pattern):
        x, a = sublayer_apply(bp[f"sub{j}"], x, mixer, ffn, cfg, positions,
                              causal=causal, memory=memory)
        aux = aux + a
    return x, aux


def run_blocks(blocks, x, cfg, positions, *, pattern=None, causal=True,
               memory=None):
    """The stacked blocks over a whole sequence (``pattern`` the
    sublayers of a block, ``cfg.pattern`` by default), a Python loop in
    place of the reference's scan.  Returns ``(x, aux)``, aux a float32
    scalar tensor: the router loss summed over the MoE sublayers (0
    without), out of each block's checkpoint where it is rematerialised.

    Where gradients are kept and ``cfg.remat != "none"``, each block runs
    under ``torch.utils.checkpoint`` (non-reentrant), the reference's
    ``_remat``: only its input is kept, and its forward (the kernel of
    its mixer included) runs again in the backward.  Granite's ``"dots"``
    policy, which would keep the outputs of the block's products, is
    taken as a whole-block checkpoint too: at 2 x 4096 tokens those bf16
    outputs (q, k, v, the output projection, the MLP's three) hold 0.39
    GB a layer, 15.5 GB over 40 layers beside a 42 GB train state, and
    recomputing them costs one more forward of the block's products.
    Neither choice changes a number.
    """
    pattern = cfg.pattern if pattern is None else pattern
    remat = cfg.remat != "none" and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for bp in block_layers(blocks):
        args = (bp, x, cfg, positions, causal, pattern, memory)
        if remat:
            x, a = checkpoint(_block, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = _block(*args)
        aux = aux + a
    return x, aux


def build_inputs(params, batch, cfg):
    """The decoder input sequence: the embedded ``batch["tokens"]`` (B,
    S), after the vision prefix ``batch["vision_embed"] @ vis_proj`` (B,
    P, D) where the model has one, plus sinusoidal positions for an
    encoder-decoder."""
    cd = getattr(torch, cfg.compute_dtype)
    x = embed_tokens(params, batch["tokens"], cfg, cd)
    if cfg.vision_prefix > 0:
        vis = batch["vision_embed"].to(cd) @ params["vis_proj"].to(cd)
        x = torch.cat([vis, x], dim=1)
    if not cfg.use_rope and cfg.enc_layers > 0:
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                     device=x.device).to(cd)[None]
    return x


def encode(params, batch, cfg):
    """The encoder of an encoder-decoder over ``batch["frames"]`` (B, F,
    D), the precomputed frame embeddings of the audio stub:
    bidirectional attention blocks, then ``enc_norm``."""
    cd = getattr(torch, cfg.compute_dtype)
    x = batch["frames"].to(cd) @ params["enc_in"].to(cd)
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                 device=x.device).to(cd)[None]
    pos = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    x, _ = run_blocks(params["enc_blocks"], x, cfg, pos,
                      pattern=(("attn", "mlp"),), causal=False)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


#: the batch entries the forward reads
BATCH_INPUTS = ("tokens", "vision_embed", "frames")


def forward_hidden(params, batch, cfg, *, device="cuda"):
    """Forward up to the final norm: ``(hidden (B, S, D) in the compute
    dtype, aux)``, the vision prefix's positions cut off.  ``params`` is
    ``Model.params`` on ``device``; ``batch["tokens"]`` (B, S) integers,
    with ``vision_embed`` (B, vision_prefix, D) for a VLM and ``frames``
    (B, F, D) for an encoder-decoder, arrays or tensors.
    Gradients are kept unless the caller runs it under
    ``torch.no_grad()``."""
    dev = resolve_device(device)
    _check_on(dev, params, "forward")
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()
             if k in BATCH_INPUTS}
    x = build_inputs(params, batch, cfg)
    memory = encode(params, batch, cfg) if cfg.enc_layers > 0 else None
    pos = torch.arange(x.shape[1], device=dev).expand(x.shape[:2])
    x, aux = run_blocks(params["blocks"], x, cfg, pos, causal=True,
                        memory=memory)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x[:, cfg.vision_prefix:], aux


@torch.no_grad()
def forward(params, batch, cfg, *, device="cuda"):
    """Teacher-forced forward: ``(logits (B, S, V) f32, aux)``."""
    x, aux = forward_hidden(params, batch, cfg, device=device)
    cd = getattr(torch, cfg.compute_dtype)
    logits = torch.einsum("bsd,dv->bsv", x.to(cd), params["lm_head"].to(cd))
    return logits.float(), aux


# ================================================================ loss

def _xent_chunk(x, w, targets, mask):
    """Summed masked NLL of one chunk: its logits live only here, in the
    mask's dtype (float32, float64 for a float64 compute dtype)."""
    logits = torch.einsum("bcd,dv->bcv", x.to(w.dtype), w).to(mask.dtype)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return ((torch.logsumexp(logits, dim=-1) - gold) * mask).sum()


def chunked_xent(x, lm_head, targets, mask, cfg):
    """Cross-entropy without a (B, S, V) logits tensor (the reference's
    ``chunked_xent``): the sequence goes in chunks of ``cfg.xent_chunk``
    tokens (all of it where that does not divide S), each chunk's logits
    made, reduced and, where gradients are kept, made again in the
    backward under a checkpoint, so that at most one chunk's (B, chunk,
    V) logits exist.  The gold logit is gathered (the reference reduces
    a one-hot product, which gives the same number).  Returns the mean
    NLL over the mask's weight (at least 1)."""
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
    remat = torch.is_grad_enabled()
    nll = torch.zeros((), dtype=acc, device=x.device)
    for c0 in range(0, s, chunk):
        part = (x[:, c0:c0 + chunk], w, targets[:, c0:c0 + chunk],
                mask[:, c0:c0 + chunk])
        nll = nll + (checkpoint(_xent_chunk, *part, use_reentrant=False,
                                preserve_rng_state=False) if remat
                     else _xent_chunk(*part))
    return nll / torch.clamp(mask.sum(), min=1.0)


def loss_fn(params, batch, cfg, *, device="cuda"):
    """``(total, metrics)``: the next-token loss of ``batch`` (``tokens``,
    ``targets``, optional ``loss_mask``, with ``vision_embed`` or
    ``frames`` where the model takes them; arrays or tensors) plus
    ``router_aux_coef`` times the MoE router loss, summed over the MoE
    sublayers and not divided by their number, as the reference's
    ``run_blocks`` sums it (0 without MoE); metrics ``loss``,
    ``aux_loss`` and ``perplexity = exp(min(loss, 20))``, detached.
    ``total`` carries the graph."""
    dev = resolve_device(device)
    x, aux = forward_hidden(params, batch, cfg, device=dev)
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = torch.as_tensor(mask).to(dev)
    loss = chunked_xent(x, params["lm_head"],
                        torch.as_tensor(batch["targets"]).to(dev), mask, cfg)
    total = loss + cfg.router_aux_coef * aux
    loss = loss.detach()
    return total, {"loss": loss, "aux_loss": aux.detach(),
                   "perplexity": torch.exp(torch.clamp(loss, max=20.0))}
