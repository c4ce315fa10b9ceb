"""The LM: its decode path, its forward (prefill) and its loss.

The port of the reference package's ``models/model.py`` on one device:
parameter definitions for every architecture (so parameter counts agree
with the reference), the ``Model`` module holding them, the stacked KV
caches and ``decode_forward``; ``forward_hidden`` / ``forward`` over a
whole sequence; and ``chunked_xent`` / ``loss_fn``, which the train step
differentiates.  Every attention layer of a decode step runs
``models/attention.decode_attention`` (the flash-decode kernel on the
card); every attention layer of a forward runs ``attention.attention``
(the flash-attention kernel) and every Mamba-2 layer
``models/ssm.ssm_apply`` (the SSD-scan kernel), both differentiable
(``kernels/ops.py``).  Decode and prefill run under ``torch.no_grad()``
(``decode_forward``, ``forward``, ``launch/steps.make_prefill_step``);
``forward_hidden`` and the loss keep gradients when the caller does.

Parameters keep the reference's names and layouts (``wq`` is (d, h, hd),
blocks are stacked on a leading ``n_blocks`` axis), so carrying weights
across is a copy (``repro_torch.convert.params_from_reference``).  The
matrix products the reference leaves to XLA are ``torch.einsum`` here,
with the parameters cast to the compute dtype inside every product, as
the reference casts them.

``Model`` holds every configuration.  Decode runs ``attn`` mixers with
``mlp`` ffns, full attention (``window == 0``), no encoder and no vision
prefix; the forward runs ``attn`` (full or windowed) and ``mamba``
mixers with an ``mlp`` or no ffn, no encoder and no vision prefix.
Other configurations raise ``NotImplementedError`` naming the ROADMAP
item that ports them (``check_decode_supported``,
``check_forward_supported``).  The multi-device split-KV branches
(``softmax_combine``) are not ported: the port serves on one card.
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
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.blocks import (ParamDef, init_params, mlp_defs,
                                       rms_norm, rope, stack_defs, swiglu,
                                       tree_leaves, tree_map, unflatten)

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


def _moe_defs(cfg: ArchConfig):
    """The reference's ``moe.moe_defs`` (definitions only: the MoE ffn
    is a later slice)."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    return {
        "router": ParamDef((d, e), (None, None), scale=0.02),
        "we_i": ParamDef((e, d, f), ("experts", "embed", "mlp")),
        "we_g": ParamDef((e, d, f), ("experts", "embed", "mlp")),
        "we_o": ParamDef((e, f, d), ("experts", "mlp", "embed")),
    }


def _ffn_defs(cfg: ArchConfig, kind):
    d = cfg.d_model
    if kind is None:
        return {}
    norm = {"norm": ParamDef((d,), ("norm",), init="ones")}
    if kind == "mlp":
        return {**norm, **mlp_defs(d, cfg.d_ff)}
    if kind == "moe":
        return {**norm, **_moe_defs(cfg)}
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


def check_decode_supported(cfg: ArchConfig) -> None:
    """Raise for what the port's decode path does not run yet."""
    why = []
    if any(m != "attn" for m, _ in cfg.pattern):
        why.append("SSM mixers")
    if any(f != "mlp" for _, f in cfg.pattern):
        why.append("MoE or absent ffns")
    if cfg.enc_layers > 0:
        why.append("an encoder")
    if cfg.vision_prefix > 0:
        why.append("a vision prefix")
    if cfg.window > 0:
        why.append("a sliding window")
    if why:
        raise NotImplementedError(
            f"{cfg.name}: the port's decode path runs dense full-attention "
            f"models; {', '.join(why)} come with a later slice (ROADMAP "
            f"queue 1 item 2)")


def check_forward_supported(cfg: ArchConfig) -> None:
    """Raise for what the port's forward (prefill) path does not run
    yet: attention (full or windowed) and Mamba-2 mixers with an MLP or
    no ffn run; MoE ffns, encoders and vision prefixes do not."""
    why = []
    if any(f == "moe" for _, f in cfg.pattern):
        why.append("MoE ffns")
    if cfg.enc_layers > 0:
        why.append("an encoder")
    if cfg.vision_prefix > 0:
        why.append("a vision prefix")
    if why:
        raise NotImplementedError(
            f"{cfg.name}: the port's forward path does not run "
            f"{', '.join(why)} yet (ROADMAP queue 1 item 2)")


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

def _project_qkv(p, x, cfg, cd):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cd))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(cd))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(cd))
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    return q, k, v


def cache_len(cfg, seq_len):
    return min(seq_len, cfg.window) if cfg.window else seq_len


def init_caches(cfg, batch, seq_len, *, device="cuda"):
    """Per-layer decode caches stacked over n_blocks, zero-filled:
    ``{"layers": {"sub<i>": {"k": (n_blocks, B, S, KVH, hd), "v": ...}}}``
    in bf16 whatever the compute dtype (the reference's default)."""
    check_decode_supported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_blocks, batch, cache_len(cfg, seq_len), cfg.n_kv_heads,
             cfg.hd)
    return {"layers": {
        f"sub{i}": {name: torch.zeros(shape, dtype=torch.bfloat16, device=dev)
                    for name in ("k", "v")}
        for i in range(len(cfg.pattern))}}


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
    ``kv_len[b]`` slots of row b of the cache."""
    return attn.decode_attention(q, kc, vc, kv_len=kv_len, window=cfg.window)


def attn_decode_apply(p, x, cache, slot, positions, kv_len, cfg):
    """The attention sublayer of one decode step; updates ``cache``."""
    cd = getattr(torch, cfg.compute_dtype)
    h = rms_norm(x, p["norm"], cfg.norm_eps).to(cd)
    q, k, v = _project_qkv(p, h, cfg, cd)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    kc, vc = cache_insert(cache["k"], cache["v"], k, v, slot)
    o = decode_attn_core(q, kc, vc, kv_len, cfg)
    return x + torch.einsum("bshk,hkd->bsd", o.to(cd), p["wo"].to(cd))


def ffn_apply(p, x, kind, cfg):
    """The ffn sublayer: an MLP, or nothing (``kind`` None)."""
    if kind is None:
        return x
    cd = getattr(torch, cfg.compute_dtype)
    h = rms_norm(x, p["norm"], cfg.norm_eps).to(cd)
    return x + swiglu(h, p["wi"], p["wg"], p["wo"], cd)


def run_blocks_decode(blocks, caches, x, slot, positions, kv_len, cfg):
    """One decode step through the stacked blocks, a Python loop in place
    of the reference's scan; the caches are updated in place."""
    for i in range(cfg.n_blocks):
        bp = tree_map(lambda a: a[i], blocks)
        for j, (_, ffn) in enumerate(cfg.pattern):
            sub = bp[f"sub{j}"]
            cache = tree_map(lambda a: a[i], caches["layers"][f"sub{j}"])
            x = attn_decode_apply(sub["mixer"], x, cache, slot, positions,
                                  kv_len, cfg)
            x = ffn_apply(sub["ffn"], x, ffn, cfg)
    return x


def embed_tokens(params, tokens, cfg, cd):
    """Token embedding lookup (the reference's gather branch)."""
    return params["embed"][tokens].to(cd)


def _check_on(dev, tree, what):
    for name, t in tree_leaves(tree):
        if t.device != dev:
            raise ValueError(f"{what} on {dev}: {name} is on {t.device}")


@torch.no_grad()
def decode_forward(params, caches, tokens, step, cfg, *, device="cuda"):
    """Single-token serve forward: (B, 1) tokens -> (B, 1, V) f32 logits.

    ``params`` is ``Model.params``; ``caches`` comes from
    ``init_caches`` and is updated IN PLACE (returned as well, as the
    reference returns its new caches).  ``step`` is the host-side
    position: an int for every row, or a (B,) array of per-row positions
    (continuous batching); each must lie in the cache.  Everything runs
    on ``device``, where the parameters and caches must be.
    """
    dev = resolve_device(device)
    check_decode_supported(cfg)
    _check_on(dev, {"params": params, "caches": caches}, "decode_forward")
    cd = getattr(torch, cfg.compute_dtype)
    steps = np.asarray(step.cpu() if torch.is_tensor(step) else step)
    b = tokens.shape[0]
    n_slots = caches["layers"]["sub0"]["k"].shape[2]
    if steps.ndim not in (0, 1) or (steps.ndim == 1 and steps.shape != (b,)):
        raise ValueError(f"step must be a scalar or ({b},), got "
                         f"{steps.shape}")
    if not ((steps >= 0) & (steps < n_slots)).all():
        raise IndexError(f"decode positions {steps} outside the "
                         f"{n_slots}-slot cache")
    if steps.ndim == 1:
        slot = torch.tensor(steps, dtype=torch.long, device=dev)
        positions = slot[:, None]
    else:
        slot = int(steps)
        positions = torch.full((b, 1), slot, dtype=torch.long, device=dev)
    kv_len = (positions[:, 0] + 1).to(torch.int32)
    tokens = torch.as_tensor(tokens).to(dev)
    x = embed_tokens(params, tokens, cfg, cd)
    x = run_blocks_decode(params["blocks"], caches, x, slot, positions,
                          kv_len, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", x.to(cd), params["lm_head"].to(cd))
    return logits.float(), caches


# ================================================================ forward

def attn_core(q, k, v, cfg, *, causal, window):
    """Train/prefill attention core on one device (the reference's
    ``m == 1`` branch): ``attention.attention``, whose CUDA path is the
    hand-written flash-attention kernel."""
    return attn.attention(q, k, v, causal=causal, window=window)


def attn_apply(p, x, cfg, positions, *, causal=True, window=0):
    """The self-attention sublayer over a whole sequence (cross
    attention comes with the encoder-decoder)."""
    cd = getattr(torch, cfg.compute_dtype)
    h = rms_norm(x, p["norm"], cfg.norm_eps).to(cd)
    q, k, v = _project_qkv(p, h, cfg, cd)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = attn_core(q, k, v, cfg, causal=causal, window=window)
    return x + torch.einsum("bshk,hkd->bsd", o.to(cd), p["wo"].to(cd))


def sublayer_apply(sub, x, mixer, ffn, cfg, positions, *, causal=True):
    """One (mixer, ffn) sublayer: attention or Mamba-2, then an MLP or
    nothing."""
    if mixer == "attn":
        x = attn_apply(sub["mixer"], x, cfg, positions, causal=causal,
                       window=cfg.window)
    else:
        hm = rms_norm(x, sub["mixer"]["norm"], cfg.norm_eps)
        y, _ = ssm_mod.ssm_apply(
            {k: v for k, v in sub["mixer"].items() if k != "norm"}, hm, cfg)
        x = x + y
    return ffn_apply(sub.get("ffn"), x, ffn, cfg)


def block_layers(blocks, n_blocks):
    """One parameter tree per block: views ``a[i]`` of the stacked tree,
    or ``blocks`` itself where it is already a list of per-block trees,
    which only the train step makes (``launch/steps.grad_leaves``)."""
    if isinstance(blocks, list):
        return blocks
    return [tree_map(lambda a: a[i], blocks) for i in range(n_blocks)]


def _block(bp, x, cfg, positions, causal):
    for j, (mixer, ffn) in enumerate(cfg.pattern):
        x = sublayer_apply(bp[f"sub{j}"], x, mixer, ffn, cfg, positions,
                           causal=causal)
    return x


def run_blocks(blocks, x, cfg, positions, *, causal=True):
    """The stacked blocks over a whole sequence, a Python loop in place
    of the reference's scan.  Returns ``(x, aux)``; aux, the MoE router
    loss, is 0 here.

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
    remat = cfg.remat != "none" and torch.is_grad_enabled()
    for bp in block_layers(blocks, cfg.n_blocks):
        if remat:
            x = checkpoint(_block, bp, x, cfg, positions, causal,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _block(bp, x, cfg, positions, causal)
    return x, 0.0


def build_inputs(params, batch, cfg):
    """The decoder input sequence from ``batch["tokens"]`` (B, S)."""
    return embed_tokens(params, batch["tokens"],
                        cfg, getattr(torch, cfg.compute_dtype))


def forward_hidden(params, batch, cfg, *, device="cuda"):
    """Forward up to the final norm: ``(hidden (B, S, D) in the compute
    dtype, aux)``.  ``params`` is ``Model.params`` on ``device``;
    ``batch["tokens"]`` (B, S) integers.
    Gradients are kept unless the caller runs it under
    ``torch.no_grad()``."""
    dev = resolve_device(device)
    check_forward_supported(cfg)
    _check_on(dev, params, "forward")
    tokens = torch.as_tensor(batch["tokens"]).to(dev)
    x = build_inputs(params, {"tokens": tokens}, cfg)
    pos = torch.arange(x.shape[1], device=dev).expand(x.shape[:2])
    x, aux = run_blocks(params["blocks"], x, cfg, pos, causal=True)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


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
    ``targets``, optional ``loss_mask``, arrays or tensors) plus
    ``router_aux_coef`` times the MoE router loss (0 until MoE ffns are
    ported); metrics ``loss``, ``aux_loss`` and ``perplexity =
    exp(min(loss, 20))``, detached.  ``total`` carries the graph."""
    dev = resolve_device(device)
    x, aux = forward_hidden(params, batch, cfg, device=dev)
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = torch.as_tensor(mask).to(dev)
    loss = chunked_xent(x, params["lm_head"],
                        torch.as_tensor(batch["targets"]).to(dev), mask, cfg)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=dev)
    total = loss + cfg.router_aux_coef * aux
    loss = loss.detach()
    return total, {"loss": loss, "aux_loss": aux,
                   "perplexity": torch.exp(torch.clamp(loss, max=20.0))}
