"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060) block.

The port of the reference package's ``models/ssm.py``, full-sequence
half: parameter definitions, the depthwise causal convolution, the plain
chunked scan ``ssd_chunked`` (an oracle here, kept in ``kernels/ref.py``
beside the scan's backward, which recomputes it) and ``ssm_apply``,
whose scan is ``kernels/ops.ssd_scan``: the hand-written Hopper kernel
on a CUDA tensor, its plain version on a CPU tensor, differentiable on
both.  B and C are one group (G = 1) shared by every head.  The
single-token decode step (``ssm_decode_init``, ``ssm_decode_step``) is
plain PyTorch, as the reference's is jnp: a (B, H, N, P) state update a
token, which no kernel of the reference computes.  Both run on a mesh
of ranks, each on its block of the heads (``ssm_apply``,
``ssm_decode_step``): the scan needs no collective, since B and C are
whole on every rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import collectives as coll
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_chunked  # noqa: F401 (the oracle)
from repro_torch.models.blocks import ParamDef, rms_norm, silu, wide_mm
from repro_torch.parallel import sharding as shd


def ssm_dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    n_heads = d_in // cfg.ssm_headdim
    return d_in, n_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_conv


def ssm_defs(cfg):
    d = cfg.d_model
    d_in, h, p, n, k = ssm_dims(cfg)
    return {
        "wz": ParamDef((d, d_in), ("embed", "ssm_inner")),
        "wx": ParamDef((d, d_in), ("embed", "ssm_inner")),
        "wB": ParamDef((d, n), ("embed", None)),
        "wC": ParamDef((d, n), ("embed", None)),
        "wdt": ParamDef((d, h), ("embed", "ssm_heads")),
        "dt_bias": ParamDef((h,), ("ssm_heads",), init="zeros"),
        "A_log": ParamDef((h,), ("ssm_heads",), init="zeros"),
        "D": ParamDef((h,), ("ssm_heads",), init="ones"),
        "conv_x": ParamDef((k, d_in), ("conv_k", "ssm_inner"), scale=0.5),
        "conv_B": ParamDef((k, n), ("conv_k", None), scale=0.5),
        "conv_C": ParamDef((k, n), ("conv_k", None), scale=0.5),
        "gnorm": ParamDef((d_in,), ("ssm_inner",), init="ones"),
        "wo": ParamDef((d_in, d), ("ssm_inner", "embed")),
    }


def _causal_conv(x, w):
    """Depthwise causal conv: x (B, S, C), w (K, C).  Tap by tap from
    zero, in the reference's order (each bf16 product and sum rounds
    where the reference's do)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = 0
    for i in range(k):
        out = out + xp[:, i:i + x.shape[1]] * w[i]
    return out


def _head_axes(cfg, sp):
    """The mesh axes that split the heads and their channels (none off a
    mesh); a plan must split both alike."""
    if not sp:
        return ()
    axes = shd.entry_axes(sp["wx"], 1)
    if axes != shd.entry_axes(sp["wdt"], 1):
        raise ValueError(f"{cfg.name}: the plan splits the SSM channels "
                         f"over {axes}, its heads otherwise")
    return axes


#: the leaves every rank of the heads' axes holds whole (the one group's
#: B and C projections and taps)
SHARED = ("wB", "wC", "conv_B", "conv_C")


def ssm_apply(p, x, cfg, *, chunk=256, sp=None, mesh=None):
    """Full-sequence Mamba-2 block.  x (B, S, D) -> (y (B, S, D), state).

    The scan gets x in the compute dtype and gives y back in f32, as the
    reference's ``ssd_chunked`` does at this call site: ``D * x`` is
    added and the cast to the compute dtype made after it.  (A float64
    compute dtype keeps all of it in float64.)

    On a mesh ``p`` holds this rank's blocks (``sp`` their specs), as the
    reference's GSPMD places them: its heads (``wdt``, ``dt_bias``,
    ``A_log``, ``D``) and their channels (``wz``, ``wx``, ``conv_x``,
    ``gnorm``, ``wo``) over ``model``, ``SHARED`` whole, dims split over
    the batch axes gathered first (FSDP); x is the rank's rows, alike on
    every ``model`` rank.  The scan runs on the rank's heads
    (``ops.ssd_scan``) with no collective; the gated norm's sum of squares
    and ``wo``'s float32 partial sums are all-reduced (the sum rounded to
    the compute dtype once, ``wide_mm``); the state is the rank's heads.
    Under autograd x and ``SHARED`` enter through ``grad_psum``: each
    rank's gradient of them is the part of its heads."""
    cd = getattr(torch, cfg.compute_dtype)
    acc = torch.promote_types(cd, torch.float32)
    d_in, h, hp, n, k = ssm_dims(cfg)
    axes = _head_axes(cfg, sp)
    split = bool(axes) and any(mesh.shape[a] > 1 for a in axes)
    if sp:
        p = {name: shd.fsdp_whole(t, sp[name], mesh) for name, t in p.items()}
    xc = x.to(cd)
    if split:
        xc = coll.grad_psum(xc, mesh, axes)
        p = {**p, **dict(zip(SHARED, coll.grad_psum(
            tuple(p[name] for name in SHARED), mesh, axes)))}
    count = shd.block(mesh, axes)[1] if axes else 1
    d_loc, h_loc = d_in // count, h // count
    z = xc @ p["wz"].to(cd)
    xin = xc @ p["wx"].to(cd)
    B_ = xc @ p["wB"].to(cd)
    C_ = xc @ p["wC"].to(cd)
    dt_raw = xc @ p["wdt"].to(cd)
    xin = silu(_causal_conv(xin, p["conv_x"].to(cd)))
    B_ = silu(_causal_conv(B_, p["conv_B"].to(cd)))
    C_ = silu(_causal_conv(C_, p["conv_C"].to(cd)))
    dt = F.softplus(dt_raw.to(acc) + p["dt_bias"].to(acc))
    a = -torch.exp(p["A_log"].to(acc)) * dt                # (B, S, H)
    xh = xin.reshape(*xin.shape[:2], h_loc, hp)
    y, state = ops.ssd_scan(xh, dt, a, B_, C_, chunk=chunk, y_dtype=acc)
    y = y + p["D"].to(acc)[:, None] * xh.to(acc)
    y = y.reshape(*x.shape[:2], d_loc)
    if not split:
        y = rms_norm(y.to(cd) * silu(z), p["gnorm"], cfg.norm_eps)
        return y @ p["wo"].to(cd), state
    y = _gated_norm(y.to(cd) * silu(z), p["gnorm"], cfg.norm_eps, mesh, axes,
                    d_in)
    with torch.profiler.record_function("model_psum"):
        out = coll.psum(wide_mm(y, p["wo"].to(cd)), mesh, axes)
    return out.to(cd), state


def ssm_decode_init(cfg, batch, dtype=torch.float32, *, device="cuda"):
    """Zero caches of one Mamba-2 layer on ``device`` (the card unless the
    caller asks for the CPU): the last K - 1 conv inputs ``conv`` (B,
    K - 1, d_in + 2N) in ``dtype`` and the state ``state`` (B, H, N, P)
    in float32."""
    device = resolve_device(device)
    d_in, h, p, n, k = ssm_dims(cfg)
    return {"conv": torch.zeros((batch, k - 1, d_in + 2 * n), dtype=dtype,
                                device=device),
            "state": torch.zeros((batch, h, n, p), dtype=torch.float32,
                                 device=device)}


def _gated_norm(y, scale, eps, mesh, axes, width):
    """``rms_norm`` of a row whose ``width`` channels are split over
    ``axes``: the sum of squares of the rank's block all-reduced in
    float32 (at least) before the scale, so every rank divides by the
    whole row's mean square.  Each rank uses that sum on its own channels,
    so under autograd its gradient is all-reduced too (``grad_psum``)."""
    dt = y.dtype
    yf = y.to(torch.promote_types(dt, torch.float32))
    ss = coll.grad_psum(coll.psum((yf * yf).sum(-1, keepdim=True), mesh,
                                  axes), mesh, axes)
    yf = yf * torch.rsqrt(ss / width + eps)
    return (yf * scale.to(yf.dtype)).to(dt)


def ssm_decode_step(p, x, cache, cfg, *, sp=None, mesh=None):
    """Single-token step.  x (B, 1, D) -> (y (B, 1, D), new cache), the
    reference's arithmetic op by op: the conv window and its product in
    the compute dtype (the product summed over the K taps in float32 and
    rounded once, as a dot), dt, the decay and the state in float32.
    The new cache is returned as new tensors; the caller writes it back.

    On a mesh ``p`` holds this rank's blocks (``sp`` their specs): its
    block of heads (``ssm_heads``) and of their channels (``ssm_inner``:
    ``wz``, ``wx``, ``conv_x``, ``gnorm``, ``wo``), ``wB``, ``wC`` and the
    B / C taps whole, dims split over the batch axes gathered first
    (FSDP).  The state is the rank's heads; the conv cache stays whole on
    every rank, as the reference's is, so the new column of the window is
    gathered over the heads' axes before the write.  The gated norm's sum
    of squares is all-reduced over them (``_gated_norm``) and ``wo``'s
    partial sums are added in float32 by an all-reduce.  A plan must split
    the channels as it splits the heads.
    """
    cd = getattr(torch, cfg.compute_dtype)
    acc = torch.promote_types(cd, torch.float32)
    d_in, h, hp, n, k = ssm_dims(cfg)
    axes = _head_axes(cfg, sp)
    if sp:
        p = {name: shd.fsdp_whole(t, sp[name], mesh) for name, t in p.items()}
    index, count = shd.block(mesh, axes) if axes else (0, 1)
    d_loc, h_loc = d_in // count, h // count
    if cache["state"].shape[1] != h_loc:
        raise ValueError(f"a state of {cache['state'].shape[1]} heads, the "
                         f"rank's weights hold {h_loc}")
    xt = x[:, 0].to(cd)                                   # (B, D)
    z = xt @ p["wz"].to(cd)
    xin = xt @ p["wx"].to(cd)
    bc = torch.cat([xt @ p["wB"].to(cd), xt @ p["wC"].to(cd)], dim=-1)
    xbc = torch.cat([coll.all_gather(xin, mesh, axes, 1), bc],
                    dim=-1)                               # (B, d_in + 2N)
    dt_raw = xt @ p["wdt"].to(cd)
    conv_w = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]],
                       dim=1).to(cd)                     # (K, d_loc + 2N)
    window = torch.cat([cache["conv"].to(cd), xbc[:, None]], dim=1)
    mine = window if count == 1 else torch.cat(
        [window[..., index * d_loc:(index + 1) * d_loc],
         window[..., d_in:]], dim=-1)
    conv_out = silu(torch.einsum("bkc,kc->bc", mine.to(acc),
                                 conv_w.to(acc)).to(cd))
    xin = conv_out[:, :d_loc]
    B_ = conv_out[:, d_loc:d_loc + n].to(acc)
    C_ = conv_out[:, d_loc + n:].to(acc)
    dt = F.softplus(dt_raw.to(acc) + p["dt_bias"].to(acc))   # (B, H)
    a = -torch.exp(p["A_log"].to(acc)) * dt
    xh = xin.reshape(-1, h_loc, hp).to(acc)
    state = cache["state"] * torch.exp(a)[..., None, None] + torch.einsum(
        "bn,bh,bhp->bhnp", B_, dt, xh)
    y = torch.einsum("bn,bhnp->bhp", C_, state)
    y = y + p["D"].to(acc)[:, None] * xh
    y = y.reshape(-1, d_loc).to(cd) * silu(z)
    if count == 1:
        y = rms_norm(y, p["gnorm"], cfg.norm_eps)
        out = y @ p["wo"].to(cd)
    else:
        y = _gated_norm(y, p["gnorm"], cfg.norm_eps, mesh, axes, d_in)
        out = coll.psum(wide_mm(y, p["wo"].to(cd)), mesh, axes).to(cd)
    return out[:, None], {"conv": window[:, 1:].to(cache["conv"].dtype),
                          "state": state}
