"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060) block.

The port of the reference package's ``models/ssm.py``, full-sequence
half: parameter definitions, the depthwise causal convolution, the plain
chunked scan ``ssd_chunked`` (an oracle here) and ``ssm_apply``, whose
scan is ``kernels/ops.ssd_scan``: the hand-written Hopper kernel on a
CUDA tensor, its plain version on a CPU tensor.  B and C are one group
(G = 1) shared by every head.  The single-token decode step and its
caches (``ssm_decode_init``, ``ssm_decode_step``) come with SSM decode
(ROADMAP queue 1 item 2).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.blocks import ParamDef, rms_norm, silu


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


def ssd_chunked(x, dt, a, B_, C_, chunk):
    """Plain chunked SSD scan (the reference's ``ssd_chunked``).
    x (B, S, H, P); dt, a (B, S, H); B_, C_ (B, S, N).  Returns y and the
    final state (B, H, N, P), all f32."""
    b, s, h, p = x.shape
    n = B_.shape[-1]
    if s % chunk != 0:
        chunk = s
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    ac = a.reshape(b, nc, chunk, h).float()
    Bc = B_.reshape(b, nc, chunk, n).float()
    Cc = C_.reshape(b, nc, chunk, n).float()
    xdt = xc * dtc[..., None]
    cum = torch.cumsum(ac, dim=2)                          # (b,nc,q,h)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (b,nc,q,k,h)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    L = torch.where(tri[None, None, :, :, None], torch.exp(diff), 0.0)
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    y_diag = torch.einsum("bcqk,bcqkh,bckhp->bcqhp", scores, L, xdt)
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)      # (b,nc,q,h)
    chunk_states = torch.einsum("bcqn,bcqh,bcqhp->bchnp", Bc,
                                decay_states * dtc, xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])              # (b,nc,h)
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    prevs = []
    for c in range(nc):                                    # state BEFORE c
        prevs.append(state)
        state = state * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    s_prevs = torch.stack(prevs, dim=1)                    # (b,nc,h,n,p)
    y_off = torch.einsum("bcqn,bchnp,bcqh->bcqhp", Cc, s_prevs,
                         torch.exp(cum))
    return (y_diag + y_off).reshape(b, s, h, p), state


def ssm_apply(p, x, cfg, *, chunk=256):
    """Full-sequence Mamba-2 block.  x (B, S, D) -> (y (B, S, D), state).

    The scan gets x in the compute dtype and gives y back in f32, as the
    reference's ``ssd_chunked`` does at this call site: ``D * x`` is
    added and the cast to the compute dtype made after it.
    """
    cd = getattr(torch, cfg.compute_dtype)
    d_in, h, hp, n, k = ssm_dims(cfg)
    xc = x.to(cd)
    z = xc @ p["wz"].to(cd)
    xin = xc @ p["wx"].to(cd)
    B_ = xc @ p["wB"].to(cd)
    C_ = xc @ p["wC"].to(cd)
    dt_raw = xc @ p["wdt"].to(cd)
    xin = silu(_causal_conv(xin, p["conv_x"].to(cd)))
    B_ = silu(_causal_conv(B_, p["conv_B"].to(cd)))
    C_ = silu(_causal_conv(C_, p["conv_C"].to(cd)))
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float()) * dt                # (B, S, H)
    xh = xin.reshape(*xin.shape[:2], h, hp)
    y, state = ops.ssd_scan(xh, dt, a, B_, C_, chunk=chunk,
                            y_dtype=torch.float32)
    y = y + p["D"].float()[:, None] * xh.float()
    y = y.reshape(*x.shape[:2], d_in)
    y = rms_norm(y.to(cd) * silu(z), p["gnorm"], cfg.norm_eps)
    return y @ p["wo"].to(cd), state
