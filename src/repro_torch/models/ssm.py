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
token, which no kernel of the reference computes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_chunked  # noqa: F401 (the oracle)
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


def ssm_apply(p, x, cfg, *, chunk=256):
    """Full-sequence Mamba-2 block.  x (B, S, D) -> (y (B, S, D), state).

    The scan gets x in the compute dtype and gives y back in f32, as the
    reference's ``ssd_chunked`` does at this call site: ``D * x`` is
    added and the cast to the compute dtype made after it.  (A float64
    compute dtype keeps all of it in float64.)
    """
    cd = getattr(torch, cfg.compute_dtype)
    acc = torch.promote_types(cd, torch.float32)
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
    dt = F.softplus(dt_raw.to(acc) + p["dt_bias"].to(acc))
    a = -torch.exp(p["A_log"].to(acc)) * dt                # (B, S, H)
    xh = xin.reshape(*xin.shape[:2], h, hp)
    y, state = ops.ssd_scan(xh, dt, a, B_, C_, chunk=chunk, y_dtype=acc)
    y = y + p["D"].to(acc)[:, None] * xh.to(acc)
    y = y.reshape(*x.shape[:2], d_in)
    y = rms_norm(y.to(cd) * silu(z), p["gnorm"], cfg.norm_eps)
    return y @ p["wo"].to(cd), state


def ssm_decode_init(cfg, batch, dtype=torch.float32, *, device="cpu"):
    """Zero caches of one Mamba-2 layer: the last K - 1 conv inputs
    ``conv`` (B, K - 1, d_in + 2N) in ``dtype`` and the state ``state``
    (B, H, N, P) in float32."""
    d_in, h, p, n, k = ssm_dims(cfg)
    return {"conv": torch.zeros((batch, k - 1, d_in + 2 * n), dtype=dtype,
                                device=device),
            "state": torch.zeros((batch, h, n, p), dtype=torch.float32,
                                 device=device)}


def ssm_decode_step(p, x, cache, cfg):
    """Single-token step.  x (B, 1, D) -> (y (B, 1, D), new cache), the
    reference's arithmetic op by op: the conv window and its product in
    the compute dtype (the product summed over the K taps in float32 and
    rounded once, as a dot), dt, the decay and the state in float32.
    The new cache is returned as new tensors; the caller writes it back.
    """
    cd = getattr(torch, cfg.compute_dtype)
    acc = torch.promote_types(cd, torch.float32)
    d_in, h, hp, n, k = ssm_dims(cfg)
    xt = x[:, 0].to(cd)                                   # (B, D)
    z = xt @ p["wz"].to(cd)
    xbc = torch.cat([xt @ p["wx"].to(cd), xt @ p["wB"].to(cd),
                     xt @ p["wC"].to(cd)], dim=-1)       # (B, d_in + 2N)
    dt_raw = xt @ p["wdt"].to(cd)
    conv_w = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]],
                       dim=1).to(cd)                     # (K, d_in + 2N)
    window = torch.cat([cache["conv"].to(cd), xbc[:, None]], dim=1)
    conv_out = silu(torch.einsum("bkc,kc->bc", window.to(acc),
                                 conv_w.to(acc)).to(cd))
    xin = conv_out[:, :d_in]
    B_ = conv_out[:, d_in:d_in + n].to(acc)
    C_ = conv_out[:, d_in + n:].to(acc)
    dt = F.softplus(dt_raw.to(acc) + p["dt_bias"].to(acc))   # (B, H)
    a = -torch.exp(p["A_log"].to(acc)) * dt
    xh = xin.reshape(-1, h, hp).to(acc)
    state = cache["state"] * torch.exp(a)[..., None, None] + torch.einsum(
        "bn,bh,bhp->bhnp", B_, dt, xh)
    y = torch.einsum("bn,bhnp->bhp", C_, state)
    y = y + p["D"].to(acc)[:, None] * xh
    y = rms_norm(y.reshape(-1, d_in).to(cd) * silu(z), p["gnorm"],
                 cfg.norm_eps)
    out = (y @ p["wo"].to(cd))[:, None]
    return out, {"conv": window[:, 1:].to(cache["conv"].dtype),
                 "state": state}
