"""AdamW with a warmup + cosine schedule and global-norm clipping.

The port of the reference package's ``optim/adamw.py``.
The optimizer state mirrors the parameter tree (``{"m", "v", "step"}``,
moments in float32).  Every expression keeps the reference's order of
operations in float32: the bias corrections ``1 - b ** step``, the clip
factor ``min(1, clip / max(gnorm, 1e-12))`` and
``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``, leaf by leaf in the
reference's order (dict keys sorted).  ``apply`` updates the parameters,
the moments and the gradients IN PLACE (at granite_3_2b's width a copy of
any of them is 10.5 GB) and returns them, as the reference returns its
new trees.

On a mesh (``mesh`` and ``specs``, the specs of the rank's blocks of
every leaf) each rank holds its blocks of the parameters, moments and
gradients; the norm sums each leaf's squares once over the mesh (a psum
over the axes that split the leaf, never over one on which it is
replicated), and every other step is elementwise on the rank's blocks.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import collectives as coll
from repro_torch.models.blocks import tree_leaves, tree_map
from repro_torch.parallel.sharding import entry_axes


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (an integer tensor): linear warmup,
    then a cosine down to ``min_lr_frac * lr``; a float32 tensor."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                        1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * torch.clamp(t, 0.0, 1.0)))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params):
    """Zero moments shaped like ``params`` and step 0 (int32), on the
    parameters' device."""
    dev = next(t for _, t in tree_leaves(params)).device
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree, *, mesh=None, specs=None):
    """sqrt of the sum over leaves (in order) of each leaf's sum of
    squares, in float32.  On a ``mesh`` each leaf of ``tree`` is this
    rank's block under ``specs``: its sum of squares is summed over the
    axes that split it (one all-reduce for the leaves split alike), so
    every rank gets the whole tree's norm."""
    squares = [torch.sum(torch.square(g.float()))
               for _, g in tree_leaves(tree)]
    if specs is not None:
        groups: dict = {}
        for i, (_, sp) in enumerate(tree_leaves(specs)):
            axes = sorted({a for d in range(len(sp))
                           for a in entry_axes(sp, d) if mesh.shape[a] > 1})
            groups.setdefault(tuple(axes), []).append(i)
        for axes, idx in groups.items():
            if axes:
                summed = coll.psum(torch.stack([squares[i] for i in idx]),
                                   mesh, axes)
                for j, i in enumerate(idx):
                    squares[i] = summed[j]
    return torch.sqrt(sum(squares))


@torch.no_grad()
def apply(cfg: AdamWConfig, params, opt_state, grads, *, mesh=None,
          specs=None):
    """One AdamW step: ``(params, opt_state, {"grad_norm", "lr"})``.
    ``params``, ``opt_state["m"]``, ``opt_state["v"]`` and ``grads`` are
    updated in place (grads scaled by the clip factor); the step is a new
    tensor.  On a ``mesh`` they are this rank's blocks under ``specs``
    (``global_norm``)."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads, mesh=mesh, specs=specs)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    for (_, p), (_, g), (_, m), (_, v) in zip(
            tree_leaves(params), tree_leaves(grads),
            tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"])):
        g = g.mul_(scale).float()
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        upd = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        upd.add_(cfg.weight_decay * p)
        p.sub_((lr * upd).to(p.dtype))
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "step": step}, {"grad_norm": gnorm, "lr": lr}
