"""Pipeline parallelism: a GPipe-style microbatch pipeline over a mesh
axis.

The port of the reference package's ``parallel/pipeline.py``.  Layers are
split into S contiguous stages, one per rank of the axis; activations
flow stage to stage as point-to-point sends (``core/collectives.
ppermute``: a stage hand-off is a one-hop unicast on the distribution
tree, the overlay chain of the paper's Fig. 2b).

    y = pipeline(stage_fn, mesh, "stage")(stage_params, xs)

- ``stage_params``: this rank's stage of the layers (``pipeline_stages``
  makes them stage-major; rank s keeps stage s);
- ``xs``: (n_micro, mb, ...) microbatches, the same on every rank (only
  stage 0 reads them);
- schedule: n_micro + S - 1 ticks; at tick t stage 0 takes microbatch t
  (zeros once they are all in), every stage computes on what it holds
  (bubbles compute on zeros, as in the reference) and sends the result
  to the next stage.  Results are valid on the LAST stage; the others
  return zeros.
"""
from __future__ import annotations

import torch

from repro_torch.core.collectives import ppermute


def pipeline(stage_fn, mesh, axis: str):
    """A pipelined runner of ``stage_fn(stage_params, x) -> y`` (y shaped
    like x) over the mesh axis ``axis``."""

    def run(stage_params, xs):
        n_stages = mesh.shape[axis]
        sid = mesh.axis_index(axis)
        n_micro = xs.shape[0]
        ticks = n_micro + n_stages - 1
        perm = [(i, i + 1) for i in range(n_stages - 1)]   # forward chain
        buf = torch.zeros_like(xs)          # completed microbatches (last)
        carry = torch.zeros_like(xs[0])     # activation entering the stage
        for t in range(ticks):
            if sid == 0:
                carry = xs[t] if t < n_micro else torch.zeros_like(carry)
            y = stage_fn(stage_params, carry)
            # the microbatch leaving the last stage at tick t is t - (S - 1)
            out_idx = t - (n_stages - 1)
            if sid == n_stages - 1 and out_idx >= 0:
                buf[out_idx] = y
            recv = ppermute(y, mesh, axis, perm) if n_stages > 1 else None
            carry = recv if recv is not None else torch.zeros_like(y)
        return buf

    return run


def pipeline_stages(stacked_params, n_stages: int):
    """Reshape (L, ...) stacked layer parameters (a tensor or a tuple,
    list or dict of them) to (S, L/S, ...) stage-major, so that dim 0
    splits over the stage axis."""
    def reshape(p):
        n = p.shape[0]
        assert n % n_stages == 0, (n, n_stages)
        return p.reshape((n_stages, n // n_stages) + tuple(p.shape[1:]))
    if isinstance(stacked_params, torch.Tensor):
        return reshape(stacked_params)
    if isinstance(stacked_params, dict):
        return {k: pipeline_stages(v, n_stages)
                for k, v in stacked_params.items()}
    return type(stacked_params)(pipeline_stages(v, n_stages)
                                for v in stacked_params)
