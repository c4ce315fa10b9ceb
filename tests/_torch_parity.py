"""Shared pieces of the port's parity tests against the reference package.

``ref_params`` draws the reference's seed-0 smoke parameters and
``ported`` loads them into the port's ``Model``; ``batch_arrays`` draws
a prefill batch (tokens and, where the model has them, the vision prefix
and the encoder frames) from numpy;
``run_ref`` runs a reference function under ``jit`` in float32 and op by
op in bf16 (``jax.disable_jit``: under ``jit`` XLA may skip a bf16
rounding its code asks for, ROADMAP queue 3).

Op by op, the reference's MoE layer would run ``shard_map`` eagerly,
which costs seconds a call on the CPU.  On the one-device mesh its body
sees whole arrays and every collective over the "model" axis (size 1) is
an identity, so ``run_ref`` runs that body as a ``vmap`` over a size-1
"model" axis instead: the same primitives on the same values, bit for
bit the eager ``shard_map``'s results (checked in
``tests/test_torch_moe.py``).
"""
from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import base as ref_base
from repro.launch.mesh import single_device_mesh
from repro.models import blocks as ref_blocks
from repro.models import model as ref_model
from repro.models import moe as ref_moe
from repro_torch.configs import base as port_base
from repro_torch.convert import params_from_reference
from repro_torch.models import model as port_model
from repro_torch.models.blocks import tree_leaves

import _torch_mesh_cases as mesh_cases

def to_np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    """The reference's seed-0 parameters of ``arch``'s smoke config."""
    cfg = ref_base.get_config(arch, smoke=True)
    return ref_blocks.init_params(ref_model.model_defs(cfg),
                                  jax.random.PRNGKey(0))


def drawn_params(arch, seed):
    """Every leaf of ``arch``'s smoke parameters drawn from
    ``default_rng(seed)`` (``_torch_mesh_cases.drawn_params``: a leaf the
    init sets to a constant c — the q/k/v biases, the norm scales,
    Mamba-2's ``dt_bias``, ``A_log`` and ``D`` — becomes c + 0.1 N(0, 1),
    every other leaf N(0, 1) times its init's scale), as a reference tree,
    which both packages load.  (At c + 0.3 N one of jamba's smoke chunks
    passes the decay sum at which the reference's ``ssd_chunked``
    gradient turns NaN, ROADMAP queue 3.)"""
    defs = port_model.model_defs(port_base.get_config(arch, smoke=True))
    drawn = iter(mesh_cases.drawn_params(list(tree_leaves(defs)),
                                         seed).values())
    # the reference's tree (pytree order is the sorted order drawn in)
    return jax.tree.map(lambda d: jnp.asarray(next(drawn)),
                        ref_model.model_defs(ref_base.get_config(
                            arch, smoke=True)), is_leaf=ref_blocks.is_def)


def ported(arch, compute_dtype="bfloat16", params=None):
    """Reference config, params (seed 0 unless ``params``, a reference
    tree) and the port's config and Model loaded with them, at the smoke
    config in ``compute_dtype``."""
    cfg = ref_base.get_config(arch, smoke=True).replace(
        compute_dtype=compute_dtype)
    pcfg = port_base.get_config(arch, smoke=True).replace(
        compute_dtype=compute_dtype)
    params = ref_params(arch) if params is None else params
    model = port_model.Model(pcfg, device="cpu")
    model.load_state_dict(params_from_reference(
        jax.tree.map(np.asarray, params)))
    return cfg, pcfg, params, model


def batch_arrays(cfg, b, s, seed=0):
    """A prefill batch of ``s`` positions as numpy arrays, the reference's
    ``batch_structs``: ``s - vision_prefix`` tokens, ``vision_embed`` (b,
    vision_prefix, d) for a VLM and ``frames`` (b, max(s // stride, 8),
    d) for an encoder-decoder, float values that bf16 holds exactly."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (b, s - cfg.vision_prefix)).astype(np.int32)}

    def embed(n):
        x = rng.standard_normal((b, n, cfg.d_model)).astype(np.float32)
        return to_np(jnp.asarray(x).astype(jnp.bfloat16))
    if cfg.vision_prefix:
        out["vision_embed"] = embed(cfg.vision_prefix)
    if cfg.enc_layers:
        out["frames"] = embed(max(s // max(cfg.audio_stride, 1), 8))
    return out


def ref_batch(arrays):
    return {k: jnp.asarray(v) if k == "tokens"
            else jnp.asarray(v).astype(jnp.bfloat16)
            for k, v in arrays.items()}


def port_batch(arrays):
    return {k: torch.tensor(v) if k == "tokens"
            else torch.tensor(v).bfloat16() for k, v in arrays.items()}


def _one_device_shard_map(f, *, mesh, in_specs, out_specs, check_vma):
    def run(*args):
        out = jax.vmap(f, axis_name="model")(*(a[None] for a in args))
        return jax.tree.map(lambda o: o[0], out)
    return run


@contextlib.contextmanager
def op_by_op(compute_dtype):
    """The reference op by op (bf16) or as it is (float32)."""
    if compute_dtype == "float32":
        yield
        return
    saved = ref_moe.shard_map
    ref_moe.shard_map = _one_device_shard_map
    try:
        with jax.disable_jit():
            yield
    finally:
        ref_moe.shard_map = saved


def run_ref(fn, compute_dtype, *args):
    """The reference's ``fn`` on the one-device mesh, under jit (float32)
    or op by op (bf16)."""
    with single_device_mesh(), op_by_op(compute_dtype):
        if compute_dtype == "float32":
            fn = jax.jit(fn)
        return fn(*args)
