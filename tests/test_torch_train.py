"""The port's training path against the reference package.

``loss_fn`` (its loss, metrics and every gradient leaf) at all ten smoke
configs, also at drawn leaves and with MoE rows dropped at capacity; the
gradients of the two kernel Functions
(``kernels/flash_attention.FlashAttention``, ``kernels/ssd_scan.SSDScan``),
``adamw.apply``, ``make_train_step`` at ``accum_steps`` 1 and 2, and
8-step ``Trainer`` runs (granite_3_2b, mixtral_8x7b) against the
reference's, in float32, the reference under ``jit``, within ``TOL`` (the
gradient leaves of ``loss_fn`` against a float64 evaluation, see
``test_loss_and_every_gradient_match_reference``).  Both packages load the
same weights (``params_from_reference``), and the ``Trainer`` runs start
from the reference's step-0 state written by the reference's
``CheckpointManager``, which also holds the shared on-disk layout.

The reference's ``ssd_chunked`` masks L after its exp, so its gradient is
NaN once a chunk's decay sum passes ~88 (ROADMAP queue 3); the port masks
before the exp, and the SSD gradients are compared where the reference's
are finite.
"""
from __future__ import annotations

import contextlib
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.sharded import CheckpointManager as RefCheckpoints
from repro.configs import base as ref_base
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.launch import steps as ref_steps
from repro.launch.mesh import single_device_mesh
from repro.models import attention as ref_attn
from repro.models import blocks as ref_blocks
from repro.models import model as ref_model
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
from repro.optim import adamw as ref_adamw
from repro.runtime import train as ref_train
from repro_torch.checkpoint.sharded import treedef_str
from repro_torch.configs import base as port_base
from repro_torch.convert import params_from_reference
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as port_ssd
from repro_torch.launch import steps as port_steps
from repro_torch.models import blocks as port_blocks
from repro_torch.models import model as port_model
from repro_torch.models import moe as port_moe
from repro_torch.optim import adamw
from repro_torch.runtime import train as port_train

from _torch_parity import drawn_params

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
TRAIN = port_base.ARCH_IDS
#: text positions of a parity batch: 32, and 64 for danube, a multiple of
#: its smoke window (32) at which the window binds and the reference
#: applies it (ROADMAP queue 3)
SEQ = {"h2o_danube_3_4b": 64}
TOL = 1e-4


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = ref_base.get_config(arch, smoke=True)
    return ref_blocks.init_params(ref_model.model_defs(cfg),
                                  jax.random.PRNGKey(0))


def ported(arch, params=None):
    """Reference config and params (seed 0 unless ``params`` is given),
    the port's config and a Model loaded with those params, float32
    compute."""
    cfg = ref_base.get_config(arch, smoke=True).replace(
        compute_dtype="float32")
    pcfg = port_base.get_config(arch, smoke=True).replace(
        compute_dtype="float32")
    params = _ref_params(arch) if params is None else params
    model = port_model.Model(pcfg, device="cpu")
    model.load_state_dict(params_from_reference(
        jax.tree.map(np.asarray, params)))
    return cfg, pcfg, params, model


def lm_batch(cfg, b, s, seed=0):
    """A train batch of ``s`` text positions from ``default_rng(seed)``:
    tokens, targets, a loss mask, and where the model takes them the
    vision prefix's ``vision_embed`` and the encoder's ``frames``
    (``steps.batch_structs``' shapes, unit normals that bf16 holds
    exactly)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    mask[0, : s // 4] = 0.0            # a masked prefix: the mean is weighted
    out = {"tokens": rows[:, :-1], "targets": rows[:, 1:],
           "loss_mask": mask}
    structs = port_steps.batch_structs(cfg, s + cfg.vision_prefix, b,
                                       train=True)
    for name in ("vision_embed", "frames"):
        if name in structs:
            x = rng.standard_normal(structs[name].shape).astype(np.float32)
            out[name] = torch.tensor(x).bfloat16().float().numpy()
    return out


def ref_jit(fn, *args):
    with single_device_mesh():
        return jax.jit(fn)(*args)


def named(tree):
    return dict(port_blocks.tree_leaves(jax.tree.map(np.asarray, tree)))


# =================================================================== loss

#: how far the float32 gradient leaves of either package may lie from
#: the float64 evaluation, in multiples of the other package's distance
#: (element-wise maxima).  Over granite and mamba2 at batch seeds 0-4 the
#: port's distance over the reference's ranged from 0.24 to 3.8 leaf by
#: leaf, either package the closer one depending on the seed: both round
#: in float32, in different orders.
ORACLE_FACTOR = 8.0


def train_step_grads(model, batch, cfg, dtype):
    """``(metrics, {name: gradient})`` of the port's ``loss_fn`` through
    the train step's per-layer leaves (``steps.accumulate_grads``), with
    the parameters and the compute dtype in ``dtype``."""
    params = port_blocks.tree_map(lambda t: t.detach().to(dtype),
                                  model.params)
    grads = port_blocks.tree_map(torch.zeros_like, params)
    metrics = port_steps.accumulate_grads(
        params, batch, cfg.replace(compute_dtype=str(dtype)[6:]), grads,
        device="cpu")
    return metrics, {k: g.double().numpy()
                     for k, g in port_blocks.tree_leaves(grads)}


@contextlib.contextmanager
def routes():
    """Record ``(eids, n_exp, cap_e)`` of every call of the port's
    capacity-bucketed expert ffn (``moe._bucket_ffn``): each row's
    expert, ``n_exp`` for a row sent nowhere, so the routing and both
    kinds of drop."""
    calls, bucket_ffn = [], port_moe._bucket_ffn

    def recorded(rows, eids, n_exp, cap_e, *args):
        calls.append((eids.clone(), n_exp, cap_e))
        return bucket_ffn(rows, eids, n_exp, cap_e, *args)
    port_moe._bucket_ffn = recorded
    try:
        yield calls
    finally:
        port_moe._bucket_ffn = bucket_ffn


def dropped(eids, n_exp, cap_e):
    """Rows a bucket-ffn call drops: those sent nowhere (past ``cap``)
    and those past ``cap_e`` at their expert."""
    counts = torch.bincount(eids, minlength=n_exp + 1)
    return int(counts[n_exp] + torch.clamp(counts[:n_exp] - cap_e,
                                           min=0).sum())


def _ref_value_and_grad(arch):
    """``jax.jit(jax.value_and_grad(loss_fn))`` of the reference at
    ``arch``'s float32 smoke config."""
    cfg = ref_base.get_config(arch, smoke=True).replace(
        compute_dtype="float32")
    mesh = single_device_mesh()
    return jax.jit(jax.value_and_grad(
        lambda p, b: ref_model.loss_fn(p, b, cfg, mesh), has_aux=True))


#: one compilation per architecture, shared by its batch seeds and drawn
#: leaves
ref_value_and_grad = functools.lru_cache(maxsize=None)(_ref_value_and_grad)


def loss_and_gradients(arch, seed, params=None, cached=True):
    """At the smoke config and batch ``seed``: the reference's
    ``(total, metrics)`` and float32 gradients (under ``jit``), the port's
    float32 metrics and gradients, the port's float64 gradients, and the
    routes of the port's float32 and float64 evaluations (``routes``).
    ``params`` (a reference tree) replaces the seed-0 parameters;
    ``cached=False`` traces the reference anew (for a function patched at
    trace time)."""
    cfg, pcfg, params, model = ported(arch, params)
    batch = lm_batch(cfg, 2, SEQ.get(arch, 32), seed=seed)
    fn = ref_value_and_grad(arch) if cached else _ref_value_and_grad(arch)
    with single_device_mesh():
        want, want_g = fn(params, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    with routes() as r32:
        metrics, grads = train_step_grads(model, batch, pcfg, torch.float32)
    with routes() as r64:
        _, g64 = train_step_grads(model, batch, pcfg, torch.float64)
    return cfg, want, named(want_g), metrics, grads, g64, (r32, r64)


def distances(want, grads, g64):
    """``{leaf: (d_ref, d_port, scale)}``: the largest element-wise
    distance of the reference's and of the port's float32 gradient from
    the float64 one, and the float64 leaf's largest magnitude."""
    return {name: (np.abs(want[name] - g64[name]).max(),
                   np.abs(g - g64[name]).max(), np.abs(g64[name]).max())
            for name, g in grads.items()}


@pytest.mark.parametrize("seed", [0, 4])
@pytest.mark.parametrize("arch", TRAIN)
def test_loss_and_every_gradient_match_reference(arch, seed):
    """``loss_fn``'s total and metrics (element-wise, ``TOL``) and the
    gradient of every parameter, through the train step's per-layer
    leaves, against ``jax.value_and_grad(loss_fn)``.

    Each gradient leaf is held element-wise to the port's float64
    evaluation (``g64``).  The reference's float32 gradient lies within
    ``TOL`` of it, scaled by the leaf's largest magnitude, or within
    ``ORACLE_FACTOR`` times the port's own float32 distance: so the port
    computes the reference's function.  The port's float32 gradient lies
    within ``ORACLE_FACTOR`` times the reference's distance: so it rounds
    no worse.  Granite's smoke gradients are ill-conditioned in float32
    (attention logits up to 105; the 0.02-scale embedding's norm
    multiplies block 0's gradient by ~50): its ``embed`` gradient lies
    1.7e-4 of its maximum from float64 in the port and 4.6e-5 in the
    reference at seed 0, 1.6e-4 and 1.9e-4 at seed 4, which is why
    neither package is held to the other at ``TOL`` directly (the
    figures come from ``python tests/test_torch_train.py``)."""
    cfg, (want_total, want_m), want, metrics, grads, g64, (r32, r64) = \
        loss_and_gradients(arch, seed)
    check_routes(cfg, r32, r64)
    check_loss_and_gradients(cfg, want_total, want_m, want, metrics, grads,
                             g64)


def check_routes(cfg, r32, r64):
    """The float64 evaluation routes every row to the experts the float32
    one does, with the same drops, or it is a different function and no
    oracle; and each block's recompute in the backward routes as its
    forward did (the forward's calls, then the recompute's, block by
    block in reverse order)."""
    assert len(r32) == len(r64)
    for i, ((e32, n_exp, cap_e), (e64, _, _)) in enumerate(zip(r32, r64)):
        assert torch.equal(e32, e64), (
            f"call {i}: the float64 evaluation routes "
            f"{int((e32 != e64).sum())} rows elsewhere; drops "
            f"{dropped(e32, n_exp, cap_e)} vs {dropped(e64, n_exp, cap_e)}")
    per_block = [f for _, f in cfg.pattern].count("moe")
    if not per_block or cfg.remat == "none":
        return
    blocks = [r32[i:i + per_block] for i in range(0, len(r32), per_block)]
    assert len(blocks) == 2 * cfg.n_blocks
    for fwd, again in zip(blocks[:cfg.n_blocks], blocks[cfg.n_blocks:][::-1]):
        for (e, _, _), (e_again, _, _) in zip(fwd, again):
            assert torch.equal(e, e_again)


def check_loss_and_gradients(cfg, want_total, want_m, want, metrics, grads,
                             g64):
    for key in ("loss", "aux_loss", "perplexity"):
        close(metrics[key], want_m[key])
    close(metrics["loss"] + cfg.router_aux_coef * metrics["aux_loss"],
          want_total)
    assert set(grads) == set(want)
    for name, (d_ref, d_port, scale) in distances(want, grads, g64).items():
        assert d_ref <= max(TOL * scale, ORACLE_FACTOR * d_port), (
            name, d_ref, d_port, scale)
        assert d_port <= ORACLE_FACTOR * max(
            d_ref, np.finfo(np.float32).eps * scale), (name, d_port, d_ref)


#: one configuration of each family at drawn leaves: qwen1.5 and whisper
#: for the q/k/v biases, mamba2 and jamba for the Mamba-2 leaves
DRAWN = ("qwen1_5_110b", "mixtral_8x7b", "mamba2_370m", "jamba_v0_1_52b",
         "whisper_medium", "internvl2_26b")


@pytest.mark.parametrize("arch", DRAWN)
def test_loss_and_every_gradient_match_reference_at_drawn_leaves(arch):
    """``test_loss_and_every_gradient_match_reference`` with every leaf
    drawn (``drawn_params``), so that the leaves the init sets to
    constants are compared at other values: a swapped ``bk``/``bv``, a
    misplaced norm scale or a wrong use of ``A_log``, ``dt_bias`` or
    ``D`` shows here."""
    cfg, (want_total, want_m), want, metrics, grads, g64, (r32, r64) = \
        loss_and_gradients(arch, 0, params=drawn_params(arch, 11))
    check_routes(cfg, r32, r64)
    check_loss_and_gradients(cfg, want_total, want_m, want, metrics, grads,
                             g64)


@contextlib.contextmanager
def ref_overflow():
    """Record, for every call of the reference's bucket ffn, its rows past
    ``cap_e`` at their expert (``jax.debug.callback`` from inside its
    jitted ``shard_map`` body).  At one device ``cap >= T k``, so no row
    is sent nowhere: its sentinel rows are the unused send slots."""
    counts, bucket_ffn = [], ref_moe._bucket_ffn

    def recorded(rows, eids, n_exp, cap_e, *args, **kw):
        c = jnp.bincount(eids, length=n_exp + 1)[:n_exp]
        jax.debug.callback(lambda n: counts.append(int(n)),
                           jnp.maximum(c - cap_e, 0).sum())
        return bucket_ffn(rows, eids, n_exp, cap_e, *args, **kw)
    ref_moe._bucket_ffn = recorded
    try:
        yield counts
    finally:
        ref_moe._bucket_ffn = bucket_ffn


def concentrated_router(arch, scale=10.0):
    """Seed-0 parameters whose first MoE sublayer sends most tokens to
    expert 0: that router's column 0 becomes ``scale`` times the unit
    mean of the sublayer's input rows (89% of mixtral's smoke tokens lie
    on its positive side, so expert 0 is in the top k of ~57 of 64
    tokens against a ``cap_e`` of 40).  The input of the first MoE
    sublayer does not depend on any router, so one forward finds it."""
    cfg, pcfg, params, model = ported(arch)
    rows, bucket_ffn = [], port_moe._bucket_ffn

    def recorded(x, *args):
        rows.append(x.detach().clone())
        return bucket_ffn(x, *args)
    port_moe._bucket_ffn = recorded
    try:
        with torch.no_grad():
            port_model.forward_hidden(model.params, lm_batch(cfg, 2, 32),
                                      pcfg, device="cpu")
    finally:
        port_moe._bucket_ffn = bucket_ffn
    mean = rows[0][::cfg.top_k].mean(0).double().numpy()
    sub = next(f"sub{i}" for i, (_, f) in enumerate(cfg.pattern)
               if f == "moe")
    router = np.array(params["blocks"][sub]["ffn"]["router"])
    router[0, :, 0] = scale * mean / np.linalg.norm(mean)
    params = jax.tree.map(lambda a: a, params)
    params["blocks"][sub]["ffn"]["router"] = jnp.asarray(router)
    return params


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "jamba_v0_1_52b"])
def test_gradients_match_reference_with_rows_dropped_at_capacity(arch):
    """A router that sends more than ``cap_e`` rows to one expert
    (``concentrated_router``): both packages drop the same number of
    rows there, at least one, and the loss and every gradient leaf agree
    as in ``test_loss_and_every_gradient_match_reference``.  A dropped
    row adds nothing to the output, so its gate and its expert rows get
    an exactly zero gradient in both."""
    params = concentrated_router(arch)
    with ref_overflow() as ref_counts:
        cfg, (want_total, want_m), want, metrics, grads, g64, (r32, r64) \
            = loss_and_gradients(arch, 0, params=params, cached=False)
    got = [dropped(*call) for call in r32]
    assert got[0] > 0 and ref_counts and ref_counts[0] == got[0], (
        got, ref_counts)
    check_routes(cfg, r32, r64)
    check_loss_and_gradients(cfg, want_total, want_m, want, metrics, grads,
                             g64)


@pytest.mark.parametrize("s,chunk", [(64, 512), (64, 16), (60, 16)])
def test_chunked_xent_matches_reference(s, chunk):
    """The chunked cross-entropy and its gradients at chunks that take
    the whole sequence, divide it, and do not divide it (the whole
    sequence again), against the reference's ``chunked_xent``."""
    cfg = ref_base.get_config("granite_3_2b", smoke=True).replace(
        compute_dtype="float32", xent_chunk=chunk)
    pcfg = port_base.get_config("granite_3_2b", smoke=True).replace(
        compute_dtype="float32", xent_chunk=chunk)
    rng = np.random.default_rng(s + chunk)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((cfg.d_model, cfg.vocab_size)).astype(
        np.float32) * 0.1
    b = lm_batch(cfg, 2, s, seed=1)
    want, (gx, gw) = ref_jit(jax.value_and_grad(
        lambda x, w: ref_model.chunked_xent(
            x, w, jnp.asarray(b["targets"]), jnp.asarray(b["loss_mask"]),
            cfg), argnums=(0, 1)), jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.tensor(a, requires_grad=True) for a in (x, w))
    got = port_model.chunked_xent(tx, tw, torch.tensor(b["targets"]),
                                  torch.tensor(b["loss_mask"]), pcfg)
    got.backward()
    close(got, want)
    close(tx.grad, gx)
    close(tw.grad, gw)


# ======================================================= kernel functions

#: (B, S, H, KVH, D, causal, window): GQA causal through the reference's
#: dense (64) and chunked (96) branches, a window where it applies it
#: (dense at 64, swa at 96 = 3 x 32), bidirectional, MHA
ATTN_GRAD_CASES = [(2, 64, 4, 2, 16, True, 0), (1, 96, 4, 1, 16, True, 0),
                   (1, 64, 4, 2, 16, True, 32), (2, 96, 4, 2, 8, True, 32),
                   (1, 64, 2, 2, 16, False, 0), (2, 64, 4, 4, 16, True, 0)]


@pytest.mark.parametrize("case", ATTN_GRAD_CASES)
def test_attention_function_gradients_match_reference(case, monkeypatch):
    """dq, dk, dv of ``ops.flash_attention`` (the Function: plain forward
    on the CPU, ``ref.mha_backward`` in blocks of 16 query rows, so the
    key bands are exercised) against ``jax.grad`` of the reference's
    ``attention`` at kv_chunk 32."""
    monkeypatch.setattr(ref, "MHA_BLOCK_Q", 16)
    b, s, h, kvh, d, causal, window = case
    rng = np.random.default_rng(s * h + window)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32) for shape
                   in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d),
                       (b, s, h, d)))

    def f(q, k, v):
        return (ref_attn.attention(q, k, v, causal=causal, window=window,
                                   kv_chunk=32) * do).sum()
    want = ref_jit(jax.grad(f, argnums=(0, 1, 2)), *map(jnp.asarray,
                                                       (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(do))
    for g, w in zip(got, want):
        close(g, w)


def ssd_inputs(shape, seed, decay=0.1):
    b, s, h, p, n = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, p)).astype(np.float32),
            np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(
                np.float32),
            (-np.abs(rng.standard_normal((b, s, h))) * decay).astype(
                np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, h, p)).astype(np.float32))


#: (B, S, H, P, N, chunk): chunks that divide S, one chunk, and S = 100
#: with chunk 32 (the port pads its recompute to 128; the reference's
#: ``ssd_chunked`` takes the whole sequence as one chunk)
SSD_GRAD_CASES = [(2, 64, 3, 16, 16, 32), (1, 64, 2, 8, 16, 64),
                  (1, 100, 2, 8, 16, 32), (2, 48, 2, 16, 8, 16)]


@pytest.mark.parametrize("case", SSD_GRAD_CASES)
def test_ssd_function_gradients_match_reference(case):
    """dx, ddt, da, dB, dC of ``ops.ssd_scan`` (the Function: the exact
    recurrence forward on the CPU, ``ref.ssd_backward`` at the chunk)
    against ``jax.grad`` of the reference's ``ssd_chunked``."""
    *shape, chunk = case
    x, dt, a, B_, C_, dy = ssd_inputs(shape, seed=sum(case))

    def f(*args):
        return (ref_ssm.ssd_chunked(*args, chunk)[0] * dy).sum()
    want = ref_jit(jax.grad(f, argnums=(0, 1, 2, 3, 4)),
                   *map(jnp.asarray, (x, dt, a, B_, C_)))
    ins = [torch.tensor(t, requires_grad=True) for t in (x, dt, a, B_, C_)]
    y, _ = ops.ssd_scan(*ins, chunk=chunk, y_dtype=torch.float32)
    got = torch.autograd.grad(y, ins, torch.tensor(dy))
    for g, w in zip(got, want):
        close(g, w)


def test_ssd_gradient_is_finite_where_the_reference_overflows():
    """Over a 128-position chunk of decay 0.7 a step the masked
    ``cum_q - cum_k`` above the diagonal reach 89: the reference's
    ``ssd_chunked`` takes their exp (inf) before masking it and its da is
    NaN; the port's is finite and equals autograd of the exact
    recurrence in float64."""
    x, _, _, B_, C_, dy = ssd_inputs((1, 128, 2, 8, 8), seed=3)
    dt = np.full((1, 128, 2), 0.7, np.float32)
    a = -dt

    def f(*args):
        return (ref_ssm.ssd_chunked(*args, 128)[0] * dy).sum()
    ref_da = jax.grad(f, argnums=2)(*map(jnp.asarray, (x, dt, a, B_, C_)))
    assert np.isnan(np.asarray(ref_da)).any()
    ins = [torch.tensor(t, requires_grad=True) for t in (x, dt, a, B_, C_)]
    y, _ = ops.ssd_scan(*ins, chunk=128, y_dtype=torch.float32)
    got = torch.autograd.grad(y, ins, torch.tensor(dy))
    ins64 = [torch.tensor(t, dtype=torch.float64, requires_grad=True)
             for t in (x, dt, a, B_, C_)]
    want = torch.autograd.grad(ref.ssd_reference(*ins64)[0], ins64,
                               torch.tensor(dy, dtype=torch.float64))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g.double(), w, rtol=TOL, atol=TOL)


def test_ssd_function_final_state_has_no_gradient():
    x, dt, a, B_, C_, _ = ssd_inputs((1, 32, 2, 8, 8), seed=5)
    ins = [torch.tensor(t, requires_grad=True) for t in (x, dt, a, B_, C_)]
    y, state = port_ssd.SSDScan.apply(*ins, 16, torch.float32)
    assert y.requires_grad and not state.requires_grad


# ================================================================== adamw

def _grad_tree(params, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32) * scale), params)


@pytest.mark.parametrize("scale", [1e-3, 1.0])
def test_adamw_apply_matches_reference(scale):
    """Three AdamW steps fed identical gradients (unclipped at 1e-3, the
    clip engaged at 1.0): params, m, v, lr and grad_norm, across the
    warmup and the cosine (warmup 2 of 10 steps)."""
    cfg = ref_adamw.AdamWConfig(warmup_steps=2, total_steps=10)
    pcfg = adamw.AdamWConfig(warmup_steps=2, total_steps=10)
    params = _ref_params("granite_3_2b")
    state = ref_adamw.init(params)
    tparams = port_blocks.unflatten(params_from_reference(
        jax.tree.map(np.asarray, params)))
    tstate = adamw.init(tparams)
    for i in range(3):
        grads = _grad_tree(params, i, scale)
        params, state, om = ref_jit(
            functools.partial(ref_adamw.apply, cfg), params, state, grads)
        tgrads = port_blocks.unflatten(params_from_reference(
            jax.tree.map(np.asarray, grads)))
        tparams, tstate, tom = adamw.apply(pcfg, tparams, tstate, tgrads)
        close(tom["lr"], om["lr"], 1e-6)
        close(tom["grad_norm"], om["grad_norm"])
        assert int(tstate["step"]) == int(state["step"]) == i + 1
        for tree, ttree in ((params, tparams), (state["m"], tstate["m"]),
                            (state["v"], tstate["v"])):
            want = named(tree)
            for name, t in port_blocks.tree_leaves(ttree):
                np.testing.assert_allclose(_np(t), want[name], rtol=TOL,
                                           atol=1e-6, err_msg=name)


def test_schedule_matches_reference():
    cfg = ref_adamw.AdamWConfig(warmup_steps=7, total_steps=50)
    pcfg = adamw.AdamWConfig(warmup_steps=7, total_steps=50)
    steps = np.arange(0, 60, dtype=np.int32)
    want = np.asarray(ref_adamw.schedule(cfg, jnp.asarray(steps)))
    got = adamw.schedule(pcfg, torch.tensor(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# ============================================================= train step

@pytest.mark.parametrize("arch,accum", [("granite_3_2b", 1),
                                        ("granite_3_2b", 2),
                                        ("mamba2_370m", 2),
                                        ("mixtral_8x7b", 2)])
def test_train_step_matches_reference(arch, accum):
    """One ``make_train_step`` step (gradient accumulation over
    ``accum`` microbatches, then AdamW) against the reference's: every
    metric, every parameter and both moments."""
    cfg, pcfg, params, model = ported(arch)
    batch = lm_batch(cfg, 4, 32, seed=2)
    opt = ref_adamw.AdamWConfig(warmup_steps=1)
    mesh = single_device_mesh()
    step = ref_steps.make_train_step(cfg, mesh, opt, accum_steps=accum)
    new_p, new_s, want_m = ref_jit(step, params, ref_adamw.init(params),
                                   {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    tstep = port_steps.make_train_step(
        pcfg, adamw.AdamWConfig(warmup_steps=1), accum, device="cpu")
    tparams, tstate, got_m = tstep(model.params, adamw.init(model.params),
                                   batch)
    assert set(got_m) == set(want_m)
    for key in want_m:
        close(got_m[key], want_m[key])
    for tree, ttree in ((new_p, tparams), (new_s["m"], tstate["m"]),
                        (new_s["v"], tstate["v"])):
        want = named(tree)
        for name, t in port_blocks.tree_leaves(ttree):
            np.testing.assert_allclose(_np(t), want[name], rtol=TOL,
                                       atol=TOL, err_msg=name)


#: the largest share of a config's gradient elements that may lie within
#: float32's noise of 0 (see the test below); 0.19% at whisper's smoke
#: config, whose key biases' true gradients are exactly 0
NOISE_SHARE = 1e-2


@pytest.mark.parametrize("arch", ["whisper_medium", "internvl2_26b",
                                  "jamba_v0_1_52b"])
def test_train_step_matches_reference_through_its_gradient(arch,
                                                           monkeypatch):
    """One ``make_train_step`` step at accum 1 (whisper's ``frames`` and
    internvl2's ``vision_embed`` in the batch): every metric against the
    reference's step; the step's gradient, leaf by leaf, under the rule of
    ``test_loss_and_every_gradient_match_reference`` against the port's
    float64 step; its parameters and both moments against the
    reference's ``adamw.apply`` of that gradient, element-wise; and
    against the reference's own step, element-wise, outside the elements
    whose true gradient is float32 noise.

    An element is noise when its float64 gradient is nonzero and no
    larger than its leaf's float32 error (the larger of either package's
    largest distance from the float64 gradient), and such elements are at
    most ``NOISE_SHARE`` of the config's.  There the two float32
    gradients may differ in sign, and AdamW's first update
    g / (|g| + 1e-8) moves the element by up to lr = 3e-4 either way
    (1 to 10 elements a config, at most 0.40 of the float32 error from
    0), beyond ``TOL`` of the other's."""
    cfg, pcfg, params, model = ported(arch)
    batch = lm_batch(cfg, 4, 32, seed=2)
    opt = ref_adamw.AdamWConfig(warmup_steps=1)
    mesh = single_device_mesh()
    step = ref_steps.make_train_step(cfg, mesh, opt, accum_steps=1)
    ref_p, ref_s, want_m = ref_jit(step, params, ref_adamw.init(params),
                                   {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    seen, apply = [], adamw.apply

    def recorded(opt_cfg, params, state, grads, **kw):
        # a copy: apply scales the gradient by the clip factor in place
        seen.append({k: g.detach().double().clone().numpy()
                     for k, g in port_blocks.tree_leaves(grads)})
        return apply(opt_cfg, params, state, grads, **kw)
    monkeypatch.setattr(adamw, "apply", recorded)
    out = {}
    for dtype in (torch.float32, torch.float64):
        p = port_blocks.tree_map(lambda t: t.detach().clone().to(dtype),
                                 model.params)
        out[dtype] = port_steps.make_train_step(
            pcfg.replace(compute_dtype=str(dtype)[6:]),
            adamw.AdamWConfig(warmup_steps=1), 1, device="cpu")(
                p, adamw.init(p), batch)
    tparams, tstate, got_m = out[torch.float32]
    assert set(got_m) == set(want_m)
    for key in want_m:
        close(got_m[key], want_m[key])
    grads, g64 = seen
    want_g, _ = ref_jit(jax.grad(lambda p, b: ref_model.loss_fn(
        p, b, cfg, mesh), has_aux=True), params,
        {k: jnp.asarray(v) for k, v in batch.items()})
    noise = {}
    for name, (d_ref, d_port, scale) in distances(
            named(want_g), grads, g64).items():
        assert d_ref <= max(TOL * scale, ORACLE_FACTOR * d_port), (
            name, d_ref, d_port, scale)
        assert d_port <= ORACLE_FACTOR * max(
            d_ref, np.finfo(np.float32).eps * scale), (name, d_port, d_ref)
        noise[name] = (g64[name] != 0) & (
            np.abs(g64[name]) <= max(d_ref, d_port))
    assert sum(m.sum() for m in noise.values()) <= NOISE_SHARE * sum(
        g.size for g in g64.values())
    new_p, new_s, _ = ref_jit(
        functools.partial(ref_adamw.apply, opt), params,
        ref_adamw.init(params),
        jax.tree.map(jnp.asarray, port_blocks.unflatten(
            {k: g.astype(np.float32) for k, g in grads.items()})))
    for tree, ref_tree, ttree in ((new_p, ref_p, tparams),
                                  (new_s["m"], ref_s["m"], tstate["m"]),
                                  (new_s["v"], ref_s["v"], tstate["v"])):
        want, ref_want = named(tree), named(ref_tree)
        for name, t in port_blocks.tree_leaves(ttree):
            got = _np(t)
            np.testing.assert_allclose(got, want[name], rtol=TOL,
                                       atol=TOL, err_msg=name)
            kept = ~noise[name]
            np.testing.assert_allclose(got[kept], ref_want[name][kept],
                                       rtol=TOL, atol=TOL, err_msg=name)


def test_train_step_rejects_a_batch_accum_does_not_divide():
    _, pcfg, _, model = ported("granite_3_2b")
    step = port_steps.make_train_step(pcfg, accum_steps=3, device="cpu")
    with pytest.raises(ValueError, match="accum_steps"):
        step(model.params, adamw.init(model.params),
             lm_batch(pcfg, 4, 16))


# ================================================================ trainer

def trainer_history_matches_reference(arch, tmp_path):
    """The reference ``Trainer`` runs 8 steps from its seed-0 state; that
    state, written at step 0 by the reference's ``CheckpointManager``, is
    where the port's ``Trainer`` resumes.  The loss histories agree, and
    the port's step-8 checkpoint restores in the reference equal to the
    reference's own final state."""
    cfg = ref_base.get_config(arch, smoke=True).replace(
        compute_dtype="float32")
    pcfg = port_base.get_config(arch, smoke=True).replace(
        compute_dtype="float32")
    kw = dict(total_steps=8, ckpt_every=4, keep=3, log_every=100)
    dc = dict(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4, seed=7)
    rt = ref_train.Trainer(cfg, single_device_mesh(), RefDataConfig(**dc),
                           ref_train.TrainerConfig(
                               ckpt_dir=str(tmp_path / "ref"), **kw),
                           log=lambda *_: None)
    rt.init_state()
    shared = RefCheckpoints(tmp_path / "port", async_write=False)
    shared.save(0, rt._state_tree(), meta={"loss": float("nan")})
    want = rt.run(resume=False)
    pt = port_train.Trainer(pcfg, DataConfig(**dc), port_train.TrainerConfig(
        ckpt_dir=str(tmp_path / "port"), **kw), log=lambda *_: None,
        device="cpu")
    got = pt.run()
    assert [h["step"] for h in got["history"]] == list(range(8))
    np.testing.assert_allclose([h["loss"] for h in got["history"]],
                               [h["loss"] for h in want["history"]],
                               rtol=TOL, atol=TOL)
    assert shared.all_steps() == [0, 4, 8]
    tree, step, meta = shared.restore(rt._state_tree())
    assert step == 8 and meta["loss"] == got["final_loss"]
    final = named(rt._state_tree())
    for name, leaf in port_blocks.tree_leaves(tree):
        np.testing.assert_allclose(np.asarray(leaf, np.float32),
                                   final[name].astype(np.float32),
                                   rtol=TOL, atol=TOL, err_msg=name)


def test_trainer_history_matches_reference_from_its_checkpoint(tmp_path):
    """granite_3_2b: ``trainer_history_matches_reference``."""
    trainer_history_matches_reference("granite_3_2b", tmp_path)


def test_moe_trainer_history_matches_reference_from_its_checkpoint(tmp_path):
    """mixtral_8x7b, the router's aux loss in every step's total and
    its experts' moments: ``trainer_history_matches_reference``."""
    trainer_history_matches_reference("mixtral_8x7b", tmp_path)


def test_checkpoint_manifest_treedef_is_the_references():
    """The manifest's tree string, for the trainer's state tree (an
    empty ``err``, a scalar ``step``), is the reference's."""
    params = _ref_params("mamba2_370m")
    tree = {"params": params, "opt": ref_adamw.init(params), "err": {}}
    assert treedef_str(tree) == str(jax.tree.flatten(tree)[1])


# ================================================================ devices

def test_training_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    pcfg = port_base.get_config("granite_3_2b", smoke=True)
    with pytest.raises(RuntimeError, match="cuda"):
        port_steps.make_train_step(pcfg)
    with pytest.raises(RuntimeError, match="cuda"):
        port_train.Trainer(pcfg, DataConfig(vocab_size=pcfg.vocab_size,
                                            seq_len=16, global_batch=2),
                           port_train.TrainerConfig(ckpt_dir=str(tmp_path)))
    model = port_model.Model(pcfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        port_model.loss_fn(model.params, lm_batch(pcfg, 1, 8), pcfg)


@pytest.mark.parametrize("arch", ["whisper_medium", "internvl2_26b"])
def test_training_raises_for_moe_and_encoders(arch, tmp_path):
    """The train step trains every configuration; the ``Trainer`` raises
    for the encoder-decoder and the VLM, whose ``frames`` or
    ``vision_embed`` its data pipeline does not carry (nor does the
    reference's), and names them."""
    pcfg = port_base.get_config(arch, smoke=True)
    assert callable(port_steps.make_train_step(pcfg, device="cpu"))
    name = "frames" if pcfg.enc_layers else "vision_embed"
    with pytest.raises(NotImplementedError, match=name):
        port_train.Trainer(pcfg, DataConfig(vocab_size=pcfg.vocab_size,
                                            seq_len=16, global_batch=2),
                           port_train.TrainerConfig(ckpt_dir=str(tmp_path)),
                           device="cpu")


def test_batch_structs_are_the_references():
    """``steps.batch_structs``: every entry's shape and dtype, the
    reference's, for every configuration, train and not, at a length
    the encoder's stride divides and one it does not."""
    for arch in port_base.ARCH_IDS:
        cfg = ref_base.get_config(arch)
        pcfg = port_base.get_config(arch)
        for seq, batch, train in ((4096, 4, True), (1000, 2, False),
                                  (20, 1, True)):
            want = ref_steps.batch_structs(cfg, seq, batch, train=train)
            got = port_steps.batch_structs(pcfg, seq, batch, train=train)
            assert {k: (tuple(v.shape), str(v.dtype)) for k, v in
                    want.items()} == {k: (v.shape, str(v.dtype)[6:])
                                      for k, v in got.items()}, arch


TRAIN_ALONE = """
import sys, tempfile
sys.modules["jax"] = None
sys.modules["repro"] = None
from repro_torch.launch import train
for arch in ("granite_3_2b", "mamba2_370m", "mixtral_8x7b"):
    with tempfile.TemporaryDirectory() as d:
        assert train.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--steps", "3", "--batch", "4", "--seq", "32",
                           "--accum", "2", "--ckpt-every", "2",
                           "--ckpt-dir", d]) == 0
import torch
from repro_torch.configs.base import get_config
from repro_torch.launch import steps
from repro_torch.models.model import Model
from repro_torch.optim import adamw
for arch in ("whisper_medium", "internvl2_26b"):
    cfg = get_config(arch, smoke=True)
    params = Model(cfg, device="cpu").params
    batch = {k: torch.ones(s.shape, dtype=s.dtype) for k, s in
             steps.batch_structs(cfg, 32, 2, train=True).items()}
    _, _, m = steps.make_train_step(cfg, device="cpu")(
        params, adamw.init(params), batch)
    assert torch.isfinite(m["loss"])
assert not any(m.startswith(("jax.", "repro.")) for m in sys.modules)
print("ok")
"""


def test_training_path_runs_with_jax_and_repro_absent():
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", TRAIN_ALONE], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "ok"


# ================================================================ on card

#: (B, S, H, KVH, D, window, dtype): granite's heads, danube's D = 120
#: with a window, in bf16 (the wgmma forward) and float32 (SIMT)
CARD_ATTN = [(1, 512, 32, 8, 64, 0, "bfloat16"),
             (1, 640, 8, 2, 120, 256, "bfloat16"),
             (2, 300, 8, 2, 64, 0, "float32")]
#: forward tolerance (rtol = atol) by dtype, scaled by each gradient's max
CARD_TOL = {"bfloat16": 2e-2, "float32": 2e-5}


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_ATTN)
def test_cuda_attention_backward_matches_plain_autograd(case):
    """On the card, the Function's gradients (the kernel's output in
    Delta) against torch.autograd of ``ref.mha_reference``, within the
    forward's tolerance times each gradient's max abs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, s, h, kvh, d, window, dtype = case
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(
        getattr(torch, dtype)) for shape in ((b, s, h, d), (b, s, kvh, d),
                                            (b, s, kvh, d), (b, s, h, d)))
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(ops.flash_attention(
        *ins, causal=True, window=window), ins, do)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.mha_reference(
        *ins, causal=True, window=window), ins, do)
    for g, w in zip(got, want):
        tol = CARD_TOL[dtype] * float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= tol


#: (B, Sq, Skv, H, KVH, D, dtype), all bidirectional: whisper's encoder
#: (Sq = Skv) and its cross-attention (decoder queries over encoder
#: frames, Sq != Skv) at its heads, in bf16 (the wgmma forward), and a
#: GQA cross-attention with ragged tiles in float32 (SIMT)
CARD_CROSS = [(1, 512, 512, 16, 16, 64, "bfloat16"),
              (2, 512, 128, 16, 16, 64, "bfloat16"),
              (1, 300, 77, 8, 2, 64, "float32")]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CROSS)
def test_cuda_bidirectional_attention_backward_matches_plain_autograd(case):
    """``test_cuda_attention_backward_matches_plain_autograd`` with
    ``causal=False``: the encoder's attention and the cross-attention
    the encoder-decoder trains through."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, sq, skv, h, kvh, d, dtype = case
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(
        getattr(torch, dtype)) for shape in ((b, sq, h, d), (b, skv, kvh, d),
                                            (b, skv, kvh, d), (b, sq, h, d)))
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(ops.flash_attention(*ins, causal=False), ins,
                              do)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.mha_reference(*ins, causal=False), ins,
                               do)
    for g, w in zip(got, want):
        tol = CARD_TOL[dtype] * float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_ssd_backward_matches_plain_autograd(dtype):
    """On the card, the SSD Function's five gradients against
    torch.autograd of the exact recurrence ``ref.ssd_reference``, within
    the forward's tolerance (3e-2 bf16, 1e-4 f32) times each max abs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, dt, a, B_, C_, dy = (torch.tensor(t, device="cuda") for t in
                            ssd_inputs((2, 200, 4, 64, 128), seed=9))
    cd = getattr(torch, dtype)
    args = (x.to(cd), dt, a, B_.to(cd), C_.to(cd))
    ins = [t.clone().requires_grad_() for t in args]
    y, _ = ops.ssd_scan(*ins, chunk=64, y_dtype=torch.float32)
    got = torch.autograd.grad(y, ins, dy)
    ins = [t.clone().requires_grad_() for t in args]
    want = torch.autograd.grad(ref.ssd_reference(*ins)[0], ins, dy)
    tol = {"bfloat16": 3e-2, "float32": 1e-4}[dtype]
    for g, w in zip(got, want):
        bound = tol * float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= bound


if __name__ == "__main__":
    # The float32 gradient distances from float64 that ORACLE_FACTOR and
    # the gradient test's docstring quote: per architecture and batch
    # seed, the port-over-reference ratio's range over the leaves and the
    # ``embed`` leaf's two distances over its largest magnitude.
    for arch in TRAIN:
        for seed in range(5):
            _, _, want, _, grads, g64, _ = loss_and_gradients(arch, seed)
            dist = distances(want, grads, g64)
            ratios = [d_port / max(d_ref, np.finfo(np.float32).eps * scale)
                      for d_ref, d_port, scale in dist.values()]
            d_ref, d_port, scale = dist["embed"]
            print(f"{arch} seed {seed}: port/reference {min(ratios):.2f}"
                  f"-{max(ratios):.2f}; embed port {d_port / scale:.2e}, "
                  f"reference {d_ref / scale:.2e}")
