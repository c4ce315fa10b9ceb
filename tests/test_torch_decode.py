"""The port's decode path for the families beyond dense attention, against
the reference package: the Mamba-2 step, the cache trees, the
encoder-decoder's step and the sliding window past its end.

Both packages load the same seed-0 smoke weights
(``_torch_parity.ported``) and get the same numpy-seeded inputs.
Tolerances: float32 1e-3 on logits (the bf16 caches may round one element
the other way after float32 products summed in other orders), bf16 3e-2
with the reference run op by op, as ``tests/test_torch_models.py``'s
``DECODE_TOL``; the Mamba-2 step's output and state 1e-5 in float32 (no
cache rounding inside one step).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.launch.mesh import single_device_mesh
from repro.models import attention as ref_attn
from repro.models import model as ref_model
from repro.models import ssm as ref_ssm
from repro_torch.configs import base as port_base
from repro_torch.models import model as port_model
from repro_torch.models import ssm as port_ssm
from repro_torch.models.blocks import tree_leaves

from _torch_parity import drawn_params, op_by_op, ported, run_ref, to_np

DECODE_TOL = {"float32": 1e-3, "bfloat16": 3e-2}
STEP_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


@pytest.mark.parametrize("compute_dtype", sorted(STEP_TOL))
def test_ssm_decode_step_matches_reference(compute_dtype):
    """One Mamba-2 step at mamba2 smoke's layer 0 from a random cache
    (conv bf16, state f32): the output, the new conv window and state."""
    tol = STEP_TOL[compute_dtype]
    cfg, pcfg, params, model = ported("mamba2_370m", compute_dtype)
    p_ref = {k: v[0] for k, v in params["blocks"]["sub0"]["mixer"].items()
             if k != "norm"}
    p_port = {k: v[0] for k, v in
              model.params["blocks"]["sub0"]["mixer"].items() if k != "norm"}
    rng = np.random.default_rng(8)
    d_in, h, p, n, k = port_ssm.ssm_dims(pcfg)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    conv = to_np(jnp.asarray(rng.standard_normal(
        (3, k - 1, d_in + 2 * n)), jnp.bfloat16))
    state = rng.standard_normal((3, h, n, p)).astype(np.float32)
    dt = getattr(jnp, compute_dtype)
    want, want_cache = run_ref(
        lambda pp, xx, c: ref_ssm.ssm_decode_step(pp, xx, c, cfg),
        compute_dtype, p_ref, jnp.asarray(x).astype(dt),
        {"conv": jnp.asarray(conv).astype(jnp.bfloat16),
         "state": jnp.asarray(state)})
    got, cache = port_ssm.ssm_decode_step(
        p_port, torch.tensor(x).to(getattr(torch, compute_dtype)),
        {"conv": torch.tensor(conv).bfloat16(), "state": torch.tensor(state)},
        pcfg)
    assert got.dtype == getattr(torch, compute_dtype)
    assert cache["conv"].dtype == torch.bfloat16
    assert cache["state"].dtype == torch.float32
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=tol, atol=tol)
    assert np.array_equal(to_np(cache["conv"]), to_np(want_cache["conv"]))
    np.testing.assert_allclose(cache["state"].numpy(),
                               np.asarray(want_cache["state"]), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("arch", ref_base.ARCH_IDS)
def test_init_caches_is_the_reference_tree(arch):
    """Names, shapes and dtypes of every cache leaf (a rolling buffer of
    the window for danube and mixtral, conv and state for Mamba-2
    sublayers, the memory of the encoder-decoder), zero-filled, in bf16
    and in float32 caches; and ``ssm_decode_init``'s."""
    cfg = ref_base.get_config(arch, smoke=True)
    pcfg = port_base.get_config(arch, smoke=True)
    want = ref_model.init_caches(cfg, 3, 48, abstract=True)
    got = port_model.init_caches(pcfg, 3, 48, device="cpu")
    flat = dict(tree_leaves(got))
    want_flat = dict(tree_leaves(want))
    assert sorted(flat) == sorted(want_flat)
    for name, leaf in flat.items():
        assert tuple(leaf.shape) == tuple(want_flat[name].shape), name
        assert str(leaf.dtype).split(".")[-1] == str(want_flat[name].dtype)
        assert not leaf.any()
    f32 = dict(tree_leaves(ref_model.init_caches(cfg, 3, 48, abstract=True,
                                                 dtype=jnp.float32)))
    for name, leaf in tree_leaves(port_model.init_caches(
            pcfg, 3, 48, dtype=torch.float32, device="cpu")):
        assert str(leaf.dtype).split(".")[-1] == str(f32[name].dtype)
    if "mamba" in {m for m, _ in cfg.pattern}:
        w = ref_ssm.ssm_decode_init(cfg, 2)
        g = port_ssm.ssm_decode_init(pcfg, 2, device="cpu")
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in g.items()} == \
            {k: (v.shape, str(v.dtype)) for k, v in w.items()}


@pytest.mark.parametrize("compute_dtype", sorted(DECODE_TOL))
def test_whisper_decode_matches_reference(compute_dtype):
    """Eight steps of the encoder-decoder over a random memory: the
    sinusoidal position of the step, self-attention over the cache and
    cross-attention over the memory.  bf16 at a scalar step over three
    rows (the reference's whisper decode takes one position for the
    batch: a (B,) step raises there for B > 1, ROADMAP queue 3); float32
    at one row with a (1,) step (the reference's scalar branch cannot
    write a float32 k into its bf16 cache: queue 3)."""
    whisper_parity(compute_dtype)


@pytest.mark.parametrize("compute_dtype", sorted(DECODE_TOL))
def test_whisper_decode_matches_reference_at_drawn_leaves(compute_dtype):
    """The same eight steps with every leaf drawn
    (``_torch_parity.drawn_params``): at seed-0 leaves the q/k/v biases
    are 0 and the norm scales 1, so only drawn leaves test them."""
    params = drawn_params("whisper_medium", 11)
    mixer = params["blocks"]["sub0"]["mixer"]
    assert all(float(jnp.abs(mixer[n]).min()) > 0 for n in ("bq", "bk",
                                                            "bv"))
    whisper_parity(compute_dtype, params)


def whisper_parity(compute_dtype, params=None):
    tol = DECODE_TOL[compute_dtype]
    cfg, pcfg, params, model = ported("whisper_medium", compute_dtype,
                                      params)
    mesh = single_device_mesh()
    b = 3 if compute_dtype == "bfloat16" else 1
    rc = ref_model.init_caches(cfg, b, 32)
    pc = port_model.init_caches(pcfg, b, 32, device="cpu")
    rng = np.random.default_rng(9)
    memory = to_np(jnp.asarray(rng.standard_normal(
        rc["memory"].shape), jnp.bfloat16))
    rc["memory"] = jnp.asarray(memory).astype(jnp.bfloat16)
    pc["memory"].copy_(torch.tensor(memory))

    def ref_step(p, c, t, st):
        return ref_model.decode_forward(p, c, t, st, cfg, mesh,
                                        batch_shardable=False)
    if compute_dtype == "float32":
        ref_step = jax.jit(ref_step)
    for t in range(8):
        tok = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        step = 2 + t if b > 1 else np.array([2 + t], np.int32)
        with mesh, op_by_op(compute_dtype):
            want, rc = ref_step(params, rc, jnp.asarray(tok),
                                jnp.asarray(step))
        got, pc = port_model.decode_forward(
            model.params, pc, torch.tensor(tok).long(), step, pcfg,
            device="cpu")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)


def _rolling_decode_attention(q, k, v, *, kv_len=None, window=0):
    """The reference's decode attention with the rolling-buffer mask of
    its sharded branch, ``kpos < min(step + 1, S_cache)`` (its
    ``models/model.py:273-274``), in its single-shard arithmetic."""
    b, sq, h, d = q.shape
    n_kv = k.shape[2]
    kpos = jnp.arange(k.shape[1])
    valid = kpos[None, :] < jnp.minimum(kv_len, k.shape[1])[:, None]
    qg = q.reshape(b, sq, n_kv, h // n_kv, d).astype(jnp.float32)
    logits = jnp.einsum("bqkrd,bskd->bkrqs", qg, k.astype(jnp.float32))
    logits = logits / jnp.sqrt(d).astype(jnp.float32)
    logits = jnp.where(valid[:, None, None, None], logits, ref_attn.NEG_INF)
    w = jax.nn.softmax(logits, axis=-1)
    out = jnp.einsum("bkrqs,bskd->bqkrd", w, v.astype(jnp.float32))
    return out.reshape(b, sq, h, d).astype(q.dtype)


def test_decode_past_the_window(monkeypatch):
    """danube smoke (window 32) decoding 48 positions into a 32-slot
    rolling buffer (max_seq 64), float32, two rows.

    - Against the reference's decode with its sharded branch's
      rolling-buffer mask: within 1e-3 at every position.
    - Against the reference's teacher-forced ``forward`` over the 48
      tokens (s = 48 <= 2 kv_chunk: its dense branch, which applies the
      window): past the window, no farther than the reference's own
      decode is inside it (its bf16 cache against the forward's float32
      k/v: 0.51 on this input).  The reference's single-shard decode,
      whose mask assumes a linear cache (ROADMAP queue 3), is off by
      several times that past the window."""
    cfg, pcfg, params, model = ported("h2o_danube_3_4b", "float32")
    mesh = single_device_mesh()
    b, n, window = 2, 48, cfg.window
    tok = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (b, n)).astype(np.int32)
    fwd, _ = run_ref(lambda p, t: ref_model.forward(p, {"tokens": t}, cfg,
                                                    mesh),
                     "float32", params, jnp.asarray(tok))
    fwd = np.asarray(fwd)
    pc = port_model.init_caches(pcfg, b, 64, device="cpu")
    assert pc["layers"]["sub0"]["k"].shape[2] == window
    got = np.stack([port_model.decode_forward(
        model.params, pc, torch.tensor(tok[:, t:t + 1]).long(), t, pcfg,
        device="cpu")[0][:, 0].numpy() for t in range(n)], axis=1)

    def ref_decode():
        rc = ref_model.init_caches(cfg, b, 64)
        step = jax.jit(lambda p, c, t, st: ref_model.decode_forward(
            p, c, t, st, cfg, mesh, batch_shardable=False))
        out = []
        for t in range(n):
            with mesh:
                lg, rc = step(params, rc, jnp.asarray(tok[:, t:t + 1]),
                              jnp.full((b,), t, jnp.int32))
            out.append(np.asarray(lg)[:, 0])
        return np.stack(out, axis=1)
    single_shard = ref_decode()
    monkeypatch.setattr(ref_attn, "decode_attention",
                        _rolling_decode_attention)
    rolling = ref_decode()
    np.testing.assert_allclose(got, rolling, rtol=1e-3, atol=1e-3)

    def worst(a, lo, hi):
        return float(np.abs(a[:, lo:hi] - fwd[:, lo:hi]).max())
    inside = worst(single_shard, 0, window)
    assert worst(got, window, n) <= inside
    assert worst(single_shard, window, n) > 4 * inside
