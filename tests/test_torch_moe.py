"""The port's MoE layer (``repro_torch.models.moe``) against the reference.

The reference's ``moe_decode`` and ``moe_train`` run under ``shard_map``
on a one-device mesh, where the expert axis has size 1 and every
collective is an identity; the port is that arithmetic in plain
PyTorch.  Both get the same numpy-seeded inputs and the reference's
seed-0 ffn weights of the three MoE smoke configs.

Tolerances: float32 1e-5 (products summed in other orders); bf16 3e-2,
the reference run op by op (``_torch_parity.run_ref``), as every bf16
parity test of the port (under ``jit`` XLA may skip bf16 roundings inside
a fusion).  Routing (expert ids) is compared exactly, the gates and the
aux loss within 1e-6.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.launch.mesh import single_device_mesh
from repro.models import blocks as ref_blocks
from repro.models import model as ref_model
from repro.models import moe as ref_moe
from repro_torch.configs import base as port_base
from repro_torch.launch import steps as port_steps
from repro_torch.models import model as port_model
from repro_torch.models import moe as port_moe

from _torch_parity import run_ref
from _torch_parity import to_np as _np

MOE = ("mixtral_8x7b", "qwen3_moe_235b_a22b", "jamba_v0_1_52b")
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


@functools.lru_cache(maxsize=None)
def _ref_ffn(arch):
    """The seed-0 ffn weights of the first MoE sublayer of block 0."""
    cfg = ref_base.get_config(arch, smoke=True)
    params = ref_blocks.init_params(ref_model.model_defs(cfg),
                                    jax.random.PRNGKey(0))
    j = [f for _, f in cfg.pattern].index("moe")
    return {k: np.asarray(v[0]) for k, v in
            params["blocks"][f"sub{j}"]["ffn"].items() if k != "norm"}


def configs(arch, compute_dtype):
    return (ref_base.get_config(arch, smoke=True).replace(
        compute_dtype=compute_dtype),
        port_base.get_config(arch, smoke=True).replace(
            compute_dtype=compute_dtype))


def run_both(fn_name, arch, compute_dtype, x, weights):
    """The reference's and the port's ``fn_name`` on x (float32 numpy,
    cast to the compute dtype) with ``weights`` (numpy)."""
    cfg, pcfg = configs(arch, compute_dtype)
    jdt, tdt = getattr(jnp, compute_dtype), getattr(torch, compute_dtype)
    fn = functools.partial(getattr(ref_moe, fn_name), cfg=cfg,
                           mesh=single_device_mesh(),
                           batch_axes=ref_model.BATCH_AXES)
    want, want_aux = run_ref(fn, compute_dtype,
                             {k: jnp.asarray(v) for k, v in weights.items()},
                             jnp.asarray(x).astype(jdt))
    got, aux = getattr(port_moe, fn_name)(
        {k: torch.tensor(v) for k, v in weights.items()},
        torch.tensor(x).to(tdt), pcfg)
    assert got.dtype == tdt and got.shape == x.shape
    return got, aux, want, want_aux


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("compute_dtype", sorted(TOL))
def test_moe_decode_matches_reference(arch, compute_dtype):
    """Three rows of one token, the serve step's shape."""
    x = np.random.default_rng(0).standard_normal(
        (3, 1, ref_base.get_config(arch, smoke=True).d_model))
    got, _, want, _ = run_both("moe_decode", arch, compute_dtype,
                               x.astype(np.float32), _ref_ffn(arch))
    tol = TOL[compute_dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("compute_dtype", sorted(TOL))
def test_moe_train_matches_reference(arch, compute_dtype):
    """2 x 64 tokens, the prefill / forward path: y and the aux loss."""
    x = np.random.default_rng(1).standard_normal(
        (2, 64, ref_base.get_config(arch, smoke=True).d_model))
    got, aux, want, want_aux = run_both("moe_train", arch, compute_dtype,
                                        x.astype(np.float32),
                                        _ref_ffn(arch))
    tol = TOL[compute_dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    assert aux.dtype == torch.float32
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)


def skewed(arch, n_tokens, seed):
    """Inputs and weights that send every token to expert 0 first: x has
    a positive mean and the router's column 0 sums it."""
    cfg = ref_base.get_config(arch, smoke=True)
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n_tokens, 1, cfg.d_model)) + 1.0) \
        .astype(np.float32)
    w = dict(_ref_ffn(arch))
    w["router"] = w["router"].copy()
    w["router"][:, 0] = 1.0
    return cfg, x, w


@pytest.mark.parametrize("path,arch", [("moe_decode", "qwen3_moe_235b_a22b"),
                                       ("moe_train", "mixtral_8x7b")])
@pytest.mark.parametrize("compute_dtype", sorted(TOL))
def test_capacity_drops_match_reference(path, arch, compute_dtype):
    """A routing skewed past the capacity: expert 0 gets every token, more
    rows than ``cap_e`` (decode: _cap(T k, E, 2 cf) = 24 for 32 tokens
    of qwen3 smoke's 8 experts; forward: _cap(cap, E, 1) = 24 for 32
    tokens of mixtral smoke's 4), so the rows past it give 0 in both
    packages, the same rows."""
    cfg, x, w = skewed(arch, 32, seed=2)
    n = 32 * cfg.top_k
    if path == "moe_decode":
        cap_e = port_moe._cap(n, cfg.n_experts, cfg.capacity_factor * 2)
    else:
        cap = max(8, int(np.ceil(cfg.capacity_factor * n / 8)) * 8)
        cap_e = port_moe._cap(cap, cfg.n_experts, 1.0)
    _, ids, _ = port_moe._router(torch.tensor(x[:, 0]),
                                 torch.tensor(w["router"]), cfg.top_k)
    assert int((ids == 0).sum()) == 32 > cap_e == 24
    got, _, want, _ = run_both(path, arch, compute_dtype, x, w)
    tol = TOL[compute_dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    # the tokens past the capacity lost expert 0's contribution
    full = dict(w)
    _, pcfg = configs(arch, compute_dtype)
    roomy = pcfg.replace(capacity_factor=16.0)
    ample, _ = getattr(port_moe, path)(
        {k: torch.tensor(v) for k, v in full.items()},
        torch.tensor(x).to(getattr(torch, compute_dtype)), roomy)
    diff = (_np(ample) - _np(got)).reshape(32, -1)
    changed = np.abs(diff).max(-1) > 0
    assert not changed[:cap_e].any() and changed[cap_e:].all()


def test_router_matches_reference_with_ties():
    """``_router`` against the reference's, at seeded inputs and at a
    router of zeros, where every expert ties and ``jax.lax.top_k`` takes
    the lowest ids first."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 64)).astype(np.float32)
    for wr in (rng.standard_normal((64, 8)).astype(np.float32) * 0.1,
               np.zeros((64, 8), np.float32)):
        gates, ids, aux = ref_moe._router(jnp.asarray(x), jnp.asarray(wr), 3)
        g, i, a = port_moe._router(torch.tensor(x), torch.tensor(wr), 3)
        assert np.array_equal(i.numpy(), np.asarray(ids))
        np.testing.assert_allclose(g.numpy(), np.asarray(gates), rtol=1e-6,
                                   atol=1e-6)
        assert float(a) == pytest.approx(float(aux), rel=1e-6)
    assert i.tolist() == [[0, 1, 2]] * 16


def test_defs_and_cap_are_the_reference():
    for arch in MOE:
        for smoke in (False, True):
            cfg = ref_base.get_config(arch, smoke=smoke)
            pcfg = port_base.get_config(arch, smoke=smoke)
            assert {k: (d.shape, d.axes, d.scale) for k, d in
                    port_moe.moe_defs(pcfg).items()} == \
                {k: (d.shape, d.axes, d.scale) for k, d in
                 ref_moe.moe_defs(cfg).items()}
    for args in ((6, 4, 2.5), (256, 8, 1.25), (20480, 8, 1.0), (3, 128, 1)):
        assert port_moe._cap(*args) == ref_moe._cap(*args)


@pytest.mark.parametrize("arch", MOE)
def test_moe_training_raises(arch):
    """MoE configurations train: the train step is built and the loss
    carries a gradient to every router.  The unported ``"ragged"``
    grouping raises, naming ROADMAP queue 1 item 7."""
    pcfg = port_base.get_config(arch, smoke=True)
    assert callable(port_steps.make_train_step(pcfg, device="cpu"))
    model = port_model.Model(pcfg, device="cpu")
    tok = torch.zeros((1, 8), dtype=torch.long)
    leaves = port_steps.grad_leaves(model.params, port_model.tree_map(
        torch.zeros_like, model.params))
    total, metrics = port_model.loss_fn(leaves, {"tokens": tok,
                                                 "targets": tok},
                                        pcfg, device="cpu")
    total.backward()
    assert float(metrics["aux_loss"]) > 0
    for j, (_, ffn) in enumerate(pcfg.pattern):
        if ffn == "moe":
            for block in leaves["blocks"]:
                assert block[f"sub{j}"]["ffn"]["router"].grad.abs().sum() > 0
    ragged = pcfg.replace(moe_impl="ragged")
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        port_model.loss_fn(model.params, {"tokens": tok, "targets": tok},
                           ragged, device="cpu")


#: (arch, skewed): every MoE smoke config at seeded inputs, and mixtral's
#: forward with expert 0 sent more rows than ``cap_e`` (``skewed``)
GRAD_CASES = [(arch, False) for arch in MOE] + [("mixtral_8x7b", True)]


@pytest.mark.parametrize("arch,skew", GRAD_CASES)
def test_moe_train_gradients_match_reference(arch, skew):
    """``moe_train`` under autograd: the gradients of ``sum(y * dy) +
    aux`` with respect to x, the router and the three expert weights
    against ``jax.grad`` of the reference's, float32 under ``jit``, within
    1e-5 scaled by each gradient's largest magnitude.  They reach the
    gates (the top-k probabilities renormalised), the aux loss through
    the mean probability, the router and the experts through the
    (E, cap_e, D) buffer; a row dropped past ``cap_e`` and the buffer's
    sentinel row contribute nothing in either package."""
    cfg, pcfg = configs(arch, "float32")
    if skew:
        _, x, w = skewed(arch, 32, seed=2)
    else:
        x = np.random.default_rng(5).standard_normal(
            (2, 32, cfg.d_model)).astype(np.float32)
        w = _ref_ffn(arch)
    dy = np.random.default_rng(6).standard_normal(x.shape).astype(
        np.float32)
    fn = functools.partial(ref_moe.moe_train, cfg=cfg,
                           mesh=single_device_mesh(),
                           batch_axes=ref_model.BATCH_AXES)

    def objective(w, x):
        y, aux = fn(w, x)
        return (y * dy).sum() + aux
    want = run_ref(jax.grad(objective, argnums=(0, 1)), "float32",
                   {k: jnp.asarray(v) for k, v in w.items()},
                   jnp.asarray(x))
    tw = {k: torch.tensor(v, requires_grad=True) for k, v in w.items()}
    tx = torch.tensor(x, requires_grad=True)
    y, aux = port_moe.moe_train(tw, tx, pcfg)
    ((y * torch.tensor(dy)).sum() + aux).backward()
    for name, got, exp in [(k, tw[k].grad, want[0][k]) for k in tw] + [
            ("x", tx.grad, want[1])]:
        exp = _np(exp)
        tol = TOL["float32"] * max(np.abs(exp).max(), 1.0)
        np.testing.assert_allclose(_np(got), exp, rtol=0, atol=tol,
                                   err_msg=name)


def test_op_by_op_moe_is_the_eager_shard_map():
    """``run_ref`` runs the reference's one-device ``shard_map`` body as a
    ``vmap`` over a size-1 "model" axis in bf16; its results are the
    eager ``shard_map``'s bit for bit."""
    cfg, _ = configs("mixtral_8x7b", "bfloat16")
    mesh = single_device_mesh()
    w = {k: jnp.asarray(v) for k, v in _ref_ffn("mixtral_8x7b").items()}
    x = jnp.asarray(np.random.default_rng(4).standard_normal(
        (2, 16, cfg.d_model)), jnp.bfloat16)
    fn = functools.partial(ref_moe.moe_train, cfg=cfg, mesh=mesh,
                           batch_axes=ref_model.BATCH_AXES)
    with mesh, jax.disable_jit():
        want = fn(w, x)
    got = run_ref(fn, "bfloat16", w, x)
    for g, e in zip(got, want):
        assert np.array_equal(_np(g), _np(e))
