"""The port's training path against the reference package.

``loss_fn`` (its loss, metrics and every gradient leaf), the gradients of
the two kernel Functions (``kernels/flash_attention.FlashAttention``,
``kernels/ssd_scan.SSDScan``), ``adamw.apply``, ``make_train_step`` at
``accum_steps`` 1 and 2 and an 8-step ``Trainer`` run against the
reference's at the granite_3_2b and mamba2_370m smoke configs, in
float32, the reference under ``jit``, within ``TOL`` (the gradient
leaves of ``loss_fn`` against a float64 evaluation, see
``test_loss_and_every_gradient_match_reference``).  Both packages load
the same weights (``params_from_reference``), and the ``Trainer`` run
starts from the reference's step-0 state written by the reference's
``CheckpointManager``, which also holds the shared on-disk layout.

The reference's ``ssd_chunked`` masks L after its exp, so its gradient is
NaN once a chunk's decay sum passes ~88 (ROADMAP queue 3); the port masks
before the exp, and the SSD gradients are compared where the reference's
are finite.
"""
from __future__ import annotations

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
from repro_torch.optim import adamw
from repro_torch.runtime import train as port_train

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
TRAIN = ("granite_3_2b", "mamba2_370m")
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


def ported(arch):
    """Reference config and params (seed 0), the port's config and a
    Model loaded with those params, float32 compute."""
    cfg = ref_base.get_config(arch, smoke=True).replace(
        compute_dtype="float32")
    pcfg = port_base.get_config(arch, smoke=True).replace(
        compute_dtype="float32")
    params = _ref_params(arch)
    model = port_model.Model(pcfg, device="cpu")
    model.load_state_dict(params_from_reference(
        jax.tree.map(np.asarray, params)))
    return cfg, pcfg, params, model


def lm_batch(cfg, b, s, seed=0):
    rows = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    mask[0, : s // 4] = 0.0            # a masked prefix: the mean is weighted
    return {"tokens": rows[:, :-1], "targets": rows[:, 1:],
            "loss_mask": mask}


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


def loss_and_gradients(arch, seed):
    """At the smoke config and batch ``seed``: the reference's
    ``(total, metrics)`` and float32 gradients (under ``jit``), the port's
    float32 metrics and gradients, and the port's float64 gradients."""
    cfg, pcfg, params, model = ported(arch)
    batch = lm_batch(cfg, 2, 32, seed=seed)
    mesh = single_device_mesh()
    want, want_g = ref_jit(
        jax.value_and_grad(lambda p, b: ref_model.loss_fn(p, b, cfg, mesh),
                           has_aux=True), params,
        {k: jnp.asarray(v) for k, v in batch.items()})
    metrics, grads = train_step_grads(model, batch, pcfg, torch.float32)
    _, g64 = train_step_grads(model, batch, pcfg, torch.float64)
    return cfg, want, named(want_g), metrics, grads, g64


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
    cfg, (want_total, want_m), want, metrics, grads, g64 = \
        loss_and_gradients(arch, seed)
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
                                        ("mamba2_370m", 2)])
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


def test_train_step_rejects_a_batch_accum_does_not_divide():
    _, pcfg, _, model = ported("granite_3_2b")
    step = port_steps.make_train_step(pcfg, accum_steps=3, device="cpu")
    with pytest.raises(ValueError, match="accum_steps"):
        step(model.params, adamw.init(model.params),
             lm_batch(pcfg, 4, 16))


# ================================================================ trainer

def test_trainer_history_matches_reference_from_its_checkpoint(tmp_path):
    """The reference ``Trainer`` runs 8 steps from its seed-0 state; that
    state, written at step 0 by the reference's ``CheckpointManager``, is
    where the port's ``Trainer`` resumes.  The loss histories agree, and
    the port's step-8 checkpoint restores in the reference equal to the
    reference's own final state."""
    cfg = ref_base.get_config("granite_3_2b", smoke=True).replace(
        compute_dtype="float32")
    pcfg = port_base.get_config("granite_3_2b", smoke=True).replace(
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


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "whisper_medium"])
def test_training_raises_for_moe_and_encoders(arch, tmp_path):
    pcfg = port_base.get_config(arch, smoke=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_steps.make_train_step(pcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_train.Trainer(pcfg, DataConfig(vocab_size=pcfg.vocab_size,
                                            seq_len=16, global_batch=2),
                           port_train.TrainerConfig(ckpt_dir=str(tmp_path)),
                           device="cpu")


TRAIN_ALONE = """
import sys, tempfile
sys.modules["jax"] = None
sys.modules["repro"] = None
from repro_torch.launch import train
for arch in ("granite_3_2b", "mamba2_370m"):
    with tempfile.TemporaryDirectory() as d:
        assert train.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--steps", "3", "--batch", "4", "--seq", "32",
                           "--accum", "2", "--ckpt-every", "2",
                           "--ckpt-dir", d]) == 0
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
            _, _, want, _, grads, g64 = loss_and_gradients(arch, seed)
            dist = distances(want, grads, g64)
            ratios = [d_port / max(d_ref, np.finfo(np.float32).eps * scale)
                      for d_ref, d_port, scale in dist.values()]
            d_ref, d_port, scale = dist["embed"]
            print(f"{arch} seed {seed}: port/reference {min(ratios):.2f}"
                  f"-{max(ratios):.2f}; embed port {d_port / scale:.2e}, "
                  f"reference {d_ref / scale:.2e}")
