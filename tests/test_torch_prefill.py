"""The port's prefill path against the reference package.

``attention`` against the reference's train/prefill dispatch,
``ssm_apply`` against the reference's Mamba-2 block, and
``launch/steps.make_prefill_step`` / ``models.model.forward`` against
the reference's at the smoke configs of every family: dense, windowed,
Mamba-2, MoE, the hybrid, the encoder-decoder (frames through the
encoder, cross-attention) and the VLM (a vision prefix), both packages
loading the same weights (``params_from_reference``) and the same
numpy-seeded batch (``_torch_parity.batch_arrays``).  Float32 runs the
reference under ``jit`` (1e-4); bf16 runs it op by op
(``_torch_parity.run_ref``, 3e-2), because under ``jit`` XLA may skip a
bf16 rounding its code asks for (ROADMAP queue 3).  The reference's
``dense_attention`` (s <= 2 * kv_chunk) rounds P to bf16 before P V, where
its chunked and sliding-window branches and the port keep P in float32
(queue 3): qwen3, whisper (decoder and encoder) and jamba are held at
lengths that take the chunked branch, since rounded P moves qwen3's
routing and whisper's encoder memory past 3e-2.  The hybrid's bf16
prefill is compared sublayer by sublayer from the reference's inputs
(``test_hybrid_prefill``).

The reference's ``attention`` drops the sliding window when
``s > 2 * kv_chunk`` and ``s`` is not a multiple of the window: it then
calls ``chunked_attention``, which has no window argument
(``src/repro/models/attention.py:173-177``; ROADMAP queue 3).  The port
applies the window at every length, so windowed prefill is held to the
reference only where the reference applies it (s <= 2 * kv_chunk, or s a
multiple of the window) and to ``dense_attention(window=...)`` at the
other lengths (danube smoke at s = 80).
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

from repro.configs import base as ref_base
from repro.launch import steps as ref_steps
from repro.launch.mesh import single_device_mesh
from repro.models import attention as ref_attn
from repro.models import blocks as ref_blocks
from repro.models import model as ref_model
from repro.models import ssm as ref_ssm
from repro_torch.configs import base as port_base
from repro_torch.convert import params_from_reference
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import steps as port_steps
from repro_torch.models import attention as port_attn
from repro_torch.models import blocks as port_blocks
from repro_torch.models import model as port_model
from repro_torch.models import ssm as port_ssm
from repro_torch.runtime import train as port_train

from _torch_parity import (batch_arrays, drawn_params, op_by_op,
                           port_batch, ported, ref_batch, ref_params,
                           run_ref)
from _torch_parity import to_np as _np

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
PREFILL = ("granite_3_2b", "llama3_2_3b", "qwen1_5_110b", "h2o_danube_3_4b",
           "mamba2_370m",
           "mixtral_8x7b", "qwen3_moe_235b_a22b", "jamba_v0_1_52b",
           "whisper_medium", "internvl2_26b")
#: (compute dtype, tolerance): f32 under jit, bf16 op by op
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
#: ``tests/test_torch_train.py``'s float64 rule: each float32 side within
#: this factor of the other's distance from the port's float64 result
ORACLE_FACTOR = 8.0


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# ============================================================== attention

#: (S, window): the reference's branches at kv_chunk 32 — dense (64),
#: chunked (96, full attention), dense with a window (64), swa (96 and
#: 128, multiples of the window)
ATTN_POINTS = [(64, 0), (96, 0), (64, 32), (96, 32), (128, 32)]


@pytest.mark.parametrize("point", ATTN_POINTS)
@pytest.mark.parametrize("compute_dtype", sorted(TOL))
def test_attention_matches_reference_dispatch(point, compute_dtype):
    """The port's ``attention`` (the kernel's plain version on the CPU)
    against the reference's ``attention`` at kv_chunk 32, the smoke
    configs' own, through each of its branches."""
    s, window = point
    tol = TOL[compute_dtype]
    rng = np.random.default_rng(s + window)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((2, s, 4, 16), (2, s, 2, 16), (2, s, 2, 16)))
    dt = getattr(jnp, compute_dtype)
    want = run_ref(functools.partial(ref_attn.attention, causal=True,
                                     window=window, kv_chunk=32),
                   compute_dtype, *(jnp.asarray(a).astype(dt)
                                    for a in (q, k, v)))
    got = port_attn.attention(*(torch.tensor(a).to(getattr(torch,
                                                            compute_dtype))
                                for a in (q, k, v)), causal=True,
                              window=window)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_windowed_attention_where_the_reference_drops_the_window():
    """At s = 80 > 2 * kv_chunk, not a multiple of the window 32, the
    reference's ``attention`` runs ``chunked_attention`` without the
    window (off by 0.83 from the oracle on this input); the port keeps
    the window and equals ``dense_attention(window=32)``."""
    rng = np.random.default_rng(80)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((2, 80, 4, 16), (2, 80, 2, 16), (2, 80, 2, 16)))
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    dense = ref_attn.dense_attention(*jargs, causal=True, window=32)
    got = port_attn.attention(*map(torch.tensor, (q, k, v)), causal=True,
                              window=32)
    np.testing.assert_allclose(_np(got), _np(dense), rtol=2e-5, atol=2e-5)
    dropped = ref_attn.attention(*jargs, causal=True, window=32,
                                 kv_chunk=32)
    assert float(np.abs(_np(dropped) - _np(dense)).max()) > 0.1


# ==================================================================== ssm

@pytest.mark.parametrize("compute_dtype", sorted(TOL))
def test_ssm_apply_matches_reference(compute_dtype):
    """The Mamba-2 block at the smoke config, over 64 positions: y and
    the final state (f32 in both packages, 1e-4 in f32 and 3e-2 in
    bf16)."""
    tol = TOL[compute_dtype]
    cfg, pcfg, params, model = ported("mamba2_370m", compute_dtype)
    p_ref = {k: v[0] for k, v in params["blocks"]["sub0"]["mixer"].items()
             if k != "norm"}
    p_port = {k: v[0] for k, v in
              model.params["blocks"]["sub0"]["mixer"].items() if k != "norm"}
    x = np.random.default_rng(5).standard_normal((2, 64, cfg.d_model))
    dt = getattr(jnp, compute_dtype)
    y_want, s_want = run_ref(lambda p, xx: ref_ssm.ssm_apply(p, xx, cfg),
                             compute_dtype, p_ref,
                             jnp.asarray(x, jnp.float32).astype(dt))
    y, state = port_ssm.ssm_apply(p_port, torch.tensor(x).float().to(
        getattr(torch, compute_dtype)), pcfg)
    assert y.dtype == getattr(torch, compute_dtype)
    assert state.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(y_want), rtol=tol, atol=tol)
    np.testing.assert_allclose(state.numpy(), np.asarray(s_want), rtol=tol,
                               atol=tol)


def test_ssm_pieces_match_reference():
    """``ssm_dims``/``ssm_defs`` equal the reference's; the causal
    convolution sums in the reference's order (bit-equal in bf16)."""
    for arch in ("mamba2_370m", "jamba_v0_1_52b"):
        for smoke in (False, True):
            cfg = ref_base.get_config(arch, smoke=smoke)
            pcfg = port_base.get_config(arch, smoke=smoke)
            assert port_ssm.ssm_dims(pcfg) == ref_ssm.ssm_dims(cfg)
            want = {name: (d.shape, d.axes, d.init, d.scale) for name, d in
                    ref_ssm.ssm_defs(cfg).items()}
            got = {name: (d.shape, d.axes, d.init, d.scale) for name, d in
                   port_ssm.ssm_defs(pcfg).items()}
            assert got == want
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    with jax.disable_jit():
        want = ref_ssm._causal_conv(jnp.asarray(x).astype(jnp.bfloat16),
                                    jnp.asarray(w).astype(jnp.bfloat16))
    got = port_ssm._causal_conv(torch.tensor(x).bfloat16(),
                                torch.tensor(w).bfloat16())
    assert np.array_equal(_np(got), _np(want))


# ================================================================ prefill

#: (arch, batch, positions): danube at 64 and 96, mixtral at 64, where
#: the reference applies their window of 32; internvl2's 64 positions are
#: 8 of vision prefix and 56 tokens; qwen3 at 96 and whisper at 272 (68
#: encoder frames) take the reference's chunked branch (module
#: docstring); jamba in ``test_hybrid_prefill_matches_reference``
PREFILL_POINTS = [("granite_3_2b", 2, 64), ("llama3_2_3b", 2, 64),
                  ("qwen1_5_110b", 2, 64),
                  ("h2o_danube_3_4b", 2, 64),
                  ("h2o_danube_3_4b", 2, 96), ("mamba2_370m", 2, 64),
                  ("mixtral_8x7b", 2, 64), ("qwen3_moe_235b_a22b", 2, 96),
                  ("whisper_medium", 2, 272), ("internvl2_26b", 2, 64)]


@pytest.mark.parametrize("point", PREFILL_POINTS)
@pytest.mark.parametrize("compute_dtype", sorted(TOL))
def test_prefill_step_matches_reference(point, compute_dtype):
    arch, b, s = point
    tol = TOL[compute_dtype]
    cfg, pcfg, params, model = ported(arch, compute_dtype)
    batch = batch_arrays(cfg, b, s)
    want = run_ref(ref_steps.make_prefill_step(cfg, single_device_mesh()),
                   compute_dtype, params, ref_batch(batch))
    got = port_steps.make_prefill_step(pcfg, device="cpu")(
        model.params, port_batch(batch))
    assert got.shape == (b, 1, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("compute_dtype", sorted(TOL))
def test_prefill_step_matches_reference_at_drawn_leaves(compute_dtype):
    """qwen1.5's prefill step with every leaf drawn (``drawn_params``):
    its q/k/v biases are 0 at seed-0 leaves.  96 positions take the
    reference's chunked branch: at 64 its ``dense_attention`` rounds P to
    bf16 (ROADMAP queue 3), which at these leaves puts 8.6% of the bf16
    logits outside the band (0.094 at most)."""
    tol = TOL[compute_dtype]
    cfg, pcfg, params, model = ported(
        "qwen1_5_110b", compute_dtype, drawn_params("qwen1_5_110b", 6))
    batch = batch_arrays(cfg, 2, 96, seed=2)
    want = run_ref(ref_steps.make_prefill_step(cfg, single_device_mesh()),
                   compute_dtype, params, ref_batch(batch))
    got = port_steps.make_prefill_step(pcfg, device="cpu")(
        model.params, port_batch(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


#: the families' prefill at drawn leaves: (arch, positions, compute
#: dtype), the positions as in ``PREFILL_POINTS``; jamba in float32 only
#: (its bf16 check is sublayer by sublayer, op by op: a minute or more,
#: and a swapped or misplaced drawn leaf shows in float32 alike)
DRAWN_POINTS = [(arch, s, dt) for arch, s in (("whisper_medium", 272),
                                              ("mamba2_370m", 64))
                for dt in sorted(TOL)] + [("jamba_v0_1_52b", 96, "float32")]


@pytest.mark.parametrize("point", DRAWN_POINTS,
                         ids=lambda p: f"{p[2]}-{p[0]}")
def test_family_prefill_matches_reference_at_drawn_leaves(point):
    """whisper's, mamba2's and jamba's prefill with every leaf drawn
    (``drawn_params``: the q/k/v biases, norm scales and Mamba-2's
    ``dt_bias``, ``A_log`` and ``D`` at c + 0.1 N), at the tolerance of
    the seed-0 tests above: the prefill step.  A float32 logit
    beyond ``TOL`` of the reference's is held by the float64 rule of
    ``tests/test_torch_train.py`` (the port's float64 evaluation the
    oracle, each side's distance from it within ``ORACLE_FACTOR`` of the
    other's): whisper's 272 positions put 4 of 512 logits up to 1.46e-4
    from the reference's at max |logit| 3.18, the reference 6.3e-5 and the
    port 1.18e-4 from the float64 logits (ROADMAP queue 3)."""
    arch, s, compute_dtype = point
    tol = TOL[compute_dtype]
    cfg, pcfg, params, model = ported(arch, compute_dtype,
                                      drawn_params(arch, 7))
    batch = batch_arrays(cfg, 2, s, seed=3)
    want = np.asarray(run_ref(ref_steps.make_prefill_step(
        cfg, single_device_mesh()), compute_dtype, params, ref_batch(batch)))
    got = port_steps.make_prefill_step(pcfg, device="cpu")(
        model.params, port_batch(batch)).numpy()
    if compute_dtype != "float32" or np.allclose(got, want, rtol=tol,
                                                 atol=tol):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        return
    exact = port_steps.make_prefill_step(
        pcfg.replace(compute_dtype="float64"), device="cpu")(
            port_blocks.tree_map(lambda t: t.double(), model.params),
            {k: v.double() if v.is_floating_point() else v
             for k, v in port_batch(batch).items()}).numpy()
    d_ref, d_port = np.abs(want - exact).max(), np.abs(got - exact).max()
    scale = np.abs(exact).max()
    assert d_ref <= max(tol * scale, ORACLE_FACTOR * d_port), (d_ref, d_port)
    assert d_port <= ORACLE_FACTOR * max(
        d_ref, np.finfo(np.float32).eps * scale), (d_port, d_ref)


@pytest.mark.parametrize("arch", PREFILL)
def test_forward_matches_reference(arch):
    """Every position's logits, float32, and the aux loss (the router
    loss summed over the MoE sublayers, within 1e-6; 0 without MoE).
    2e-4: the largest of 2 x 64 x V logits, whose float32 sums
    (projections, softmax, norms) run in other orders in the two
    packages; the last position alone meets 1e-4 above."""
    cfg, pcfg, params, model = ported(arch, "float32")
    batch = batch_arrays(cfg, 2, 64, seed=1)
    want, want_aux = run_ref(
        lambda p, bb: ref_model.forward(p, bb, cfg, single_device_mesh()),
        "float32", params, ref_batch(batch))
    got, aux = port_model.forward(model.params, port_batch(batch), pcfg,
                                  device="cpu")
    assert got.shape == (2, 64 - cfg.vision_prefix, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    if any(f == "moe" for _, f in cfg.pattern):
        assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)
    else:
        assert aux == float(want_aux) == 0.0


@pytest.mark.parametrize("compute_dtype", sorted(TOL))
def test_hybrid_prefill_matches_reference(compute_dtype):
    """jamba smoke (one period: 7 Mamba-2 layers and one attention layer,
    MoE at the odd ones), 2 x 96.  Float32: the prefill step's logits.
    bf16: each sublayer from the reference's input to it, because the
    whole stack compounds a few bf16 flips (the scan's float32 sums run
    in other orders) into a MoE router's near tie, and one flipped expert
    moves a row by 2.7 (at magnitude 46) from sublayer 3 on.  96
    positions: the reference's chunked attention branch (P in float32)."""
    tol = TOL[compute_dtype]
    cfg, pcfg, params, model = ported("jamba_v0_1_52b", compute_dtype)
    mesh = single_device_mesh()
    batch = batch_arrays(cfg, 2, 96)
    if compute_dtype == "float32":
        want = run_ref(ref_steps.make_prefill_step(cfg, mesh), "float32",
                       params, ref_batch(batch))
        got = port_steps.make_prefill_step(pcfg, device="cpu")(
            model.params, port_batch(batch))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)
        return
    pos = np.broadcast_to(np.arange(96), (2, 96))
    bp = jax.tree.map(lambda a: a[0], params["blocks"])
    bpp = port_model.block_layers(model.params["blocks"])[0]
    with mesh, op_by_op(compute_dtype):
        x = ref_model.build_inputs(params, ref_batch(batch), cfg, mesh)
    for i, (mixer, ffn) in enumerate(cfg.pattern):
        with mesh, op_by_op(compute_dtype):
            want, want_aux = ref_model.sublayer_apply(
                bp[f"sub{i}"], x, mixer, ffn, cfg, mesh, jnp.asarray(pos))
        with torch.no_grad():
            got, aux = port_model.sublayer_apply(
                bpp[f"sub{i}"], torch.tensor(_np(x)).bfloat16(), mixer, ffn,
                pcfg, torch.tensor(pos))
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
        assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)
        x = want


def test_danube_prefill_where_the_reference_drops_the_window(monkeypatch):
    """Danube smoke at s = 80: the reference's own ``attention`` would drop
    the window here, so the port is held to the reference with its
    attention replaced by ``dense_attention(window=...)``, which applies
    it."""
    cfg, pcfg, params, model = ported("h2o_danube_3_4b", "float32")
    tok = tokens(cfg, 2, 80, seed=2)

    def dense(q, k, v, *, causal=True, window=0, kv_chunk=1024,
              q_offset=None):
        return ref_attn.dense_attention(q, k, v, causal=causal,
                                        window=window)
    monkeypatch.setattr(ref_model.attn, "attention", dense)
    want = run_ref(ref_steps.make_prefill_step(cfg, single_device_mesh()),
                   "float32", params, {"tokens": jnp.asarray(tok)})
    got = port_steps.make_prefill_step(pcfg, device="cpu")(
        model.params, {"tokens": torch.tensor(tok)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


# ========================================================= what runs where

@pytest.mark.parametrize("arch", ref_base.ARCH_IDS)
def test_model_holds_every_config_and_convert_carries_it(arch):
    """``Model`` takes every smoke config, and ``params_from_reference``
    carries the reference's tree across: every name, shape and value."""
    cfg = ref_base.get_config(arch, smoke=True)
    tree = jax.tree.map(np.asarray, ref_params(arch))
    model = port_model.Model(port_base.get_config(arch, smoke=True),
                             device="cpu")
    state = params_from_reference(tree)
    model.load_state_dict(state)          # strict: no name missing or extra
    assert port_blocks.count_params(port_model.model_defs(model.cfg)) == \
        ref_blocks.count_params(ref_model.model_defs(cfg))
    for name, leaf in port_blocks.tree_leaves(tree):
        assert np.array_equal(model.state_dict()[name].numpy(), leaf)


@pytest.mark.parametrize("arch", ["whisper_medium", "internvl2_26b"])
def test_forward_raises_for_moe_encoders_and_vision(arch, tmp_path):
    """The encoder's and the vision prefix's forward runs and so does
    their loss; the ``Trainer`` raises for them, naming the input its
    data pipeline lacks (MoE's training in ``tests/test_torch_moe.py``)."""
    pcfg = port_base.get_config(arch, smoke=True)
    model = port_model.Model(pcfg, device="cpu")
    batch = port_batch(batch_arrays(pcfg, 1, 16))
    x, aux = port_model.forward_hidden(model.params, batch, pcfg,
                                       device="cpu")
    assert x.shape == (1, 16 - pcfg.vision_prefix, pcfg.d_model)
    total, _ = port_model.loss_fn(model.params, {**batch,
                                                 "targets": batch["tokens"]},
                                  pcfg, device="cpu")
    assert torch.isfinite(total)
    with pytest.raises(NotImplementedError,
                       match="frames" if pcfg.enc_layers else "vision_embed"):
        port_train.Trainer(pcfg, DataConfig(vocab_size=pcfg.vocab_size,
                                            seq_len=16, global_batch=2),
                           port_train.TrainerConfig(ckpt_dir=str(tmp_path)),
                           device="cpu")


def test_shape_table_is_the_reference_data():
    assert port_steps.SHAPE_TABLE == ref_steps.SHAPE_TABLE


def test_prefill_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    pcfg = port_base.get_config("granite_3_2b", smoke=True)
    with pytest.raises(RuntimeError, match="cuda"):
        port_steps.make_prefill_step(pcfg)
    model = port_model.Model(pcfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        port_model.forward_hidden(model.params,
                                  {"tokens": torch.zeros((1, 4), dtype=int)},
                                  pcfg)


PREFILL_ALONE = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import torch
from repro_torch.configs.base import get_config
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models.model import Model
for arch in ("granite_3_2b", "h2o_danube_3_4b", "mamba2_370m", "jamba_v0_1_52b",
             "whisper_medium", "internvl2_26b"):
    cfg = get_config(arch, smoke=True)
    model = Model(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 40), generator=gen)}
    if cfg.vision_prefix:
        batch["vision_embed"] = torch.randn(2, cfg.vision_prefix, cfg.d_model, generator=gen)
    if cfg.enc_layers:
        batch["frames"] = torch.randn(2, 10, cfg.d_model, generator=gen)
    out = make_prefill_step(cfg, device="cpu")(model.params, batch)
    assert out.shape == (2, 1, cfg.vocab_size) and bool(torch.isfinite(out).all())
assert not any(m.startswith(("jax.", "repro.")) for m in sys.modules)
print("ok")
"""


def test_prefill_path_runs_with_jax_and_repro_absent():
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", PREFILL_ALONE], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "ok"


@pytest.mark.gpu
@pytest.mark.parametrize("point", PREFILL_POINTS)
def test_cuda_prefill_matches_cpu_on_card(point):
    """The card's prefill (both kernels) against the CPU's plain path,
    float32 with TF32 off, within 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arch, b, s = point
    _, pcfg, _, model = ported(arch, "float32")
    card = port_model.Model(pcfg, device="cuda")
    card.load_state_dict(model.state_dict())
    batch = port_batch(batch_arrays(pcfg, b, s))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = port_steps.make_prefill_step(pcfg)(
            card.params, {k: v.cuda() for k, v in batch.items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    want = port_steps.make_prefill_step(pcfg, device="cpu")(
        model.params, batch)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)
