"""The port's LM decode path against the reference package.

Configs are held equal field by field, parameter counts equal for all
ten architectures, the elementwise blocks and attention within float32
rounding, and ``decode_forward`` over eight continuous-batching steps
(per-row positions) at the smoke configs of every family that decodes
with per-row positions (dense, sliding-window, MoE, Mamba-2, hybrid,
VLM), both packages loading the same weights
(``params_from_reference``).  The encoder-decoder, the Mamba-2 step and
the cache trees are in ``tests/test_torch_decode.py``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.launch.mesh import single_device_mesh
from repro.models import attention as ref_attn
from repro.models import blocks as ref_blocks
from repro.models import model as ref_model
from repro_torch.configs import base as port_base
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import attention as port_attn
from repro_torch.models import blocks as port_blocks
from repro_torch.launch import steps as port_steps
from repro_torch.models import model as port_model
from repro_torch.runtime import train as port_train

from _torch_parity import drawn_params, op_by_op, ported
from _torch_parity import to_np as _np

DENSE = ("granite_3_2b", "llama3_2_3b", "qwen1_5_110b")
#: every architecture whose reference decodes with per-row positions
#: (whisper's reference takes one position for the batch: queue 3)
DECODE = DENSE + ("h2o_danube_3_4b", "mamba2_370m", "mixtral_8x7b",
                  "qwen3_moe_235b_a22b", "jamba_v0_1_52b", "internvl2_26b")


# ================================================================ configs

@pytest.mark.parametrize("arch", ref_base.ARCH_IDS)
def test_configs_equal_reference(arch):
    for smoke in (False, True):
        want = ref_base.get_config(arch, smoke=smoke)
        got = port_base.get_config(arch, smoke=smoke)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.hd, got.n_blocks) == (want.hd, want.n_blocks)
    assert port_base.ARCH_IDS == ref_base.ARCH_IDS


@pytest.mark.parametrize("arch", ref_base.ARCH_IDS)
def test_count_params_equal_reference(arch):
    """Definitions only: nothing is allocated at the full configs."""
    for smoke in (False, True):
        cfg = ref_base.get_config(arch, smoke=smoke)
        pcfg = port_base.get_config(arch, smoke=smoke)
        assert port_blocks.count_params(port_model.model_defs(pcfg)) == \
            ref_blocks.count_params(ref_model.model_defs(cfg))


def test_granite_full_width_count():
    cfg = port_base.get_config("granite_3_2b")
    assert port_blocks.count_params(port_model.model_defs(cfg)) == \
        2_634_201_088


@pytest.mark.parametrize("arch", DENSE)
def test_model_state_names_and_layouts_are_the_reference_tree(arch):
    cfg, _, params, model = ported(arch)
    want = {name: tuple(np.shape(leaf)) for name, leaf in
            port_blocks.tree_leaves(jax.tree.map(np.asarray, params))}
    got = {name: tuple(p.shape) for name, p in model.state_dict().items()}
    assert got == want
    assert model.params["blocks"]["sub0"]["mixer"]["wq"].shape == (
        cfg.n_blocks, cfg.d_model, cfg.n_heads, cfg.hd)
    assert not any(p.requires_grad for p in model.parameters())


def test_init_params_scheme():
    """zeros / ones as named; normal with std 1/sqrt(shape[-2]) or the
    ``scale`` override, drawn on the generator's device."""
    defs = {"a": port_blocks.ParamDef((512, 256), ("x", "y")),
            "b": port_blocks.ParamDef((4096,), ("x",), init="ones"),
            "c": port_blocks.ParamDef((64, 64), ("x", "y"), init="zeros"),
            "d": port_blocks.ParamDef((256, 512), ("x", "y"), scale=0.02)}
    out = port_blocks.init_params(defs, torch.Generator().manual_seed(0))
    assert out["a"].std().item() == pytest.approx(1 / 512 ** 0.5, rel=0.02)
    assert out["d"].std().item() == pytest.approx(0.02, rel=0.02)
    assert (out["b"] == 1).all() and (out["c"] == 0).all()
    again = port_blocks.init_params(defs, torch.Generator().manual_seed(0))
    assert torch.equal(out["a"], again["a"])


@pytest.mark.parametrize("arch", ["whisper_medium", "internvl2_26b"])
def test_later_slices_raise(arch, tmp_path):
    """``Model`` holds every configuration, and every one decodes and
    builds a train step; the ``Trainer`` raises for the encoder-decoder
    and the VLM, whose ``frames`` or ``vision_embed`` its data pipeline
    does not carry (nor does the reference's)."""
    cfg = port_base.get_config(arch, smoke=True)
    model = port_model.Model(cfg, device="cpu")
    caches = port_model.init_caches(cfg, 1, 8, device="cpu")
    logits, _ = port_model.decode_forward(model.params, caches,
                                          torch.tensor([[1]]), 0, cfg,
                                          device="cpu")
    assert logits.shape == (1, 1, cfg.vocab_size)
    assert callable(port_steps.make_train_step(cfg, device="cpu"))
    with pytest.raises(NotImplementedError, match="data pipeline"):
        port_train.Trainer(cfg, DataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=16, global_batch=2),
                           port_train.TrainerConfig(ckpt_dir=str(tmp_path)),
                           device="cpu")


# ================================================================ blocks

def test_blocks_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    np.testing.assert_allclose(
        port_blocks.rms_norm(torch.tensor(x), torch.tensor(scale),
                             1e-5).numpy(),
        np.asarray(ref_blocks.rms_norm(jnp.asarray(x), jnp.asarray(scale),
                                       1e-5)), rtol=1e-6, atol=1e-6)
    q = rng.standard_normal((3, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 200, (3, 5))
    for theta in (1e4, 5e5):
        np.testing.assert_allclose(
            port_blocks.rope(torch.tensor(q), torch.tensor(pos),
                             theta).numpy(),
            np.asarray(ref_blocks.rope(jnp.asarray(q), jnp.asarray(pos),
                                       theta)), rtol=1e-6, atol=1e-6)
    wi, wg, wo = (rng.standard_normal(s).astype(np.float32) / 8
                  for s in ((64, 128), (64, 128), (128, 64)))
    np.testing.assert_allclose(
        port_blocks.swiglu(torch.tensor(x), *map(torch.tensor, (wi, wg, wo)),
                           torch.float32).numpy(),
        np.asarray(ref_blocks.swiglu(jnp.asarray(x),
                                     *map(jnp.asarray, (wi, wg, wo)),
                                     jnp.float32)), rtol=1e-6, atol=1e-6)


def test_bf16_blocks_round_where_the_reference_rounds():
    """In bf16 the port's norm, rope and SwiGLU equal the reference run
    op by op, bit for bit."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    xb, xt = jnp.asarray(x).astype(jnp.bfloat16), \
        torch.tensor(x).bfloat16()
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    assert np.array_equal(
        _np(port_blocks.rms_norm(xt, torch.tensor(scale), 1e-5)),
        _np(ref_blocks.rms_norm(xb, jnp.asarray(scale), 1e-5)))
    q = rng.standard_normal((3, 1, 4, 16)).astype(np.float32)
    pos = np.array([[0], [3], [700]])
    assert np.array_equal(
        _np(port_blocks.rope(torch.tensor(q).bfloat16(), torch.tensor(pos),
                             1e4)),
        _np(ref_blocks.rope(jnp.asarray(q).astype(jnp.bfloat16),
                            jnp.asarray(pos), 1e4)))
    wi, wg, wo = (rng.standard_normal(s).astype(np.float32) / 8
                  for s in ((64, 128), (64, 128), (128, 64)))
    with jax.disable_jit():
        want = ref_blocks.swiglu(xb, *map(jnp.asarray, (wi, wg, wo)),
                                 jnp.bfloat16)
    assert np.array_equal(
        _np(port_blocks.swiglu(xt, *map(torch.tensor, (wi, wg, wo)),
                               torch.bfloat16)), _np(want))


# ============================================================== attention

def test_dense_and_decode_attention_match_reference():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 6, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 6, 2, 16)).astype(np.float32)
    for causal, window in ((True, 0), (False, 0), (True, 3)):
        np.testing.assert_allclose(
            port_attn.dense_attention(*map(torch.tensor, (q, k, v)),
                                      causal=causal, window=window).numpy(),
            np.asarray(ref_attn.dense_attention(
                *map(jnp.asarray, (q, k, v)), causal=causal,
                window=window)), rtol=1e-5, atol=1e-5)
    kv_len = np.array([1, 6], np.int32)
    qd = q[:, :1]
    for kl in (kv_len, None):
        np.testing.assert_allclose(
            port_attn.decode_attention(
                *map(torch.tensor, (qd, k, v)),
                kv_len=None if kl is None else torch.tensor(kl)).numpy(),
            np.asarray(ref_attn.decode_attention(
                *map(jnp.asarray, (qd, k, v)),
                kv_len=None if kl is None else jnp.asarray(kl))),
            rtol=2e-5, atol=2e-5)
    # a window no shorter than the cache excludes nothing (the port's
    # rolling buffers); a cache longer than the window is not the port's
    np.testing.assert_allclose(
        port_attn.decode_attention(*map(torch.tensor, (qd, k, v)),
                                   kv_len=torch.tensor(kv_len),
                                   window=6).numpy(),
        np.asarray(ref_attn.decode_attention(
            *map(jnp.asarray, (qd, k, v)), kv_len=jnp.asarray(kv_len),
            window=6)), rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="window"):
        port_attn.decode_attention(*map(torch.tensor, (qd, k, v)),
                                   kv_len=torch.tensor(kv_len), window=4)


# ========================================================= decode_forward

#: (compute dtype, logits tolerance).  Float32: 1e-3, because the bf16
#: cache may round one k/v element the other way after float32 products
#: summed in another order.  Bfloat16: 3e-2.
DECODE_TOL = {"float32": 1e-3, "bfloat16": 3e-2}


def assert_caches_close(pc, rc, tol):
    """Every cache leaf of the port against the reference's, in the
    reference's dtype.  bf16 leaves (k, v, conv): every element within ``tol`` or, where a value rounded
    the other way into bf16, within one bf16 ulp (2^-7 relative at most),
    such flips under 1%.  The float32 SSM state within ``tol`` times its
    largest magnitude (at least 1): a conv input that rounded the other
    way into the bf16 conv cache, or a k/v flip upstream, reaches every
    element of a state through dt B x (jamba's float32 state: 4.3e-3 off
    at magnitudes to 25)."""
    for sub, layer in rc["layers"].items():
        for name, want in layer.items():
            got = pc["layers"][sub][name]
            assert tuple(got.shape) == tuple(want.shape), (sub, name)
            g, w = _np(got), _np(want)
            if name == "state":
                assert got.dtype == torch.float32
                assert np.abs(g - w).max() <= tol * max(1.0, np.abs(w).max())
                continue
            assert str(got.dtype).split(".")[-1] == str(want.dtype)
            close = np.abs(g - w) <= tol + tol * np.abs(w)
            flips = np.abs(g - w) <= 2.0 ** -7 * np.abs(w)
            assert (close | flips).all(), (sub, name)
            assert (~close).mean() < 1e-2, (sub, name)


@pytest.mark.parametrize("arch", DECODE)
@pytest.mark.parametrize("compute_dtype", sorted(DECODE_TOL))
def test_decode_forward_matches_reference(arch, compute_dtype):
    """Eight decode steps with per-row positions from both packages.

    The bf16 reference runs op by op (``_torch_parity.op_by_op``): under
    ``jit`` XLA may keep excess precision inside a fusion and skip a bf16
    rounding its code asks for, so its bf16 results depend on how XLA
    fuses.  Caches: ``assert_caches_close``.  Positions stay inside
    danube's window of 32 (past it, see ``tests/test_torch_decode.py``).
    """
    decode_parity(*ported(arch, compute_dtype), compute_dtype)


@pytest.mark.parametrize("compute_dtype", sorted(DECODE_TOL))
def test_decode_forward_matches_reference_at_drawn_leaves(compute_dtype):
    """qwen1.5's eight decode steps with every leaf drawn
    (``drawn_params``): at seed-0 leaves its q/k/v biases are 0, so only
    drawn leaves test them."""
    params = drawn_params("qwen1_5_110b", 5)
    assert float(jnp.abs(params["blocks"]["sub0"]["mixer"]["bk"]).min()) > 0
    decode_parity(*ported("qwen1_5_110b", compute_dtype, params),
                  compute_dtype)


@pytest.mark.parametrize("compute_dtype", sorted(DECODE_TOL))
@pytest.mark.parametrize("arch", ["mamba2_370m", "jamba_v0_1_52b"])
def test_ssm_decode_matches_reference_at_drawn_leaves(arch, compute_dtype):
    """mamba2's and jamba's eight decode steps with every leaf drawn
    (``drawn_params``): at seed-0 leaves ``dt_bias`` and ``A_log`` are 0
    and ``D`` and the norm scales (``gnorm`` among them) 1, so only drawn
    leaves test them.  The caches are in the compute dtype: in float32 a
    bf16 cache element that rounds the other way after float32 sums in
    other orders moves jamba's logits by 0.036 here, the rounding
    ``DECODE_TOL`` allows for at seed-0 leaves."""
    params = drawn_params(arch, 7)
    mixer = next(sub["mixer"] for sub in params["blocks"].values()
                 if "A_log" in sub["mixer"])
    for name in ("dt_bias", "A_log"):
        assert float(jnp.abs(mixer[name]).min()) > 0
    assert float(jnp.abs(mixer["D"] - 1).min()) > 0
    decode_parity(*ported(arch, compute_dtype, params), compute_dtype,
                  cache_dtype=compute_dtype)


def decode_parity(cfg, pcfg, params, model, compute_dtype,
                  cache_dtype="bfloat16"):
    tol = DECODE_TOL[compute_dtype]
    mesh = single_device_mesh()
    b, s = 3, 32
    rc = ref_model.init_caches(cfg, b, s, dtype=getattr(jnp, cache_dtype))
    pc = port_model.init_caches(pcfg, b, s, dtype=getattr(torch, cache_dtype),
                                device="cpu")
    rng = np.random.default_rng(0)
    pos = np.array([0, 3, 7], np.int32)

    def ref_step(p, c, t, st):
        return ref_model.decode_forward(p, c, t, st, cfg, mesh,
                                        batch_shardable=False)
    if compute_dtype == "float32":
        ref_step = jax.jit(ref_step)
    for _ in range(8):
        tok = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        with mesh, op_by_op(compute_dtype):
            want, rc = ref_step(params, rc, jnp.asarray(tok),
                                jnp.asarray(pos))
        got, pc = port_model.decode_forward(
            model.params, pc, torch.tensor(tok).long(), pos, pcfg,
            device="cpu")
        assert got.shape == (b, 1, cfg.vocab_size) and \
            got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)
        pos = pos + 1
    assert_caches_close(pc, rc, tol)


def test_decode_forward_scalar_step_and_range():
    """The scalar-position branch writes every row's slot; positions
    outside the cache raise instead of clamping."""
    _, pcfg, _, model = ported("granite_3_2b", "float32")
    caches = port_model.init_caches(pcfg, 2, 8, device="cpu")
    tok = torch.tensor([[1], [2]])
    port_model.decode_forward(model.params, caches, tok, 5, pcfg,
                              device="cpu")
    k = caches["layers"]["sub0"]["k"]
    assert (k[:, :, 5] != 0).any(dim=-1).all()
    assert (k[:, :, :5] == 0).all() and (k[:, :, 6:] == 0).all()
    for bad in (8, -1, np.array([0, 8])):
        with pytest.raises(IndexError):
            port_model.decode_forward(model.params, caches, tok, bad, pcfg,
                                      device="cpu")


def test_decode_forward_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, pcfg, _, model = ported("granite_3_2b")
    caches = port_model.init_caches(pcfg, 1, 8, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        port_model.decode_forward(model.params, caches,
                                  torch.tensor([[1]]), 0, pcfg)
    with pytest.raises(RuntimeError, match="cuda"):
        port_model.Model(pcfg)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", DECODE[2:] + ("whisper_medium",))
def test_cuda_decode_matches_cpu_on_card(arch):
    """Eight decode steps of each newly served family on the card
    (flash_decode's SIMT variant) against the CPU's plain path, float32
    with float32 caches and TF32 off, within 1e-3: a bf16 cache element
    that rounds the other way on one device moves mamba2's, jamba's and
    qwen3's logits past 1e-3 (``chip_smoke.serve_cross``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, pcfg, _, model = ported(arch, "float32")
    card = port_model.Model(pcfg, device="cuda")
    card.load_state_dict(model.state_dict())
    b, s = 3, 32
    caches = {dev: port_model.init_caches(pcfg, b, s, dtype=torch.float32,
                                          device=dev)
              for dev in ("cpu", "cuda")}
    rng = np.random.default_rng(0)
    pos = np.array([0, 3, 7], np.int32)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for _ in range(8):
            tok = torch.tensor(rng.integers(0, pcfg.vocab_size, (b, 1)))
            got, _ = port_model.decode_forward(card.params, caches["cuda"],
                                               tok.cuda(), pos, pcfg)
            want, _ = port_model.decode_forward(model.params, caches["cpu"],
                                                tok, pos, pcfg, device="cpu")
            torch.testing.assert_close(got.cpu(), want, rtol=1e-3,
                                       atol=1e-3)
            pos = pos + 1
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
