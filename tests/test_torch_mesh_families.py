"""The port's serve step on a mesh for every family beyond the dense
decoder, against the reference package.

- Three decode steps of the mixtral, qwen3-MoE, mamba2, jamba, whisper
  and internvl2 smoke configs through ``make_serve_step`` on gloo
  ranks: (1, 4) with the sequence over ``model`` and (2, 2) with the
  batch over ``data``, float32 and bf16 under ``xla``; (1, 4) under
  ``gleam_tree``; mixtral and jamba on (2, 2) with whole rows and on
  (1, 8), where their 4 experts run in ``"etp"`` mode (the (1, 4) and
  (2, 2) cases run ``"ep"``).  Logits of every step and every final
  cache leaf (k, v, the Mamba-2 conv window and state, the encoder
  memory) within ``SERVE_TOL`` of the reference's serve step on the same
  mesh (1e-4 float32, 2e-2 bf16), and in float32 within 1e-5 of the port
  on one device (jamba and whisper within ``ONE_DEVICE_TOL``).
- jamba and whisper in float64 against the port on one device in
  float64: their float32 runs' larger distance is rounding.
- The split Mamba-2 step's gated norm and conv cache, each against a
  wrong version the sublayer band must tell apart (the norm taken per
  rank, the window written from the rank's channels only).
- The MoE's reference specs (``moe._specs``) against the plan's, and
  mixtral and jamba on a (1, 1) mesh bit for bit ``decode_forward``
  without one.

Parameters are drawn with every leaf random
(``_torch_mesh_cases.drawn_params``), every cache leaf filled from a
seed.  The reference runs once per module, in three subprocesses side by
side (``REF_GROUPS``), each on 8 host devices, under ``jit`` with ``--xla_allow_excess_precision=false`` (as
``tests/test_torch_mesh.py`` runs it), beside the port's 4-rank and
8-rank gloo worlds (``tests/_torch_dist.py``: under its lock, each limit
``MARGIN`` times the time measured alone).
"""
from __future__ import annotations

import functools
import os

import numpy as np
import pytest
import torch

import _torch_mesh_cases as cases
from _torch_dist import (exclusive, limit, merged, run, start_references,
                         start_world)
from repro_torch.configs import base as port_base
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import steps as port_steps
from repro_torch.models import blocks as port_blocks
from repro_torch.models import model as port_model
from repro_torch.models import moe as port_moe
from repro_torch.models import ssm as port_ssm
from repro_torch.parallel import sharding as port_sharding

#: (compute dtype, tolerance against the reference on the same mesh)
SERVE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: seconds each world and the reference took with this module alone on an
#: 8-CPU host, the largest of the runs measured (their limits are
#: ``_torch_dist.limit`` of these: ``MARGIN`` times, at least
#: ``MIN_LIMIT``)
ALONE = {"families4": 35.3, "families8": 35.3, "reference": 75.3}

REF_SRC = r"""
import os, pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
import _torch_mesh_cases as cases
from repro.configs.base import get_config
from repro.launch import steps as ref_steps
from repro.models import model as mdl

workdir = sys.argv[1]


def unflatten(flat):
    tree = {}
    for name, leaf in flat.items():
        node = tree
        *path, last = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


out = {}
for key, arch, shape, bs, sched, dt in cases.family_cases():
    if arch not in GROUP:
        continue
    cfg = get_config(arch, smoke=True).replace(compute_dtype=dt,
                                               collective_schedule=sched)
    data = np.load(os.path.join(workdir, f"family_{arch}.npz"))
    params = unflatten({k[2:]: jnp.asarray(data[k]) for k in data
                        if k.startswith("p:")})
    for sub in params["blocks"].values():
        sub.setdefault("ffn", {})       # a sublayer without an ffn
    cdt = jnp.float32 if dt == "float32" else jnp.bfloat16
    caches = mdl.init_caches(cfg, cases.SERVE_BATCH, cases.SERVE_SEQ,
                             dtype=cdt)
    caches = unflatten({n: jnp.asarray(data[f"c:{n}"]).astype(leaf.dtype)
                        for n, leaf in leaves(caches)})
    n = shape[0] * shape[1]
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape),
                ("data", "model"))
    serve = jax.jit(ref_steps.make_serve_step(cfg, mesh, bs))
    logits = []
    with mesh:
        for i in range(cases.SERVE_STEPS):
            lg, caches = serve(params, caches,
                               jnp.asarray(data["tokens"][i]),
                               jnp.int32(cases.FAMILY_START[arch] + i))
            logits.append(np.asarray(lg))
    out[key] = {"logits": np.stack(logits),
                **{f"c:{n}": np.asarray(t.astype(jnp.float32))
                   for n, t in leaves(caches)}}

with open(os.path.join(workdir, f"{NAME}_0.pkl"), "wb") as fh:
    pickle.dump(out, fh)
"""


#: the reference's cases by arch, one process a group, side by side
REF_GROUPS = (("jamba_v0_1_52b",), ("mixtral_8x7b", "qwen3_moe_235b_a22b"),
              ("mamba2_370m", "whisper_medium", "internvl2_26b"))


def _structs(cfg):
    """``{dotted cache leaf: whole shape}`` of the serve caches."""
    return {n: sd[0] for n, sd in port_blocks.tree_leaves(
        port_model.cache_structs(cfg, cases.SERVE_BATCH, cases.SERVE_SEQ))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference on 8 host devices and the port's family cases in a
    4-rank and an 8-rank gloo world, started together."""
    workdir = tmp_path_factory.mktemp("families")
    for arch in cases.FAMILY_ARCHES:
        cfg = port_base.get_config(arch, smoke=True)
        params = cases.drawn_params(list(port_blocks.tree_leaves(
            port_model.model_defs(cfg))))
        np.savez(workdir / f"family_{arch}.npz",
                 **{f"p:{k}": v for k, v in params.items()},
                 **cases.family_inputs(cfg, _structs(cfg),
                                       cases.FAMILY_START[arch]))
    with exclusive():
        refs = start_references(
            "reference", REF_SRC, REF_GROUPS, 8, workdir,
            timeout=limit(ALONE["reference"]),
            xla_flags="--xla_allow_excess_precision=false "
                      "--xla_backend_optimization_level=0")
        worlds = [start_world("families", n, workdir,
                              timeout=limit(ALONE[f"families{n}"]))
                  for n in (4, 8)]
        run(*worlds, *refs)
    port, port64, pieces = {}, {}, {}
    for w in worlds:
        for r in range(len(w.procs)):
            got = w.result(r)
            if r == 0:
                port.update(got["serve"])
                port64.update(got["float64"])
            for key, res in got["pieces"].items():
                pieces.setdefault(key, []).append(res)
    return {"port": port, "port64": port64, "pieces": pieces,
            "ref": merged(refs), "dir": workdir}


@functools.lru_cache(maxsize=None)
def one_device(arch, workdir, dtype="float32"):
    """The port on one device (``mesh=None``) in ``dtype``: the logits of
    the three steps and the final cache leaves."""
    cfg = port_base.get_config(arch, smoke=True).replace(compute_dtype=dtype)
    data = np.load(os.path.join(workdir, f"family_{arch}.npz"))
    model = port_model.Model(cfg, device="cpu")
    model.load_state_dict({k[2:]: torch.from_numpy(data[k]) for k in data
                           if k.startswith("p:")})
    caches = port_model.init_caches(cfg, cases.SERVE_BATCH, cases.SERVE_SEQ,
                                    dtype=getattr(torch, dtype),
                                    device="cpu")
    for name, t in port_blocks.tree_leaves(caches):
        t.copy_(torch.from_numpy(data[f"c:{name}"]))
    logits = []
    for i in range(cases.SERVE_STEPS):
        got, caches = port_model.decode_forward(
            model.params, caches, torch.from_numpy(data["tokens"][i]).long(),
            cases.FAMILY_START[arch] + i, cfg, device="cpu")
        logits.append(got.numpy())
    return {"logits": np.stack(logits),
            **{f"c:{n}": t.numpy() for n, t in
               port_blocks.tree_leaves(caches)}}


def distance(got, want, tol):
    """max |got - want| / (tol (1 + |want|)) over the logits and every
    cache leaf: at most 1 where ``assert_allclose(rtol=tol, atol=tol)``
    holds."""
    return max(float(np.max(np.abs(got[n] - want[n])
                            / (tol * (1 + np.abs(want[n])))))
               for n in want if n == "logits" or n.startswith("c:"))


#: the limit of each family's whole 3-step float32 run against the port
#: on one device: 1e-5, but jamba's 8 sublayers and whisper's
#: cross-attention (outputs of magnitude ~24) carry the float32
#: reassociation of the ranks' partial sums further.  Their readings, in
#: units of 1e-5: jamba 2.17 ((1, 4) under xla and gleam_tree), 2.94
#: ((2, 2), rows over data), 2.99 ((2, 2), whole rows), 2.54 ((1, 8));
#: whisper 1.33 ((1, 4), both schedules), 2.08 ((2, 2)).  In float64 the
#: same runs are the one device's (``test_family_float64_on_mesh_is_one_device``)
ONE_DEVICE_TOL = {"jamba_v0_1_52b": 4e-5, "whisper_medium": 3e-5}
#: the float64 runs' limit against the port on one device, by the dtype
#: of the leaf.  The float64 leaves read up to 3.8e-14 (jamba's conv
#: windows); the logits and the SSM state, float32 on both, come out
#: equal (a float32 ulp is 6e-8 of the value)
FLOAT64_TOL = {"float64": 1e-13, "float32": 1e-12}
PATTERNS = {a: port_base.get_config(a, smoke=True).pattern
            for a in cases.FAMILY_ARCHES}


@pytest.mark.parametrize("case", cases.family_cases(), ids=lambda c: c[0])
def test_family_serve_step_on_mesh_matches_reference(runs, case):
    key, arch, shape, bs, sched, dt = case
    got, want = runs["port"][key], runs["ref"][key]
    tol = SERVE_TOL[dt]
    cfg = port_base.get_config(arch, smoke=True)
    assert got["logits"].shape == (cases.SERVE_STEPS, cases.SERVE_BATCH, 1,
                                   cfg.vocab_size)
    assert np.isfinite(got["logits"]).all()
    assert got["plan"] == "inference"
    names = sorted(k for k in want if k.startswith("c:"))
    assert sorted(k for k in got if k.startswith("c:")) == names
    for name in ["logits"] + names:
        np.testing.assert_allclose(got[name], want[name], rtol=tol, atol=tol,
                                   err_msg=name)
    if dt == "float32":
        alone = one_device(arch, str(runs["dir"]))
        tol = ONE_DEVICE_TOL.get(arch, 1e-5)
        reading = distance(got, alone, tol)
        assert reading <= 1.0, (reading, tol)


@pytest.mark.parametrize("case", cases.float64_cases(), ids=lambda c: c[0])
def test_family_float64_on_mesh_is_one_device(runs, case):
    """jamba and whisper in float64 on a mesh against the port on one
    device in float64, within ``FLOAT64_TOL``: the mesh adds the same
    terms as the one device, so the float32 distance that
    ``ONE_DEVICE_TOL`` allows them is the rounding of a reassociated
    sum, not arithmetic of its own (the SSM state stays float32 on both,
    as the reference keeps it)."""
    key, arch, shape, bs = case
    got = runs["port64"][key]
    alone = one_device(arch, str(runs["dir"]), "float64")
    assert sorted(got) == sorted(alone) + ["plan"]
    readings = {n: distance({n: got[n]}, {n: alone[n]},
                            FLOAT64_TOL[alone[n].dtype.name])
                for n in alone}
    assert any(alone[n].dtype == np.float64 for n in alone)
    assert max(readings.values()) <= 1.0, readings


@pytest.mark.parametrize("case", cases.mutant_cases(),
                         ids=lambda c: f"{c[0]}/{c[1]}")
def test_split_mamba_step_tells_its_mutants_apart(runs, case):
    """The band ``test_family_sublayer_on_mesh_matches_whole`` holds the
    split Mamba-2 step to fails a wrong version of it on some rank: the
    gated norm taken over the rank's channels alone moves the output,
    the conv column written from the rank's channels alone moves the
    conv window."""
    key, mutant = case
    leaf = {"per_rank_norm": "out", "rank_channels_conv": "conv"}[mutant]
    right = runs["pieces"][key]
    wrong = runs["pieces"][f"{key}/{mutant}"]
    assert len(wrong) == len(right) == 4
    assert max(r[leaf] for r in right) <= 1.0
    assert max(r[leaf] for r in wrong) > 1.0, wrong


@pytest.mark.parametrize("case", cases.piece_cases(PATTERNS),
                         ids=lambda c: c[0])
def test_family_sublayer_on_mesh_matches_whole(runs, case):
    """One sublayer of block 0 in float32 on every rank's blocks against
    the whole sublayer, within 1e-5 of its largest magnitude on every
    rank (the band ``tools/chip_mesh.py`` holds a sublayer to, at 1e-5):
    its output and every cache leaf it writes (the conv window whole,
    the state gathered from its heads, k and v)."""
    key, arch, shape, bs, j, part, kind = case
    ranks = runs["pieces"][key]
    assert len(ranks) == shape[0] * shape[1]
    want = {"mamba": {"out", "conv", "state"}, "attn": {"out", "k", "v"}}
    for res in ranks:
        assert set(res) == want.get(kind, {"out"})
        assert all(r <= 1.0 for r in res.values()), res


def _live(spec, mesh):
    """A spec with the axes of one rank dropped (they split nothing)."""
    out = []
    for d in range(len(spec)):
        axes = tuple(a for a in port_sharding.entry_axes(spec, d)
                     if mesh.shape[a] > 1)
        out.append(axes[0] if len(axes) == 1 else (axes or None))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (1, 8), (2, 16, 16)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ["mixtral_8x7b", "qwen3_moe_235b_a22b",
                                  "jamba_v0_1_52b"])
def test_moe_reference_specs_are_the_plans(arch, shape):
    """``moe._specs`` (the reference's shard_map in-specs) equal the
    specs the serve plan gives the expert leaves, under both plans:
    experts over ``model`` in ``"ep"`` mode, ``moe_d_ff`` in ``"etp"``,
    ``embed`` over the batch axes with FSDP."""
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                      "model")
    mesh = port_mesh.abstract_mesh(shape, axes)
    cfg = port_base.get_config(arch)
    for smoke in (False, True):
        c = port_base.get_config(arch, smoke=smoke)
        for plan_cfg, plan in (port_steps.serve_plan(c, mesh),
                               (c, port_sharding.ShardingPlan(mesh))):
            specs = port_blocks.param_specs(port_model.model_defs(plan_cfg),
                                            plan)
            moe = next(s["ffn"] for s in specs["blocks"].values()
                       if "we_i" in s["ffn"])
            mode, router, ig, o = port_moe._specs(plan_cfg, mesh)
            assert mode == port_moe.expert_mode(c, mesh.shape["model"])
            assert _live(moe["router"][1:], mesh) == router
            for name, want in (("we_i", ig), ("we_g", ig), ("we_o", o)):
                assert _live(moe[name][1:], mesh) == want, name
    assert port_moe.expert_mode(cfg, 16) == (
        "ep" if cfg.n_experts % 16 == 0 else "etp")


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "jamba_v0_1_52b"])
def test_mesh_of_one_is_decode_forward(arch):
    """``make_serve_step`` on ``single_device_mesh`` gives the logits and
    caches of ``decode_forward`` without a mesh bit for bit (the mesh
    code of the MoE, the Mamba-2 step and the attention with every
    collective on axes of one rank)."""
    cfg = port_base.get_config(arch, smoke=True)
    model = port_model.Model(cfg, seed=3, device="cpu")
    mesh = port_mesh.single_device_mesh(device="cpu")
    step = port_steps.make_serve_step(cfg, mesh, batch_shardable=False)
    caches = [port_model.init_caches(cfg, 4, 16, device="cpu")
              for _ in range(2)]
    gen = torch.Generator().manual_seed(1)
    for (name, a), (_, b) in zip(port_blocks.tree_leaves(caches[0]),
                                 port_blocks.tree_leaves(caches[1])):
        a.copy_(torch.randn(a.shape, generator=gen))
        b.copy_(a)
    tok = torch.tensor([[3], [7], [11], [200]])
    for t in range(4):
        a, caches[0] = step(model.params, caches[0], tok + t, 9 + t)
        b, caches[1] = port_model.decode_forward(model.params, caches[1],
                                                 tok + t, 9 + t, cfg,
                                                 device="cpu")
        assert torch.equal(a, b)
    for (name, a), (_, b) in zip(port_blocks.tree_leaves(caches[0]),
                                 port_blocks.tree_leaves(caches[1])):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mixtral_8x7b", "qwen3_moe_235b_a22b"])
def test_expert_blocks_of_the_ranks_sum_to_the_layer(arch, dtype):
    """``moe.expert_block`` called with each of 4 ranks' experts (the
    ``"ep"`` body with a rank index) sums to ``moe_decode`` on one
    device: in float32 within 1e-6 (each (token, k) row comes from one
    rank), in bf16 bit for bit (a row's k contributions are added in one
    rounding either way)."""
    cfg = port_base.get_config(arch, smoke=True).replace(compute_dtype=dtype)
    model = port_model.Model(cfg, seed=2, device="cpu")
    p = {k: v[0] for k, v in
         model.params["blocks"]["sub0"]["ffn"].items() if k != "norm"}
    x = torch.randn(8, 1, cfg.d_model,
                    generator=torch.Generator().manual_seed(4)).to(
                        getattr(torch, dtype))
    want, _ = port_moe.moe_decode(p, x, cfg)
    x2 = x.reshape(8, cfg.d_model)
    gates, ids, _ = port_moe._router(x2, p["router"], cfg.top_k)
    e_local = cfg.n_experts // 4
    parts = [port_moe.expert_block(
        {n: p[n][r * e_local:(r + 1) * e_local] for n in ("we_i", "we_g",
                                                          "we_o")},
        x2, gates, ids, cfg, rank=r, n_ranks=4) for r in range(4)]
    got = sum(t.float() for t in parts).to(x.dtype).reshape(x.shape)
    if dtype == "bfloat16":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_moe_train_on_a_mesh_of_one_is_the_one_device_layer():
    """``moe_apply`` on a (1, 1) mesh runs ``moe_train``'s mesh code (the
    dispatch with every all_to_all on an axis of one rank) and gives the
    one-device layer's output and router loss bit for bit."""
    cfg = port_base.get_config("mixtral_8x7b", smoke=True)
    model = port_model.Model(cfg, device="cpu")
    p = {k: v[0] for k, v in model.params["blocks"]["sub0"]["ffn"].items()
         if k != "norm"}
    mesh = port_mesh.single_device_mesh("cpu")
    sp = {k: v[1:] for k, v in port_blocks.tree_leaves(
        port_model.train_specs(cfg, mesh)["blocks"]["sub0"]["ffn"])}
    x = torch.randn(2, 8, cfg.d_model)
    y, aux = port_moe.moe_apply(p, x, cfg, mesh=mesh, sp=sp)
    want, want_aux = port_moe.moe_train(p, x, cfg)
    assert torch.equal(y, want) and torch.equal(aux, want_aux)
