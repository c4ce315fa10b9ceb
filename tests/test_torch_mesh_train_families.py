"""The port's prefill and train steps on a mesh for MoE, Mamba-2, the
hybrid, the encoder-decoder and the VLM, against the reference package's
GSPMD steps on the same meshes.

mixtral_8x7b, qwen3_moe_235b_a22b, mamba2_370m, jamba_v0_1_52b,
whisper_medium and internvl2_26b at their smoke configs, every leaf drawn
(``_torch_mesh_cases.drawn_params``: a constant c + 0.1 N, which keeps
jamba's SSD decay sums where the reference's ``ssd_chunked`` gradient
stays finite), on (1, 4) and (2, 2) in a 4-rank gloo world, and mixtral
on (1, 8) (its 4 experts on 8 ranks: ``"etp"``) and jamba on (2, 4) in an
8-rank one.  The MoE meshes of the 4-rank world run ``"ep"``: each
rank's slice of the sequence dispatched to the experts' owners by
``all_to_all`` and back; qwen3 at 62 positions on (1, 4) takes
``moe_decode``'s body, as the reference's ``moe_apply`` chooses for a
sequence that ``model`` does not divide.  whisper's batch carries its
frames, internvl2's its vision prefix, split over ``data`` like the
tokens.  The checks are ``tests/test_torch_mesh_train.py``'s:

- ``loss_fn``: its loss and metrics (the aux loss averaged over the
  ranks, as the reference's pmeans average it) within ``TOL``, and every
  gradient leaf, gathered whole, within ``TOL`` of the reference's
  ``jax.grad`` on the mesh or under the float64 rule (``ORACLE_FACTOR``);
- one ``make_train_step`` step at accum 2 (``step_faults``), its
  updated leaves outside the elements whose float64 gradient is nonzero
  and no larger than the leaf's float32 error: the rule
  ``tests/test_torch_train.py`` holds these families' one-device step
  to (at whisper's drawn leaves on (1, 4) one element of
  ``enc_blocks.sub0.ffn.wo`` has a float64 gradient of 2.36e-7 and the
  reference's float32 one 7.1e-9, 0.97 of it off: AdamW's first update
  g / (|g| + 1e-8) moves it 1.3e-4 from the port's, whose gradient is
  1.28e-7, while the element-wise rule keeps it);
- ``make_prefill_step``'s last-position logits in float32 within ``TOL``;
- bf16 prefill of mixtral and mamba2 on (1, 4) and (2, 2): the port on
  the mesh against the port on one device (``BF16_BAND``);
- two wrong MoE steps the checks must reject (``cases.MOE_MUTANTS``);
- every rank reports the same step.

The reference runs in five subprocesses side by side (``REF_GROUPS``),
each on 8 forced host devices, jitted
on the meshes with its parameters and batch placed as its
``lowering_spec`` places them (``--xla_allow_excess_precision=false``,
``--xla_backend_optimization_level=0`` as
``tests/test_torch_mesh_families.py`` runs it); the two worlds run beside
it (``tests/_torch_dist.py``: under its lock, each limit ``MARGIN``
times the time measured alone).
"""
from __future__ import annotations

import functools
import os
import types

import numpy as np
import pytest
import torch

import _torch_mesh_cases as cases
from _torch_dist import (exclusive, limit, merged, run, start_references,
                         start_world)
from repro.configs import base as ref_base
from repro.models import blocks as ref_blocks
from repro.models import model as ref_model
from repro.parallel import sharding as ref_sharding
from repro_torch.configs import base as port_base
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import steps as port_steps
from repro_torch.models import blocks as port_blocks
from repro_torch.models import model as port_model
from repro_torch.optim import adamw
from test_torch_mesh_train import TOL, loss_faults, step_faults

#: seconds each world and the reference took with this module alone on an
#: 8-CPU host, the largest of the runs measured (their limits are
#: ``_torch_dist.limit`` of these: ``MARGIN`` times, at least
#: ``MIN_LIMIT``)
ALONE = {"train_families4": 117.4, "train_families8": 117.4,
         "reference": 117.4}
#: the bf16 prefill's largest distance from the port on one device, per
#: case; every other case is the one device's bits (mixtral's: its
#: expert outputs are each one rank's, added in the one device's order,
#: and no row drops).  mamba2's gated norm sums the squares of the rank's
#: channels and all-reduces them, and ``wo``'s float32 partial sums are
#: added over the ranks: both float32 sums in another order than the one
#: device's, which move a few bf16 roundings.  Measured: 76 of the 2048
#: last-position logits one bf16 ulp (2^-7, the logits below 4 in
#: magnitude) from the one device's on either mesh.
BF16_BAND = {"mamba2_370m/1x4": 2.0 ** -7, "mamba2_370m/2x2": 2.0 ** -7}

REF_SRC = r"""
import os, pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import _torch_mesh_cases as cases
from repro.configs.base import get_config
from repro.launch import steps as ref_steps
from repro.models import model as mdl
from repro.models.blocks import param_shardings
from repro.optim import adamw
from repro.parallel.sharding import ShardingPlan

workdir = sys.argv[1]


def mesh_of(shape):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))


def unflatten(flat):
    tree = {}
    for name, leaf in flat.items():
        node = tree
        *path, last = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree.astype(jnp.float32))}


apply = adamw.apply


def recorded(opt_cfg, params, state, grads):
    p, s, m = apply(opt_cfg, params, state, grads)
    return p, s, {**m, "grads": grads}


ref_steps.adamw.apply = recorded
out = {}
opt = adamw.AdamWConfig(warmup_steps=1)
for key, arch, shape, seq in cases.family_train_cases():
    if not key.startswith(GROUP):
        continue
    mesh = mesh_of(shape)
    data = np.load(os.path.join(workdir, f"family_train_{arch}_s{seq}.npz"))
    whole = unflatten({k[2:]: jnp.asarray(data[k]) for k in data
                       if k.startswith("p:")})
    for tree in ("blocks", "enc_blocks"):
        for sub in whole.get(tree, {}).values():
            sub.setdefault("ffn", {})       # a sublayer without an ffn
    cfg = get_config(arch, smoke=True).replace(compute_dtype="float32")
    psh = param_shardings(mdl.model_defs(cfg), ShardingPlan(mesh))
    params = jax.device_put(whole, psh)
    res = {}
    with mesh:
        def placed(k):
            a = jnp.asarray(data[k])
            spec = P(ref_steps._bspec(mesh), *([None] * (a.ndim - 1)))
            return jax.device_put(a, NamedSharding(mesh, spec))
        batch = {k: placed(k) for k in ("tokens", "targets", "loss_mask")
                 + cases.MODALITIES if k in data}
        (_, m), g = jax.jit(jax.value_and_grad(
            lambda p, b: mdl.loss_fn(p, b, cfg, mesh), has_aux=True))(
                params, batch)
        res["metrics"] = {k: float(v) for k, v in m.items()}
        res["grads"] = flat(g)
        step = ref_steps.make_train_step(cfg, mesh, opt,
                                         accum_steps=cases.TRAIN_ACCUM)
        new_p, _, sm = jax.jit(step)(params, adamw.init(params), batch)
        res["step"] = {"metrics": {k: float(v) for k, v in sm.items()
                                   if k != "grads"},
                       "grads": flat(sm["grads"]), "params": flat(new_p)}
        pre = {k: v for k, v in batch.items()
               if k not in ("targets", "loss_mask")}
        res["prefill_float32"] = np.asarray(jax.jit(
            ref_steps.make_prefill_step(cfg, mesh))(params, pre))
    out[key] = res

with open(os.path.join(workdir, f"{NAME}_0.pkl"), "wb") as fh:
    pickle.dump(out, fh)
"""
#: the reference's cases (by key prefix) in processes of their own, run
#: side by side (compiling them is most of the module's time, one process
#: a core): each of jamba's three meshes, the MoE families', the rest
REF_GROUPS = (("jamba_v0_1_52b/1x4",), ("jamba_v0_1_52b/2x2",),
              ("jamba_v0_1_52b/2x4",),
              ("mixtral_8x7b", "qwen3_moe_235b_a22b"),
              ("mamba2_370m", "whisper_medium", "internvl2_26b"))


def _data_name(arch, seq):
    return f"family_train_{arch}_s{seq}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference on 8 host devices and the port's cases in a 4-rank
    and an 8-rank gloo world, started together under the lock."""
    workdir = tmp_path_factory.mktemp("mesh_train_families")
    for arch, seq in {(c[1], c[3]) for c in cases.family_train_cases()}:
        cfg = port_base.get_config(arch, smoke=True)
        params = cases.drawn_params(list(port_blocks.tree_leaves(
            port_model.model_defs(cfg))))
        np.savez(workdir / f"{_data_name(arch, seq)}.npz",
                 **{f"p:{k}": v for k, v in params.items()},
                 **cases.family_train_inputs(cfg, seq))
    with exclusive():
        refs = start_references(
            "reference", REF_SRC, REF_GROUPS, 8, workdir,
            timeout=limit(ALONE["reference"]),
            xla_flags="--xla_allow_excess_precision=false "
                      "--xla_backend_optimization_level=0")
        worlds = [start_world("train_families", n, workdir,
                              timeout=limit(ALONE[f"train_families{n}"]))
                  for n in (4, 8)]
        run(*worlds, *refs)
    port, ranks = {}, {}
    for w in worlds:
        port.update(w.result())
        for r in range(len(w.procs)):
            for key, res in w.result(r).items():
                ranks.setdefault(key, []).append(
                    res["float32"]["step"]["metrics"])
    return {"port": port, "ref": merged(refs), "ranks": ranks,
            "dir": workdir}


def _ids(case):
    return case[0]


@pytest.mark.parametrize("case", cases.family_train_cases(), ids=_ids)
def test_family_loss_and_every_gradient_on_a_mesh_match_reference(runs,
                                                                  case):
    key = case[0]
    assert loss_faults(runs["port"][key], runs["ref"][key]) == {}


@pytest.mark.parametrize("case", cases.family_train_cases(), ids=_ids)
def test_family_train_step_on_a_mesh_matches_reference(runs, case):
    key = case[0]
    assert step_faults(runs["port"][key], runs["ref"][key],
                       leaf_noise=True) == {}


@pytest.mark.parametrize("case", cases.family_train_cases(), ids=_ids)
def test_family_prefill_step_on_a_mesh_matches_reference(runs, case):
    key, arch = case[0], case[1]
    got = runs["port"][key]["prefill_float32"]
    vocab = port_base.get_config(arch, smoke=True).vocab_size
    assert got.shape == (cases.TRAIN_BATCH, 1, vocab)
    np.testing.assert_allclose(got, runs["ref"][key]["prefill_float32"],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", cases.bf16_family_cases(), ids=_ids)
def test_family_bf16_prefill_on_a_mesh_is_one_device(runs, case):
    key, arch = case[0], case[1]
    got = runs["port"][key]["prefill_bfloat16"]
    assert np.isfinite(got).all()
    want = one_device_bf16(arch, str(runs["dir"]))
    band = BF16_BAND.get(key, 0.0)
    if band == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= band


@functools.lru_cache(maxsize=None)
def one_device_bf16(arch, workdir):
    """The port's bf16 prefill logits on one device (``mesh=None``)."""
    cfg = port_base.get_config(arch, smoke=True).replace(
        compute_dtype="bfloat16")
    data = np.load(os.path.join(workdir, f"{_data_name(arch, cases.TRAIN_SEQ)}"
                                         ".npz"))
    params = port_blocks.unflatten({k[2:]: torch.from_numpy(data[k])
                                    for k in data if k.startswith("p:")})
    return port_steps.make_prefill_step(cfg, device="cpu")(
        params, {"tokens": torch.from_numpy(data["prefill16"])}).numpy()


@pytest.mark.parametrize("mutant", cases.MOE_MUTANTS,
                         ids=lambda m: f"{m[0]}/{m[1]}")
def test_checks_reject_a_wrong_dispatch(runs, mutant):
    """Each wrong MoE step fails the checks its case passes: without the
    return the loss and the gradients are wrong; without the psum of the
    input's gradient the loss is right and the gradients are not."""
    name, key = mutant
    port, ref = runs["port"][key], runs["ref"][key]
    faults = loss_faults({**port, "float32": port[name]}, ref)
    if name == "no_input_psum":
        assert set(faults) == {"grads"}, faults
    else:
        assert "metrics" in faults and "grads" in faults, faults


@pytest.mark.parametrize("case", cases.family_train_cases(), ids=_ids)
def test_family_ranks_report_the_same_step(runs, case):
    """A step's metrics are the whole batch's on every rank, bit for
    bit."""
    every = runs["ranks"][case[0]]
    assert len(every) == case[2][0] * case[2][1]
    assert all(m == every[0] for m in every)


@pytest.mark.parametrize("shape", ((1, 4), (2, 2), (1, 8), (2, 4)),
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", cases.TRAIN_FAMILY_ARCHES)
def test_train_specs_are_the_reference_shardings(arch, shape):
    """The spec of every leaf of ``train_specs`` (the plan the port's
    train and prefill steps place each leaf by) is the spec of the
    reference's ``param_shardings`` under its train plan
    (``blocks.param_specs``, which it wraps), at the smoke config and at
    the published one: the experts, the SSM inner dim and heads, the conv
    taps, the encoder and the vision projection."""
    mesh = port_mesh.abstract_mesh(shape, ("data", "model"))
    ref_mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                     devices=np.empty(shape, np.int8),
                                     shape=dict(zip(("data", "model"),
                                                    shape)))
    for smoke in (True, False):
        want = ref_blocks.param_specs(
            ref_model.model_defs(ref_base.get_config(arch, smoke=smoke)),
            ref_sharding.ShardingPlan(ref_mesh))
        got = dict(port_blocks.tree_leaves(port_model.train_specs(
            port_base.get_config(arch, smoke=smoke), mesh)))
        assert got == _flat_specs(want)


def _flat_specs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_specs(tree[k], f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tuple(tree)}


@pytest.mark.parametrize("arch", cases.TRAIN_FAMILY_ARCHES)
def test_family_single_device_mesh_is_the_one_device_step(arch):
    """``make_train_step`` and ``make_prefill_step`` on
    ``single_device_mesh`` are the steps without a mesh, bit for bit (the
    loss, ``grad_norm``, every updated leaf, both moments, the prefill
    logits), through the mesh code of the MoE dispatch, the Mamba-2
    heads, the encoder and the vision prefix."""
    cfg = port_base.get_config(arch, smoke=True).replace(
        compute_dtype="float32")
    mesh = port_mesh.single_device_mesh(device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             cases.family_train_inputs(cfg, 16, batch=2).items()
             if k != "prefill16"}
    outs = []
    for kw in ({"device": "cpu"}, {"mesh": mesh}):
        params = port_model.Model(cfg, seed=0, device="cpu").params
        step = port_steps.make_train_step(
            cfg, adamw.AdamWConfig(warmup_steps=1), 2, **kw)
        p, s, m = step(params, adamw.init(params), batch)
        logits = port_steps.make_prefill_step(cfg, **kw)(
            p, {k: v for k, v in batch.items()
                if k not in ("targets", "loss_mask")})
        outs.append((dict(port_blocks.tree_leaves(
            {"p": p, "m": s["m"], "v": s["v"]})), m, logits))
    (p0, m0, l0), (p1, m1, l1) = outs
    assert m0.keys() == m1.keys()
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(p0[n], p1[n]) for n in p0)
    assert torch.equal(l0, l1)
