"""The port's prefill and train steps on a mesh, against the reference
package's GSPMD steps on the same meshes.

granite_3_2b, llama3_2_3b, qwen1_5_110b and h2o_danube_3_4b at their
smoke configs, every leaf drawn (``_torch_mesh_cases.drawn_params``: the
q/k/v biases and the norm scales c + 0.1 N), on (1, 4) and (2, 2) in a
4-rank gloo world and (2, 4) and (4, 2) in an 8-rank one.  The meshes take
every branch of ``attn_core``: kv heads split (granite, qwen1.5 and danube
on a 2-way model axis), kv heads replicated (the same on a 4-way one) and
the sequence-parallel fallback with ``q_offset`` (llama's 3 heads on any
model axis), danube's window on each.  llama and qwen1.5 embed by the
masked lookup psummed over ``model``, granite and danube by the gather.
The loss mask is not uniform across rows, so the whole batch's mask sum
and the reference's microbatches are held too.

- ``loss_fn``: its loss and metrics within ``TOL``, and every gradient
  leaf, gathered whole, against ``jax.grad`` of the reference's
  ``loss_fn`` on the mesh: within ``TOL`` of the leaf's largest
  magnitude, or under ``tests/test_torch_train.py``'s rule against the
  port's float64 gradient on the same mesh (``ORACLE_FACTOR``).
- One ``make_train_step`` step at accum 2: its metrics (``grad_norm``
  too), the gradient it hands AdamW under the same rule, and every updated
  leaf within ``TOL`` of the reference's step outside the elements whose
  gradient is float32 noise around 0 (the float64 rule of
  ``test_train_step_matches_reference_through_its_gradient``).
- ``make_prefill_step``: the last position's logits in float32 within
  ``TOL``; in bf16 (granite and danube at 96 positions, the reference's
  chunked branch) the port on every mesh is the port on one device, bit
  for bit (its partial sums over split heads and the MLP's inner dim are
  added in float32 and rounded once, ``blocks.wide_mm``), and within 3e-2
  of the reference on one device.  The reference's own GSPMD bf16
  prefill on these meshes lies 0.109 to 0.180 (max abs; 4.6% to 8.3% of
  the logits outside the band) from its one-device run, which rounds
  once (ROADMAP queue 3), so it is no oracle at that band.
- Three wrong steps the checks must reject (``cases.TRAIN_MUTANTS``).
- A (1, 1) mesh is the one-device step, bit for bit.

The reference runs in one subprocess an arch, side by side, each on 8
forced host devices, jitted
on the meshes with its parameters and batch placed as its
``lowering_spec`` places them, with ``--xla_allow_excess_precision=false``
(bf16 rounded where the code asks); the two worlds run beside it
(``tests/_torch_dist.py``: under its lock, each limit ``MARGIN`` times
the time measured alone).
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
from repro_torch.optim import adamw

#: the tolerances of ``tests/test_torch_train.py`` and of the bf16 prefill
#: in ``tests/test_torch_prefill.py``
TOL, BF16_TOL, ORACLE_FACTOR, NOISE_SHARE = 1e-4, 3e-2, 8.0, 1e-2
#: seconds each world and the reference took with this module alone on an
#: 8-CPU host, the largest of the runs measured (their limits are
#: ``_torch_dist.limit`` of these: ``MARGIN`` times, at least
#: ``MIN_LIMIT``)
ALONE = {"train4": 56.8, "train8": 78.1, "reference": 91.2}

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


# the gradient the step hands AdamW, returned beside its metrics
apply = adamw.apply


def recorded(opt_cfg, params, state, grads):
    p, s, m = apply(opt_cfg, params, state, grads)
    return p, s, {**m, "grads": grads}


ref_steps.adamw.apply = recorded

def load(arch):
    data = np.load(os.path.join(workdir, f"train_{arch}.npz"))
    return data, unflatten({k[2:]: jnp.asarray(data[k]) for k in data
                            if k.startswith("p:")})


out = {}
opt = adamw.AdamWConfig(warmup_steps=1)
for arch in cases.BF16_ARCHES:
    if arch not in GROUP:
        continue
    data, whole = load(arch)
    cfg = get_config(arch, smoke=True).replace(compute_dtype="bfloat16")
    mesh = mesh_of((1, 1))
    with mesh:
        out[f"{arch}/bfloat16"] = np.asarray(jax.jit(
            ref_steps.make_prefill_step(cfg, mesh))(
                whole, {"tokens": jnp.asarray(data["prefill16"])}))
for key, arch, shape, embed in cases.train_cases():
    if arch not in GROUP:
        continue
    mesh = mesh_of(shape)
    data, whole = load(arch)
    res = {}
    for dt in ("float32",):
        cfg = get_config(arch, smoke=True).replace(compute_dtype=dt,
                                                   embed_impl=embed)
        psh = param_shardings(mdl.model_defs(cfg), ShardingPlan(mesh))
        params = jax.device_put(whole, psh)
        rows = NamedSharding(mesh, P(ref_steps._bspec(mesh), None))
        with mesh:
            batch = {k: jax.device_put(jnp.asarray(data[k]), rows)
                     for k in ("tokens", "targets", "loss_mask")}
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
            res["prefill_float32"] = np.asarray(jax.jit(
                ref_steps.make_prefill_step(cfg, mesh))(
                    params, {"tokens": batch["tokens"]}))
    out[key] = res

with open(os.path.join(workdir, f"{NAME}_0.pkl"), "wb") as fh:
    pickle.dump(out, fh)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference on 8 host devices and the port's cases in a 4-rank
    and an 8-rank gloo world, started together."""
    workdir = tmp_path_factory.mktemp("mesh_train")
    for arch in cases.TRAIN_ARCHES:
        cfg = port_base.get_config(arch, smoke=True)
        params = cases.drawn_params(list(port_blocks.tree_leaves(
            port_model.model_defs(cfg))))
        np.savez(workdir / f"train_{arch}.npz",
                 **{f"p:{k}": v for k, v in params.items()},
                 **cases.train_inputs(cfg))
    with exclusive():
        refs = start_references(
            "reference", REF_SRC, [(a,) for a in cases.TRAIN_ARCHES], 8,
            workdir, timeout=limit(ALONE["reference"]),
            xla_flags="--xla_allow_excess_precision=false")
        worlds = [start_world("train", n, workdir,
                              timeout=limit(ALONE[f"train{n}"]))
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


# ================================================================ checks

def metric_faults(got, want, keys):
    """The metrics of ``keys`` farther than ``TOL`` (element-wise, as
    ``np.testing.assert_allclose`` measures it) from the reference's."""
    return [(k, got[k], want[k]) for k in keys
            if abs(got[k] - want[k]) > TOL + TOL * abs(want[k])]


def gradient_faults(want, got, g64):
    """``{leaf: (d, d_ref, d_port, scale)}`` of the gradient leaves that
    fail both rules: ``d = max |port - reference|`` within ``TOL`` of the
    leaf's largest magnitude ``scale`` (of the float64 gradient), or
    ``tests/test_torch_train.py``'s rule on the float32 gradients'
    distances from the float64 one (the reference's within ``TOL`` of the
    scale or ``ORACLE_FACTOR`` times the port's; the port's within
    ``ORACLE_FACTOR`` times the reference's)."""
    assert set(got) == set(want)
    out = {}
    for name, g in got.items():
        scale = np.abs(g64[name]).max()
        d = np.abs(g - want[name]).max()
        d_ref = np.abs(want[name] - g64[name]).max()
        d_port = np.abs(g - g64[name]).max()
        if d <= TOL * scale:
            continue
        if d_ref <= max(TOL * scale, ORACLE_FACTOR * d_port) and \
                d_port <= ORACLE_FACTOR * max(
                    d_ref, np.finfo(np.float32).eps * scale):
            continue
        out[name] = (d, d_ref, d_port, scale)
    return out


def step_faults(port, ref, leaf_noise=False):
    """The train step's faults: its metrics, the gradient it hands AdamW
    (``gradient_faults`` against the port's float64 step), and each
    updated leaf farther than ``TOL`` from the reference's outside the
    elements whose float64 gradient is nonzero and no larger than either
    float32 gradient's distance from it there (where AdamW's first
    update, g / (|g| + 1e-8), may take the noise's sign), which must be
    at most ``NOISE_SHARE`` of all.  That is the element-wise form of
    ``test_train_step_matches_reference_through_its_gradient``'s rule,
    which takes the leaf's largest distance for every element: it keeps
    every element that rule keeps and more (at llama's drawn leaves the
    embedding's gradient reaches 32, its float32 error 3e-3, and 812 of
    its elements lie below that error, their own far smaller).
    ``leaf_noise`` takes that rule itself: the leaf's largest float32
    error for every element."""
    got, want = port["float32"]["step"], ref["step"]
    g64 = port["float64"]["step"]["grads"]
    faults = {"metrics": metric_faults(got["metrics"], want["metrics"],
                                       sorted(want["metrics"])),
              "grads": gradient_faults(want["grads"], got["grads"], g64)}
    noise, params = 0, {}
    for name, g in g64.items():
        err = np.maximum(np.abs(want["grads"][name] - g),
                         np.abs(got["grads"][name] - g))
        if leaf_noise:
            err = err.max()
        kept = ~((g != 0) & (np.abs(g) <= err))
        noise += int((~kept).sum())
        d = np.abs(got["params"][name] - want["params"][name])
        if (d[kept] > TOL + TOL * np.abs(want["params"][name][kept])).any():
            params[name] = float(d[kept].max())
    faults["params"] = params
    faults["noise"] = noise > NOISE_SHARE * sum(g.size
                                                for g in g64.values())
    return {k: v for k, v in faults.items() if v}


def loss_faults(port, ref):
    """``loss_fn``'s faults: its metrics and every gradient leaf."""
    got = port["float32"]
    faults = {"metrics": metric_faults(got["metrics"], ref["metrics"],
                                       ("loss", "aux_loss", "perplexity")),
              "grads": gradient_faults(ref["grads"], got["grads"],
                                       port["float64"]["grads"])}
    return {k: v for k, v in faults.items() if v}


# ================================================================ tests

@pytest.mark.parametrize("case", cases.train_cases(), ids=lambda c: c[0])
def test_loss_and_every_gradient_on_a_mesh_match_reference(runs, case):
    key = case[0]
    assert loss_faults(runs["port"][key], runs["ref"][key]) == {}


@pytest.mark.parametrize("case", cases.train_cases(), ids=lambda c: c[0])
def test_train_step_on_a_mesh_matches_reference(runs, case):
    key = case[0]
    assert step_faults(runs["port"][key], runs["ref"][key]) == {}


@pytest.mark.parametrize("case", cases.train_cases(), ids=lambda c: c[0])
def test_prefill_step_on_a_mesh_matches_reference(runs, case):
    key, arch = case[0], case[1]
    got = runs["port"][key]["prefill_float32"]
    vocab = port_base.get_config(arch, smoke=True).vocab_size
    assert got.shape == (cases.TRAIN_BATCH, 1, vocab)
    np.testing.assert_allclose(got, runs["ref"][key]["prefill_float32"],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", cases.bf16_cases(), ids=lambda c: c[0])
def test_bf16_prefill_on_a_mesh_matches_reference(runs, case):
    key, arch = case[0], case[1]
    got = runs["port"][key]["prefill_bfloat16"]
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, one_device_bf16(arch,
                                                       str(runs["dir"])))
    np.testing.assert_allclose(got, runs["ref"][f"{arch}/bfloat16"],
                               rtol=BF16_TOL, atol=BF16_TOL)


@functools.lru_cache(maxsize=None)
def one_device_bf16(arch, workdir):
    """The port's bf16 prefill logits on one device (``mesh=None``)."""
    cfg = port_base.get_config(arch, smoke=True).replace(
        compute_dtype="bfloat16")
    data = np.load(os.path.join(workdir, f"train_{arch}.npz"))
    params = port_blocks.unflatten({k[2:]: torch.from_numpy(data[k])
                                    for k in data if k.startswith("p:")})
    return port_steps.make_prefill_step(cfg, device="cpu")(
        params, {"tokens": torch.from_numpy(data["prefill16"])}).numpy()


@pytest.mark.parametrize("mutant", cases.TRAIN_MUTANTS,
                         ids=lambda m: f"{m[0]}/{m[1]}")
def test_checks_reject_a_wrong_mesh_step(runs, mutant):
    """Each wrong step fails the checks its case passes: the gradient
    without the psum over ``model`` (the loss's value is right), the loss
    over each rank's own mask sum, and microbatches cut from each rank's
    own rows (``loss_fn`` is right, the step is not)."""
    name, key = mutant
    port, ref = runs["port"][key], runs["ref"][key]
    wrong = {**port, "float32": port[name]}
    if name == "no_model_psum":
        faults = loss_faults(wrong, ref)
        assert set(faults) == {"grads"}, faults
    elif name == "own_mask_sum":
        assert "metrics" in loss_faults(wrong, ref)
    else:
        assert loss_faults(wrong, ref) == {}
        assert "metrics" in step_faults(wrong, ref)


@pytest.mark.parametrize("case", cases.train_cases(), ids=lambda c: c[0])
def test_every_rank_reports_the_same_step(runs, case):
    """A step's metrics (the loss, ``grad_norm``) are the whole batch's
    on every rank, bit for bit: rank 0's are held to the reference above."""
    every = runs["ranks"][case[0]]
    assert len(every) == case[2][0] * case[2][1]
    assert all(m == every[0] for m in every)


@pytest.mark.parametrize("arch", cases.TRAIN_ARCHES)
def test_single_device_mesh_is_the_one_device_step(arch):
    """``make_train_step`` and ``make_prefill_step`` on
    ``single_device_mesh`` are the steps without a mesh, bit for bit:
    the loss, ``grad_norm``, every updated leaf, both moments and the
    prefill logits."""
    cfg = port_base.get_config(arch, smoke=True).replace(
        compute_dtype="float32", embed_impl=cases.TRAIN_EMBED[arch])
    mesh = port_mesh.single_device_mesh(device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             cases.train_inputs(cfg).items() if k != "prefill16"}
    outs = []
    for kw in ({"device": "cpu"}, {"mesh": mesh}):
        params = port_model.Model(cfg, seed=0, device="cpu").params
        step = port_steps.make_train_step(
            cfg, adamw.AdamWConfig(warmup_steps=1), 2, **kw)
        p, s, m = step(params, adamw.init(params), batch)
        logits = port_steps.make_prefill_step(cfg, **kw)(
            p, {"tokens": batch["tokens"]})
        outs.append((dict(port_blocks.tree_leaves(
            {"p": p, "m": s["m"], "v": s["v"]})), m, logits))
    (p0, m0, l0), (p1, m1, l1) = outs
    assert m0.keys() == m1.keys()
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(p0[n], p1[n]) for n in p0)
    assert torch.equal(l0, l1)
