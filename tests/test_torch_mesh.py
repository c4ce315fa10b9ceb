"""The port's mesh, sharding planner and serve step on a mesh, against the
reference package.

- The planner: every leaf's spec of all ten configurations and every
  cache spec equal to the reference's ``ShardingPlan.spec`` /
  ``cache_specs`` on meshes (1, 1), (1, 4), (2, 2), (2, 4), (16, 16) and
  (2, 16, 16) under both rule tables (names and sizes only, no ranks).
- ``input_specs``: the block shapes and dtypes of every input of a cell
  equal to the reference's ``lowering_spec`` arguments cut by its
  shardings (on 8 forced host devices).
- The serve step: three decode steps of the granite, llama, qwen1.5 and
  danube (past its window) smoke configs on meshes (1, 4), (2, 2) and
  (2, 4) of gloo ranks, ``batch_shardable`` both ways where the batch
  divides, both ``softmax_combine`` schedules, in float32 (within 1e-4
  of the reference's serve step on the same mesh, 1e-5 of the port on
  one device) and bf16 (2e-2, the reference test's band), under the
  serve plan and the default (FSDP) plan; the final caches too.  The
  other families' serve steps are held in
  ``tests/test_torch_mesh_families.py``.

The reference runs once per module, one subprocess an arch on 8 host
devices each, and the port in two gloo worlds (4 and 8 ranks,
``tests/_torch_dist.py``: under its lock, each limit ``MARGIN`` times the
time measured alone), all at once.  The reference runs under ``jit``
with ``--xla_allow_excess_precision=false``: XLA then rounds to bf16
wherever the code asks (as op by op, bit for bit, checked at (1, 4)),
where by default it keeps float32 inside fusions and moves bf16 logits
by a few ulps from the code's own rounding (ROADMAP queue 3).
Parameters are drawn with every leaf random
(``_torch_mesh_cases.drawn_params``: biases and norm scales c + 0.1 N),
caches filled from a seed.
"""
from __future__ import annotations

import functools
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import _torch_mesh_cases as cases
from _torch_dist import (SRC, exclusive, limit, merged, run,
                         start_references, start_world)
from repro.configs import base as ref_base
from repro.models import blocks as ref_blocks
from repro.models import model as ref_model
from repro.parallel import sharding as ref_sharding
from repro_torch.configs import base as port_base
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import steps as port_steps
from repro_torch.models import blocks as port_blocks
from repro_torch.models import model as port_model
from repro_torch.parallel import sharding as port_sharding

AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
PLAN_MESHES = ((1, 1), (1, 4), (2, 2), (2, 4), (16, 16), (2, 16, 16))
RULES = {"default": (ref_sharding.DEFAULT_RULES, port_sharding.DEFAULT_RULES),
         "inference": (ref_sharding.INFERENCE_RULES,
                       port_sharding.INFERENCE_RULES)}


def ref_mesh(shape):
    """What the reference's planner reads of a mesh: names, the device
    grid's shape, the sizes."""
    axes = AXES[len(shape)]
    return types.SimpleNamespace(axis_names=axes,
                                 devices=np.empty(shape, np.int8),
                                 shape=dict(zip(axes, shape)))


# ================================================================ planner

@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("shape", PLAN_MESHES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ref_base.ARCH_IDS)
def test_param_specs_equal_reference(arch, shape, rules):
    ref_rules, port_rules = RULES[rules]
    defs = ref_model.model_defs(ref_base.get_config(arch))
    want = ref_blocks.param_specs(
        defs, ref_sharding.ShardingPlan(ref_mesh(shape), ref_rules))
    pdefs = port_model.model_defs(port_base.get_config(arch))
    mesh = port_mesh.abstract_mesh(shape, AXES[len(shape)])
    got = port_blocks.param_specs(
        pdefs, port_sharding.ShardingPlan(mesh, port_rules))
    want_flat = {n: tuple(s) for n, s in port_blocks.tree_leaves(
        ref_tree(want))}
    got_flat = dict(port_blocks.tree_leaves(got))
    assert got_flat == want_flat
    # the planner shards something on every mesh of more than one rank
    if np.prod(shape) > 1:
        assert any(s for s in got_flat.values())


def ref_tree(tree):
    """The reference's spec tree with PartitionSpecs as leaves."""
    if isinstance(tree, dict):
        return {k: ref_tree(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("shape", PLAN_MESHES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ref_base.ARCH_IDS)
def test_cache_specs_equal_reference(arch, shape):
    mesh = port_mesh.abstract_mesh(shape, AXES[len(shape)])
    for bs in (True, False):
        want = ref_model.cache_specs(ref_base.get_config(arch), 8, 64,
                                     ref_mesh(shape), bs)
        got = port_model.cache_specs(port_base.get_config(arch), 8, 64,
                                     mesh, bs)
        assert got == ref_tree(want)
        assert port_model.kv_cache_spec(mesh, bs) == tuple(
            ref_model.kv_cache_spec(ref_mesh(shape), bs))


@pytest.mark.parametrize("shape", PLAN_MESHES,
                         ids=lambda s: "x".join(map(str, s)))
def test_overrides_and_tree_shardings_equal_reference(shape):
    """``with_overrides`` (FSDP off, and the vocabulary kept whole) gives
    the reference's specs for every leaf of qwen1.5; ``tree_shardings``
    maps a tree of logical axes and shapes to the plan's spec of each."""
    axes = AXES[len(shape)]
    overrides = dict(embed=((),), vocab=((),))
    ref_plan = ref_sharding.with_overrides(
        ref_sharding.ShardingPlan(ref_mesh(shape)), **overrides)
    mesh = port_mesh.abstract_mesh(shape, axes)
    plan = port_sharding.with_overrides(port_sharding.ShardingPlan(mesh),
                                        **overrides)
    defs = port_model.model_defs(port_base.get_config("qwen1_5_110b"))
    for name, d in port_blocks.tree_leaves(defs):
        assert plan.spec(d.axes, d.shape) == tuple(
            ref_plan.spec(d.axes, d.shape)), name
    got = plan.tree_shardings(
        port_blocks.tree_map(lambda d: d.axes, defs),
        port_blocks.tree_map(lambda d: d.shape, defs))
    for (name, sh), (_, d) in zip(port_blocks.tree_leaves(got),
                                  port_blocks.tree_leaves(defs)):
        assert sh.mesh is mesh and sh.spec == plan.spec(d.axes, d.shape)


def test_with_overrides_and_fallback():
    """llama3.2's 24 heads on a 16-way model axis stay whole (no other
    logical axis of ``wq`` takes the model axis), and ``with_overrides``
    turns FSDP off."""
    mesh = port_mesh.abstract_mesh((16, 16), ("data", "model"))
    plan = port_sharding.ShardingPlan(mesh)
    assert plan.spec(("embed", "heads", None), (3072, 24, 128)) == ("data",)
    assert plan.spec(("embed", "heads", "head_dim"), (3072, 24, 128)) == (
        "data", None, "model")
    off = port_sharding.with_overrides(plan, embed=((),))
    assert off.spec(("embed", "heads", None), (3072, 32, 128)) == (
        None, "model")
    assert off.rules["embed"] == ((),) and plan.rules["embed"] != ((),)


def test_meshes_without_a_world():
    mesh = port_mesh.abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert mesh.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh.size == 512 and mesh.abstract
    with pytest.raises(ValueError, match="abstract"):
        mesh.axis_index("data")
    one = port_mesh.single_device_mesh(device="cpu")
    assert one.shape == {"data": 1, "model": 1}
    assert one.axis_index("model") == 0 and one.group("model") is None
    with pytest.raises(ValueError, match="256 ranks"):
        port_mesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        port_mesh.make_mesh((1, 1), ("data", "model"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            port_mesh.single_device_mesh()


def test_shard_blocks_on_an_abstract_plan():
    """``block_shape`` of qwen1.5-110b's decode blocks on (1, 4): a
    quarter of the heads, the MLP and the vocabulary."""
    mesh = port_mesh.abstract_mesh((1, 4), ("data", "model"))
    cfg = port_base.get_config("qwen1_5_110b")
    _, plan = port_steps.serve_plan(cfg, mesh)
    specs = port_blocks.param_specs(port_model.model_defs(cfg), plan)
    assert plan.rules is port_sharding.DEFAULT_RULES      # 55.6 GB > 40
    wq = specs["blocks"]["sub0"]["mixer"]["wq"]
    assert port_sharding.block_shape((80, 8192, 64, 128), wq, mesh) == (
        80, 8192, 16, 128)
    assert port_sharding.block_shape(
        (8192, 152064), specs["lm_head"], mesh) == (8192, 38016)
    with pytest.raises(ValueError, match="split"):
        port_sharding.block_shape((10,), ("model",), mesh)


# ============================================================== reference

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


out = {}
for case in cases.serve_cases():
    key = cases.ref_key(case[1:])
    if key in out or case[1] not in GROUP:
        continue
    arch, shape, bs, sched, dt, _, embed = case[1:]
    cfg = get_config(arch, smoke=True).replace(
        compute_dtype=dt, collective_schedule=sched, embed_impl=embed)
    data = np.load(os.path.join(workdir, f"serve_{arch}.npz"))
    params = unflatten({k[2:]: jnp.asarray(data[k]) for k in data
                        if k.startswith("p:")})
    cdt = jnp.float32 if dt == "float32" else jnp.bfloat16
    caches = mdl.init_caches(cfg, cases.SERVE_BATCH, cases.SERVE_SEQ,
                             dtype=cdt)
    caches["layers"]["sub0"] = {n: jnp.asarray(data[n]).astype(cdt)
                                for n in ("k", "v")}
    mesh = mesh_of(shape)
    serve = jax.jit(ref_steps.make_serve_step(cfg, mesh, bs))
    logits = []
    with mesh:
        for i in range(cases.SERVE_STEPS):
            lg, caches = serve(params, caches,
                               jnp.asarray(data["tokens"][i]),
                               jnp.int32(cases.SERVE_START[arch] + i))
            logits.append(np.asarray(lg))
    out[key] = {"logits": np.stack(logits),
                **{n: np.asarray(caches["layers"]["sub0"][n]
                                 .astype(jnp.float32)) for n in ("k", "v")}}

# input_specs: every argument's block shape and dtype under the
# reference's shardings
blocks = {}
for arch, shape_name, shape in cases.INPUT_SPEC_CELLS if FIRST else ():
    spec = ref_steps.lowering_spec(get_config(arch), shape_name,
                                   mesh_of(shape))
    args = jax.tree_util.tree_leaves(spec.args)
    shards = jax.tree_util.tree_leaves(spec.in_shardings)
    assert len(args) == len(shards)
    blocks[(arch, shape_name, shape)] = [
        (tuple(s.shard_shape(a.shape)), str(a.dtype))
        for a, s in zip(args, shards)]

# where jax.make_mesh puts host device r (the port's rank r)
order = {shape: np.vectorize(lambda d: d.id)(
    jax.make_mesh(shape, ("data", "model")).devices).tolist()
    for shape in ((2, 4), (4, 2), (1, 8))}

with open(os.path.join(workdir, f"{NAME}_0.pkl"), "wb") as fh:
    pickle.dump({"serve": out, "input_specs": blocks, "order": order}, fh)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference on 8 host devices and the port's serve cases in a
    4-rank and an 8-rank gloo world, started together."""
    workdir = tmp_path_factory.mktemp("mesh")
    for arch in cases.SERVE_ARCHES:
        cfg = port_base.get_config(arch, smoke=True)
        params = cases.drawn_params(list(port_blocks.tree_leaves(
            port_model.model_defs(cfg))))
        np.savez(workdir / f"serve_{arch}.npz",
                 **{f"p:{k}": v for k, v in params.items()},
                 **cases.serve_inputs(arch, cfg))
    with exclusive():
        refs = start_references(
            "reference", REF_SRC, [(a,) for a in cases.SERVE_ARCHES], 8,
            workdir, timeout=limit(ALONE["reference"]),
            xla_flags="--xla_allow_excess_precision=false")
        worlds = [start_world("serve", n, workdir,
                              timeout=limit(ALONE[f"serve{n}"]))
                  for n in (4, 8)]
        run(*worlds, *refs)
    port = {}
    for w in worlds:
        port.update(w.result())
    return {"port": port, "ref": merged(refs), "dir": workdir}


@functools.lru_cache(maxsize=None)
def one_device(arch, dt, workdir):
    """The port on one device (``mesh=None``): the same three steps."""
    cfg = port_base.get_config(arch, smoke=True).replace(compute_dtype=dt)
    data = np.load(os.path.join(workdir, f"serve_{arch}.npz"))
    model = port_model.Model(cfg, device="cpu")
    model.load_state_dict({k[2:]: torch.from_numpy(data[k]) for k in data
                           if k.startswith("p:")})
    cdt = getattr(torch, dt)
    caches = port_model.init_caches(cfg, cases.SERVE_BATCH, cases.SERVE_SEQ,
                                    dtype=cdt, device="cpu")
    for n in ("k", "v"):
        caches["layers"]["sub0"][n].copy_(torch.from_numpy(data[n]).to(cdt))
    logits = []
    for i in range(cases.SERVE_STEPS):
        got, caches = port_model.decode_forward(
            model.params, caches, torch.from_numpy(data["tokens"][i]).long(),
            cases.SERVE_START[arch] + i, cfg, device="cpu")
        logits.append(got.numpy())
    return np.stack(logits)


#: (compute dtype, tolerance against the reference on the same mesh)
SERVE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: seconds each world and the reference took with this module alone on an
#: 8-CPU host, the largest of the runs measured (their limits are
#: ``_torch_dist.limit`` of these: ``MARGIN`` times, at least
#: ``MIN_LIMIT``)
ALONE = {"serve4": 33.2, "serve8": 42.0, "reference": 81.5}


@pytest.mark.parametrize("case", cases.serve_cases(), ids=lambda c: c[0])
def test_serve_step_on_mesh_matches_reference(runs, case):
    key, arch, shape, bs, sched, dt, plan, embed = case
    got = runs["port"][key]
    want = runs["ref"]["serve"][cases.ref_key(case[1:])]
    tol = SERVE_TOL[dt]
    assert got["logits"].shape == (cases.SERVE_STEPS, cases.SERVE_BATCH, 1,
                                   port_base.get_config(
                                       arch, smoke=True).vocab_size)
    assert np.isfinite(got["logits"]).all()
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=tol,
                               atol=tol)
    for name in ("k", "v"):
        np.testing.assert_allclose(got[name], want[name], rtol=tol, atol=tol)
    if dt == "float32":
        np.testing.assert_allclose(got["logits"],
                                   one_device(arch, dt, str(runs["dir"])),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cell", cases.INPUT_SPEC_CELLS,
                         ids=lambda c: f"{c[0]}/{c[1]}/{c[2][0]}x{c[2][1]}")
def test_input_specs_are_the_reference_blocks(runs, cell):
    arch, shape_name, shape = cell
    got = port_steps.input_specs(port_base.get_config(arch), shape_name,
                                 port_mesh.abstract_mesh(shape,
                                                         ("data", "model")))
    flat = [(tuple(ts.shape), str(ts.dtype).split(".")[-1])
            for part in got for _, ts in port_blocks.tree_leaves(
                part if isinstance(part, dict) else {"": part})]
    assert flat == runs["ref"]["input_specs"][cell]


def test_ranks_take_the_reference_device_order(runs):
    """``make_mesh`` puts rank r at the row-major coordinate of r
    (``np.unravel_index``), where ``jax.make_mesh`` puts host device r."""
    for shape, ids in runs["ref"]["order"].items():
        grid = np.zeros(shape, int)
        for r in range(int(np.prod(shape))):
            grid[np.unravel_index(r, shape)] = r
        assert grid.tolist() == ids, shape


# ============================================================== one device

def test_single_device_mesh_is_the_one_device_path():
    """``make_serve_step`` on ``single_device_mesh`` is ``decode_forward``
    without a mesh, bit for bit, logits and caches."""
    cfg = port_base.get_config("qwen1_5_110b", smoke=True)
    model = port_model.Model(cfg, seed=3, device="cpu")
    mesh = port_mesh.single_device_mesh(device="cpu")
    step = port_steps.make_serve_step(cfg, mesh, batch_shardable=False)
    assert step.plan.rules is port_sharding.INFERENCE_RULES
    caches = [port_model.init_caches(cfg, 2, 16, device="cpu")
              for _ in range(2)]
    tok = torch.tensor([[3], [7]])
    for t in range(4):
        a, caches[0] = step(model.params, caches[0], tok + t, t)
        b, caches[1] = port_model.decode_forward(model.params, caches[1],
                                                 tok + t, t, cfg,
                                                 device="cpu")
        assert torch.equal(a, b)
    for n in ("k", "v"):
        assert torch.equal(caches[0]["layers"]["sub0"][n],
                           caches[1]["layers"]["sub0"][n])


@pytest.mark.parametrize("arch", ref_base.ARCH_IDS)
def test_serve_step_on_a_mesh_takes_every_family(arch):
    """``make_serve_step`` builds for every configuration on meshes of
    more than one rank, with the reference's decode plan: mixtral_8x7b
    and jamba_v0_1_52b whole (all their experts counted) fit half a card
    on (1, 4) and take the inference plan, qwen3-MoE-235B does not."""
    cfg = port_base.get_config(arch)
    for shape in ((1, 4), (2, 2), (16, 16)):
        mesh = port_mesh.abstract_mesh(shape, ("data", "model"))
        step = port_steps.make_serve_step(cfg, mesh, batch_shardable=False)
        want = port_blocks.count_params(port_model.model_defs(cfg)) * 2 \
            / shape[1] <= port_steps.CARD_BYTES / 2
        assert (step.plan.rules is port_sharding.INFERENCE_RULES) == want
        assert step.cfg.fsdp_weights == (not want)
    if arch in ("mixtral_8x7b", "jamba_v0_1_52b"):
        assert port_steps.make_serve_step(
            cfg, port_mesh.abstract_mesh((1, 4), ("data", "model")),
            False).plan.rules is port_sharding.INFERENCE_RULES


def test_serve_plan_follows_the_budget():
    """Pure tensor parallelism where the bf16 weights of a model shard
    fit half of the card (80 GB off the card), the default plan where not:
    qwen1.5-110b needs 55.6 GB a shard at 4 ways, 27.8 GB at 8."""
    cfg = port_base.get_config("qwen1_5_110b")
    for shape, rules in (((1, 4), port_sharding.DEFAULT_RULES),
                         ((1, 8), port_sharding.INFERENCE_RULES)):
        mesh = port_mesh.abstract_mesh(shape, ("data", "model"))
        got_cfg, plan = port_steps.serve_plan(cfg, mesh)
        assert plan.rules is rules
        assert got_cfg.fsdp_weights == (rules is port_sharding.DEFAULT_RULES)


MESH_ALONE = r"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax.") or name == "repro" \
                or name.startswith("repro."):
            raise ImportError(f"blocked: {name}")
for m in list(sys.modules):
    if m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro":
        del sys.modules[m]
sys.meta_path.insert(0, Block())
import repro_torch.launch.mesh, repro_torch.parallel.sharding
import repro_torch.core.collectives, repro_torch.parallel.pipeline
import repro_torch.runtime.elastic, repro_torch.launch.steps
import repro_torch.models.model, repro_torch.checkpoint.sharded
import repro_torch.models.moe, repro_torch.models.ssm
import repro_torch.optim.adamw, repro_torch.kernels.flash_attention
# the mesh train and prefill steps run on a (1, 1) mesh
import torch
from repro_torch.configs.base import get_config
from repro_torch.launch.mesh import single_device_mesh
from repro_torch.launch.steps import make_prefill_step, make_train_step
from repro_torch.models.model import Model
from repro_torch.optim import adamw
cfg = get_config("llama3_2_3b", smoke=True).replace(compute_dtype="float32")
mesh = single_device_mesh(device="cpu")
params = Model(cfg, device="cpu").params
toks = torch.arange(32).reshape(2, 16) % cfg.vocab_size
_, _, metrics = make_train_step(cfg, mesh=mesh)(
    params, adamw.init(params), {"tokens": toks, "targets": toks})
assert torch.isfinite(metrics["loss"])
assert make_prefill_step(cfg, mesh=mesh)(params, {"tokens": toks}).shape \
    == (2, 1, cfg.vocab_size)
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules)
print("ok")
"""


def test_mesh_modules_import_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", MESH_ALONE], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "ok"
