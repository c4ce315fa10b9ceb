"""One rank of a gloo world for the port's mesh tests.

    python tests/_torch_mesh_worker.py JOB RANK WORLD WORKDIR NAME

Joins the world NAME through a ``FileStore`` under WORKDIR (60 s
timeout), runs JOB and writes this rank's results to
``WORKDIR/NAME_<rank>.pkl``.  Imports torch, numpy
and the port, never jax or the reference package (checked at the end).
Each rank runs one CPU thread.
"""
from __future__ import annotations

import datetime
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

import _torch_mesh_cases as cases
from repro_torch.core import collectives as coll
from repro_torch.launch.mesh import make_mesh

COMBINE = {"add": torch.add, "min": torch.minimum,
           "softmax": coll._softmax_merge}


def _block(a, rank, n):
    rows = a.shape[0] // n
    return torch.from_numpy(a[rank * rows:(rank + 1) * rows].copy())


def job_collectives(rank, world, workdir):
    """Every collective case at this world's size on a one-axis mesh;
    each rank's result per case."""
    mesh = make_mesh((world,), ("x",), device="cpu")
    inp = cases.collective_inputs(world)
    v = _block(inp["v"], rank, world)
    w = _block(inp["w"], rank, world)
    parts = tuple(_block(inp[k], rank, world) for k in ("m", "l", "acc"))
    out = {}
    for key, fn, root, arg in cases.collective_cases(world):
        f = getattr(coll, fn)
        if fn in ("tree_broadcast", "unicast_broadcast"):
            got = f(v, mesh, "x", root=root)
        elif fn == "ring_broadcast":
            got = f(v, mesh, "x", root=root, chunks=arg)
        elif fn in ("tree_reduce", "tree_allreduce", "butterfly_allreduce"):
            x = parts if arg == "softmax" else v
            kw = {} if fn == "butterfly_allreduce" else {"root": root}
            got = f(x, mesh, "x", COMBINE[arg], **kw)
        elif fn == "allreduce_sum":
            got = f((v, w), mesh, ("x",), schedule=arg)
        else:
            got = f(parts, mesh, ("x",), schedule=arg)
        out[key] = [t.numpy() for t in got] if isinstance(got, tuple) \
            else got.numpy()
    # an axis of size 1 returns its input untouched
    one = make_mesh((1, world), ("one", "x"), device="cpu")
    for fn in ("tree_broadcast", "unicast_broadcast", "ring_broadcast"):
        assert getattr(coll, fn)(v, one, "one") is v, fn
    assert coll.butterfly_allreduce(v, one, "one", torch.add) is v
    for sched in cases.SOFTMAX_SCHEDULES:
        got = coll.softmax_combine(parts, one, ("one",), schedule=sched)
        assert all(torch.equal(g, p) for g, p in zip(got, parts)), sched
    return out


def job_pipeline(rank, world, workdir):
    from repro_torch.parallel.pipeline import pipeline, pipeline_stages
    mesh = make_mesh((world,), ("stage",), device="cpu")
    inp = {k: torch.from_numpy(a) for k, a in cases.pipeline_inputs().items()}
    staged = pipeline_stages((inp["w"], inp["b"]), world)
    mine = tuple(p[rank] for p in staged)

    def stage_fn(params, x):
        for wi, bi in zip(*params):
            x = torch.tanh(x @ wi + bi)
        return x
    return pipeline(stage_fn, mesh, "stage")(mine, inp["xs"]).numpy()


def _serve_world(rank, world):
    """The serve cases of this world's size."""
    shapes = {(1, 4), (2, 2)} if world == 4 else {(2, 4)}
    return [c for c in cases.serve_cases() if c[2] in shapes]


def job_serve(rank, world, workdir):
    """Each serve case of this world: three steps through
    ``make_serve_step`` (or ``decode_forward`` under the default plan),
    the logits of every step and the final caches gathered whole."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import steps as port_steps
    from repro_torch.models import model as mdl
    from repro_torch.models.blocks import shard_params, unflatten
    from repro_torch.parallel import sharding as shd
    meshes = {}
    out = {}
    for key, arch, shape, bs, sched, dt, plan_kind, embed in \
            _serve_world(rank, world):
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, ("data", "model"), device="cpu")
        mesh = meshes[shape]
        cfg = get_config(arch, smoke=True).replace(
            compute_dtype=dt, collective_schedule=sched, embed_impl=embed)
        data = np.load(os.path.join(workdir, f"serve_{arch}.npz"))
        defs = mdl.model_defs(cfg)
        whole = unflatten({k[2:]: torch.from_numpy(data[k]) for k in data
                           if k.startswith("p:")})
        step_fn = port_steps.make_serve_step(cfg, mesh, bs)
        if plan_kind == "serve":
            plan, run = step_fn.plan, step_fn
        else:
            plan = shd.ShardingPlan(mesh, shd.DEFAULT_RULES)

            def run(p, c, t, s, cfg=step_fn.cfg, plan=plan, mesh=mesh, bs=bs):
                return mdl.decode_forward(p, c, t, s, cfg, mesh=mesh,
                                          batch_shardable=bs, plan=plan,
                                          device="cpu")
        params = shard_params(whole, defs, plan, mesh)
        cdt = getattr(torch, dt)
        cspec = mdl.kv_cache_spec(mesh, bs)
        caches = mdl.init_caches(cfg, cases.SERVE_BATCH, cases.SERVE_SEQ,
                                 mesh=mesh, batch_shardable=bs, dtype=cdt,
                                 device="cpu")
        for name in ("k", "v"):
            full = torch.from_numpy(data[name]).to(cdt)
            caches["layers"]["sub0"][name].copy_(
                shd.shard(full, (None,) + cspec, mesh))
        tok_spec = (mdl._bspec(mesh) if bs else None, None)
        logits = []
        for i in range(cases.SERVE_STEPS):
            tok = shd.shard(torch.from_numpy(data["tokens"][i]).long(),
                            tok_spec, mesh)
            got, caches = run(params, caches, tok,
                              cases.SERVE_START[arch] + i)
            logits.append(shd.gather(got, tok_spec + (None,), mesh).numpy())
        kv = {name: shd.gather(caches["layers"]["sub0"][name],
                               (None,) + cspec, mesh).float().numpy()
              for name in ("k", "v")}
        out[key] = {"logits": np.stack(logits), **kv}
    return out


def job_ckpt_save(rank, world, workdir):
    """Shard a granite smoke tree on a (2, 2) mesh, gather it whole and
    write it from rank 0 (a checkpoint written on 4 ranks)."""
    from repro_torch.checkpoint.sharded import CheckpointManager
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as mdl
    from repro_torch.models.blocks import param_specs, tree_map, unflatten
    from repro_torch.parallel import sharding as shd
    from repro_torch.runtime.elastic import remesh_tree
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    defs = mdl.model_defs(get_config("granite_3_2b", smoke=True))
    data = np.load(os.path.join(workdir, "tree.npz"))
    whole = unflatten({k: data[k] for k in data})
    blocks = remesh_tree(whole, defs, mesh)
    specs = param_specs(defs, shd.ShardingPlan(mesh))
    full = tree_map(lambda b, s: shd.gather(b, s, mesh), blocks, specs)
    if rank == 0:
        CheckpointManager(os.path.join(workdir, "ckpt"),
                          async_write=False).save(7, full, meta={"ranks": 4})
    dist.barrier()
    return {"block_shape": tuple(blocks["blocks"]["sub0"]["ffn"]["wi"].shape)}


def job_ckpt_restore(rank, world, workdir):
    """Restore the 4-rank checkpoint onto a (1, world) mesh and onto the
    plan's blocks of this world; gather them back whole."""
    from repro_torch.checkpoint.sharded import CheckpointManager
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as mdl
    from repro_torch.models.blocks import (param_shardings, param_specs,
                                           tree_leaves, tree_map)
    from repro_torch.parallel import sharding as shd
    mesh = make_mesh((1, world), ("data", "model"), device="cpu")
    defs = mdl.model_defs(get_config("granite_3_2b", smoke=True))
    plan = shd.ShardingPlan(mesh)
    example = tree_map(lambda d: torch.empty(d.shape, device="meta"), defs)
    tree, step, meta = CheckpointManager(os.path.join(workdir, "ckpt")) \
        .restore(example, shardings=param_shardings(defs, plan))
    full = tree_map(lambda b, s: shd.gather(b, s, mesh), tree,
                    param_specs(defs, plan))
    return {"step": step, "meta": meta,
            "leaves": {n: t.numpy() for n, t in tree_leaves(full)},
            "local_wq": tuple(tree["blocks"]["sub0"]["mixer"]["wq"].shape)}


def main():
    job, rank, world, workdir, name = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), sys.argv[4], sys.argv[5]
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, f"store_{name}"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        out = globals()[f"job_{job}"](rank, world, workdir)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    leaked = [m for m in sys.modules if m == "jax" or m.startswith(
        ("jax.", "repro.")) or m == "repro"]
    assert not leaked, leaked
    with open(os.path.join(workdir, f"{name}_{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)


if __name__ == "__main__":
    main()
