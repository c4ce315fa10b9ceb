"""One rank of a gloo world for the port's mesh tests.

    python tests/_torch_mesh_worker.py JOB RANK WORLD WORKDIR NAME

Joins the world NAME through a ``FileStore`` under WORKDIR (60 s
timeout), runs JOB and writes this rank's results to
``WORKDIR/NAME_<rank>.pkl``: rank 0 all of them, another rank only what
its test reads (``RANK_VIEW``).  Imports torch, numpy
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
    for case, (split, concat) in enumerate(cases.ALL_TO_ALL_DIMS):
        out[f"all_to_all/{split}{concat}"] = _all_to_all_case(
            rank, world, mesh, case, split, concat)
    # an axis of size 1 returns its input untouched
    one = make_mesh((1, world), ("one", "x"), device="cpu")
    for fn in ("tree_broadcast", "unicast_broadcast", "ring_broadcast"):
        assert getattr(coll, fn)(v, one, "one") is v, fn
    assert coll.butterfly_allreduce(v, one, "one", torch.add) is v
    for sched in cases.SOFTMAX_SCHEDULES:
        got = coll.softmax_combine(parts, one, ("one",), schedule=sched)
        assert all(torch.equal(g, p) for g, p in zip(got, parts)), sched
    return out


def _all_to_all_case(rank, world, mesh, case, split, concat):
    """``coll.all_to_all`` of this rank's block and the gradient of its
    output's weighted sum, beside the same exchange done by ``all_gather``
    (differentiable, its backward the reduce-scatter) and slicing:
    ``[out, grad, out by all_gather, grad by all_gather]``."""
    inp = cases.all_to_all_inputs(world)
    w = torch.from_numpy(inp["w"][case][rank])
    outs = []
    for exchange in ("all_to_all", "all_gather"):
        x = torch.from_numpy(inp["x"][rank]).requires_grad_()
        if exchange == "all_to_all":
            y = coll.all_to_all(x, mesh, "x", split, concat)
        else:
            whole = coll.all_gather(x[None], mesh, ("x",), 0)
            y = torch.cat([b.chunk(world, split)[rank] for b in whole],
                          dim=concat)
        (g,) = torch.autograd.grad((y * w).sum(), x)
        outs += [y.detach().numpy(), g.numpy()]
    return outs


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


def job_families(rank, world, workdir):
    """Each family case of this world (4 ranks: (1, 4) and (2, 2); 8:
    (1, 8)): three steps through ``make_serve_step`` from caches filled
    whole and cut to the rank's blocks, the logits of every step and
    every final cache leaf gathered whole (``serve``; the float64 runs
    of ``float64_cases`` in ``float64``); and the sublayer pieces of
    ``_family_pieces`` (``pieces``)."""
    meshes, out, out64 = {}, {}, {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, ("data", "model"), device="cpu")
        return meshes[shape]

    for key, arch, shape, bs, sched, dt in cases.family_cases():
        if shape[0] * shape[1] == world:
            out[key] = _family_serve(arch, mesh_of(shape), bs, sched, dt,
                                     workdir)
    for key, arch, shape, bs in cases.float64_cases():
        if shape[0] * shape[1] == world:
            out64[key] = _family_serve(arch, mesh_of(shape), bs, "xla",
                                       "float64", workdir)
    return {"serve": out, "float64": out64,
            "pieces": _family_pieces(world, workdir)}


def _family_serve(arch, mesh, bs, sched, dt, workdir):
    """Three steps of ``arch``'s smoke config through ``make_serve_step``
    on ``mesh`` in ``dt``: the logits of every step, the plan, and every
    final cache leaf gathered whole."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import steps as port_steps
    from repro_torch.models import model as mdl
    from repro_torch.models.blocks import shard_params, tree_leaves, unflatten
    from repro_torch.parallel import sharding as shd
    cfg = get_config(arch, smoke=True).replace(compute_dtype=dt,
                                               collective_schedule=sched)
    data = np.load(os.path.join(workdir, f"family_{arch}.npz"))
    step_fn = port_steps.make_serve_step(cfg, mesh, bs)
    whole = unflatten({k[2:]: torch.from_numpy(data[k]) for k in data
                       if k.startswith("p:")})
    params = shard_params(whole, mdl.model_defs(cfg), step_fn.plan, mesh)
    cdt = getattr(torch, dt)
    caches = mdl.init_caches(step_fn.cfg, cases.SERVE_BATCH,
                             cases.SERVE_SEQ, mesh=mesh,
                             batch_shardable=bs, dtype=cdt, device="cpu")
    specs = dict(tree_leaves(mdl.cache_specs(
        cfg, cases.SERVE_BATCH, cases.SERVE_SEQ, mesh, bs)))
    for name, t in tree_leaves(caches):
        t.copy_(shd.shard(torch.from_numpy(data[f"c:{name}"]).to(t.dtype),
                          specs[name], mesh))
    tok_spec = (mdl._bspec(mesh) if bs else None, None)
    logits = []
    for i in range(cases.SERVE_STEPS):
        tok = shd.shard(torch.from_numpy(data["tokens"][i]).long(),
                        tok_spec, mesh)
        got, caches = step_fn(params, caches, tok,
                              cases.FAMILY_START[arch] + i)
        logits.append(shd.gather(got, tok_spec + (None,), mesh).numpy())
    wide = torch.promote_types(cdt, torch.float32)
    return {"logits": np.stack(logits),
            "plan": "default" if step_fn.cfg.fsdp_weights else "inference",
            **{f"c:{n}": shd.gather(t, specs[n], mesh).to(wide).numpy()
               for n, t in tree_leaves(caches)}}


class _RankChannelsOnly:
    """``core.collectives`` with ``all_gather`` replaced by one that puts
    the rank's block in place and zeros elsewhere: the Mamba-2 step's new
    conv column written from the rank's channels alone."""

    def __getattr__(self, name):
        return getattr(coll, name)

    @staticmethod
    def all_gather(x, mesh, axes, dim):
        from repro_torch.parallel import sharding as shd
        index, count = shd.block(mesh, axes)
        parts = [torch.zeros_like(x) for _ in range(count)]
        parts[index] = x
        return torch.cat(parts, dim=dim)


def _per_rank_norm(y, scale, eps, mesh, axes, width):
    """The gated norm over the rank's channels alone."""
    from repro_torch.models.blocks import rms_norm
    return rms_norm(y, scale, eps)


#: each mutant of ``cases.SSM_MUTANTS`` as the ``models.ssm`` global it
#: replaces
SSM_MUTANTS = {"per_rank_norm": ("_gated_norm", _per_rank_norm),
               "rank_channels_conv": ("coll", _RankChannelsOnly())}


def _family_pieces(world, workdir):
    """Each family's sublayer kinds of block 0 in float32 on this world's
    meshes: the rank's blocks (split-KV attention with the owner's write,
    the cross-attention, the Mamba-2 step on its heads, the MLP, the MoE)
    against the whole sublayer on this rank, on the same input and
    caches.  Every rank returns, for the output and every new cache leaf,
    max |mesh - whole| over 1e-5 (1 + max |whole|): a sublayer sums
    terms on the scale of its largest output, so its float32 rounding is
    on that scale (``tools/chip_mesh.py``'s band of a sublayer)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import steps as port_steps
    from repro_torch.models import model as mdl
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.blocks import (param_specs, rms_norm,
                                           shard_params, tree_map, unflatten)
    from repro_torch.parallel import sharding as shd
    patterns = {a: get_config(a, smoke=True).pattern
                for a in cases.FAMILY_ARCHES}
    meshes, out = {}, {}

    def ratio(got, want):
        return float((got - want).abs().max()
                     / (1e-5 * (1 + want.abs().max())))

    for key, arch, shape, bs, j, part, kind in cases.piece_cases(patterns):
        if shape[0] * shape[1] != world:
            continue
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, ("data", "model"), device="cpu")
        mesh = meshes[shape]
        cfg = get_config(arch, smoke=True).replace(compute_dtype="float32")
        step_fn = port_steps.make_serve_step(cfg, mesh, bs)
        cfg = step_fn.cfg
        data = np.load(os.path.join(workdir, f"family_{arch}.npz"))
        whole = unflatten({k[2:]: torch.from_numpy(data[k]) for k in data
                           if k.startswith("p:")})
        defs = mdl.model_defs(cfg)
        sub = f"sub{j}"
        mine = tree_map(lambda a: a[0], shard_params(
            whole, defs, step_fn.plan, mesh)["blocks"][sub][part])
        full = tree_map(lambda a: a[0], whole["blocks"][sub][part])
        sp = tree_map(lambda s: s[1:], param_specs(
            defs, step_fn.plan)["blocks"][sub][part])
        cspecs = mdl.cache_specs(cfg, cases.SERVE_BATCH, cases.SERVE_SEQ,
                                 mesh, bs)
        rows = (mdl._bspec(mesh) if bs else None,)
        batch_axes = shd.entry_axes(rows, 0)
        x = torch.from_numpy(np.random.default_rng(j).standard_normal(
            (cases.SERVE_BATCH, 1, cfg.d_model)).astype(np.float32))
        step = cases.FAMILY_START[arch]

        def leaf(name, spec=None):
            t = torch.from_numpy(data[f"c:{name}"])
            return t if spec is None else shd.shard(t, spec, mesh)

        res = {}
        if part == "ffn":
            got, _ = mdl.ffn_apply(mine, shd.shard(x, rows, mesh), kind, cfg,
                                   decode=True, sp=sp, mesh=mesh,
                                   batch_axes=batch_axes)
            want, _ = mdl.ffn_apply(full, x, kind, cfg, decode=True)
            res["out"] = ratio(shd.gather(got, rows, mesh), want)
        elif kind == "mamba":
            lsp = {n: sp_[1:] for n, sp_ in cspecs["layers"][sub].items()}
            cache = {n: leaf(f"layers.{sub}.{n}")[0] for n in ("conv",
                                                            "state")}
            mc = {n: shd.shard(t, lsp[n], mesh) for n, t in cache.items()}
            hm = rms_norm(x, full["norm"], cfg.norm_eps)
            def drop(p):
                return {k: v for k, v in p.items() if k != "norm"}
            want, new1 = ssm_mod.ssm_decode_step(drop(full), hm, cache, cfg)

            def on_mesh():
                got, new = ssm_mod.ssm_decode_step(drop(mine), shd.shard(
                    hm, rows, mesh), mc, cfg, sp=drop(sp), mesh=mesh)
                r = {"out": ratio(shd.gather(got, rows, mesh), want)}
                for n in new:
                    r[n] = ratio(shd.gather(new[n], lsp[n], mesh), new1[n])
                return r
            res = on_mesh()
            for mkey, mutant in cases.mutant_cases():
                if mkey != key:
                    continue
                name, wrong = SSM_MUTANTS[mutant]
                right = getattr(ssm_mod, name)
                setattr(ssm_mod, name, wrong)
                try:
                    out[f"{key}/{mutant}"] = on_mesh()
                finally:
                    setattr(ssm_mod, name, right)
        else:
            kvspec = cspecs["layers"][sub]["k"][1:]
            kv = {n: leaf(f"layers.{sub}.{n}")[0] for n in ("k", "v")}
            mkv = {n: shd.shard(t, kvspec, mesh).clone() for n, t in
                   kv.items()}
            n_slots = kv["k"].shape[1]
            slot = step % n_slots
            seq_axes = mdl._seq_axes(mesh, bs)
            index, _ = shd.block(mesh, seq_axes)
            owner, local = divmod(slot, mkv["k"].shape[1])
            positions = torch.full((cases.SERVE_BATCH, 1), step)

            def insert(kc, vc, k, v):
                if owner == index:
                    return mdl.cache_insert(kc, vc, k, v, local)
                return kc, vc

            def core(q, kc, vc):
                return mdl.split_kv_attention(q, kc, vc, step, cfg, mesh,
                                              seq_axes)

            def insert1(kc, vc, k, v):
                return mdl.cache_insert(kc, vc, k, v, slot)

            def core1(q, kc, vc):
                return mdl.decode_attn_core(q, kc, vc, torch.full(
                    (q.shape[0],), min(step + 1, n_slots),
                    dtype=torch.int32), cfg)
            memory = leaf("memory") if cfg.enc_layers else None
            got = mdl.attn_decode_apply(
                mine, shd.shard(x, rows, mesh), mkv,
                shd.shard(positions, rows, mesh), insert, core, cfg,
                None if memory is None else shd.shard(
                    memory, cspecs["memory"], mesh), sp=sp, mesh=mesh)
            want = mdl.attn_decode_apply(full, x, kv, positions, insert1,
                                         core1, cfg, memory)
            res["out"] = ratio(shd.gather(got, rows, mesh), want)
            for n in ("k", "v"):
                res[n] = ratio(shd.gather(mkv[n], kvspec, mesh), kv[n])
        out[key] = res
    return out


def _train_run(arch, mesh, embed, workdir, dtype, mutant=None,
               data_name=None):
    """``arch``'s smoke config in ``dtype`` on ``mesh``, every result
    gathered whole: the loss, metrics and every gradient leaf of
    ``loss_fn`` over the whole batch (``accumulate_grads`` then
    ``sync_grads``, the train step's own parts), and one
    ``make_train_step`` step at ``TRAIN_ACCUM`` (its metrics, the
    gradient it hands AdamW and the updated parameters).  ``mutant``
    replaces one part by a wrong one (``cases.TRAIN_MUTANTS``,
    ``cases.MOE_MUTANTS``).  The inputs are ``WORKDIR/<data_name>.npz``
    (``train_<arch>`` by default): the parameters, the batch and its
    modality inputs."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import steps
    from repro_torch.models import model as mdl
    from repro_torch.models.blocks import (shard_params, tree_leaves,
                                           tree_map, unflatten)
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    cfg = get_config(arch, smoke=True).replace(
        compute_dtype=str(dtype)[6:], embed_impl=embed)
    data = np.load(os.path.join(workdir,
                                f"{data_name or 'train_' + arch}.npz"))
    whole = unflatten({k[2:]: torch.from_numpy(data[k]).to(dtype)
                       for k in data if k.startswith("p:")})
    defs = mdl.model_defs(cfg)
    specs = mdl.train_specs(cfg, mesh)
    rows = (mdl._bspec(mesh), None)
    batch = {k: shd.shard(torch.from_numpy(data[k]), rows, mesh)
             for k in ("tokens", "targets", "loss_mask") + cases.MODALITIES
             if k in data}
    batch["loss_mask"] = batch["loss_mask"].to(dtype)

    def gather(tree):
        return {n: shd.gather(t, sp, mesh).double().numpy().copy()
                for (n, t), (_, sp) in zip(tree_leaves(tree),
                                           tree_leaves(specs))}

    saved, seen, apply = {}, [], adamw.apply

    def recorded(opt_cfg, params, state, grads, **kw):
        seen.append(gather(grads))
        return apply(opt_cfg, params, state, grads, **kw)
    from repro_torch.models import moe
    wrong = {"no_model_psum": (coll, "grad_psum", lambda x, mesh, axes: x),
             "own_mask_sum": (mdl, "_mask_total",
                              lambda mask, mesh, axes: mask.sum()),
             "own_rows_microbatches": (steps, "microbatches", _own_rows),
             **{name: (moe, "coll", cases.MoEMutant(name, coll))
                for name, _ in cases.MOE_MUTANTS}}
    patches = [(adamw, "apply", recorded)]
    if mutant:
        patches.append(wrong[mutant])
    for module, name, fn in patches:
        saved[(module, name)] = getattr(module, name)
        setattr(module, name, fn)
    try:
        params = shard_params(whole, defs, shd.ShardingPlan(mesh), mesh)
        grads = tree_map(torch.zeros_like, params)
        metrics = steps.accumulate_grads(params, batch, cfg, grads,
                                         mesh=mesh, device="cpu")
        steps.sync_grads(grads, specs, mesh)
        step = steps.make_train_step(
            cfg, adamw.AdamWConfig(warmup_steps=1), cases.TRAIN_ACCUM,
            mesh=mesh)
        new_p, _, step_m = step(params, adamw.init(params), batch)
    finally:
        for (module, name), fn in saved.items():
            setattr(module, name, fn)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": gather(grads),
            "step": {"metrics": {k: float(v) for k, v in step_m.items()},
                     "grads": seen[0], "params": gather(new_p)}}


def _own_rows(batch, accum, mesh):
    """Microbatches cut from this rank's own rows (a mutant)."""
    n = len(batch["tokens"]) // accum
    return [{k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            for i in range(accum)]


def job_train(rank, world, workdir):
    """Each train case of this world's meshes: ``_train_run`` in float32
    and float64, the prefill step's last-position logits in float32 (and
    bf16 for ``cases.bf16_cases``), and the mutants of
    ``cases.TRAIN_MUTANTS``."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import steps
    from repro_torch.models import model as mdl
    from repro_torch.models.blocks import shard_params, unflatten
    from repro_torch.parallel import sharding as shd
    meshes, out = {}, {}
    bf16 = {key for key, _, _ in cases.bf16_cases()}
    for key, arch, shape, embed in cases.train_cases():
        if shape[0] * shape[1] != world:
            continue
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, ("data", "model"), device="cpu")
        mesh = meshes[shape]
        res = {dt: _train_run(arch, mesh, embed, workdir, getattr(torch, dt))
               for dt in ("float32", "float64")}
        data = np.load(os.path.join(workdir, f"train_{arch}.npz"))
        whole = unflatten({k[2:]: torch.from_numpy(data[k]) for k in data
                           if k.startswith("p:")})
        rows = (mdl._bspec(mesh), None)
        for dt, toks in (("float32", "tokens"), ("bfloat16", "prefill16")):
            if dt == "bfloat16" and key not in bf16:
                continue
            cfg = get_config(arch, smoke=True).replace(compute_dtype=dt,
                                                       embed_impl=embed)
            params = shard_params(whole, mdl.model_defs(cfg),
                                  shd.ShardingPlan(mesh), mesh)
            logits = steps.make_prefill_step(cfg, mesh=mesh)(
                params, {"tokens": shd.shard(torch.from_numpy(data[toks]),
                                             rows, mesh)})
            res[f"prefill_{dt}"] = shd.gather(logits, rows + (None,),
                                              mesh).numpy()
        for mutant, mkey in cases.TRAIN_MUTANTS:
            if mkey == key:
                res[mutant] = _train_run(arch, mesh, embed, workdir,
                                         torch.float32, mutant)
        out[key] = res
    return out


def job_train_families(rank, world, workdir):
    """Each case of ``cases.family_train_cases`` on this world's meshes:
    ``_train_run`` in float32 and float64, the prefill step's
    last-position logits in float32 (and bf16 for
    ``cases.bf16_family_cases``), and the mutants of
    ``cases.MOE_MUTANTS``."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import steps
    from repro_torch.models import model as mdl
    from repro_torch.models.blocks import shard_params, unflatten
    from repro_torch.parallel import sharding as shd
    meshes, out = {}, {}
    bf16 = {key for key, _, _ in cases.bf16_family_cases()}
    for key, arch, shape, seq in cases.family_train_cases():
        if shape[0] * shape[1] != world:
            continue
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, ("data", "model"), device="cpu")
        mesh = meshes[shape]
        name = f"family_train_{arch}_s{seq}"
        res = {dt: _train_run(arch, mesh, "gather", workdir,
                              getattr(torch, dt), data_name=name)
               for dt in ("float32", "float64")}
        data = np.load(os.path.join(workdir, f"{name}.npz"))
        whole = unflatten({k[2:]: torch.from_numpy(data[k]) for k in data
                           if k.startswith("p:")})
        rows = (mdl._bspec(mesh), None)
        for dt, toks in (("float32", "tokens"), ("bfloat16", "prefill16")):
            if dt == "bfloat16" and key not in bf16:
                continue
            cfg = get_config(arch, smoke=True).replace(compute_dtype=dt)
            params = shard_params(whole, mdl.model_defs(cfg),
                                  shd.ShardingPlan(mesh), mesh)
            batch = {k: shd.shard(torch.from_numpy(data[k]), rows, mesh)
                     for k in cases.MODALITIES if k in data}
            batch["tokens"] = shd.shard(torch.from_numpy(data[toks]), rows,
                                        mesh)
            logits = steps.make_prefill_step(cfg, mesh=mesh)(params, batch)
            res[f"prefill_{dt}"] = shd.gather(logits, rows + (None,),
                                              mesh).numpy()
        for mutant, mkey in cases.MOE_MUTANTS:
            if mkey == key:
                res[mutant] = _train_run(arch, mesh, "gather", workdir,
                                         torch.float32, mutant,
                                         data_name=name)
        out[key] = res
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


#: what a rank other than 0 writes of a job's results, where its test
#: reads less than rank 0's (the others write everything)
RANK_VIEW = {
    "serve": lambda out: {},
    "families": lambda out: {"pieces": out["pieces"]},
    "train": lambda out: {key: {"float32": {"step": {
        "metrics": res["float32"]["step"]["metrics"]}}}
        for key, res in out.items()},
}
RANK_VIEW["train_families"] = RANK_VIEW["train"]


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
    if rank and job in RANK_VIEW:
        out = RANK_VIEW[job](out)
    with open(os.path.join(workdir, f"{name}_{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)


if __name__ == "__main__":
    main()
