"""The port's Gleam collectives and GPipe pipeline on gloo worlds, against
the reference package on forced host devices.

Every function of ``core/collectives.py`` at 2, 4 and 8 ranks on a
one-axis mesh: the broadcasts from each root (the ring with ``chunks`` 1
and 2) bit for bit; the tree reduce and allreduce from each root and the
butterfly with the combines ``add``, ``min`` and ``_softmax_merge``,
``allreduce_sum`` under its four schedules (on a two-leaf tuple) and
``softmax_combine`` under both, within 1e-6 relative, every rank's
value (a tree reduce's partials on the ranks other than the root too).
The reference runs the same cases under ``shard_map`` on the first n of
8 host devices, once per module; the port in three gloo worlds
(``tests/_torch_dist.py``: under its lock, each limit ``MARGIN`` times
the time measured alone), all at once.  Then the
pipeline: ``tests/test_pipeline.py``'s case (8 stages of 2 layers, 4
microbatches) on 8 ranks against the reference's pipelined and
sequential results.  And ``all_to_all`` at every world size and four
(split, concat) pairs: its output and its gradient.
"""
from __future__ import annotations

import numpy as np
import pytest

import _torch_mesh_cases as cases
from _torch_dist import (exclusive, limit, run, start_reference,
                         start_world)

REF_SRC = r"""
import os, pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.core import collectives as coll
from repro.parallel.pipeline import pipeline, pipeline_stages
import _torch_mesh_cases as cases

COMBINE = {"add": jnp.add, "min": jnp.minimum,
           "softmax": coll._softmax_merge}
X = P("x")
out = {}
for n in cases.WORLDS:
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
    inp = cases.collective_inputs(n)
    v, w = jnp.asarray(inp["v"]), jnp.asarray(inp["w"])
    parts = tuple(jnp.asarray(inp[k]) for k in ("m", "l", "acc"))

    def run(fn, args, spec):
        f = shard_map(fn, mesh=mesh, in_specs=spec, out_specs=spec[0],
                      check_vma=False)
        return jax.jit(f)(*args)

    for key, fn, root, arg in cases.collective_cases(n):
        f = getattr(coll, fn)
        if fn in ("tree_broadcast", "unicast_broadcast"):
            got = run(lambda s: f(s, "x", root=root), (v,), (X,))
        elif fn == "ring_broadcast":
            got = run(lambda s: f(s, "x", root=root, chunks=arg), (v,), (X,))
        elif fn in ("tree_reduce", "tree_allreduce", "butterfly_allreduce"):
            kw = {} if fn == "butterfly_allreduce" else {"root": root}
            if arg == "softmax":
                got = run(lambda p: f(p, "x", COMBINE[arg], **kw), (parts,),
                          ((X, X, X),))
            else:
                got = run(lambda s: f(s, "x", COMBINE[arg], **kw), (v,),
                          (X,))
        elif fn == "allreduce_sum":
            got = run(lambda p: f(p, ("x",), schedule=arg), ((v, w),),
                      ((X, X),))
        else:
            got = run(lambda p: f(p, ("x",), schedule=arg), (parts,),
                      ((X, X, X),))
        out[(n, key)] = [np.asarray(g) for g in got] \
            if isinstance(got, tuple) else np.asarray(got)

# the pipeline: tests/test_pipeline.py's case on the cases' inputs
p = cases.PIPE
inp = {k: jnp.asarray(a) for k, a in cases.pipeline_inputs().items()}
mesh = Mesh(np.array(jax.devices()[:p["stages"]]), ("stage",))


def layer(prm, x):
    return jnp.tanh(x @ prm[0] + prm[1])


def stage_fn(stage_params, x):
    y, _ = jax.lax.scan(lambda xx, prm: (layer(prm, xx), None), x,
                        stage_params)
    return y


def full(x):
    y, _ = jax.lax.scan(lambda xx, prm: (layer(prm, xx), None), x,
                        (inp["w"], inp["b"]))
    return y


def body(stage_params, xs):
    stage_params = jax.tree.map(lambda a: a[0], stage_params)
    return jax.lax.psum(pipeline(stage_fn, "stage")(stage_params, xs),
                        "stage")


staged = pipeline_stages((inp["w"], inp["b"]), p["stages"])
f = shard_map(body, mesh=mesh, in_specs=((P("stage"), P("stage")), P()),
              out_specs=P(), check_vma=False)
pipe = {"pipelined": np.asarray(jax.jit(f)(staged, inp["xs"])),
        "sequential": np.asarray(jax.vmap(full)(inp["xs"]))}
with open(os.path.join(sys.argv[1], "reference_0.pkl"), "wb") as fh:
    pickle.dump({"collectives": out, "pipeline": pipe}, fh)
"""

#: seconds each world and the reference took with this module alone on an
#: 8-CPU host, the largest of the runs measured (their limits are
#: ``_torch_dist.limit`` of these: ``MARGIN`` times, at least
#: ``MIN_LIMIT``)
ALONE = {"collectives2": 8.8, "collectives4": 9.6, "collectives8": 11.3,
         "pipeline8": 11.3, "reference": 27.9}
ALL_CASES = [(n,) + c for n in cases.WORLDS for c in cases.collective_cases(n)]
BROADCASTS = ("tree_broadcast", "unicast_broadcast", "ring_broadcast")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("collectives")
    with exclusive():
        ref = start_reference("reference", REF_SRC, 8, workdir,
                              timeout=limit(ALONE["reference"]))
        worlds = {n: start_world("collectives", n, workdir,
                                 timeout=limit(ALONE[f"collectives{n}"]))
                  for n in cases.WORLDS}
        pipe = start_world("pipeline", cases.PIPE["stages"], workdir,
                           timeout=limit(ALONE["pipeline8"]))
        run(*worlds.values(), pipe, ref)
    port = {}
    for n, w in worlds.items():
        ranks = [w.result(r) for r in range(n)]
        for key in ranks[0]:
            per = [r[key] for r in ranks]
            port[(n, key)] = ([np.concatenate([p[i] for p in per])
                               for i in range(len(per[0]))]
                              if isinstance(per[0], list)
                              else np.concatenate(per))
    stages = [pipe.result(r) for r in range(cases.PIPE["stages"])]
    return {"port": port, "pipeline": stages, "ref": ref.result()}


@pytest.mark.parametrize("case", ALL_CASES, ids=lambda c: f"{c[0]}/{c[1]}")
def test_collective_matches_reference(runs, case):
    n, key, fn, root, arg = case
    got = runs["port"][(n, key)]
    want = runs["ref"]["collectives"][(n, key)]
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if fn in BROADCASTS:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    if fn in BROADCASTS:
        # every rank holds the root's block
        rows = got[0].shape[0] // n
        root_block = cases.collective_inputs(n)["v"][root * rows:
                                                     (root + 1) * rows]
        np.testing.assert_array_equal(got[0], np.tile(root_block, (n, 1)))


@pytest.mark.parametrize("dims", cases.ALL_TO_ALL_DIMS,
                         ids=lambda d: f"split{d[0]}_concat{d[1]}")
@pytest.mark.parametrize("n", cases.WORLDS)
def test_all_to_all_and_its_gradient(runs, n, dims):
    """``collectives.all_to_all`` on gloo: each rank's output is block
    ``rank`` of every rank's input concatenated in rank order, and its
    gradient (the exchange back) is autograd's of the same exchange done
    by a differentiable ``all_gather`` and slicing, bit for bit."""
    split, concat = dims
    out, grad, out_ref, grad_ref = runs["port"][(n, f"all_to_all/"
                                                 f"{split}{concat}")]
    inp = cases.all_to_all_inputs(n)
    want = cases.all_to_all_want(inp["x"], split, concat)
    np.testing.assert_array_equal(out, np.concatenate(want))
    np.testing.assert_array_equal(out_ref, out)
    np.testing.assert_array_equal(grad, grad_ref)
    # the gradient is the weights exchanged back
    w = np.stack(inp["w"][cases.ALL_TO_ALL_DIMS.index(dims)])
    np.testing.assert_array_equal(grad, np.concatenate(
        cases.all_to_all_want(w, concat, split)))


def test_pipeline_matches_reference(runs):
    """The last stage holds the pipelined result, equal to the
    reference's pipelined and sequential results within 1e-5; every
    other stage returns zeros."""
    *early, last = runs["pipeline"]
    want = runs["ref"]["pipeline"]
    np.testing.assert_allclose(last, want["pipelined"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(last, want["sequential"], rtol=1e-5,
                               atol=1e-5)
    assert all(not e.any() for e in early)


def test_pipeline_stages_layout():
    import torch
    from repro_torch.parallel.pipeline import pipeline_stages
    w = torch.arange(16 * 3).reshape(16, 3)
    staged = pipeline_stages({"w": w, "pair": (w, w[:, :1])}, 4)
    assert staged["w"].shape == (4, 4, 3)
    assert torch.equal(staged["w"][1, 0], w[4])
    assert staged["pair"][1].shape == (4, 4, 1)
    with pytest.raises(AssertionError):
        pipeline_stages(w, 3)
