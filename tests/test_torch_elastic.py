"""The port's elastic runtime and checkpoint restore onto another mesh,
against the reference's ``TestElastic`` (``tests/test_runtime.py``).

``remesh_tree`` on one device keeps every leaf; ``ElasticGroup`` fences
stale epochs with the reference's log.  A checkpoint of a granite smoke
tree sharded on a (2, 2) gloo world, gathered and written from rank 0,
restores onto (1, 2) ranks (each keeping its block under
``ShardingPlan``) and onto one device, in both packages: every leaf the
original's bits.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from _torch_dist import exclusive, limit, run, start_world
from repro.checkpoint.sharded import CheckpointManager as RefCkpt
from repro.configs import base as ref_base
from repro.launch.mesh import single_device_mesh as ref_single
from repro.models import blocks as ref_blocks
from repro.models import model as ref_model
from repro.parallel.sharding import ShardingPlan as RefPlan
from repro.runtime.elastic import ElasticGroup as RefGroup
from repro.runtime.elastic import remesh_tree as ref_remesh
from repro_torch.checkpoint.sharded import CheckpointManager
from repro_torch.configs import base as port_base
from repro_torch.launch.mesh import single_device_mesh
from repro_torch.models import blocks as port_blocks
from repro_torch.models import model as port_model
from repro_torch.parallel.sharding import ShardingPlan
from repro_torch.runtime.elastic import ElasticGroup, remesh_tree


def granite_tree():
    """Seed-0 reference parameters of the granite smoke config, as a
    nested dict of numpy arrays."""
    cfg = ref_base.get_config("granite_3_2b", smoke=True)
    params = ref_blocks.init_params(ref_model.model_defs(cfg),
                                    jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def test_remesh_roundtrip_matches_reference():
    tree = granite_tree()
    defs = port_model.model_defs(port_base.get_config("granite_3_2b",
                                                      smoke=True))
    moved = remesh_tree(tree, defs, single_device_mesh(device="cpu"))
    want = ref_remesh(tree, ref_model.model_defs(
        ref_base.get_config("granite_3_2b", smoke=True)), ref_single())
    got = dict(port_blocks.tree_leaves(moved))
    for name, leaf in port_blocks.tree_leaves(jax.tree.map(np.asarray, want)):
        assert isinstance(got[name], torch.Tensor)
        np.testing.assert_array_equal(got[name].numpy(), leaf)


def test_group_epoch_fencing_matches_reference():
    groups = [ElasticGroup(["pod0", "pod1"]), RefGroup(["pod0", "pod1"])]
    for g in groups:
        e0 = g.epoch
        g.fail("pod1")
        assert g.active() == ["pod0"]
        assert not g.is_current(e0)            # stale epoch fenced
        g.join("pod2")
        assert "pod2" in g.active() and g.is_current(g.epoch)
    assert groups[0].log == groups[1].log
    assert groups[0].epoch == groups[1].epoch == 2


#: seconds each world took with this module alone on an 8-CPU host (their
#: limits are ``_torch_dist.limit`` of these: ``MARGIN`` times, at least
#: ``MIN_LIMIT``)
ALONE = {"ckpt_save4": 2.1, "ckpt_restore2": 2.0}


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The tree written from a 4-rank (2, 2) world, then restored in a
    2-rank world."""
    workdir = tmp_path_factory.mktemp("elastic")
    tree = granite_tree()
    np.savez(workdir / "tree.npz", **dict(port_blocks.tree_leaves(tree)))
    with exclusive():
        save, = run(start_world("ckpt_save", 4, workdir,
                                timeout=limit(ALONE["ckpt_save4"])))
        restore, = run(start_world("ckpt_restore", 2, workdir,
                                   timeout=limit(ALONE["ckpt_restore2"])))
    return {"tree": tree, "dir": workdir, "save": save.result(),
            "restore": [restore.result(r) for r in range(2)]}


def test_checkpoint_written_on_4_ranks_restores_on_2(written):
    want = dict(port_blocks.tree_leaves(written["tree"]))
    assert written["save"]["block_shape"] == (2, 32, 64)   # d/2, d_ff/2
    for got in written["restore"]:
        assert got["step"] == 7 and got["meta"] == {"ranks": 4}
        assert got["local_wq"] == (2, 64, 2, 16)             # heads / 2
        assert set(got["leaves"]) == set(want)
        for name, leaf in want.items():
            np.testing.assert_array_equal(got["leaves"][name], leaf)


def test_checkpoint_written_on_4_ranks_restores_on_1_in_both(written):
    ckpt = written["dir"] / "ckpt"
    defs = port_model.model_defs(port_base.get_config("granite_3_2b",
                                                      smoke=True))
    mesh = single_device_mesh(device="cpu")
    shardings = port_blocks.param_shardings(defs, ShardingPlan(mesh))
    example = port_blocks.tree_map(
        lambda d: torch.empty(d.shape, device="meta"), defs)
    tree, step, _ = CheckpointManager(ckpt).restore(example,
                                                    shardings=shardings)
    want = dict(port_blocks.tree_leaves(written["tree"]))
    assert step == 7
    for name, leaf in port_blocks.tree_leaves(tree):
        assert leaf.device.type == "cpu"
        np.testing.assert_array_equal(leaf.numpy(), want[name])
    # the reference restores the port's checkpoint onto its one device
    rdefs = ref_model.model_defs(ref_base.get_config("granite_3_2b",
                                                     smoke=True))
    rmesh = ref_single()
    rtree, rstep, meta = RefCkpt(ckpt).restore(
        written["tree"], shardings=ref_blocks.param_shardings(
            rdefs, RefPlan(rmesh)))
    assert rstep == 7 and meta == {"ranks": 4}
    for name, leaf in port_blocks.tree_leaves(jax.tree.map(np.asarray,
                                                           rtree)):
        np.testing.assert_array_equal(leaf, want[name])


def test_reference_checkpoint_restores_onto_the_port_mesh(tmp_path):
    """A checkpoint the reference writes restores in the port with
    shardings: each leaf the reference's."""
    tree = granite_tree()
    RefCkpt(tmp_path, async_write=False).save(3, tree, meta={"by": "ref"})
    defs = port_model.model_defs(port_base.get_config("granite_3_2b",
                                                      smoke=True))
    mesh = single_device_mesh(device="cpu")
    got, step, meta = CheckpointManager(tmp_path).restore(
        tree, shardings=port_blocks.param_shardings(defs, ShardingPlan(mesh)))
    assert (step, meta) == (3, {"by": "ref"})
    want = dict(port_blocks.tree_leaves(tree))
    for name, leaf in port_blocks.tree_leaves(got):
        np.testing.assert_array_equal(leaf.numpy(), want[name])
