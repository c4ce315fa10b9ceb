"""Checkpoints in the reference package's on-disk layout.

The port of the reference's ``checkpoint/sharded.py`` on one device.  One
directory per step, written exactly as the reference writes it, so that
a checkpoint written by either package restores in the other:

    ckpt_dir/step_000000123/
        MANIFEST.json        # step, time, tree structure, shapes, dtypes, meta
        leaf_00000.npy ...   # one file per leaf, the full array
        COMMITTED            # written last: crash-consistent marker

Leaves are numbered in the reference's flatten order (dict keys sorted
at every level); the tree goes to ``.tmp_step_*`` and is renamed into
place once ``COMMITTED`` is written, and only committed steps count.
With ``async_write`` the device-to-host copy is made at ``save`` and the
disk write runs on one background thread.  Leaves are whole logical
arrays (a caller on a mesh gathers its blocks first,
``parallel/sharding.gather``), which is what makes a restore onto any
other mesh simple: ``restore(..., shardings=)`` loads each whole leaf and
keeps the target mesh's block of it, so a checkpoint written on 4 ranks
restores on 2 or 1.
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import pathlib
import shutil
import time

import numpy as np
import torch

from repro_torch.models.blocks import tree_leaves, tree_map


def treedef_str(tree) -> str:
    """The tree's structure as the reference's manifest writes it
    (``str`` of a JAX treedef): ``PyTreeDef({'a': *, 'b': {}})``."""
    def fmt(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"'{k}': {fmt(node[k])}"
                                   for k in sorted(node)) + "}"
        return "*"
    return f"PyTreeDef({fmt(tree)})"


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _fill(example, leaves):
    """A tree shaped like ``example`` whose leaves come from ``leaves``
    in flatten order."""
    if isinstance(example, dict):
        return {k: _fill(example[k], leaves) for k in sorted(example)}
    return next(leaves)


class CheckpointManager:
    def __init__(self, directory, *, keep: int = 3, async_write: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pool = cf.ThreadPoolExecutor(max_workers=1) \
            if async_write else None
        self._pending: cf.Future | None = None

    # ----------------------------------------------------------- write

    def save(self, step: int, tree, *, meta: dict | None = None) -> None:
        """Snapshot ``tree`` (a nested dict of tensors or arrays) at
        ``step``.  The copy to host memory is made now; with
        ``async_write`` the disk write runs in the background (after the
        previous one has finished), so training goes on meanwhile."""
        host_tree = tree_map(_host, tree)
        if self._pool is None:
            self._write(step, host_tree, meta or {})
            return
        self.wait()
        self._pending = self._pool.submit(self._write, step, host_tree,
                                          meta or {})

    def wait(self) -> None:
        """Block until the pending write (if any) is committed; raises
        what it raised."""
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _write(self, step: int, host_tree, meta: dict) -> None:
        d = self.dir / f"step_{step:09d}"
        tmp = self.dir / f".tmp_step_{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        leaves = [leaf for _, leaf in tree_leaves(host_tree)]
        manifest = {
            "step": step,
            "time": time.time(),
            "treedef": treedef_str(host_tree),
            "n_leaves": len(leaves),
            "leaves": [{"shape": list(l.shape), "dtype": str(l.dtype)}
                       for l in leaves],
            "meta": meta,
        }
        for i, leaf in enumerate(leaves):
            np.save(tmp / f"leaf_{i:05d}.npy", leaf)
        (tmp / "MANIFEST.json").write_text(json.dumps(manifest, indent=1))
        (tmp / "COMMITTED").write_text("ok")
        if d.exists():
            shutil.rmtree(d)
        tmp.rename(d)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # ----------------------------------------------------------- read

    def all_steps(self):
        out = []
        for p in sorted(self.dir.glob("step_*")):
            if (p / "COMMITTED").exists():
                out.append(int(p.name.split("_")[1]))
        return out

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, example_tree, *, step: int | None = None,
                shardings=None):
        """Restore into the structure of ``example_tree`` (the latest
        committed step unless ``step``): ``(tree, step, meta)``, each leaf
        a tensor on its example leaf's device (the CPU for an array), in
        the dtype it was saved in.  Raises if the leaf count or a shape
        differs from the example (whose leaves have the whole logical
        shapes).

        ``shardings``: a tree like ``example_tree`` of
        ``parallel/sharding.NamedSharding`` on the TARGET mesh (elastic
        restore: the mesh the checkpoint was written on does not
        matter); each leaf is then this rank's block of the whole leaf,
        on the mesh's device."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        d = self.dir / f"step_{step:09d}"
        manifest = json.loads((d / "MANIFEST.json").read_text())
        examples = [leaf for _, leaf in tree_leaves(example_tree)]
        if manifest["n_leaves"] != len(examples):
            raise ValueError(f"checkpoint has {manifest['n_leaves']} "
                             f"leaves, the model expects {len(examples)}")
        loaded = []
        for i, ex in enumerate(examples):
            arr = np.load(d / f"leaf_{i:05d}.npy")
            if tuple(arr.shape) != tuple(ex.shape):
                raise ValueError(f"leaf {i}: checkpoint {arr.shape} != "
                                 f"model {tuple(ex.shape)}")
            dev = ex.device if isinstance(ex, torch.Tensor) \
                and shardings is None else "cpu"
            loaded.append(torch.from_numpy(arr).to(dev))
        tree = _fill(example_tree, iter(loaded))
        if shardings is not None:
            from repro_torch.parallel.sharding import shard
            tree = tree_map(lambda t, s: shard(t, s.spec, s.mesh).to(
                s.mesh.device), tree, shardings)
        return tree, step, manifest["meta"]
