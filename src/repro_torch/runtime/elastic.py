"""Elastic scaling: re-mesh a running job onto a different set of ranks.

The port of the reference package's ``runtime/elastic.py``.  The Gleam
mapping: a group membership change is an envelope re-registration.
Losing a pod or gaining one is a control-plane event; the data plane
(the step) is rebuilt against the new mesh while the *logical* state is
untouched:

    1. snapshot the logical state (whole leaves: the checkpoint layout);
    2. build the new mesh and sharding plan (re-registration);
    3. cut every leaf to the new mesh's block (``remesh_tree``);
    4. rebuild the step functions for the new mesh.

``ElasticGroup`` keeps the registry: who is in the group, and the
registration epoch that fences stale members out.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.blocks import param_specs, tree_map
from repro_torch.parallel.sharding import ShardingPlan, shard


def remesh_tree(tree, defs, new_mesh):
    """This rank's blocks on ``new_mesh`` (on its device) of a
    parameter-shaped tree of whole leaves (tensors or arrays), as
    ``ShardingPlan(new_mesh)`` places them (elastic restore)."""
    specs = param_specs(defs, ShardingPlan(new_mesh))

    def move(leaf, spec):
        t = leaf if isinstance(leaf, torch.Tensor) \
            else torch.tensor(np.asarray(leaf))
        return shard(t.to(new_mesh.device), spec, new_mesh)
    return tree_map(move, tree, specs)


@dataclasses.dataclass
class Member:
    name: str
    healthy: bool = True


class ElasticGroup:
    """Membership registry for one logical training or serving group.

    Mirrors the paper's centralised registration: a master (this object)
    collects member states and assigns the epoch, and every
    re-registration bumps it; members of an old epoch are fenced out, the
    analogue of the PSN resync on source switching."""

    def __init__(self, members):
        self.members = {m: Member(m) for m in members}
        self.epoch = 0
        self.log: list = []

    def active(self):
        return [m.name for m in self.members.values() if m.healthy]

    def fail(self, name: str):
        self.members[name].healthy = False
        self.epoch += 1
        self.log.append(("fail", name, self.epoch))

    def join(self, name: str):
        self.members[name] = Member(name)
        self.epoch += 1
        self.log.append(("join", name, self.epoch))

    def is_current(self, epoch: int) -> bool:
        """Fencing: actions from older epochs are rejected."""
        return epoch == self.epoch
