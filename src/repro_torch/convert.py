"""Carry state across from the reference package.

A topology and a workload (the flow engine's state: a fabric and the
operations staged on it), and a model's parameters.  Every function
reads the reference's objects by duck typing (attributes, ``to_dict``,
nested dicts of arrays), never by importing the reference package, and
builds the port's own objects so both packages can be fed the same
inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fattree import Link, Topology
from repro_torch.core.workload import Workload
from repro_torch.models.blocks import tree_leaves


def topology_from_reference(topo) -> Topology:
    """A port ``Topology`` equal to a reference one.

    Copies hosts and switches in order, every node's port map, every
    directed link's bandwidth and delay in the reference's insertion
    order (which fixes the dense link ids of ``LinkMap``), and the set of
    links that are down.
    """
    out = Topology()
    for h in topo.hosts:
        out.add_host(h)
    for s in topo.switches:
        out.add_switch(s)
    for node, ports in topo.ports.items():
        out.ports[node] = dict(ports)
    for key, link in topo.links.items():
        out.links[key] = Link(float(link.bw), float(link.delay))
    out._down = set(topo.down_links())
    out._struct_rev = 1
    out._fp = (out._struct_rev, frozenset(out._down))
    return out


def workload_from_reference(wl) -> Workload:
    """A port ``Workload`` equal to a reference one (through its dict)."""
    return Workload.from_dict(wl.to_dict())


def params_from_reference(tree) -> dict:
    """The reference's parameter tree (nested dicts of arrays) as a
    state dict of the port's ``models.model.Model``: one CPU tensor per
    leaf under its dotted name (``blocks.sub0.mixer.wq``), stacked
    ``(n_blocks, ...)`` layouts kept.  Load it with
    ``model.load_state_dict``."""
    return {name: torch.tensor(np.asarray(leaf))
            for name, leaf in tree_leaves(tree)}
