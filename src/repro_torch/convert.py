"""Carry a topology and a workload across from the reference package.

The port's state is a fabric and the operations staged on it, so this is
its counterpart of carrying weights across: both functions read the
reference's objects by duck typing (attributes and ``to_dict``), never by
importing the reference package, and rebuild the port's own objects so
both packages can be fed the same inputs.
"""
from __future__ import annotations

from repro_torch.core.fattree import Link, Topology
from repro_torch.core.workload import Workload


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
