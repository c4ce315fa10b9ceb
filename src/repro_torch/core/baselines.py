"""Application-layer multicast baselines (§2.3, Fig. 2a/2b).

The overlay *schedules* (which host relays to which) are plain edge
lists — ``ring_edges`` / ``binary_tree_edges`` — shared by both
simulation backends, so packet-level and flow-level runs of the same
baseline route identically:

- ``MultiUnicastBcast`` — the sender transmits identical data over one RC
  connection per receiver (Fig. 2a): sender-link bottleneck.
- ``RingBcast``         — overlay pipeline (the HPL *increasing-ring*):
  the message is split into chunks; receiver i relays each chunk to i+1
  after a host forwarding overhead (RX stack -> CPU -> TX stack, §2.3).
- ``BinaryTreeBcast``   — overlay binomial/binary tree relay, the
  double-binary-tree family's single-tree member.

The classes run over plain RC unicast QPs in the packet simulator and
record per-receiver delivery times so JCT is measured exactly like the
Gleam path.

Each baseline is also registered as a first-class **transport** in the
Workload-IR registry (``core/workload.py``), so any engine stages it
through the uniform API:

    eng.stage(GroupOp("bcast", members, nbytes, transport="ring"))

The packet engine lowers the transport onto the relay classes below;
the flow engine lowers it onto the relay edge-set (``ring_edges`` etc.)
and applies the pipelined-round structure analytically on the fluid
steady-state hop time (the standard scalable approximation) — see
``core/engine.py``.  ``flow_baseline_jct`` survives as a thin legacy
wrapper over that path.

The port's own copy of the reference ``core/baselines.py``: the port imports
nothing of the reference package.  The edge functions live once, in the
port's ``core/workload.py``, which registers the four transports; each
relay transport's ``packet_bcast`` there imports this module at its first
packet run (``PACKET_RUNNERS``), so a flow-only user never loads the packet
engine.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

from repro_torch.core import workload as wl
from repro_torch.core.gleam import GleamNetwork
from repro_torch.core.workload import binary_tree_edges, ring_edges

# host store-and-forward cost per message (canonical home: workload.py)
RELAY_OVERHEAD = wl.RELAY_OVERHEAD


class _Bcast:
    def __init__(self, net: GleamNetwork, members: Sequence[str]):
        self.net = net
        self.members = list(members)
        self.source = self.members[0]
        self.t_deliver: Dict[str, float] = {}
        self.t_start = 0.0

    def n_receivers(self) -> int:
        return len(self.members) - 1

    def jct(self) -> float:
        if len(self.t_deliver) < self.n_receivers():
            return float("inf")
        return max(self.t_deliver.values()) - self.t_start

    def run(self, timeout: float = 10.0) -> float:
        sim = self.net.sim
        deadline = sim.now + timeout
        while len(self.t_deliver) < self.n_receivers():
            before = sim.events
            sim.run(until=deadline)
            if sim.events == before or sim.now >= deadline:
                break
        return self.jct()

    def repair_dead_relay(self, member: str, now: float) -> None:
        """A receiver went dark (detected): stop waiting for it.  The
        relay subclasses also splice the schedule around the hole."""
        if member in self.members and member != self.source:
            self.members.remove(member)
            self.t_deliver.pop(member, None)


class MultiUnicastBcast(_Bcast):
    """Fig. 2a: n-1 serialized copies through the sender's link."""

    def __init__(self, net: GleamNetwork, members: Sequence[str], **qp_kw):
        super().__init__(net, members)
        self.qps = []
        for r in self.members[1:]:
            qa, qb = net.unicast_qp(self.source, r, **qp_kw)
            qb.on_deliver = self._mk_deliver(r)
            self.qps.append((qa, qb))

    def _mk_deliver(self, member):
        def fn(msg_id, now):
            if member not in self.members:      # spliced out (leave): the
                return                          # host is up but no longer
            self.t_deliver[member] = now        # a receiver
        return fn

    def start(self, nbytes: int) -> None:
        sim = self.net.sim
        self.t_start = sim.now
        for qa, _ in self.qps:
            qa.submit(nbytes, sim.now)
        sim.kick(sim.hosts[self.source], sim.now)


class _RelayBcast(_Bcast):
    """Common machinery for overlay relays: edges (parent -> child), each
    chunk is re-submitted downstream `RELAY_OVERHEAD` after delivery."""

    def __init__(self, net: GleamNetwork, members: Sequence[str],
                 chunks: int = 8, relay_overhead: float = RELAY_OVERHEAD,
                 **qp_kw):
        super().__init__(net, members)
        self.chunks = max(1, chunks)
        self.relay_overhead = relay_overhead
        self._qp_kw = dict(qp_kw)                      # for repair re-wiring
        self.edges = self._edges()                     # (parent, child)
        self.children: Dict[str, List[str]] = {}
        for a, b in self.edges:
            self.children.setdefault(a, []).append(b)
        self.qp_out: Dict[tuple, object] = {}
        self.n_chunks_done: Dict[str, int] = {}
        for a, b in self.edges:
            qa, qb = net.unicast_qp(a, b, **qp_kw)
            self.qp_out[(a, b)] = qa
            qb.on_deliver = self._mk_deliver(b)
        self.chunk_bytes = 0

    def _edges(self) -> List[tuple]:
        raise NotImplementedError

    def _mk_deliver(self, member: str):
        def fn(msg_id, now):
            if member not in self.members:      # spliced out (leave/dark):
                return                          # don't count or relay
            self.n_chunks_done[member] = self.n_chunks_done.get(member, 0) + 1
            if self.n_chunks_done[member] == self.chunks:
                self.t_deliver[member] = now
            # relay this chunk downstream after the host forwarding cost
            for c in self.children.get(member, ()):
                qp = self.qp_out[(member, c)]
                sim = self.net.sim
                t = now + self.relay_overhead
                sim.schedule(t, lambda tt, q=qp, n=self.chunk_bytes, m=msg_id:
                             self._relay(q, member, n, m, tt))
        return fn

    def _relay(self, qp, member, nbytes, msg_id, now):
        qp.submit(nbytes, now, msg_id=msg_id)
        self.net.sim.kick(self.net.sim.hosts[member], now)

    def start(self, nbytes: int) -> None:
        sim = self.net.sim
        self.t_start = sim.now
        self.chunk_bytes = max(1, math.ceil(nbytes / self.chunks))
        for c in self.children.get(self.source, ()):
            qp = self.qp_out[(self.source, c)]
            for k in range(self.chunks):
                qp.submit(self.chunk_bytes, sim.now, msg_id=k)
        sim.kick(sim.hosts[self.source], sim.now)

    def repair_dead_relay(self, member: str, now: float) -> None:
        """Splice the relay schedule around a dark relay: its children
        re-parent onto ITS parent (ring: the chain re-links; tree: the
        grandparent adopts), fresh QPs are wired for the new edges, and
        the full chunk stream is resubmitted on each — a software relay
        keeps no per-child progress state, so conservative full
        resubmission is the overlay's go-back-N.  The chunk counter
        counts duplicates as progress (a child that already held k
        chunks delivers after ``chunks - k`` repaired arrivals), which
        is the same first-order bookkeeping the flow engine's repaired-
        schedule model applies analytically."""
        if member not in self.members or member == self.source:
            return
        sim = self.net.sim
        kids = self.children.pop(member, [])
        parent = next((a for a, b in self.edges if b == member),
                      self.source)
        super().repair_dead_relay(member, now)
        self.edges = [(a, b) for a, b in self.edges
                      if a != member and b != member]
        for c in kids:
            self.edges.append((parent, c))
            self.children.setdefault(parent, []).append(c)
            qa, qb = self.net.unicast_qp(parent, c, **self._qp_kw)
            self.qp_out[(parent, c)] = qa
            qb.on_deliver = self._mk_deliver(c)
            for k in range(self.chunks):
                qa.submit(self.chunk_bytes, now, msg_id=k)
        if kids:
            sim.kick(sim.hosts[parent], now)


class RingBcast(_RelayBcast):
    """Overlay pipeline ring: 0 -> 1 -> 2 -> ... -> n-1."""

    def _edges(self):
        return ring_edges(self.members)


class BinaryTreeBcast(_RelayBcast):
    """Overlay binary tree: member i relays to 2i+1, 2i+2."""

    def _edges(self):
        return binary_tree_edges(self.members)


# ----------------------------------------------------- transport registry

BASELINE_KINDS = ("multiunicast", "ring", "bintree")


def _packet_multiunicast(net, members, chunks, **qp_kw):
    return MultiUnicastBcast(net, members, **qp_kw)   # chunking n/a


def _packet_ring(net, members, chunks, **qp_kw):
    return RingBcast(net, members, chunks=chunks, **qp_kw)


def _packet_binary_tree(net, members, chunks, **qp_kw):
    return BinaryTreeBcast(net, members, chunks=chunks, **qp_kw)


#: the packet runner of each relay transport; ``core/workload.py``
#: registers the transports and reaches these at their first packet run
PACKET_RUNNERS = {
    "multiunicast": _packet_multiunicast,
    "ring": _packet_ring,
    "binary-tree": _packet_binary_tree,
}


# ------------------------------------------------------------ flow level

def flow_baseline_jct(engine, kind: str, members: Sequence[str],
                      nbytes: int, *, chunks: int = 8,
                      relay_overhead: float = RELAY_OVERHEAD,
                      key: int = 0) -> float:
    """Legacy fluid-model JCT of an overlay baseline on a flow engine.

    Thin wrapper over the Workload-IR path: stages one bcast GroupOp
    with the requested transport and returns its JCT (the engines'
    overlay lowering stages every relay edge as a concurrent flow and
    applies the pipelined-round structure on the steady-state chunk
    time — see ``core/engine.py``).  Prefer ``engine.stage`` directly.
    """
    n = len(members)
    if n <= 1:
        return 0.0
    op = wl.GroupOp("bcast", tuple(members), nbytes, transport=kind,
                    chunks=chunks, key=key)
    old_overhead = getattr(engine, "relay_overhead", relay_overhead)
    engine.relay_overhead = relay_overhead
    try:
        rec = engine.stage(op)
        engine.run()
    finally:
        engine.relay_overhead = old_overhead
    return rec.jct(n - 1)
