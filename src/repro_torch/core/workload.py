"""Workload IR — engine-agnostic group operations with first-class
transport strategies.

The paper's headline results (§5, Figs. 9-16) are *comparisons*: the
same group operation carried by Gleam's in-fabric multicast vs the
application-layer transports of §2.3 (multiple unicasts, pipelined
ring, binary tree).  This module makes that comparison axis a *value*
instead of a parallel class hierarchy:

- ``GroupOp``   — one declarative group operation: ``op`` (bcast /
  write / unicast / allreduce), ``members``, ``nbytes``, and a
  ``transport`` naming how the bytes move (``gleam`` | ``multiunicast``
  | ``ring`` | ``binary-tree``).
- ``MemberEvent`` — a timed membership change riding a ``GroupOp``:
  ``kind`` (``join`` | ``leave`` | ``fail`` | ``master-switch``),
  ``member``, and ``at`` (seconds after the op's submission).  A
  ``GroupOp`` with a non-empty ``events`` tuple is a *dynamic* op: the
  engines lower the events onto their membership control plane (the
  packet engine schedules in-band MFT-update envelopes; the flow
  engine integrates piecewise-membership segments — see
  ``core/engine.py`` and ``docs/ARCHITECTURE.md``).
- ``Workload``  — an ordered batch of ``GroupOp``s that runs as ONE
  independent scenario (no bandwidth sharing with other workloads).
- the **transport registry** — ``Transport`` descriptors looked up by
  ``get_transport``; each engine lowers a descriptor its own way (the
  packet engine onto the ``baselines`` relay machinery, the flow
  engine onto the transport's relay edge-set; see ``core/engine.py``).

Both simulation engines consume the IR through one entry point:

    rec  = eng.stage(GroupOp("bcast", members, nbytes,
                             transport="ring"))   # -> MsgRecord
    recs = eng.run_workloads([wl_a, wl_b])        # batched scenarios

which replaces the deprecated per-op staging methods (``add_bcast`` /
``add_write`` / ``add_unicast`` — thin shims now delegate here).

The IR is plain data: ``to_dict`` / ``from_dict`` round-trip a
``Workload`` through JSON-compatible dicts, so sweeps can be declared
in config files and checked into reference fixtures
(``tools/check_fig09.py`` drives CI's divergence gate this way).

The four built-in transports register at the end of this module, with
the relay edge-sets of the reference's ``core/baselines.py``.  Each
relay transport's packet-level runner (``packet_bcast``) imports the
port's ``core/baselines.py`` at its first call, so a flow-only user never
loads the packet engine (the reference registers the transports from
``baselines.py`` on first lookup instead).  ``register_transport``
accepts additional strategies.

This module is the port's own copy of the reference ``core/workload.py``
(the port imports nothing of the reference package).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.faults import FAULT_CHOICES, FaultEvent

__all__ = [
    "OP_CHOICES", "TRANSPORT_CHOICES", "EVENT_CHOICES", "FAULT_CHOICES",
    "RELAY_OVERHEAD", "GroupOp", "MemberEvent", "FaultEvent", "Workload",
    "Transport", "register_transport", "get_transport", "transport_names",
]

OP_CHOICES = ("bcast", "write", "unicast", "allreduce")

# Timed membership events a dynamic GroupOp may carry (§3.4 maintenance).
EVENT_CHOICES = ("join", "leave", "fail", "master-switch")

# The four §5 transport strategies.  The registry may hold more
# (register_transport), but these are what --transport advertises.
TRANSPORT_CHOICES = ("gleam", "multiunicast", "ring", "binary-tree")

# Spelling tolerance: the pre-IR baselines API called the binary tree
# "bintree"; argparse-unfriendly spellings normalize too.
_TRANSPORT_ALIASES = {
    "bintree": "binary-tree",
    "binary_tree": "binary-tree",
    "binarytree": "binary-tree",
    "multi-unicast": "multiunicast",
}

# Host store-and-forward cost per relayed message (RX stack -> CPU ->
# TX stack, §2.3) — the overlay transports' per-hop software penalty.
# Lives here (not baselines.py) because every engine's overlay lowering
# needs it; baselines re-exports it for compatibility.
RELAY_OVERHEAD = 1.5e-6


# ============================================================== registry

@dataclasses.dataclass(frozen=True)
class Transport:
    """How a one-to-many operation moves bytes.

    ``relay_edges(members) -> [(parent, child), ...]`` is the overlay
    relay schedule over the member list (source first); ``None`` means
    the transport is *native* — the fabric itself replicates (Gleam)
    and the engine's multicast machinery applies.  ``chunked``
    transports pipeline the message in ``GroupOp.chunks`` segments,
    re-serialized at every relay hop.  ``packet_bcast(net, members,
    chunks, **qp_kw)`` builds the packet-level runner (a
    ``baselines._Bcast``); ``None`` again means native.
    """

    name: str
    relay_edges: Optional[Callable[[Sequence[str]],
                                   List[Tuple[str, str]]]] = None
    chunked: bool = False
    packet_bcast: Optional[Callable] = None

    @property
    def native(self) -> bool:
        return self.relay_edges is None


_TRANSPORTS: Dict[str, Transport] = {}


def register_transport(t: Transport) -> Transport:
    """Add a transport strategy to the registry (last writer wins)."""
    _TRANSPORTS[t.name] = t
    return t


def transport_names() -> Tuple[str, ...]:
    """Registered transport names."""
    return tuple(sorted(_TRANSPORTS))


def canonical_transport(name: str) -> str:
    """Normalize aliases and validate; raises ValueError when unknown."""
    canon = _TRANSPORT_ALIASES.get(name, name)
    if canon not in _TRANSPORTS:
        raise ValueError(
            f"unknown transport {name!r}; choose from "
            f"{tuple(sorted(_TRANSPORTS))}")
    return canon


def get_transport(name: str) -> Transport:
    """Look up a transport by name; ValueError lists the valid names."""
    return _TRANSPORTS[canonical_transport(name)]


# ==================================================================== IR

@dataclasses.dataclass(frozen=True)
class MemberEvent:
    """One timed membership change on a dynamic GroupOp.

    ``at`` is seconds after the op's submission.  ``join`` adds a host
    that is not yet a member (it locks onto the live PSN stream and is
    not required to deliver the in-flight message); ``leave`` is the
    graceful departure of a receiver; ``fail`` is a silent receiver
    crash (isolated by the master after its failure-detection delay);
    ``master-switch`` hands the master+source roles to another member
    (Appendix B, no re-registration).
    """

    kind: str
    member: str
    at: float

    def __post_init__(self):
        if self.kind not in EVENT_CHOICES:
            raise ValueError(
                f"unknown event kind {self.kind!r}; choose from "
                f"{EVENT_CHOICES}")
        if not self.member:
            raise ValueError("event member must be a host name")
        if self.at < 0:
            raise ValueError(f"event time must be >= 0, got {self.at}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "MemberEvent":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown MemberEvent fields: {sorted(unknown)}")
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class GroupOp:
    """One declarative group operation.

    ``members`` is the participant list; the first member is the
    source unless ``source`` overrides it.  ``unicast`` takes exactly
    ``(src, dst)``.  ``transport`` selects the strategy (see
    TRANSPORT_CHOICES); ``chunks`` is the pipeline depth of the
    chunked overlay transports (ring / binary-tree) and ignored
    elsewhere; ``same_mr`` is the Appendix-C WRITE optimization
    (gleam only); ``key`` seeds ECMP spreading; ``events`` is the
    timed membership-change list making the op *dynamic*.  Joins,
    fails, and master-switches need the native gleam transport (the
    overlay relays have no in-fabric membership to update), but a
    graceful ``leave`` is valid on the overlays too: the engines
    resplice the relay schedule around the departing host at the
    leave instant (the dark-relay repair machinery, minus the
    failure-detection delay).

    ``phase`` is a free-form application label (``"tp-allreduce"``,
    ``"prefill"``, …) carried through to dicts and ignored by the
    engines — ``apps/metrics.py`` groups records by it.

    ``faults`` is the timed fault-injection list (``core/faults.py``):
    link/switch/master faults require the native transport (the fabric
    recovery paths are Gleam machinery); ``host_gone_dark`` is also
    valid on the overlay relays, where the engines repair the relay
    schedule around the dead host instead.

    ``loss_rate`` / ``ecn_backlog`` are the §5 loss/congestion
    scenario parameters (Figs. 15/16), carried in the IR so a sweep
    point is one serializable value: ``loss_rate`` is the per-hop
    switch-egress drop probability; ``ecn_backlog`` the egress-queue
    depth (bytes) beyond which packets are ECN-marked (DCQCN).
    ``None`` defers to the engine-level setting.  The packet engine
    applies them to the fabric (they are physical, hence global per
    scenario — conflicting non-None values in one run are an error);
    the flow engines fold them into the expected-value loss model
    (``core/flowsim.py``).
    """

    op: str
    members: Tuple[str, ...]
    nbytes: int
    transport: str = "gleam"
    source: Optional[str] = None
    same_mr: bool = False
    key: int = 0
    chunks: int = 8
    events: Tuple[MemberEvent, ...] = ()
    faults: Tuple[FaultEvent, ...] = ()
    loss_rate: Optional[float] = None
    ecn_backlog: Optional[float] = None
    phase: str = ""

    def __post_init__(self):
        object.__setattr__(self, "members", tuple(self.members))
        object.__setattr__(self, "transport",
                           canonical_transport(self.transport))
        object.__setattr__(self, "events", tuple(
            e if isinstance(e, MemberEvent) else MemberEvent.from_dict(e)
            for e in self.events))
        object.__setattr__(self, "faults", tuple(
            f if isinstance(f, FaultEvent) else FaultEvent.from_dict(f)
            for f in self.faults))
        if self.op not in OP_CHOICES:
            raise ValueError(
                f"unknown op {self.op!r}; choose from {OP_CHOICES}")
        if self.nbytes <= 0:
            raise ValueError(f"nbytes must be positive, got {self.nbytes}")
        if self.chunks < 1:
            raise ValueError(f"chunks must be >= 1, got {self.chunks}")
        if self.op == "unicast":
            if len(self.members) != 2:
                raise ValueError("unicast takes exactly (src, dst) members, "
                                 f"got {len(self.members)}")
        elif len(self.members) < 2:
            raise ValueError(f"{self.op} needs >= 2 members, "
                             f"got {len(self.members)}")
        if self.source is not None and self.source not in self.members:
            raise ValueError(f"source {self.source!r} not in members")
        if self.loss_rate is not None and not 0.0 <= self.loss_rate < 1.0:
            raise ValueError(
                f"loss_rate must be in [0, 1), got {self.loss_rate}")
        if self.ecn_backlog is not None and self.ecn_backlog <= 0.0:
            raise ValueError(
                f"ecn_backlog must be positive bytes, got {self.ecn_backlog}")
        if self.events:
            self._check_events()
        if self.faults:
            self._replay_dynamics()            # validates as it replays

    def _check_events(self) -> None:
        """Replay the membership timeline so invalid sequences fail at
        construction, not mid-simulation."""
        if self.op not in ("bcast", "write"):
            raise ValueError(
                f"membership events require a bcast/write op, not {self.op}")
        if not get_transport(self.transport).native:
            bad = [e for e in self.events if e.kind != "leave"]
            if bad:
                raise ValueError(
                    "only graceful 'leave' events are valid on an overlay "
                    f"relay transport; {self.transport!r} got "
                    f"{bad[0].kind!r} (join/fail/master-switch need the "
                    "native gleam fabric)")
        present = set(self.members)
        source = self.source or self.members[0]
        for e in sorted(self.events, key=lambda e: e.at):
            if e.kind == "join":
                if e.member in present:
                    raise ValueError(
                        f"join: {e.member!r} is already a member at t={e.at}")
                present.add(e.member)
            elif e.kind in ("leave", "fail"):
                if e.member not in present:
                    raise ValueError(
                        f"{e.kind}: {e.member!r} is not a member at t={e.at}")
                if e.member == source:
                    raise ValueError(
                        f"{e.kind}: {e.member!r} is the current source "
                        f"(switch the master first)")
                present.remove(e.member)
            else:                           # master-switch
                if e.member not in present:
                    raise ValueError(
                        f"master-switch: {e.member!r} is not a member "
                        f"at t={e.at}")
                source = e.member

    def ordered_members(self) -> List[str]:
        """Members with the effective source rotated to the front —
        the relay order the overlay schedules consume."""
        members = list(self.members)
        src = self.source or members[0]
        if members[0] != src:
            members.remove(src)
            members.insert(0, src)
        return members

    def sorted_events(self) -> List[MemberEvent]:
        """Events in time order (stable for equal ``at``)."""
        return sorted(self.events, key=lambda e: e.at)

    def sorted_faults(self) -> List[FaultEvent]:
        """Faults in time order (stable for equal ``at``)."""
        return sorted(self.faults, key=lambda f: f.at)

    def _replay_dynamics(self) -> dict:
        """Replay the merged event+fault timeline (events first on
        ties), validating it and returning the role bookkeeping the
        fault-aware lowerings share.  The re-election rule mirrors the
        runtime (``gleam.MulticastGroup``): member rank is list order
        (source first, joins appended), and a crashed master hands the
        source role to the lowest-rank survivor."""
        if self.op not in ("bcast", "write"):
            raise ValueError(
                f"faults require a bcast/write op, not {self.op}")
        native = get_transport(self.transport).native
        order = self.ordered_members()
        present = set(order)
        source = order[0]
        sources = {source}
        dark: set = set()
        snaps: List[Tuple[float, frozenset, str]] = []
        timeline = sorted(
            [(e.at, 0, e) for e in self.events]
            + [(f.at, 1, f) for f in self.faults],
            key=lambda x: (x[0], x[1]))
        for at, is_fault, ev in timeline:
            if not is_fault:
                # _check_events validated the event stream alone; the
                # merged replay re-checks against fault-induced removals
                if ev.kind == "join":
                    if ev.member in present:
                        raise ValueError(
                            f"join: {ev.member!r} already a member at "
                            f"t={at}")
                    present.add(ev.member)
                    order.append(ev.member)
                elif ev.kind in ("leave", "fail"):
                    if ev.member not in present or ev.member == source:
                        raise ValueError(
                            f"{ev.kind}: {ev.member!r} is not a removable "
                            f"member at t={at} (fault interleaving)")
                    present.discard(ev.member)
                    order.remove(ev.member)
                else:                           # master-switch
                    if ev.member not in present:
                        raise ValueError(
                            f"master-switch: {ev.member!r} is not a member "
                            f"at t={at} (fault interleaving)")
                    source = ev.member
                    sources.add(source)
            elif ev.kind == "host_gone_dark":
                if ev.node not in present:
                    raise ValueError(
                        f"host_gone_dark: {ev.node!r} is not a member "
                        f"at t={at}")
                if ev.node == source:
                    raise ValueError(
                        f"host_gone_dark: {ev.node!r} is the current "
                        f"source (use master_crash)")
                present.discard(ev.node)
                order.remove(ev.node)
                dark.add(ev.node)
            elif ev.kind == "master_crash":
                if not native:
                    raise ValueError(
                        "master_crash requires the native (gleam) "
                        f"transport, not {self.transport!r}")
                if len(present) < 2:
                    raise ValueError(
                        f"master_crash at t={at}: no survivor left to "
                        f"re-elect (need >= 2 live members)")
                present.discard(source)
                order.remove(source)
                dark.add(source)
                source = order[0]               # lowest-rank survivor
                sources.add(source)
            else:                               # link/switch fabric fault
                if not native:
                    raise ValueError(
                        f"{ev.kind} requires the native (gleam) "
                        f"transport, not {self.transport!r}")
            snaps.append((at, frozenset(present), source))
        return {"present": frozenset(present), "source": source,
                "sources": frozenset(sources), "dark": frozenset(dark),
                "snaps": snaps}

    def fault_roles(self) -> dict:
        """Membership/source timeline of the merged event+fault replay.

        Returns ``present`` / ``source`` / ``sources`` (every member
        that ever held the source role) / ``dark`` plus ``present_at``
        and ``source_at`` closures over the replay snapshots (state
        *after* everything scheduled at or before the queried time)."""
        roles = self._replay_dynamics()
        snaps = roles["snaps"]
        init = (frozenset(self.ordered_members()), self.ordered_members()[0])

        def _at(t: float) -> Tuple[frozenset, str]:
            state = init
            for at, present, source in snaps:
                if at > t:
                    break
                state = (present, source)
            return state

        roles["present_at"] = lambda t: _at(t)[0]
        roles["source_at"] = lambda t: _at(t)[1]
        return roles

    def surviving_receivers(self) -> List[str]:
        """Initial receivers that are still members when every event has
        fired — the set a dynamic op must deliver to (joiners receive
        from their join point and are not required to complete the
        in-flight message).  With faults, members that went dark or ever
        held the source role (a re-elected master re-originates the
        stream instead of receiving it) are excused too."""
        src = self.source or self.members[0]
        gone = {e.member for e in self.events
                if e.kind in ("leave", "fail")}
        if not self.faults:
            return [m for m in self.members if m != src and m not in gone]
        roles = self._replay_dynamics()
        return [m for m in self.members
                if m in roles["present"] and m not in roles["sources"]]

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "GroupOp":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown GroupOp fields: {sorted(unknown)}")
        return cls(**d)


@dataclasses.dataclass
class Workload:
    """An ordered batch of GroupOps run as ONE independent scenario.

    The builder methods append an op and return it, so benchmark code
    can keep a handle for record lookup:

        wl = Workload("fig09/1MB")
        wl.bcast(members, 1 << 20)                       # gleam
        wl.bcast(members, 1 << 20, transport="ring")     # baseline
        recs = eng.run_workloads([wl])[0]                # per-op records

    ``meta`` is a JSON-compatible free-form dict for generator
    provenance (arrival seed / rate / trace, mesh shape, model name —
    see ``apps/``), round-tripped by ``to_dict``/``from_dict`` so a
    staged app workload is replayable from its serialized form.
    """

    name: str = ""
    ops: List[GroupOp] = dataclasses.field(default_factory=list)
    meta: Dict = dataclasses.field(default_factory=dict)

    def add(self, op: GroupOp) -> GroupOp:
        self.ops.append(op)
        return op

    def bcast(self, members: Sequence[str], nbytes: int, **kw) -> GroupOp:
        return self.add(GroupOp("bcast", tuple(members), nbytes, **kw))

    def write(self, members: Sequence[str], nbytes: int, **kw) -> GroupOp:
        return self.add(GroupOp("write", tuple(members), nbytes, **kw))

    def unicast(self, src: str, dst: str, nbytes: int, **kw) -> GroupOp:
        return self.add(GroupOp("unicast", (src, dst), nbytes, **kw))

    def allreduce(self, members: Sequence[str], nbytes: int,
                  **kw) -> GroupOp:
        return self.add(GroupOp("allreduce", tuple(members), nbytes, **kw))

    def __len__(self) -> int:
        return len(self.ops)

    def to_dict(self) -> dict:
        d = {"name": self.name, "ops": [op.to_dict() for op in self.ops]}
        if self.meta:               # omitted when empty: old fixtures stable
            d["meta"] = dict(self.meta)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Workload":
        unknown = set(d) - {"name", "ops", "meta"}
        if unknown:
            raise ValueError(f"unknown Workload fields: {sorted(unknown)}")
        return cls(name=d.get("name", ""),
                   ops=[GroupOp.from_dict(o) for o in d.get("ops", [])],
                   meta=dict(d.get("meta", {})))


# relay_plan memo: staging sweeps re-plan the same (transport, member
# tuple) constantly.  Keyed by transport identity (the object is held in
# the value, so a recycled id() can never alias a dead transport);
# coarse-cleared past the cap.
_PLAN_MEMO: Dict[tuple, tuple] = {}
_PLAN_MEMO_ENTRIES = 1 << 16


def relay_plan(transport: Transport, members: Sequence[str]
               ) -> List[Tuple[str, str, int]]:
    """Lowered overlay schedule: ``(parent, child, hops_from_source)``
    per relay edge, hops computed by walking the edge list's parent
    chain — any registered transport only has to provide edges.
    Memoized; each call returns a fresh list."""
    key = (id(transport), tuple(members))
    hit = _PLAN_MEMO.get(key)
    if hit is not None and hit[0] is transport:
        return list(hit[1])
    plan = _relay_plan_uncached(transport, members)
    if len(_PLAN_MEMO) >= _PLAN_MEMO_ENTRIES:
        _PLAN_MEMO.clear()
    _PLAN_MEMO[key] = (transport, plan)
    return list(plan)


def _relay_plan_uncached(transport: Transport, members: Sequence[str]
                         ) -> List[Tuple[str, str, int]]:
    edges = transport.relay_edges(members)
    parent = {b: a for a, b in edges}
    hops: Dict[str, int] = {members[0]: 0}

    def depth(node: str) -> int:
        chain = []
        while node not in hops:                 # iterative: rings are deep
            chain.append(node)
            node = parent[node]
        d = hops[node]
        for n in reversed(chain):
            d = hops[n] = d + 1
        return d

    return [(a, b, depth(b)) for a, b in edges]


# ======================================================= built-in transports

def ring_edges(members: Sequence[str]) -> List[Tuple[str, str]]:
    """Pipeline ring relay edges: 0 -> 1 -> 2 -> ... -> n-1."""
    return [(members[i], members[i + 1]) for i in range(len(members) - 1)]


def binary_tree_edges(members: Sequence[str]) -> List[Tuple[str, str]]:
    """Binary tree relay edges: member i relays to 2i+1, 2i+2."""
    out = []
    for i, m in enumerate(members):
        for c in (2 * i + 1, 2 * i + 2):
            if c < len(members):
                out.append((m, members[c]))
    return out


def multiunicast_edges(members: Sequence[str]) -> List[Tuple[str, str]]:
    """Fig. 2a: one sender edge per receiver (no relaying)."""
    return [(members[0], m) for m in members[1:]]


def _packet_runner(name: str) -> Callable:
    """The packet-level runner of relay transport ``name``: the relay
    class of ``core/baselines.py``, imported at the first call."""
    def run(net, members, chunks, **qp_kw):
        from repro_torch.core.baselines import PACKET_RUNNERS
        return PACKET_RUNNERS[name](net, members, chunks, **qp_kw)
    return run


# The four §5 transport strategies.  "gleam" is native: no relay edges,
# the engines use their own multicast machinery (switch replication /
# one flow over the distribution tree).
register_transport(Transport("gleam"))
register_transport(Transport(
    "multiunicast", relay_edges=multiunicast_edges, chunked=False,
    packet_bcast=_packet_runner("multiunicast")))
register_transport(Transport(
    "ring", relay_edges=ring_edges, chunked=True,
    packet_bcast=_packet_runner("ring")))
register_transport(Transport(
    "binary-tree", relay_edges=binary_tree_edges, chunked=True,
    packet_bcast=_packet_runner("binary-tree")))
