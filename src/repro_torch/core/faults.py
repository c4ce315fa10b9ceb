"""Fault-injection plane — timed fabric/endpoint faults on the Workload IR.

The paper's failure story stops at a single silent receiver crash
detected by the master (Appendix B).  At datacenter scale the dominant
pathologies are the ones *around* that: links flapping, whole switches
failing, hosts going dark mid-stream, and the master itself dying.
``FaultEvent`` makes those first-class, deterministic scenario inputs,
mirroring PR-5's ``MemberEvent``: a ``GroupOp`` carries a tuple of
timed faults, and each engine lowers them onto its own machinery (the
packet engine as scheduled callbacks on the typed event loop, the flow
engine as piecewise capacity/stall segments — ``core/engine.py``).

Fault taxonomy (see docs/ARCHITECTURE.md "Fault model & recovery"):

=================  ======================  ==============================
kind               target fields           recovery path
=================  ======================  ==============================
``link_down``      ``node`` + ``peer``     leaf detect -> master re-runs
                                           Alg. 4 installs on surviving
                                           paths (``ack_psn`` reseeded)
``link_flap``      + ``duration``          as link_down; link restores
                                           itself after ``duration``
``switch_fail``    ``node`` (switch)       as link_down, every port at once
``host_gone_dark`` ``node`` (host)         switch-originated teardown
                                           confirm, no master round-trip
``master_crash``   (current master)        member-driven re-election:
                                           lowest-rank survivor takes
                                           source rotation + teardown
                                           authority (Appendix B general-
                                           ized); in-flight tail resent
                                           from the dead sender's
                                           ``snd_una``
=================  ======================  ==============================

``validate_fault_plan`` is the engine-side topology check: IR
validation cannot know the fabric, so the engines call it at staging
time to reject plans that permanently disconnect a surviving member
(e.g. failing the only leaf above a host — model that as
``host_gone_dark`` instead).

The port's own copy of the reference ``core/faults.py``: the port imports
nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Set, Tuple

__all__ = [
    "FAULT_CHOICES", "DEFAULT_FAIL_DETECT", "DEFAULT_LINK_DETECT",
    "DEFAULT_FAULT_RETRIES", "FaultEvent", "validate_fault_plan",
]

# Timed fault kinds a dynamic GroupOp may carry.
FAULT_CHOICES = ("link_down", "link_flap", "switch_fail",
                 "host_gone_dark", "master_crash")

# How long the master takes to notice a silently-failed receiver before
# isolating its port (keepalive-timeout scale, >> RTO so the sender has
# visibly wedged by the time isolation un-wedges it).  The reference
# defines it in core/gleam.py; here it sits beside DEFAULT_LINK_DETECT so
# the flow engine reads it without loading the packet simulator, and
# gleam.py re-exports it.
DEFAULT_FAIL_DETECT = 1e-3

# Link-layer loss-of-signal detection delay (seconds): how long until
# the switch adjacent to a dead link/port notices and starts local
# repair.  Deliberately much shorter than the master's keepalive-based
# ``DEFAULT_FAIL_DETECT`` (1 ms, above) — loss of light is a hardware
# signal, a dead process is a timeout.
DEFAULT_LINK_DETECT = 100e-6

# Default RoCE-style retry budget applied to QPs in fault scenarios
# (endpoint.py accepts any cap; None = legacy unbounded retransmission,
# which is what non-fault scenarios keep for bit-identical results).
DEFAULT_FAULT_RETRIES = 7


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One timed fault on a dynamic GroupOp.

    ``at`` is seconds after the op's submission.  ``node``/``peer``
    name the target: both endpoints for a link fault (order
    irrelevant), the switch for ``switch_fail``, the host for
    ``host_gone_dark``; ``master_crash`` targets whoever holds the
    master role at ``at`` and takes no target fields.  ``duration``
    (link_flap only) is how long the link stays dark before restoring
    itself.
    """

    kind: str
    at: float
    node: str = ""
    peer: str = ""
    duration: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_CHOICES:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; choose from "
                f"{FAULT_CHOICES}")
        if self.at < 0:
            raise ValueError(f"fault time must be >= 0, got {self.at}")
        if self.kind in ("link_down", "link_flap"):
            if not self.node or not self.peer:
                raise ValueError(
                    f"{self.kind} needs both link endpoints "
                    f"(node={self.node!r}, peer={self.peer!r})")
            if self.node == self.peer:
                raise ValueError(f"{self.kind}: node == peer {self.node!r}")
        elif self.kind in ("switch_fail", "host_gone_dark"):
            if not self.node:
                raise ValueError(f"{self.kind} needs a target node")
            if self.peer:
                raise ValueError(f"{self.kind} takes no peer field")
        else:                                   # master_crash
            if self.node or self.peer:
                raise ValueError(
                    "master_crash targets the current master; it takes "
                    "no node/peer fields")
        if self.kind == "link_flap":
            if self.duration <= 0:
                raise ValueError(
                    f"link_flap needs duration > 0, got {self.duration}")
        elif self.duration:
            raise ValueError(f"{self.kind} takes no duration")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultEvent":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown FaultEvent fields: {sorted(unknown)}")
        return cls(**d)


def fault_downs(faults: Sequence[FaultEvent], topo
                ) -> List[Tuple[float, float, List[Tuple[str, str]]]]:
    """Lower fabric faults to ``(t_down, t_up, [(a, b) links])`` spans.

    ``switch_fail`` expands to every link of the switch; ``t_up`` is
    ``inf`` except for flaps.  Host/master faults carry no fabric
    links (the NIC goes dark, the links stay up)."""
    spans = []
    for f in sorted(faults, key=lambda f: f.at):
        if f.kind in ("link_down", "link_flap"):
            up = f.at + f.duration if f.kind == "link_flap" else float("inf")
            spans.append((f.at, up, [(f.node, f.peer)]))
        elif f.kind == "switch_fail":
            links = [(f.node, peer)
                     for _, (peer, _) in sorted(topo.ports[f.node].items())]
            spans.append((f.at, float("inf"), links))
    return spans


def validate_fault_plan(topo, op) -> None:
    """Reject fault plans that permanently disconnect a surviving member.

    Applies the op's fabric faults to ``topo`` in time order (flapped
    links are treated as permanently down while deciding survivability
    — a plan must not *depend* on the flap healing) and checks every
    member still present reaches the source of record at that instant.
    The topology is always restored before returning.
    """
    spans = fault_downs(op.faults, topo)
    if not spans:
        return
    roles = op.fault_roles()
    downed: Set[Tuple[str, str]] = set()
    try:
        for at, _, links in spans:
            for a, b in links:
                if (a, b) not in downed:
                    topo.set_link_down(a, b, True)
                    downed.add((a, b))
            source = roles["source_at"](at)
            for m in roles["present_at"](at):
                if m == source:
                    continue
                try:
                    reachable = topo.dist(source, m) >= 0
                except (KeyError, ValueError):
                    reachable = False
                if not reachable:
                    raise ValueError(
                        f"fault plan disconnects {m!r} from source "
                        f"{source!r} at t={at} (use host_gone_dark for "
                        f"a stranded host)")
    finally:
        for a, b in downed:
            topo.set_link_down(a, b, False)
