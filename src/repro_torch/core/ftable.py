"""The extended multicast forwarding table (Fig. 5) — the foundation of
Gleam's in-fabric logic.

Indexed by GroupIP; holds
- group-level state: ``last_ack_psn``, ``ack_out_port`` (the port data
  packets enter, learned from the data plane — this also implements the
  source-switching detection of Appendix B), the pending-NACK record
  (``nack_epsn``), and per-port congestion counters for CNP filtering
  (§3.5);
- port-level entries (one per tree port): type ``connected`` (directly
  attached receiver: carries its L3/L4 and MR rewrite states) or
  ``forwarded`` (next hop is a switch); both carry the per-port
  cumulative ``ack_psn``.

Memory accounting mirrors the paper's claim (§3.3: 1K groups <= 0.92MB when
every group uses all n ports): ``entry_bytes``/``table_bytes`` let the
tests reproduce that arithmetic.

The port's own copy of the reference ``core/ftable.py``: the port imports
nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.packet import (PSN_MOD, PSN_WINDOW, PSN_WINDOW_P4,
                                     psn_geq, psn_min)

CONNECTED = "connected"
FORWARDED = "forwarded"

# Per-entry state sizes in bytes (Fig. 5 scale):
#   connected: port(1) type(1) ip(4) qpn(3) va(8) rkey(4) ack_psn(3) = 24
#   forwarded: port(1) type(1) ack_psn(3)                            = 8
# group-level: group_ip(4) last_ack_psn(3) ack_out_port(1) nack(8)
#              cc counters (4 per port)
ENTRY_BYTES = {CONNECTED: 24, FORWARDED: 8}
GROUP_BYTES = 16


@dataclasses.dataclass
class PortEntry:
    port: int
    type: str                           # connected | forwarded
    dest_ip: int = 0                    # connected only
    dest_qpn: int = 0                   # connected only
    va: int = 0                         # connected only (MR rewrite state)
    rkey: int = 0                       # connected only
    ack_psn: int = PSN_MOD - 1          # cumulative: "acked up to -1"


@dataclasses.dataclass
class GroupTable:
    group_ip: int
    entries: Dict[int, PortEntry] = dataclasses.field(default_factory=dict)
    # --- group-level ACK state (Alg 2/3)
    last_ack_psn: int = PSN_MOD - 1
    ack_out_port: Optional[int] = None  # learned: port data packets enter
    # --- fault plane: the master's IP, stamped at envelope install so a
    # switch-originated teardown-confirm can still be routed when
    # ``ack_out_port`` has not been learned yet (no data flowed)
    master_ip: int = 0
    # --- group-level NACK state (Alg 2 lines 14-16)
    nack_epsn: Optional[int] = None     # None = no pending NACK
    # --- congestion-signal filtering (§3.5): per-port CNP counters
    cnp_count: Dict[int, float] = dataclasses.field(default_factory=dict)
    psn_window: int = PSN_WINDOW        # 2^22 in p4 mode
    # --- registration load attributed to each port by THIS group, so
    # uninstalling the group can release its share of the switch-wide
    # port-utilization counters (Alg. 4's load-balancing input)
    port_refs: Dict[int, int] = dataclasses.field(default_factory=dict)
    # --- membership index (control-plane bookkeeping, not Fig. 5 state):
    # member IP -> the port this switch serves it through, recorded at
    # envelope-install time so an incremental leave/fail envelope can
    # release exactly the port the member registered through (a real
    # deployment re-derives this from the removal envelope's routing;
    # the simulator keeps the index to stay deterministic under the
    # port-utilization drift of Algorithm 4's load balancing).
    member_port: Dict[int, int] = dataclasses.field(default_factory=dict)
    # --- Alg. 3 hot-path caches (simulator-internal, not Fig. 5 state):
    # ``agg_entries_cache`` is the entry list excluding the source-facing
    # port; ``agg_min`` is (min ack_psn over that list, owning port).
    # ``ack_psn`` values only advance, so the minimum is stable until the
    # owning entry itself advances — both caches are invalidated on entry
    # or ``ack_out_port`` changes and rebuilt lazily by the switch.
    agg_entries_cache: Optional[list] = None
    agg_min: Optional[tuple] = None

    def add_connected(self, port: int, dest_ip: int, dest_qpn: int,
                      va: int = 0, rkey: int = 0):
        # new entries join the cumulative-ACK state "as caught up as the
        # group": seeding ack_psn from last_ack_psn keeps a mid-stream
        # install (dynamic join) from wedging the aggregate minimum.  At
        # registration time last_ack_psn is still the fresh-entry default
        # (PSN_MOD - 1), so the static path is unchanged.
        self.entries[port] = PortEntry(port, CONNECTED, dest_ip, dest_qpn,
                                       va, rkey,
                                       ack_psn=self.last_ack_psn)
        self.agg_entries_cache = self.agg_min = None

    def add_forwarded(self, port: int):
        if port not in self.entries:
            self.entries[port] = PortEntry(port, FORWARDED,
                                           ack_psn=self.last_ack_psn)
            self.agg_entries_cache = self.agg_min = None

    def remove_port(self, port: int) -> Optional[PortEntry]:
        """Incremental teardown of one tree port (§3.4 maintenance).

        Drops the port's entry AND its per-port group state (the CNP
        counter), so ``table_bytes`` shrinks by exactly the install
        cost.  Invalidate both aggregation caches: the removed port may
        have owned the pending minimum, and the switch re-runs Alg. 3
        right after to un-wedge (emit the newly-satisfied aggregate)."""
        e = self.entries.pop(port, None)
        if e is not None:
            self.cnp_count.pop(port, None)
            self.agg_entries_cache = self.agg_min = None
        return e

    def retarget(self, port: int, dest_ip: int, dest_qpn: int,
                 va: int = 0, rkey: int = 0) -> PortEntry:
        """Swap the receiver behind a ``connected`` port in place
        (member migration / replacement): new L3/L4 + MR rewrite
        state, per-port cumulative ACK state reset to the aggregate so
        the newcomer is not charged with the departed receiver's lag."""
        e = self.entries[port]
        if e.type != CONNECTED:
            raise ValueError(f"port {port} is not a connected entry")
        e.dest_ip, e.dest_qpn, e.va, e.rkey = dest_ip, dest_qpn, va, rkey
        e.ack_psn = self.last_ack_psn
        self.agg_entries_cache = self.agg_min = None
        return e

    # ------------------------------------------------------------ queries

    def min_ack(self) -> tuple[int, int]:
        """(min ack_psn over entries, owning port) — Alg 3 lines 6-9."""
        it = iter(self.entries.values())
        first = next(it)
        mn, mp = first.ack_psn, first.port
        for e in it:
            m2 = psn_min(mn, e.ack_psn, self.psn_window)
            if m2 != mn:
                mn, mp = e.ack_psn, e.port
        return mn, mp

    def table_bytes(self) -> int:
        return GROUP_BYTES + sum(ENTRY_BYTES[e.type] + 4
                                 for e in self.entries.values())


class ForwardingTables:
    """All multicast tables on one switch, indexed by GroupIP.

    Switch table memory is finite (the §3.3 arithmetic: 1K maximal
    groups in under a megabyte), so the store supports an optional
    ``capacity`` (max concurrently installed groups): installing one
    more evicts the least-recently-used group, exactly what a
    deployment does when group registrations outlive their tenants.
    ``get``/``create`` count as uses; ``remove`` is the explicit
    deregistration path.  ``evictions`` counts LRU victims so tests and
    benchmarks can see thrash.
    """

    def __init__(self, p4_mode: bool = False,
                 capacity: Optional[int] = None):
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.tables: Dict[int, GroupTable] = {}
        self.window = PSN_WINDOW_P4 if p4_mode else PSN_WINDOW
        self.capacity = capacity
        self.evictions = 0
        self.salvages = 0                   # re-installs that reseeded PSN
        self.on_remove = None               # callback(table) on uninstall
        self._lru: Dict[int, None] = {}     # insertion-ordered id set
        # LRU-evicted MID-STREAM groups leave their cumulative ACK high
        # water mark here (group_ip -> last_ack_psn).  If the group is
        # re-created while its broadcast is still running, the fresh
        # table starts from that mark instead of the fresh-entry default,
        # so add_connected/add_forwarded seed every entry's ack_psn at
        # the stream position — otherwise the aggregate minimum would
        # wedge at "acked up to -1" and the whole group would stall
        # waiting for ACKs that can never go backwards.  ack_out_port is
        # the mid-stream marker: it is only ever learned from live data.
        self._evicted_psn: Dict[int, int] = {}

    def _touch(self, group_ip: int) -> None:
        self._lru.pop(group_ip, None)
        self._lru[group_ip] = None

    def get(self, group_ip: int) -> Optional[GroupTable]:
        t = self.tables.get(group_ip)
        if t is not None and self.capacity is not None:
            self._touch(group_ip)       # LRU order only matters under a cap
        return t

    def create(self, group_ip: int) -> GroupTable:
        if (self.capacity is not None and group_ip not in self.tables
                and len(self.tables) >= self.capacity):
            victim = next(iter(self._lru))
            vt = self.remove(victim)
            if vt.ack_out_port is not None:     # mid-stream: salvage PSN
                self._evicted_psn[victim] = vt.last_ack_psn
            self.evictions += 1
        t = GroupTable(group_ip, psn_window=self.window)
        salvaged = self._evicted_psn.pop(group_ip, None)
        if salvaged is not None:
            t.last_ack_psn = salvaged
            self.salvages += 1
        self.tables[group_ip] = t
        self._touch(group_ip)
        return t

    def remove(self, group_ip: int) -> Optional[GroupTable]:
        """Uninstall a group (deregistration); returns the old table.

        Explicit removal also forgets any eviction-salvaged PSN mark —
        deregistration means the stream is over, so a future re-install
        of the same GroupIP is a brand-new group."""
        self._lru.pop(group_ip, None)
        self._evicted_psn.pop(group_ip, None)
        t = self.tables.pop(group_ip, None)
        if t is not None and self.on_remove is not None:
            self.on_remove(t)
        return t

    def total_bytes(self) -> int:
        return sum(t.table_bytes() for t in self.tables.values())
