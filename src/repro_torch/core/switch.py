"""Gleam switch data plane + control plane (§3.3–§3.5, §4, Appendix A).

Implements, faithfully:

- **Algorithm 1** — one-to-many data forwarding with per-port header
  rewrite (`connected` entries get dest IP/QPN replaced, src IP becomes
  GroupIP; WRITE packets additionally get their RETH va/rkey replaced from
  the per-receiver MR states).
- **Algorithms 2 & 3** — many-to-one ACK aggregation and NACK filtering:
  per-port cumulative ``ack_psn``; the aggregated ACK carries the minimum
  over downstream ports and is emitted when that minimum advances; a NACK
  is forwarded only when every receiver has acknowledged everything below
  its expected PSN (the Fig. 7 ordering hazard).
- **Algorithm 4** — envelope-driven table registration: reuse already-
  `forwarded` ports (optimal tree), least-utilized port for new ones
  (group-level load balancing), per-port sub-envelopes downstream.
- **§3.5 congestion-signal filtering** — per-port CNP counters with aging;
  only the most-congested port's signal passes upstream.
- **Appendix B source switching** — ``ack_out_port`` is re-learned when
  data enters a new port; the entry facing the current source is excluded
  from aggregation (it is the one port that never ACKs).
- **§4 P4 mode** — wrapped PSN comparisons in a 2^22 window instead of
  2^23.

The switch is transport-agnostic plumbing: it returns (out_port, packet)
emissions and the simulator owns queues, delays, ECN marking, and loss.

The port's own copy of the reference ``core/switch.py``: the port imports
nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core import packet as pk
from repro_torch.core.fattree import Topology
from repro_torch.core.ftable import (CONNECTED, FORWARDED,
                                     ForwardingTables, GroupTable)

Emit = Tuple[int, pk.Packet]


@dataclasses.dataclass
class SwitchStats:
    data_in: int = 0
    data_copies: int = 0
    acks_in: int = 0
    acks_out: int = 0
    nacks_in: int = 0
    nacks_out: int = 0
    cnps_in: int = 0
    cnps_out: int = 0
    envelopes: int = 0


class GleamSwitch:
    """One Gleam-capable switch; plain unicast forwarding for everything
    that doesn't hit a multicast table."""

    def __init__(self, name: str, topo: Topology, host_ip: Dict[str, int],
                 *, p4_mode: bool = False, cnp_aging_tau: float = 100e-6,
                 table_capacity: Optional[int] = None):
        self.name = name
        self.topo = topo
        self.host_ip = host_ip
        self.ip_host = {v: k for k, v in host_ip.items()}
        self.tables = ForwardingTables(p4_mode=p4_mode,
                                       capacity=table_capacity)
        self.tables.on_remove = self._release_ports
        self.port_util: Dict[int, int] = {}     # group registrations / port
        self.stats = SwitchStats()
        self.cnp_tau = cnp_aging_tau
        self._cnp_t: Dict[Tuple[int, int], float] = {}  # (group, port) -> t
        self.p4_mode = p4_mode
        # unicast next-hop memo: (dst_ip, flow_key) -> port or None.  The
        # topology is immutable during a run and every forwarded packet
        # of a connection hits the same pair, so the route is computed
        # once instead of per packet.
        self._nh_memo: Dict[Tuple[int, int], Optional[int]] = {}

    # --------------------------------------------------------- entry point

    def on_packet(self, p: pk.Packet, in_port: int, now: float) -> List[Emit]:
        kind = p.kind
        if kind == pk.ENVELOPE:
            return self._envelope(p, in_port, now)
        t = self.tables.get(p.dst_ip)
        if t is None:
            return self._unicast(p)
        if kind == pk.DATA:
            return self._data(t, p, in_port, now)
        if kind == pk.ACK:
            return self._ack(t, p, in_port, now)
        if kind == pk.NACK:
            return self._nack(t, p, in_port, now)
        if kind == pk.CNP:
            return self._cnp(t, p, in_port, now)
        return self._unicast(p)

    def route_envelope(self, p: pk.Packet, in_port: int,
                       now: float) -> List[Emit]:
        return self._envelope(p, in_port, now)

    def _release_ports(self, t) -> None:
        """A group was uninstalled (eviction/deregistration): give its
        registration load back to the port-utilization counters so
        Algorithm 4's least-utilized-port choice is not skewed by
        ghosts."""
        for port, refs in t.port_refs.items():
            self.port_util[port] = max(self.port_util.get(port, 0) - refs,
                                       0)

    def _count_port_ref(self, t: GroupTable, port: int) -> None:
        self.port_util[port] = self.port_util.get(port, 0) + 1
        t.port_refs[port] = t.port_refs.get(port, 0) + 1

    def _release_port_ref(self, t: GroupTable, port: int) -> int:
        """Give ONE member's registration load on ``port`` back;
        returns the remaining per-group refcount (0 = last member
        behind this port is gone and the tree edge can be pruned)."""
        self.port_util[port] = max(self.port_util.get(port, 0) - 1, 0)
        n = t.port_refs.get(port, 0) - 1
        if n > 0:
            t.port_refs[port] = n
            return n
        t.port_refs.pop(port, None)
        return 0

    # --------------------------------------------------------- data plane

    def _unicast(self, p: pk.Packet) -> List[Emit]:
        if p.kind == pk.ENVELOPE:
            return []  # envelopes are consumed by _envelope
        key = (p.dst_ip, p.src_ip * 131 + p.dst_qpn)
        port = self._nh_memo.get(key, -1)
        if port == -1:
            host = self.ip_host.get(p.dst_ip)
            try:
                port = None if host is None else self.topo.next_hop_port(
                    self.name, host, flow_key=key[1])
            except ValueError:
                port = None     # unroutable mid-fault: drop, not crash
            self._nh_memo[key] = port
        if port is None:
            return []
        return [(port, p)]

    def _data(self, t: GroupTable, p: pk.Packet, in_port: int,
              now: float) -> List[Emit]:
        """Algorithm 1 (+ MR-update interception, + Appendix B learning)."""
        self.stats.data_in += 1
        sync: List[Emit] = []
        if t.ack_out_port != in_port:
            # first data packet, or multicast source switched (Appendix B):
            # feedback must now exit through the new ingress port.
            prev_out = t.ack_out_port
            t.ack_out_port = in_port
            t.agg_entries_cache = t.agg_min = None
            if prev_out is not None and self._agg_entries(t):
                # source switch: the NEW reverse path has never seen this
                # subtree's cumulative state, so re-emit the aggregate
                # toward the new source.  In the planned Appendix-B
                # rotation the aggregate equals last_ack_psn and this
                # emits nothing; after a crash recovery it is what syncs
                # the re-elected sender's snd_una with reality.
                sync = self._generate(t, now)
        if p.op == "mr_update" and isinstance(p.payload, dict):
            # §3.3: the extra WRITE message carrying per-receiver MR info.
            # Update connected entries, then forward it as normal data so
            # every downstream switch (and receiver, for PSN continuity)
            # sees it.
            for e in t.entries.values():
                if e.type == CONNECTED and e.dest_ip in p.payload:
                    e.va, e.rkey = p.payload[e.dest_ip]
        out: List[Emit] = []
        for e in t.entries.values():
            if e.port == in_port:
                continue
            q = p.copy()
            if e.type == CONNECTED:
                q.dst_ip = e.dest_ip
                q.dst_qpn = e.dest_qpn
                q.src_ip = t.group_ip     # feedback will route by GroupIP
                if q.op == "write":       # rewrite RETH per receiver (§3.3)
                    q.va, q.rkey = e.va, e.rkey
            out.append((e.port, q))
        self.stats.data_copies += len(out)
        if sync:
            out.extend(sync)
        return out

    # ------------------------------------------------------ feedback plane

    def _agg_entries(self, t: GroupTable):
        """Entries that participate in aggregation: every tree port except
        the one facing the current source (it never ACKs).  Cached on the
        table; invalidated when entries or ``ack_out_port`` change."""
        lst = t.agg_entries_cache
        if lst is None:
            lst = t.agg_entries_cache = [
                e for e in t.entries.values() if e.port != t.ack_out_port]
        return lst

    def _advance_ack_psn(self, t: GroupTable, e, psn: int, w: int) -> None:
        """Cumulative per-port state (Alg. 2): ``ack_psn`` only moves
        forward.  The cached aggregate minimum survives unless the entry
        holding it is the one advancing."""
        if (psn - e.ack_psn) % pk.PSN_MOD < w:          # psn_geq, inlined
            e.ack_psn = psn
            agg = t.agg_min
            if agg is not None and agg[1] == e.port:
                t.agg_min = None

    def _ack(self, t: GroupTable, p: pk.Packet, in_port: int,
             now: float) -> List[Emit]:
        """Algorithm 2, ACK branch."""
        self.stats.acks_in += 1
        e = t.entries.get(in_port)
        if e is None or t.ack_out_port is None:
            return []
        self._advance_ack_psn(t, e, p.psn, t.psn_window)
        agg = t.agg_min
        if agg is not None and agg[0] == t.last_ack_psn \
                and t.nack_epsn is None:
            return []       # aggregate unchanged: Alg. 3 emits nothing
        return self._generate(t, now)

    def _nack(self, t: GroupTable, p: pk.Packet, in_port: int,
              now: float) -> List[Emit]:
        """Algorithm 2, NACK branch (lines 12-17)."""
        self.stats.nacks_in += 1
        e = t.entries.get(in_port)
        if e is None or t.ack_out_port is None:
            return []
        w = t.psn_window
        implied = pk.psn_sub(p.psn, 1)          # NACK acks everything < ePSN
        self._advance_ack_psn(t, e, implied, w)
        if t.nack_epsn is None or pk.psn_geq(t.nack_epsn, p.psn, w):
            t.nack_epsn = p.psn
        return self._generate(t, now)

    def _generate(self, t: GroupTable, now: float) -> List[Emit]:
        """Algorithm 3: aggregated ACK when the minimum advances; NACK only
        when all receivers acked everything below its expected PSN.

        The minimum over per-port ``ack_psn`` is cached in ``t.agg_min``:
        per-port cumulative ACKs only advance, so a full rescan is needed
        only when the entry that owned the minimum advances (or the entry
        set / source port changes) — every other feedback packet leaves
        the aggregate untouched.  This turns the per-ACK cost from
        O(ports) to amortized O(1), bit-identical to the full scan."""
        entries = self._agg_entries(t)
        if not entries:
            return []
        w = t.psn_window
        M = pk.PSN_MOD
        agg = t.agg_min
        if agg is None:
            e0 = entries[0]
            mn, mport = e0.ack_psn, e0.port
            for e in entries[1:]:
                a = e.ack_psn
                if a != mn and (mn - a) % M < w:        # psn_gt(mn, a)
                    mn, mport = a, e.port
            t.agg_min = (mn, mport)
        else:
            mn = agg[0]
        out: List[Emit] = []
        if mn != t.last_ack_psn and (mn - t.last_ack_psn) % M < w:
            out.append((t.ack_out_port,
                        self._feedback(t, pk.ack_packet(t.group_ip,
                                                        t.group_ip, mn))))
            t.last_ack_psn = mn
            self.stats.acks_out += 1
        if t.nack_epsn is not None:
            if pk.psn_add(mn, 1) == t.nack_epsn:
                out.append((t.ack_out_port,
                            self._feedback(t, pk.nack_packet(
                                t.group_ip, t.group_ip, t.nack_epsn))))
                t.nack_epsn = None
                self.stats.nacks_out += 1
            elif pk.psn_geq(mn, t.nack_epsn, w):
                t.nack_epsn = None   # loss already recovered downstream
        return out

    def _feedback(self, t: GroupTable, q: pk.Packet) -> pk.Packet:
        """Rewrite feedback headers at the source-facing hop ('L1 changes
        the connection-related states in the ACK header to match S's QP')."""
        e = t.entries.get(t.ack_out_port)
        if e is not None and e.type == CONNECTED:
            q.dst_ip = e.dest_ip
            q.dst_qpn = e.dest_qpn
        return q

    # -------------------------------------------------- congestion (§3.5)

    def _cnp(self, t: GroupTable, p: pk.Packet, in_port: int,
             now: float) -> List[Emit]:
        self.stats.cnps_in += 1
        if t.ack_out_port is None:
            return []
        key = (t.group_ip, in_port)
        # exponential aging (the paper's periodic aging, continuous form)
        last = self._cnp_t.get(key, now)
        cnt = t.cnp_count.get(in_port, 0.0)
        cnt = cnt * math.exp(-(now - last) / self.cnp_tau) + 1.0
        t.cnp_count[in_port] = cnt
        self._cnp_t[key] = now
        # age the others lazily for the comparison
        most = True
        for port, c in t.cnp_count.items():
            if port == in_port:
                continue
            lp = self._cnp_t.get((t.group_ip, port), now)
            c_aged = c * math.exp(-(now - lp) / self.cnp_tau)
            if c_aged > cnt:
                most = False
                break
        if not most:
            return []      # filtered: not the most congested link
        self.stats.cnps_out += 1
        return [(t.ack_out_port, self._feedback(t, p.copy()))]

    # ------------------------------------------------- control plane (A)

    def _envelope(self, p: pk.Packet, in_port: int, now: float) -> List[Emit]:
        """Algorithm 4 (install) or the §3.4 incremental teardown path,
        selected by the envelope's ``mft_op`` (absent = install, which
        keeps registration envelopes bit-identical).  Install is already
        incremental — a join envelope lands on the existing table and
        only adds the ports its nodes need."""
        self.stats.envelopes += 1
        info = p.payload
        if info.get("mft_op") in ("leave", "fail"):
            return self._envelope_remove(p, in_port, now)
        if info.get("mft_op") == "prune":
            return self._envelope_prune(p, in_port, now)
        if info.get("mft_op") == "sever":
            return self._envelope_sever(p, in_port, now)
        repair = info.get("mft_op") == "repair"
        g = info["group_ip"]
        t = self.tables.get(g) or self.tables.create(g)
        if info.get("master_ip"):
            t.master_ip = info["master_ip"]
        # Make the tree traversable from ANY member (Appendix B: the master
        # "can be any node" and the source may rotate): the upstream port the
        # envelope entered through is part of the tree too.  If it faces a
        # host the node-record branch below creates the connected entry;
        # otherwise it is a forwarded entry.
        up_peer = self.topo.ports[self.name][in_port][0]
        if up_peer not in self.host_ip and in_port not in t.entries:
            t.add_forwarded(in_port)
        down: Dict[int, list] = {}
        released = False
        if self.topo._down:
            # repair re-flood: tree edges over downed links are dead
            # weight — black-holed data copies AND a never-ACKing
            # aggregation entry.  Drop them up front; surviving members
            # re-register through live ports below (candidate_ports
            # already excludes downed ports), releasing any refs.
            for port in [pt for pt in t.entries
                         if (self.name, pt) in self.topo._down]:
                t.remove_port(port)
                released = True
        for node in info["nodes"]:
            ip = node["ip"]
            host = self.ip_host.get(ip)
            if host is None:
                continue
            # re-install (fault repair re-floods the full envelope): a
            # member already registered through its chosen port is left
            # untouched — idempotence keeps refcounts and ACK state from
            # drifting — but the sub-envelope still continues downstream
            # (a deeper switch may be the one that had to move).
            prev = t.member_port.get(ip)
            # directly connected?
            direct = None
            for port, (peer, _) in self.topo.ports[self.name].items():
                if peer == host:
                    direct = port
                    break
            if direct is not None:
                if prev == direct:
                    down.setdefault(direct, []).append(node)
                    continue
                if prev is not None:
                    released |= self._drop_member(t, ip)
                t.add_connected(direct, ip, node["qpn"],
                                node.get("va", 0), node.get("rkey", 0))
                self._count_port_ref(t, direct)
                t.member_port[ip] = direct
                down.setdefault(direct, []).append(node)
                continue
            try:
                cands = self.topo.candidate_ports(self.name, host)
            except ValueError:
                continue        # unroutable mid-fault: skip this node
            cands = [c for c in cands if c != in_port]
            if not cands:
                continue
            reuse = [c for c in cands
                     if c in t.entries and t.entries[c].type == FORWARDED]
            if reuse:
                out = reuse[0]            # reuse existing tree edge
            else:
                out = min(cands, key=lambda c: (self.port_util.get(c, 0), c))
            if prev == out:
                down.setdefault(out, []).append(node)
                continue
            if prev is not None:
                released |= self._drop_member(t, ip)
            t.add_forwarded(out)
            self._count_port_ref(t, out)
            t.member_port[ip] = out
            down.setdefault(out, []).append(node)
        if repair:
            # a repair envelope carries the FULL membership, so any
            # member still indexed here but absent from the sub-envelope
            # was rerouted around this switch by the new tree: release
            # its refs, or the stale branch below its old port survives
            # the sweep and keeps black-holing copies into the fault.
            node_ips = {node["ip"] for node in info["nodes"]}
            for ip in [m for m in t.member_port if m not in node_ips]:
                released |= self._drop_member(t, ip)
            # this switch is on the repaired tree, and the repaired tree
            # at this switch is exactly {in_port} + the sub-envelope
            # ports.  Any ref-less forwarded edge outside that set is a
            # stale old-tree edge: it would bounce data copies into
            # bypassed switches (and a never-ACKing aggregation entry).
            keep = set(down)
            keep.add(in_port)
            for port in [pt for pt, e in t.entries.items()
                         if pt not in keep and e.type == FORWARDED
                         and not t.port_refs.get(pt)]:
                t.remove_port(port)
                released = True
        emits: List[Emit] = []
        for port, nodes in down.items():
            q = p.copy()
            q.payload = {**info, "nodes": nodes}
            q.size = pk.HDR + 8 + 11 * len(nodes)   # Fig. 17 layout scale
            emits.append((port, q))
        if released and t.ack_out_port is not None and self._agg_entries(t):
            # a moved member's old port may have owned the pending
            # minimum: re-run Alg. 3 so the repaired tree un-wedges
            emits.extend(self._generate(t, now))
        return emits

    def _envelope_remove(self, p: pk.Packet, in_port: int,
                         now: float) -> List[Emit]:
        """Incremental MFT teardown (§3.4 maintenance): release each
        departing member's share of its tree port, prune forwarded
        ports whose last member is gone, uninstall the whole table when
        no member registers through this switch anymore — and un-wedge
        aggregation, because the removed receiver may have been the
        straggler holding the pending minimum (its outstanding PSN
        window is drained by re-running Algorithm 3 without it)."""
        info = p.payload
        g = info["group_ip"]
        t = self.tables.get(g)
        emits: List[Emit] = []
        if t is None:
            return emits
        down: Dict[int, list] = {}
        for node in info["nodes"]:
            ip = node["ip"]
            port = t.member_port.pop(ip, None)
            if port is None:
                # the member did not register THROUGH this switch (the
                # removal originates at a post-handover master whose
                # path differs from the install path): hold no local
                # ref to release, just relay the teardown along a tree
                # edge toward the member — the switches that did index
                # it (exactly the ones that counted refs) prune there
                host = self.ip_host.get(ip)
                if host is None:
                    continue
                try:
                    cands = [c for c in self.topo.candidate_ports(
                        self.name, host)
                        if c != in_port and c in t.entries]
                except ValueError:
                    continue    # unroutable mid-fault: nothing to relay
                if cands:
                    down.setdefault(cands[0], []).append(node)
                continue
            e = t.entries.get(port)
            refs_left = self._release_port_ref(t, port)
            # the sub-envelope continues toward the member: downstream
            # switches release their share, and the member host itself
            # learns it is out (a graceful leaver quiesces its QP and
            # confirms to the master from there)
            down.setdefault(port, []).append(node)
            if e is not None and (
                    (e.type == CONNECTED and e.dest_ip == ip)
                    or (e.type == FORWARDED and refs_left == 0)):
                t.remove_port(port)
        for port, nodes in down.items():
            q = p.copy()
            q.payload = {**info, "nodes": nodes}
            q.size = pk.HDR + 8 + 11 * len(nodes)
            emits.append((port, q))
        if not t.port_refs:
            # last member behind this switch is gone: uninstall the
            # table (memory + residual port load released via on_remove)
            self.tables.remove(g)
            return emits
        if t.ack_out_port is not None and self._agg_entries(t):
            emits.extend(self._generate(t, now))
        return emits

    # --------------------------------------------- fault plane (pruning)

    def _drop_member(self, t: GroupTable, ip: int) -> bool:
        """Release one member's local registration (dead host or a
        repair that moved it): give back its port ref and drop the
        entry when it was the last user.  Returns True if local state
        changed (the caller re-runs Alg. 3 to un-wedge)."""
        port = t.member_port.pop(ip, None)
        if port is None:
            return False
        e = t.entries.get(port)
        refs_left = self._release_port_ref(t, port)
        if e is not None and (
                (e.type == CONNECTED and e.dest_ip == ip)
                or (e.type == FORWARDED and refs_left == 0)):
            t.remove_port(port)
        return True

    def _toward_master(self, t: GroupTable, info: dict) -> Optional[int]:
        """Egress port for a switch-originated confirm: the aggregation
        reverse path when learned, else unicast toward the master."""
        if t is not None and t.ack_out_port is not None:
            return t.ack_out_port
        mip = (t.master_ip if t is not None else 0) or info.get(
            "master_ip", 0)
        mhost = self.ip_host.get(mip)
        if mhost is None:
            return None
        try:
            return self.topo.next_hop_port(self.name, mhost,
                                           flow_key=info["group_ip"])
        except ValueError:
            return None

    def prune_dead_member(self, ip: int, now: float,
                          group_ip: Optional[int] = None) -> List[Emit]:
        """Switch-originated teardown (fault plane): the access link to
        a member went permanently dark.  Prune the member from every
        group table serving it through this switch, re-run Alg. 3 so
        local aggregation un-wedges WITHOUT a master round-trip, and
        send a ``prune`` envelope along the aggregation reverse path —
        each upstream tree switch prunes hop-by-hop and the master host
        finally receives it as the teardown-confirm.

        ``group_ip`` scopes the teardown to ONE group's table: the
        fault plane drives this per group (each group's fault plan
        carries its own events), which also keeps batched ``run_many``
        scenarios independent experiments — a fault injected by one
        scenario must not prune another scenario's staged tables."""
        emits: List[Emit] = []
        host = self.ip_host.get(ip)
        dead_ports = {port for port, (peer, _)
                      in self.topo.ports[self.name].items() if peer == host}
        items = list(self.tables.tables.items()) if group_ip is None else \
            [(group_ip, self.tables.get(group_ip))]
        for g, t in items:
            if t is None:
                continue
            if t.ack_out_port in dead_ports:
                # the dead host was this table's DATA SOURCE: everything
                # this switch fed is severed from the stream, not just
                # the member entry.  Tear the local table down and relay
                # a ``sever`` out of each tree edge so the whole
                # orphaned tree unwinds hop-by-hop (a re-elected master
                # re-floods a fresh tree afterwards; without this the
                # old root's branch is off the new tree, no repair
                # envelope ever visits it, and its MFT entries leak
                # until group teardown).
                info = {"group_ip": g, "master_ip": t.master_ip,
                        "mft_op": "sever"}
                self.stats.envelopes += 1
                for port, e in sorted(t.entries.items()):
                    if e.type == FORWARDED and port not in dead_ports:
                        q = pk.Packet(pk.ENVELOPE, 0, info["master_ip"],
                                      size=pk.HDR + 8 + 11, payload=info)
                        emits.append((port, q))
                self.tables.remove(g)
                continue
            if ip not in t.member_port:
                continue
            info = {"group_ip": g, "master_ip": t.master_ip,
                    "mft_op": "prune", "nodes": [{"ip": ip}]}
            self._drop_member(t, ip)
            self.stats.envelopes += 1
            if not t.port_refs:
                self.tables.remove(g)
                t = None
            elif t.ack_out_port is not None and self._agg_entries(t):
                emits.extend(self._generate(t, now))
            out = self._toward_master(t, info)
            if out is not None:
                q = pk.Packet(pk.ENVELOPE, 0, info["master_ip"],
                              size=pk.HDR + 8 + 11, payload=info)
                emits.append((out, q))
        return emits

    def _envelope_sever(self, p: pk.Packet, in_port: int,
                        now: float) -> List[Emit]:
        """One hop of the dead-source teardown: the upstream neighbor
        toward the (dead) source unwound its table.  If data really
        entered through that edge (``ack_out_port`` — or it was never
        learned, i.e. the stream never started), this switch's subtree
        is severed too: uninstall and relay out of every remaining tree
        edge.  A switch that already re-rooted away from the severed
        upstream just prunes the dead edge and keeps serving."""
        info = p.payload
        t = self.tables.get(info["group_ip"])
        if t is None:
            return []
        if t.ack_out_port is not None and t.ack_out_port != in_port:
            if not t.port_refs.get(in_port):
                t.remove_port(in_port)
            return []
        emits: List[Emit] = [
            (port, p.copy()) for port, e in sorted(t.entries.items())
            if e.type == FORWARDED and port != in_port]
        self.tables.remove(info["group_ip"])
        return emits

    def _envelope_prune(self, p: pk.Packet, in_port: int,
                        now: float) -> List[Emit]:
        """One hop of the switch-originated teardown-confirm: prune the
        dead member locally, un-wedge aggregation, relay toward the
        master.  A non-tree switch (fallback unicast routing) just
        relays."""
        info = p.payload
        t = self.tables.get(info["group_ip"])
        emits: List[Emit] = []
        if t is not None:
            changed = False
            for node in info["nodes"]:
                changed |= self._drop_member(t, node["ip"])
            if not t.port_refs:
                self.tables.remove(info["group_ip"])
                t = None
            elif changed and t.ack_out_port is not None \
                    and self._agg_entries(t):
                emits.extend(self._generate(t, now))
        out = self._toward_master(t, info)
        if out is not None and out != in_port:
            emits.append((out, p))
        return emits
