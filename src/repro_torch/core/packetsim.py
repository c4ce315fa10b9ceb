"""Event-driven packet-level simulator (the ns-3 analogue of §5.3).

Models: per-egress FIFO serialization at link rate, propagation delay,
ECN marking on backlog, random packet discard at switch egress ("emulated
via randomly discarding packets in the middle switches"), RC endpoints
(endpoint.QP) on hosts, Gleam switches (switch.GleamSwitch) in the fabric.

The engine is a heapq of **typed event records** — plain tuples
``(t, seq, kind, ...)`` dispatched by an integer kind in the run loop:

- ``ARRIVE_SW (0)`` / ``ARRIVE_HOST (4)`` — ``(t, seq, kind, handler,
  in_port, packet)``: a packet reaches the far end of a link; the
  destination switch/host object is resolved once per link (see
  ``_link_info``) and dispatched without any per-hop closure or name
  lookup;
- ``HOST (1)``     — ``(t, seq, 1, host)``: a deferred NIC wakeup
  (the dedup marker ``host._kick_t`` still guards against multiplying
  these);
- ``TIMER (2)``    — ``(t, seq, 2, qp, host)``: a QP retransmission
  timer may have expired;
- ``CALL (3)``     — ``(t, seq, 3, fn)``: generic callback, the escape
  hatch ``schedule()`` keeps for external users (overlay relays, tests).

The ``seq`` tiebreaker makes heap comparisons never reach the payload
and preserves FIFO order among same-time events, so the dispatch is
bit-identical to the old ``(t, seq, lambda)`` loop while allocating no
closures on the per-packet path.

Hosts emit through a single NIC egress; data-plane pacing is ACK-clocked
go-back-N + DCQCN rate limiting inside the QPs.  Each host maintains a
**ready-QP set** — the QPs whose sender side has work pending
(``sq_psn != snd_nxt or snd_una != sq_psn``), kept in sync by the QP's
submit/ACK/NACK/timeout transitions — so ``next_emission`` round-robins
over exactly the QPs the old code's full rescan would have selected,
without rebuilding the list per packet.

Terminal packets are recycled through ``packet.release``'s free list:
a packet consumed by a host's RC logic, absorbed by a switch without
being re-emitted, or discarded by the loss model provably has no other
live references (switch replication always emits fresh copies).

A packet addressed to a QPN a host does not own is counted in
``no_qp_drops`` — this is exactly the Fig. 3 incompatibility (traditional
L3 multicast forwarding delivers packets no RC QP matches), which the
tests reproduce.

The port's own copy of the reference ``core/packetsim.py``: the port imports
nothing of the reference package.
"""
from __future__ import annotations

import heapq
import itertools
import random
from collections import deque
from typing import Callable, Dict, List, Optional

from repro_torch.core import packet as pk
from repro_torch.core.endpoint import INF, QP
from repro_torch.core.fattree import Topology, host_ip_map
from repro_torch.core.switch import GleamSwitch

# typed event kinds (index 2 of every heap tuple).  Arrival events carry
# the destination handler OBJECT (switch or host), resolved once at send
# time through the link memo, so the dispatch does no name lookups.
EV_ARRIVE_SW = 0                 # (t, seq, 0, switch, in_port, packet)
EV_HOST = 1                      # (t, seq, 1, host)
EV_TIMER = 2                     # (t, seq, 2, qp, host)
EV_CALL = 3                      # (t, seq, 3, fn)
EV_ARRIVE_HOST = 4               # (t, seq, 4, host, in_port, packet)

# hot-path constant aliases (module globals: no attribute chasing)
_DATA = pk.DATA
_ACK = pk.ACK
_NACK = pk.NACK
_CNP = pk.CNP
_ENV = pk.ENVELOPE
_ENV_ACK = pk.ENVELOPE_ACK


class EventBudgetExceeded(RuntimeError):
    """``PacketSim.run`` popped more events than ``max_events`` allows.

    A ``RuntimeError`` subclass so existing broad handlers keep working.
    The simulator is left fully inspectable: ``events`` and ``now``
    mirror the engine state at raise time, the event queue keeps its
    remaining events, and ``run()`` may simply be called again with a
    larger budget to continue the run.
    """

    def __init__(self, events: int, now: float):
        super().__init__(
            f"event budget exceeded after {events} events at t={now:.9e}s")
        self.events = events
        self.now = now


class Host:
    def __init__(self, name: str, ip: int, sim: "PacketSim"):
        self.name = name
        self.ip = ip
        self.sim = sim
        self.qps: Dict[int, QP] = {}
        self.ctrl: deque = deque()          # feedback/control, priority
        self.no_qp_drops = 0
        self.dead_drops = 0                 # traffic to deactivated QPs
        self.dark = False                   # NIC gone dark (fault plane)
        self.on_envelope: Optional[Callable] = None
        self.on_envelope_ack: Optional[Callable] = None
        self._qp_rr = 0
        self._kick_t = INF
        # single-NIC egress link record (see PacketSim._links); filled in
        # by PacketSim.__init__ for every host with a port-0 uplink
        self._nic: Optional[list] = [0.0, 0.0, 0, None, 0, False, 0.0,
                                     False]
        # per-message CPU submission overhead (storage-stack model, §5.2.2)
        self.overhead = 0.0
        # ready-QP set: QPs with sender-side work pending, maintained by
        # QP._ready_sync on every pending-predicate transition.  The
        # iteration list is rebuilt (in QP registration order, matching
        # the old full-scan order) only when membership changes.
        self._ready: Dict[int, QP] = {}
        self._ready_list: List[QP] = []
        self._ready_stale = False

    def add_qp(self, qp: QP) -> QP:
        qp._host = self
        qp._order = len(self.qps)
        self.qps[qp.qpn] = qp
        qp._ready_sync()
        return qp

    def _mark_ready(self, qp: QP) -> None:
        if qp.qpn not in self._ready:
            self._ready[qp.qpn] = qp
            self._ready_stale = True

    def _mark_idle(self, qp: QP) -> None:
        if self._ready.pop(qp.qpn, None) is not None:
            self._ready_stale = True

    # ------------------------------------------------------------ receive

    def on_packet(self, p: pk.Packet, now: float) -> None:
        if self.dark:                       # gone-dark NIC: silent sink
            self.dead_drops += 1
            return
        kind = p.kind
        if kind == _DATA:
            qp = self.qps.get(p.dst_qpn)
            if qp is None:
                self.no_qp_drops += 1       # Fig. 3: no matching QP
                return
            if not qp.alive:
                self.dead_drops += 1        # failed member: silent sink
                return
            fb = qp.on_data(p, now)
            if fb:
                self.ctrl.extend(fb)
            self.sim._run_host(self, now)
            return
        if kind == _ACK or kind == _NACK or kind == _CNP:
            qp = self.qps.get(p.dst_qpn)
            if qp is None:
                self.no_qp_drops += 1
                return
            if not qp.alive:
                self.dead_drops += 1
                return
            if kind == _ACK:
                qp.on_ack(p.psn, now)
            elif kind == _NACK:
                qp.on_nack(p.psn, now)
            else:
                qp.on_cnp(now)
            sim = self.sim
            sim.arm_timer(qp, self)
            sim._run_host(self, now)
            return
        if kind == _ENV:
            if self.on_envelope:
                self.on_envelope(p, now)
            return
        if kind == _ENV_ACK and self.on_envelope_ack:
            self.on_envelope_ack(p, now)

    # ------------------------------------------------------------ emit

    def next_emission(self, now: float):
        """(packet or None, next time anything becomes ready).

        Round-robins over the ready set only; membership is exactly the
        pending predicate the old implementation evaluated by scanning
        every QP, and the iteration order (QP registration order) and
        ``_qp_rr`` arithmetic are unchanged, so emission interleaving is
        bit-identical."""
        if self.ctrl:
            return self.ctrl.popleft(), now
        if self._ready_stale:
            self._ready_list = sorted(self._ready.values(),
                                      key=lambda q: q._order)
            self._ready_stale = False
        qpns = self._ready_list
        n = len(qpns)
        earliest = INF
        rr = self._qp_rr
        for i in range(n):
            qp = qpns[(rr + i) % n]
            p, t = qp.next_packet(now)
            if p is not None:
                self._qp_rr = (rr + i + 1) % n
                self.sim.arm_timer(qp, self)
                return p, t
            if t < earliest:
                earliest = t
        return None, earliest


class PacketSim:
    def __init__(self, topo: Topology, *, loss_rate: float = 0.0,
                 seed: int = 0, p4_mode: bool = False,
                 ecn_backlog: float = INF, drop_feedback: bool = False):
        self.topo = topo
        self.loss_rate = loss_rate
        self.drop_feedback = drop_feedback
        self.seed = seed
        self.rng = random.Random(seed)
        self.ecn_backlog = ecn_backlog      # seconds of egress backlog
        self.host_ip = host_ip_map(topo)
        self.hosts: Dict[str, Host] = {
            h: Host(h, ip, self) for h, ip in self.host_ip.items()}
        self.by_ip: Dict[int, Host] = {h.ip: h for h in self.hosts.values()}
        self.switches: Dict[str, GleamSwitch] = {
            s: GleamSwitch(s, topo, self.host_ip, p4_mode=p4_mode)
            for s in topo.switches}
        self._q: List = []
        self._seq = itertools.count()
        # (node, port) -> [bw, delay, arrive_kind, handler, peer_port,
        #                  from_switch, free_t, down]: lazily-memoized
        # link facts (the topology is immutable while a sim exists) plus
        # the mutable egress-free time and fault-plane down flag in the
        # same record, so the per-hop path does one dict probe total.
        # ``_out`` indexes the same records as node -> port-indexed list
        # (string keys hash faster than fresh tuples on the per-copy
        # emission path).
        self._links: Dict[tuple, list] = {}
        self._out: Dict[str, List[Optional[list]]] = {}
        self.now = 0.0
        self.events = 0
        self.dropped = 0
        self.fault_dropped = 0              # black-holed on a downed link
        self.tx_bytes = 0
        self._faulted = False               # any fault API called since
                                            # the last clear_faults()
        self._dark_deactivated: list = []   # QPs host_dark() silenced
        for h in self.hosts.values():       # hosts emit through port 0
            if 0 in topo.ports.get(h.name, ()):
                h._nic = self._link_info(h.name, 0)

    @property
    def _free(self) -> Dict[tuple, float]:
        """Egress-occupied-until view, (node, port) -> t (diagnostics)."""
        return {k: v[6] for k, v in self._links.items() if v[6] > 0.0}

    def reset_free(self) -> None:
        """Clear every egress reservation (scenario quiesce)."""
        for info in self._links.values():
            info[6] = 0.0

    # ------------------------------------------------------- fault plane
    #
    # The engine lowers each FaultEvent to one of these calls on the
    # typed event loop.  Fabric faults flip the down flag in the
    # memoized link records (so the hot path pays one truthiness test,
    # no dict probe) *and* in the topology (so repair-time route
    # recomputation sees the survivors); host faults silence the NIC.
    # clear_faults() restores everything at scenario quiesce.

    def _flag_link(self, a: str, b: str, down: bool) -> None:
        pa, pb = self.topo._link_ports(a, b)
        for node, port in ((a, pa), (b, pb)):
            info = self._links.get((node, port))
            if info is not None:
                info[7] = down

    def _routes_dirty(self) -> None:
        for sw in self.switches.values():
            sw._nh_memo.clear()

    def link_down(self, a: str, b: str) -> None:
        self._faulted = True
        self.topo.set_link_down(a, b, True)
        self._flag_link(a, b, True)
        self._routes_dirty()

    def link_up(self, a: str, b: str) -> None:
        self.topo.set_link_down(a, b, False)
        self._flag_link(a, b, False)
        self._routes_dirty()

    def switch_down(self, name: str) -> None:
        self._faulted = True
        self.topo.set_switch_down(name, True)
        for port, (peer, pport) in sorted(self.topo.ports[name].items()):
            for node, p in ((name, port), (peer, pport)):
                info = self._links.get((node, p))
                if info is not None:
                    info[7] = True
        self._routes_dirty()

    def host_dark(self, name: str) -> None:
        """Host NIC goes silently dark: drops everything, emits nothing.
        The fabric links stay up — detection is the neighbours' job."""
        self._faulted = True
        host = self.hosts[name]
        host.dark = True
        host.ctrl.clear()
        for qp in host.qps.values():
            if qp.alive:
                self._dark_deactivated.append(qp)
                qp.deactivate()

    def retire_qp(self, qp) -> None:
        """Permanently decommission a QP silenced by ``host_dark``: the
        scenario reset (``clear_faults``) revives darkened QPs so OTHER
        groups sharing the host keep working across ``run_many``
        scenarios — but the faulted group's own QP must never come
        back.  Its group excised the member (re-election / teardown
        confirm) and a revived sender would replay its frozen
        outstanding window into tables that no longer exist, stealing
        NIC bandwidth from the next scenario."""
        try:
            self._dark_deactivated.remove(qp)
        except ValueError:
            pass

    def clear_faults(self) -> None:
        """Undo every injected fault (scenario quiesce).  Reactivation
        matters: cached static groups share host QPs across run_many
        scenarios, so a QP silenced by host_dark must come back."""
        if not self._faulted:
            return
        self._faulted = False
        for info in self._links.values():
            info[7] = False
        self.topo.clear_down()
        for h in self.hosts.values():
            h.dark = False
        for qp in self._dark_deactivated:
            qp.alive = True
            qp._ready_sync()
        self._dark_deactivated.clear()
        self._routes_dirty()

    # ------------------------------------------------------------ engine

    def schedule(self, t: float, fn: Callable[[float], None]) -> None:
        """Generic callback event — the non-hot-path escape hatch."""
        heapq.heappush(self._q, (t, next(self._seq), EV_CALL, fn))

    def reseed_scenario(self, index: int) -> None:
        """Give scenario ``index`` its own deterministic RNG stream,
        derived from the constructor seed only — never from how many
        draws earlier scenarios consumed.  This is what makes serial and
        process-parallel ``run_many`` bit-identical (and doubles as the
        multi-seed axis of the loss sweeps)."""
        self.rng.seed(self.seed ^ (0x9E3779B97F4A7C15 * (index + 1)))

    def run(self, until: float = INF, max_events: int = 50_000_000) -> float:
        q = self._q
        pop = heapq.heappop
        release = pk.release
        events = self.events
        try:
            while q:
                if q[0][0] > until:
                    self.now = until
                    break
                ev = pop(q)
                t = ev[0]
                self.now = t
                kind = ev[2]
                if kind == 4:                           # EV_ARRIVE_HOST
                    p = ev[5]
                    ev[3].on_packet(p, t)
                    k = p.kind
                    if k != _ENV and k != _ENV_ACK:
                        release(p)
                elif kind == 0:                         # EV_ARRIVE_SW
                    sw = ev[3]
                    p = ev[5]
                    kept = False
                    name = sw.name
                    for out_port, c in sw.on_packet(p, ev[4], t):
                        if c is p:
                            kept = True
                        self.send(name, out_port, c, t)
                    if not kept:
                        release(p)
                elif kind == 1:                         # EV_HOST
                    self._fire(ev[3], t)
                elif kind == 2:                         # EV_TIMER
                    self._timer_fire(ev[3], ev[4], t)
                else:                                   # EV_CALL
                    ev[3](t)
                events += 1
                if events > max_events:
                    self.events = events
                    raise EventBudgetExceeded(events, self.now)
        finally:
            self.events = events
        return self.now

    # ------------------------------------------------------------ links

    def _link_info(self, node: str, port: int) -> list:
        link = self.topo.link(node, port)
        peer, peer_port = self.topo.peer(node, port)
        sw = self.switches.get(peer)
        kind = EV_ARRIVE_SW if sw is not None else EV_ARRIVE_HOST
        handler = sw if sw is not None else self.hosts[peer]
        info = self._links[(node, port)] = [
            link.bw, link.delay, kind, handler, peer_port,
            node in self.switches, 0.0,
            self.topo.is_down(node, port)]
        by_port = self._out.setdefault(node, [])
        while len(by_port) <= port:
            by_port.append(None)
        by_port[port] = info
        return info

    def send(self, node: str, port: int, p: pk.Packet, now: float) -> None:
        by_port = self._out.get(node)
        info = by_port[port] \
            if by_port is not None and port < len(by_port) else None
        if info is None:
            info = self._link_info(node, port)
        self._send_via(info, p, now)

    def _send_via(self, info: list, p: pk.Packet, now: float) -> None:
        if info[7]:                         # fault plane: link is down —
            self.fault_dropped += 1         # black-hole, no feedback
            pk.release(p)
            return
        start = info[6]
        if start < now:
            start = now
        done = start + p.size / info[0]
        info[6] = done
        self.tx_bytes += p.size
        if done - now > self.ecn_backlog and p.kind == _DATA:
            p.ecn = True
        if info[5] and self.loss_rate > 0.0 and (
                p.kind == _DATA or self.drop_feedback):
            if self.rng.random() < self.loss_rate:
                self.dropped += 1
                pk.release(p)
                return
        heapq.heappush(self._q, (done + info[1], next(self._seq),
                                 info[2], info[3], info[4], p))

    def _arrive(self, node: str, in_port: int, p: pk.Packet,
                now: float) -> None:
        """Out-of-loop arrival dispatch (tests / direct injection).  The
        run loop inlines this, adding terminal-packet recycling."""
        sw = self.switches.get(node)
        if sw is not None:
            for out_port, q in sw.on_packet(p, in_port, now):
                self.send(node, out_port, q, now)
            return
        self.hosts[node].on_packet(p, now)

    # ------------------------------------------------------------ hosts

    def _run_host(self, host: Host, now: float) -> None:
        free = host._nic[6]
        if free > now + 1e-15:              # NIC serializing: come back
            self._arm_kick(host, free)
            return
        if not host.ctrl and not host._ready:
            return      # nothing to emit: exactly next_emission's no-op
        p, t_next = host.next_emission(now)
        if p is not None:
            nic = host._nic
            self._send_via(nic, p, now)
            if host.ctrl or host._ready:
                self._arm_kick(host, nic[6])
            # else: nothing left to emit — every source of new work
            # (arrival, submit, timeout) kicks the host itself, so the
            # serialization-done wakeup would fire into a guaranteed
            # no-op; skip the event instead of scheduling it
        elif t_next < INF:
            self._arm_kick(host, t_next)

    # Kicks run the host NIC emission loop now (packet arrival, submit).
    # They do NOT touch the wakeup marker — only _fire consumes it — so
    # repeated kicks while the NIC is serializing dedupe to a single
    # scheduled wakeup instead of multiplying events.
    kick = _run_host

    def _arm_kick(self, host: Host, t: float) -> None:
        if host._kick_t <= t + 1e-15:
            return                          # earlier wakeup already armed
        host._kick_t = t
        heapq.heappush(self._q, (t, next(self._seq), EV_HOST, host))

    def _fire(self, host: Host, now: float) -> None:
        if host._kick_t < now - 1e-15:
            return                          # superseded by an earlier fire
        host._kick_t = INF                  # consume the marker
        self._run_host(host, now)

    # ------------------------------------------------------------ timers

    def arm_timer(self, qp: QP, host: Host) -> None:
        t = qp.timer_deadline
        if t == INF:
            return
        if qp._timer_ev <= t + 1e-15:
            return
        qp._timer_ev = t
        heapq.heappush(self._q, (t, next(self._seq), EV_TIMER, qp, host))

    def _timer_fire(self, qp: QP, host: Host, now: float) -> None:
        qp._timer_ev = INF
        if qp.timer_deadline <= now + 1e-12:
            qp.on_timeout(now)
            self.kick(host, now)
        self.arm_timer(qp, host)

    # ------------------------------------------------------- convenience

    def host_of_ip(self, ip: int) -> Host:
        return self.by_ip[ip]

    def send_control(self, host: Host, p: pk.Packet, now: float) -> None:
        host.ctrl.append(p)
        self.kick(host, now)
