"""Gleam high-level API: network wiring + multicast groups.

``GleamNetwork`` owns a topology + PacketSim and provides

- ``multicast_group(members)`` -> ``MulticastGroup`` with:
  * ``register()``        — the Appendix-A envelope registration (Alg. 4):
    master collects member L3/L4 states, envelopes flow hop-by-hop
    building the extended forwarding tables, members answer ACKs;
  * ``bcast(nbytes)``     — one-to-many SEND through the virtual RC
    connection (Alg. 1 forwarding + Algs. 2/3 feedback aggregation);
  * ``write(nbytes)``     — one-to-many WRITE: an MR_UPDATE message
    precedes each request so leaf switches rewrite va/rkey (§3.3);
    ``same_mr=True`` enables the Appendix-C optimization (all receivers
    share VA/R_key: no MR_UPDATE traffic, models the modified-RNIC mode);
  * the **membership control plane** (§3.4 one-to-many connection
    maintenance) — a ``MulticastGroup`` is a state machine
    (``idle -> registering -> active <-> updating -> closed``) whose
    transitions are in-band control traffic on the live fabric:
    ``join(m)`` installs the new member's ports with an incremental
    MFT-update envelope and re-arms its QP onto the live PSN stream
    (no reset); ``leave(m)`` walks a teardown envelope down the tree,
    releasing ports and un-wedging aggregation; ``fail(m)`` models a
    silent receiver crash — the master isolates the dead port after
    ``fail_detect`` with the same teardown envelope so the pending
    aggregate drains and the sender resumes; ``master_switch(m)`` folds
    the Appendix-B source rotation (sqPSN/rqPSN synchronization, NO
    re-registration) into a master handover; ``close()`` deregisters.
    Every operation lands a ``MembershipRecord`` in ``events_log``
    (request time, completion time — fail records measure recovery).
- ``unicast_qp(a, b)``    — plain RC connections for the baselines.

Completion bookkeeping: every submitted group message records the sender
CQE time (cumulative aggregated ACK covered the last PSN — hardware
reliability) and each receiver's delivery time, so benchmarks can measure
JCT, IOPS and IO latency exactly as §5 defines them.

The port's own copy of the reference ``core/gleam.py``: the port imports
nothing of the reference package.  ``DEFAULT_FAIL_DETECT`` lives in the
port's ``core/faults.py``, so the flow engine reads it without loading
the packet simulator; it is re-exported here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

from repro_torch.core import packet as pk
from repro_torch.core.endpoint import QP
from repro_torch.core.fattree import Topology
from repro_torch.core.faults import DEFAULT_FAIL_DETECT, DEFAULT_LINK_DETECT
from repro_torch.core.metrics import MsgRecord
from repro_torch.core.packetsim import Host, PacketSim

__all__ = ["GleamNetwork", "MulticastGroup", "MembershipRecord",
           "MsgRecord", "VIRTUAL_QPN", "DEFAULT_FAIL_DETECT",
           "DEFAULT_LINK_DETECT",
           "IDLE", "REGISTERING", "ACTIVE", "UPDATING", "CLOSED"]

VIRTUAL_QPN = 0x1
GROUP_IP_BASE = 1 << 20          # far above any host IP
ENVELOPE_MAX_NODES = 183         # MTU-limited (Appendix A, Fig. 17)

# group lifecycle states (docs/ARCHITECTURE.md has the diagram)
IDLE = "idle"                    # constructed, tables not installed
REGISTERING = "registering"      # Appendix-A envelopes in flight
ACTIVE = "active"                # steady state, data plane live
UPDATING = "updating"            # >= 1 membership operation in flight
CLOSED = "closed"                # deregistered, QPs quiesced


@dataclasses.dataclass
class MembershipRecord:
    """One control-plane operation's bookkeeping.  For ``fail`` records
    ``latency`` is the recovery time: crash -> detection (+
    ``fail_detect``) -> in-band isolation -> fabric confirmation."""

    kind: str                    # join | leave | fail | master-switch
    member: str
    t_request: float
    t_done: float = -1.0

    @property
    def latency(self) -> float:
        return self.t_done - self.t_request

    @property
    def complete(self) -> bool:
        return self.t_done >= 0.0


class MulticastGroup:
    def __init__(self, net: "GleamNetwork", members: Sequence[str],
                 group_ip: int, *, master: Optional[str] = None,
                 mtu: int = pk.MTU, window: int = 256,
                 ack_freq: int = 4, rto: float = 200e-6,
                 fail_detect: float = DEFAULT_FAIL_DETECT,
                 link_detect: float = DEFAULT_LINK_DETECT,
                 max_retries: Optional[int] = None):
        self.net = net
        self.members = list(members)
        self.group_ip = group_ip
        self.master = master or self.members[0]
        self.source = self.master
        self.mtu = mtu
        self.window = window
        self.ack_freq = ack_freq
        self.rto = rto
        self.fail_detect = fail_detect
        self.link_detect = link_detect
        self.max_retries = max_retries
        self.qps: Dict[str, QP] = {}
        self.records: Dict[int, MsgRecord] = {}
        self._next_msg = 0
        self.registered = False
        self.register_time = -1.0
        self.state = IDLE
        self.events_log: List[MembershipRecord] = []
        self._op_seq = 0
        self._inflight: Dict[int, MembershipRecord] = {}
        # member -> (op_seq, node record) of a fail whose isolation
        # envelope has not been sent yet (detection pending)
        self._pending_isolation: Dict[str, tuple] = {}
        # fault plane: member ip -> (op_seq, record) of a gone-dark host
        # whose switch-originated teardown-confirm is still in flight
        self._pending_dark: Dict[int, tuple] = {}
        # op_seq -> outstanding affirmation count for repair re-floods
        # (they retire when EVERY targeted member re-affirms, unlike
        # single-member ops)
        self._inflight_n: Dict[int, int] = {}
        self._n_expected = 0
        for m in self.members:
            self._make_member_qp(m)
        self._acked: set = set()

    # ------------------------------------------------------------ control

    def _make_member_qp(self, m: str) -> QP:
        h = self.net.sim.hosts[m]
        qpn = self.net.alloc_qpn(m)
        qp = QP(qpn, h.ip, self.group_ip, VIRTUAL_QPN,
                link_bw=self.net.host_bw(m), mtu=self.mtu,
                window=self.window, ack_freq=self.ack_freq, rto=self.rto,
                max_retries=self.max_retries)
        va = 0x1000_0000 + qpn * 0x10000
        rkey = 0x100 + qpn
        qp.register_mr(rkey, va, 1 << 30)
        qp.on_complete = self._mk_on_complete()
        qp.on_deliver = self._mk_on_deliver(m)
        qp.on_error = self._mk_on_error()
        self.qps[m] = h.add_qp(qp)
        return qp

    def _node_record(self, m: str) -> dict:
        qp = self.qps[m]
        rkey = next(iter(qp.mrs.keys()))
        return {"ip": qp.ip, "qpn": qp.qpn,
                "va": qp.mrs[rkey][0], "rkey": rkey}

    def _records_payload(self) -> List[dict]:
        return [self._node_record(m) for m in self.members]

    # ----- host-side handlers (installed per host by GleamNetwork and
    # dispatched here by group ip, so many groups can churn at once)

    def _member_envelope(self, host: Host, p: pk.Packet, now: float) -> None:
        info = p.payload
        if info.get("mft_op") == "prune":
            # switch-originated teardown-confirm landed on the master:
            # the fabric pruned the gone-dark member's ports on its own,
            # so the pending dark record retires here — no master-driven
            # isolation round-trip ever happened
            for node in info["nodes"]:
                pend = self._pending_dark.pop(node["ip"], None)
                if pend is not None:
                    seq, rec = pend
                    rec.t_done = now
                    self._inflight.pop(seq, None)
                    if not self._inflight and self.state == UPDATING:
                        self.state = ACTIVE
            return
        if not any(n["ip"] == host.ip for n in info["nodes"]):
            return
        sim = self.net.sim
        mft_op = info.get("mft_op", "install")
        if mft_op in ("install", "repair"):
            # membership affirmation (② in Fig. 4); joins carry an
            # op_seq so the master can retire the specific operation
            if host.ip != info["master_ip"]:
                seq = info.get("op_seq")
                payload = (self.group_ip if seq is None else
                           {"group_ip": self.group_ip, "op_seq": seq,
                            "member_ip": host.ip})
                ack = pk.Packet(pk.ENVELOPE_ACK, host.ip,
                                info["master_ip"], payload=payload)
                sim.send_control(host, ack, now)
            return
        # leave/fail teardown reached the member: a graceful leaver
        # quiesces its QP; either way the arrival confirms the tree is
        # pruned up to the leaf, so acknowledge to the master (for a
        # failed member this is the NIC-level confirmation standing in
        # for the fabric's — the RC QP above it is already dead)
        qp = self.qps.get(host.name)
        if qp is not None and mft_op == "leave":
            qp.deactivate()
        ack = pk.Packet(pk.ENVELOPE_ACK, host.ip, info["master_ip"],
                        payload={"group_ip": self.group_ip,
                                 "op_seq": info.get("op_seq"),
                                 "member_ip": host.ip})
        sim.send_control(host, ack, now)

    def _master_env_ack(self, host: Host, p: pk.Packet, now: float) -> None:
        pl = p.payload
        if isinstance(pl, dict):                     # membership op ack
            seq = pl.get("op_seq")
            n = self._inflight_n.get(seq)
            if n is not None:
                # repair re-flood: retire only when EVERY targeted
                # member has re-affirmed its (possibly moved) path
                n -= 1
                if n > 0:
                    self._inflight_n[seq] = n
                    return
                del self._inflight_n[seq]
            rec = self._inflight.pop(seq, None)
            if rec is not None:
                rec.t_done = now
                if not self._inflight and self.state == UPDATING:
                    self.state = ACTIVE
            return
        if pl == self.group_ip and not self.registered:  # registration
            self._acked.add(p.src_ip)
            if len(self._acked) >= self._n_expected:
                self.registered = True
                self.register_time = now
                self.state = ACTIVE

    def register(self, *, run: bool = True) -> float:
        """Appendix-A centralized registration; returns completion time."""
        sim = self.net.sim
        master_host = sim.hosts[self.master]
        self.state = REGISTERING
        nodes = self._records_payload()
        n_pkts = max(1, math.ceil(len(nodes) / ENVELOPE_MAX_NODES))
        for i in range(n_pkts):
            chunk = nodes[i * ENVELOPE_MAX_NODES:(i + 1) * ENVELOPE_MAX_NODES]
            env = pk.Packet(pk.ENVELOPE, master_host.ip, self.group_ip,
                            size=pk.HDR + 8 + 11 * len(chunk),
                            payload={"group_ip": self.group_ip,
                                     "master_ip": master_host.ip,
                                     "nodes": chunk, "seq": i,
                                     "total": n_pkts})
            sim.send_control(master_host, env, sim.now)
        self._n_expected = len({m for m in self.members
                                if m != self.master})
        for m in self.members:
            self.net.attach_host_handlers(m)
        if run:
            sim.run(until=sim.now + 1.0)
            assert self.registered, "registration did not complete"
        return self.register_time

    # -------------------------------------------------------------- data

    def _mk_on_complete(self):
        def fn(msg, now):
            rec = self.records.get(msg.msg_id)
            if rec is not None:
                rec.t_sender_cqe = now
        return fn

    def _mk_on_deliver(self, member: str):
        def fn(msg_id, now):
            rec = self.records.get(msg_id)
            if rec is not None:
                rec.t_deliver[member] = now
        return fn

    def _mk_on_error(self):
        def fn(qp, reason, now):
            # bounded retry exhausted: if the erroring QP is the current
            # source's, its unfinished messages can never complete —
            # surface the verdict on their records instead of hanging
            if self.qps.get(self.source) is qp:
                for rec in self.records.values():
                    if rec.t_sender_cqe < 0 and not rec.error:
                        rec.error = reason
        return fn

    def n_receivers(self) -> int:
        return len(self.members) - 1

    def bcast(self, nbytes: int, *, now: Optional[float] = None) -> MsgRecord:
        if self.state == CLOSED:
            raise RuntimeError("bcast on a closed group")
        sim = self.net.sim
        t = sim.now if now is None else now
        qp = self.qps[self.source]
        mid = self._next_msg
        self._next_msg += 1
        self.records[mid] = MsgRecord(mid, nbytes, t)
        qp.submit(nbytes, t, op="send", msg_id=mid)
        sim.kick(sim.hosts[self.source], t)
        return self.records[mid]

    def write(self, nbytes: int, *, same_mr: bool = False,
              now: Optional[float] = None) -> MsgRecord:
        """One-to-many WRITE.  Without Appendix C (same_mr=False) every
        request is preceded by an MR_UPDATE message carrying per-receiver
        (va, rkey) for the leaf switches to install (§3.3)."""
        if self.state == CLOSED:
            raise RuntimeError("write on a closed group")
        sim = self.net.sim
        t = sim.now if now is None else now
        qp = self.qps[self.source]
        mid = self._next_msg
        self._next_msg += 1
        self.records[mid] = MsgRecord(mid, nbytes, t)
        if not same_mr:
            mr_map = {}
            for m in self.members:
                if m == self.source:
                    continue
                rqp = self.qps[m]
                rkey = next(iter(rqp.mrs.keys()))
                mr_map[rqp.ip] = (rqp.mrs[rkey][0], rkey)
            upd_bytes = 12 * len(mr_map) + 16
            qp.submit(upd_bytes, t, op="mr_update", payload=mr_map,
                      msg_id=-mid - 1)
        rkey0 = next(iter(self.qps[self.source].mrs.keys()))
        va0 = self.qps[self.source].mrs[rkey0][0]
        qp.submit(nbytes, t, op="write", va=va0, rkey=rkey0, msg_id=mid)
        sim.kick(sim.hosts[self.source], t)
        return self.records[mid]

    # --------------------------------------------------------- Appendix B

    def switch_source(self, new_source: str) -> None:
        assert new_source in self.members
        old = self.qps[self.source]
        new = self.qps[new_source]
        old.sync_psn_for_source_switch(becoming_source=False)
        new.sync_psn_for_source_switch(becoming_source=True)
        self.source = new_source

    # ----------------------------------------- membership control plane

    def _require_live(self, what: str) -> None:
        if self.state not in (ACTIVE, UPDATING):
            raise RuntimeError(
                f"{what} requires an active group, state is {self.state!r}")

    def _begin_op(self, kind: str, member: str, t: float, *,
                  rec: Optional[MembershipRecord] = None
                  ) -> tuple[int, MembershipRecord]:
        self._op_seq += 1
        if rec is None:
            rec = MembershipRecord(kind, member, t)
            self.events_log.append(rec)
        self._inflight[self._op_seq] = rec
        self.state = UPDATING
        return self._op_seq, rec

    def _send_update_envelope(self, nodes: List[dict], mft_op: str,
                              op_seq: int, t: float) -> None:
        """One incremental MFT-update envelope from the master into the
        live fabric (same wire format as registration + the op tag)."""
        sim = self.net.sim
        master_host = sim.hosts[self.master]
        env = pk.Packet(pk.ENVELOPE, master_host.ip, self.group_ip,
                        size=pk.HDR + 8 + 11 * len(nodes),
                        payload={"group_ip": self.group_ip,
                                 "master_ip": master_host.ip,
                                 "nodes": nodes, "seq": 0, "total": 1,
                                 "mft_op": mft_op, "op_seq": op_seq})
        sim.send_control(master_host, env, t)

    def _run_until_op(self, rec: MembershipRecord,
                      timeout: float = 1.0) -> None:
        sim = self.net.sim
        deadline = sim.now + timeout
        while not rec.complete:
            before = sim.events
            sim.run(until=deadline)
            if sim.events == before or sim.now >= deadline:
                break
        assert rec.complete, \
            f"membership op {rec.kind}({rec.member}) did not complete"

    def join(self, member: str, *, now: Optional[float] = None,
             run: bool = False) -> MembershipRecord:
        """Add ``member`` to the live group: allocate its QP, re-arm the
        receive side onto the live PSN stream (no reset), and install
        its tree ports with an incremental MFT-update envelope.  The
        joiner receives data from the moment its leaf port is installed;
        new entries seed their cumulative ACK state from the group's
        aggregate, so the join never wedges Algorithm 3."""
        sim = self.net.sim
        t = sim.now if now is None else now
        self._require_live("join")
        if member in self.members:
            raise ValueError(f"{member!r} is already a member")
        pending = self._pending_isolation.pop(member, None)
        if pending is not None:
            # the member rejoins before its failure was even detected:
            # the rejoin IS the detection.  Send the teardown envelope
            # now, immediately ahead of the install (FIFO on the same
            # control path), so the dead port's entry and ref are
            # released before the fresh ones land — the stale timer
            # fires into a no-op.
            self._send_update_envelope([pending[1]], "fail", pending[0], t)
        qp = self._make_member_qp(member)
        qp.rearm_receiver()
        self.members.append(member)
        self.net.attach_host_handlers(member)
        seq, rec = self._begin_op("join", member, t)
        self._send_update_envelope([self._node_record(member)],
                                   "install", seq, t)
        if run:
            self._run_until_op(rec)
        return rec

    def _check_removable(self, kind: str, member: str) -> None:
        self._require_live(kind)
        if member not in self.members:
            raise ValueError(f"{member!r} is not a member")
        if member == self.source:
            raise ValueError(
                f"cannot {kind} the current source {member!r}; "
                f"master_switch first")

    def leave(self, member: str, *, now: Optional[float] = None,
              run: bool = False) -> MembershipRecord:
        """Graceful departure: a teardown envelope walks the member's
        tree path releasing ports; the member quiesces its QP when the
        envelope reaches it and confirms to the master."""
        sim = self.net.sim
        t = sim.now if now is None else now
        self._check_removable("leave", member)
        self.members.remove(member)
        seq, rec = self._begin_op("leave", member, t)
        self._send_update_envelope([self._node_record(member)],
                                   "leave", seq, t)
        if run:
            self._run_until_op(rec)
        return rec

    def fail(self, member: str, *, now: Optional[float] = None,
             run: bool = False) -> MembershipRecord:
        """Silent receiver crash at ``now``: the QP dies immediately (it
        stops ACKing, so the aggregate minimum freezes and the sender
        wedges once its window drains), and after ``fail_detect`` the
        master isolates the dead port with the same teardown envelope —
        pruned switches recompute the pending aggregate and drain the
        outstanding feedback, un-wedging the stream.  The record's
        ``latency`` is the §3.4 recovery time."""
        sim = self.net.sim
        t = sim.now if now is None else now
        self._check_removable("fail", member)
        self.qps[member].deactivate()
        self.members.remove(member)
        seq, rec = self._begin_op("fail", member, t)
        node = self._node_record(member)
        self._pending_isolation[member] = (seq, node)

        def isolate(tt: float) -> None:
            # superseded if the member rejoined first (join sends this
            # exact envelope itself, ahead of the re-install)
            if self._pending_isolation.get(member, (None,))[0] == seq:
                del self._pending_isolation[member]
                self._send_update_envelope([node], "fail", seq, tt)

        sim.schedule(t + self.fail_detect, isolate)
        if run:
            self._run_until_op(rec)
        return rec

    def master_switch(self, member: str, *, now: Optional[float] = None
                      ) -> MembershipRecord:
        """Master handover + Appendix-B source rotation: the new master
        takes the source role (sqPSN/rqPSN synchronized, NO
        re-registration — ``ack_out_port`` re-learns from its first
        data packet) and future control-plane envelopes originate from
        it."""
        sim = self.net.sim
        t = sim.now if now is None else now
        self._require_live("master-switch")
        if member not in self.members:
            raise ValueError(f"{member!r} is not a member")
        self.switch_source(member)
        self.master = member
        rec = MembershipRecord("master-switch", member, t, t_done=t)
        self.events_log.append(rec)
        return rec

    # -------------------------------------- fault plane & self-healing

    def reinstall(self, *, now: Optional[float] = None, run: bool = False,
                  rec: Optional[MembershipRecord] = None
                  ) -> MembershipRecord:
        """Multicast-tree repair: re-flood the FULL install envelope
        from the master.  Switch installs are idempotent, so only the
        members whose tree path crossed a failed element actually move
        ports (Alg. 4 re-runs onto the surviving fat-tree paths);
        moved entries seed their ``ack_psn`` from the group aggregate,
        so the repaired branch joins the cumulative-ACK state without
        ever wedging Alg. 3.  Retires when every targeted member has
        re-affirmed."""
        sim = self.net.sim
        t = sim.now if now is None else now
        self._require_live("repair")
        seq, rec = self._begin_op("repair", "*", t, rec=rec)
        self._inflight_n[seq] = len(
            [m for m in self.members if m != self.master])
        nodes = self._records_payload()
        master_host = sim.hosts[self.master]
        env = pk.Packet(pk.ENVELOPE, master_host.ip, self.group_ip,
                        size=pk.HDR + 8 + 11 * len(nodes),
                        payload={"group_ip": self.group_ip,
                                 "master_ip": master_host.ip,
                                 "nodes": nodes, "seq": 0, "total": 1,
                                 "mft_op": "repair", "op_seq": seq})
        sim.send_control(master_host, env, t)
        if run:
            self._run_until_op(rec)
        return rec

    def link_fault(self, a: str, b: str, *, now: Optional[float] = None,
                   duration: Optional[float] = None,
                   run: bool = False) -> MembershipRecord:
        """Fabric link failure under the live stream: traffic into the
        link black-holes immediately; after ``link_detect`` (loss of
        light) the master repairs the tree onto surviving paths with a
        full re-flood.  ``duration`` makes it a flap — the link heals
        on its own, but the repaired tree deliberately stays on the
        surviving paths (no flap-back thrash).  The record's latency is
        fault -> every member re-affirmed on the repaired tree."""
        sim = self.net.sim
        t = sim.now if now is None else now
        self._require_live("link-fault")
        sim.link_down(a, b)
        if duration is not None:
            sim.schedule(t + duration, lambda tt: sim.link_up(a, b))
        rec = MembershipRecord("link-fault", f"{a}~{b}", t)
        self.events_log.append(rec)
        sim.schedule(t + self.link_detect,
                     lambda tt: self.reinstall(now=tt, rec=rec))
        if run:
            self._run_until_op(rec)
        return rec

    def switch_fault(self, name: str, *, now: Optional[float] = None,
                     run: bool = False) -> MembershipRecord:
        """Whole-switch failure: every one of its links goes dark at
        once; recovery is the same detect + re-flood as ``link_fault``
        (the fault plan validator has already rejected plans that leave
        a member unreachable — fail a leaf and you must model its hosts
        as ``host_gone_dark`` instead)."""
        sim = self.net.sim
        t = sim.now if now is None else now
        self._require_live("switch-fault")
        sim.switch_down(name)
        rec = MembershipRecord("switch-fault", name, t)
        self.events_log.append(rec)
        sim.schedule(t + self.link_detect,
                     lambda tt: self.reinstall(now=tt, rec=rec))
        if run:
            self._run_until_op(rec)
        return rec

    def host_gone_dark(self, member: str, *, now: Optional[float] = None,
                       run: bool = False) -> MembershipRecord:
        """A member host dies silently (NIC stops answering anything —
        harder than ``fail``, which only kills the group QP).  The
        access leaf detects the dark port after ``link_detect`` and
        originates the teardown itself: ports are pruned hop-by-hop
        along the aggregation reverse path, each tree switch un-wedges
        locally, and the envelope lands on the master as the confirm —
        recovery with NO master round-trip, so it completes in
        detect + one-way latency rather than detect + RTT."""
        sim = self.net.sim
        t = sim.now if now is None else now
        self._check_removable("host-dark", member)
        ip = self.qps[member].ip
        sim.host_dark(member)
        sim.retire_qp(self.qps[member])     # excised for good: the
        self.members.remove(member)         # scenario reset must not
                                            # resurrect it
        seq, rec = self._begin_op("host-dark", member, t)
        self._pending_dark[ip] = (seq, rec)
        leaf, _ = self.net.topo.peer(member, 0)

        def detect(tt: float) -> None:
            for port, q in sim.switches[leaf].prune_dead_member(
                    ip, tt, group_ip=self.group_ip):
                sim.send(leaf, port, q, tt)

        sim.schedule(t + self.link_detect, detect)
        if run:
            self._run_until_op(rec)
        return rec

    def master_crash(self, *, now: Optional[float] = None,
                     run: bool = False) -> MembershipRecord:
        """The master/source host dies mid-stream; the survivors heal
        (Appendix B generalized to an unplanned handover):

        1. ``link_detect`` later, the dead master's access leaf prunes
           its connected entry (``prune_dead_member``) — BEFORE
           re-election makes that never-ACKing entry aggregable again
           (``link_detect`` << ``fail_detect``: the order is
           load-bearing).
        2. ``fail_detect`` later, the lowest-rank surviving member
           re-elects itself master + source and resumes transmission
           from the dead sender's ``snd_una``: the aggregate minimum is
           exactly what ``snd_una`` tracked, so every receiver's rqPSN
           is >= it (nobody NACKs below the new base) and the
           outstanding span fits the window (no wedge).  Unfinished
           messages are resubmitted as tails under their original
           msg_ids, so the original records complete normally."""
        sim = self.net.sim
        t = sim.now if now is None else now
        self._require_live("master-crash")
        if len(self.members) < 2:
            raise ValueError("master_crash needs a surviving member")
        old = self.source
        old_qp = self.qps[old]
        una = old_qp.snd_una
        incomplete = [m for m in old_qp.msgs if m.t_complete < 0]
        sim.host_dark(old)
        sim.retire_qp(old_qp)   # the group moves on without it: a
                                # scenario-reset revival would replay
                                # its frozen window into severed tables
        self.members.remove(old)
        seq, rec = self._begin_op("master-crash", old, t)
        old_ip = old_qp.ip
        leaf, _ = self.net.topo.peer(old, 0)

        def dark_detect(tt: float) -> None:
            for port, q in sim.switches[leaf].prune_dead_member(
                    old_ip, tt, group_ip=self.group_ip):
                sim.send(leaf, port, q, tt)

        def reelect(tt: float) -> None:
            new = self.members[0]               # lowest-rank survivor
            nqp = self.qps[new]
            # resume exactly at the dead sender's cumulative-ACK point
            nqp.sq_psn = nqp.snd_una = nqp.snd_nxt = una
            self.source = self.master = new
            for m in incomplete:
                end = pk.psn_add(m.base_psn, m.n_pkts)
                tail = pk.psn_sub(end, pk.psn_max(una, m.base_psn))
                if tail <= 0:
                    continue
                nbytes = m.nbytes - (m.n_pkts - tail) * self.mtu
                nqp.submit(max(nbytes, 1), tt, op=m.op, va=m.va,
                           rkey=m.rkey, payload=m.payload,
                           msg_id=m.msg_id)
            rec.t_done = tt
            self._inflight.pop(seq, None)
            if not self._inflight and self.state == UPDATING:
                self.state = ACTIVE
            # re-flood the install envelope from the new master: the
            # repair sweep prunes the tree branches that only existed to
            # reach the dead master's leaf (they would otherwise sit in
            # the aggregate as never-ACKing forwarded entries), and the
            # tree re-roots at the survivor.
            self.reinstall(now=tt)
            sim.kick(sim.hosts[new], tt)

        sim.schedule(t + self.link_detect, dark_detect)
        sim.schedule(t + self.fail_detect, reelect)
        if run:
            self._run_until_op(rec)
        return rec

    def close(self) -> None:
        """Deregister the group: uninstall every switch table (their
        memory and port-utilization load are released through the
        store's ``on_remove`` hook) and quiesce the member QPs."""
        for sw in self.net.sim.switches.values():
            sw.tables.remove(self.group_ip)
        for qp in self.qps.values():
            qp.deactivate()
        self.net.groups_by_ip.pop(self.group_ip, None)
        self.state = CLOSED

    # ------------------------------------------------------------- stats

    def run_until_delivered(self, rec: MsgRecord,
                            timeout: float = 5.0) -> float:
        sim = self.net.sim
        deadline = sim.now + timeout
        while (len(rec.t_deliver) < self.n_receivers()
               or rec.t_sender_cqe < 0):
            before = sim.events
            sim.run(until=deadline)
            if sim.events == before or sim.now >= deadline:
                break
        return rec.jct(self.n_receivers())


class GleamNetwork:
    def __init__(self, topo: Topology, **sim_kw):
        self.topo = topo
        self.sim = PacketSim(topo, **sim_kw)
        self._qpn: Dict[str, int] = {}
        self._groups = 0
        # group-ip -> MulticastGroup: the demux the per-host envelope
        # handlers dispatch through, so several groups can register and
        # churn on the same hosts concurrently
        self.groups_by_ip: Dict[int, MulticastGroup] = {}
        self._handled_hosts: set = set()

    def alloc_qpn(self, host: str) -> int:
        n = self._qpn.get(host, 16) + 1
        self._qpn[host] = n
        return n

    def host_bw(self, host: str) -> float:
        return self.topo.link(host, 0).bw

    def attach_host_handlers(self, member: str) -> None:
        """Install the (idempotent) control-plane dispatchers on a
        member host: envelopes and envelope-ACKs route to the owning
        group by the group ip they carry."""
        if member in self._handled_hosts:
            return
        self._handled_hosts.add(member)
        host = self.sim.hosts[member]

        def on_envelope(p: pk.Packet, now: float) -> None:
            g = self.groups_by_ip.get(p.payload.get("group_ip"))
            if g is not None:
                g._member_envelope(host, p, now)

        def on_envelope_ack(p: pk.Packet, now: float) -> None:
            pl = p.payload
            gid = pl.get("group_ip") if isinstance(pl, dict) else pl
            g = self.groups_by_ip.get(gid)
            if g is not None:
                g._master_env_ack(host, p, now)

        host.on_envelope = on_envelope
        host.on_envelope_ack = on_envelope_ack

    def multicast_group(self, members: Sequence[str],
                        **kw) -> MulticastGroup:
        g = MulticastGroup(self, members,
                           GROUP_IP_BASE + self._groups, **kw)
        self._groups += 1
        self.groups_by_ip[g.group_ip] = g
        return g

    def unicast_qp(self, a: str, b: str, *, mtu: int = pk.MTU,
                   window: int = 256, ack_freq: int = 4,
                   rto: float = 200e-6,
                   max_retries: Optional[int] = None) -> tuple[QP, QP]:
        """A plain RC connection a -> b (baselines: multiple unicasts,
        overlay relays).  ``max_retries`` bounds the sender QP's RTO
        retransmits (fault scenarios); receivers never retry."""
        ha, hb = self.sim.hosts[a], self.sim.hosts[b]
        qa = QP(self.alloc_qpn(a), ha.ip, hb.ip, 0,
                link_bw=self.host_bw(a), mtu=mtu, window=window,
                ack_freq=ack_freq, rto=rto, max_retries=max_retries)
        qb = QP(self.alloc_qpn(b), hb.ip, ha.ip, qa.qpn,
                link_bw=self.host_bw(b), mtu=mtu, window=window,
                ack_freq=ack_freq, rto=rto)
        qa.dst_qpn = qb.qpn
        ha.add_qp(qa)
        hb.add_qp(qb)
        return qa, qb
