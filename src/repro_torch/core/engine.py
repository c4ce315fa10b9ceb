"""The engines: Workload-IR staging onto a packet simulator or a fluid
solver.

The port of the reference's ``core/engine.py``.  A ``PacketEngine``
drives every staged op through the per-packet simulator on the host.  A
``FlowEngine`` lowers declarative group operations (``GroupOp`` /
``Workload``, ``core/workload.py``) onto max-min fair fluid flows — a
gleam multicast is one flow over its distribution-tree links, an overlay
transport one flow per relay edge, a dynamic op a piecewise-membership
timeline — hands them to a solver, and back-fills ``MsgRecord``s
(``core/metrics.py``):

    eng  = make_engine("flow", topo)                 # torch solver, card
    rec  = eng.stage(GroupOp("bcast", members, nbytes))
    eng.run()                                        # drive staged ops
    recs = eng.run_workloads([wl_a, wl_b])           # batched scenarios

Engines by name (``make_engine``):

    ``packet``   the packet-level reference: ``PacketEngine`` adapts
                 ``gleam.GleamNetwork`` (per-packet event loop of
                 ``packetsim``, RC endpoints, Gleam switches, go-back-N,
                 DCQCN) on the host; it takes no ``device``;
    ``flow``     fluid model on ``flowsim_torch.TorchFlowSim``; runs on
                 ``device`` (default ``"cuda"``, which raises without a
                 card; ``device="cpu"`` runs the plain PyTorch solver);
    ``flow-np``  fluid model on the numpy ``flowsim.FlowSim``.

The packet half (``PacketEngine``, ``_cqe_from_deliveries``, the fork
workers of ``run_many``) is a copy of the reference's; ``MTU`` and
``HDR`` come from the port's ``packet``, ``DEFAULT_FAIL_DETECT`` from
its ``faults``.  As in the reference, ``gleam`` (and with it
``packetsim``, ``switch``, ``endpoint`` and ``ftable``) is imported only
where a ``PacketEngine`` is built, so a flow-only user never loads the
packet simulator.
"""
from __future__ import annotations

import math
import os
import pickle
import traceback
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import staging
from repro_torch.core.fattree import Topology
from repro_torch.core.faults import (DEFAULT_FAIL_DETECT,
                                     DEFAULT_FAULT_RETRIES,
                                     DEFAULT_LINK_DETECT, validate_fault_plan)
from repro_torch.core.flowsim import FlowSim, LossParams, static_maxmin_loops
from repro_torch.core.flowsim_torch import TorchFlowSim
from repro_torch.core.metrics import MsgRecord
from repro_torch.core.packet import HDR, MTU
from repro_torch.core.workload import (GroupOp, RELAY_OVERHEAD, Transport,
                                       Workload, get_transport, relay_plan)

ENGINE_CHOICES = ("packet", "flow", "flow-np")

# ==================================================== shared staging glue

class _WorkloadStaging:
    """The engine-agnostic half of the contract: GroupOp dispatch,
    Workload batching, and the deprecated ``add_*`` shims.

    Concrete engines provide the four lowering primitives:
    ``_stage_unicast`` / ``_stage_native`` (gleam bcast+write) /
    ``_stage_overlay`` (relay transports) / ``_stage_allreduce``.
    """

    relay_overhead: float = RELAY_OVERHEAD

    def stage(self, op: GroupOp) -> MsgRecord:
        transport = get_transport(op.transport)
        if op.op == "unicast":
            return self._stage_unicast(op.members[0], op.members[1],
                                       op.nbytes, op.key)
        if op.op == "allreduce":
            return self._stage_allreduce(op, transport)
        if transport.native:
            return self._stage_native(op)
        return self._stage_overlay(op, transport)

    def run_workloads(self, workloads: Sequence[Workload],
                      timeout: float = 30.0,
                      workers: Optional[int] = None
                      ) -> List[List[MsgRecord]]:
        out: List[List[MsgRecord]] = [[] for _ in workloads]

        def scenario(wl: Workload, recs: List[MsgRecord]):
            def fn(eng):
                recs.extend(eng.stage(op) for op in wl.ops)
            return fn

        self.run_many([scenario(wl, recs)
                       for wl, recs in zip(workloads, out)], timeout,
                      workers=workers)
        return out

    # ------------------------------------------------- deprecated shims

    def _legacy(self, name: str, op: GroupOp) -> MsgRecord:
        warnings.warn(
            f"SimEngine.{name}() is deprecated; stage a workload.GroupOp "
            f"via stage() instead", DeprecationWarning, stacklevel=3)
        return self.stage(op)

    def add_bcast(self, members: Sequence[str], nbytes: int, *,
                  source: Optional[str] = None, key: int = 0) -> MsgRecord:
        """Deprecated: ``stage(GroupOp('bcast', members, nbytes))``."""
        return self._legacy("add_bcast", GroupOp(
            "bcast", tuple(members), nbytes, source=source, key=key))

    def add_write(self, members: Sequence[str], nbytes: int, *,
                  source: Optional[str] = None, same_mr: bool = False,
                  key: int = 0) -> MsgRecord:
        """Deprecated: ``stage(GroupOp('write', members, nbytes))``."""
        return self._legacy("add_write", GroupOp(
            "write", tuple(members), nbytes, source=source,
            same_mr=same_mr, key=key))

    def add_unicast(self, src: str, dst: str, nbytes: int, *,
                    key: int = 0) -> MsgRecord:
        """Deprecated: ``stage(GroupOp('unicast', (src, dst), nbytes))``."""
        return self._legacy("add_unicast", GroupOp(
            "unicast", (src, dst), nbytes, key=key))


# =========================================================== packet engine

def _cqe_from_deliveries(rec: MsgRecord) -> None:
    """Overlay completion policy: the 'CQE' of a software relay bcast
    is the last relay delivery (the overlay has no aggregated ACK)."""
    rec.t_sender_cqe = max(rec.t_deliver.values())


class PacketEngine(_WorkloadStaging):
    """Cycle-accurate backend: adapts ``GleamNetwork``/``MulticastGroup``
    (per-packet event simulation) to the SimEngine contract.

    Multicast groups are created and registered lazily per member set
    (registration time is excluded from message records, matching how the
    paper measures steady-state JCT after setup) and reused across
    epochs; Appendix-B source switching handles source rotation.
    Overlay transports lower onto the ``baselines.py`` relay classes —
    real RC unicast QPs with per-hop host forwarding overhead.
    ``relay_kw`` forwards QP tuning (window, mtu, ...) to those relays.
    """

    name = "packet"

    def __init__(self, topo: Topology, *, group_kw: Optional[dict] = None,
                 relay_kw: Optional[dict] = None,
                 staging_cache: bool = True, **sim_kw):
        from repro_torch.core.gleam import GleamNetwork
        self.topo = topo
        # the packet engine's staged artifacts are the topology's route
        # memos (dist / candidate_ports — pure functions of the routed
        # fabric).  ``staging_cache=False`` turns them off topology-wide
        # so the cache-on/off bit-identity tests have a memo-free
        # reference run (slow: one BFS per dist() call; testing only).
        topo.route_cache = bool(staging_cache)
        self.net = GleamNetwork(topo, **sim_kw)
        self.group_kw = dict(group_kw or {})
        self.relay_kw = dict(relay_kw or {})
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._chans: Dict[Tuple[str, str], object] = {}
        self._staged: List = []                 # submission thunks
        # (record, n deliveries to wait for, completion policy or None)
        self._pending: List[Tuple[MsgRecord, int, Optional[Callable]]] = []
        self._op_phys: Dict[str, float] = {}    # op-level fabric overrides
        self.last_run_stats: List = []
        self.last_run_errors: List[str] = []    # run_many degradations

    # ------------------------------------------------------------ helpers

    def stage(self, op: GroupOp) -> MsgRecord:
        self._apply_op_phys(op)
        return super().stage(op)

    def _apply_op_phys(self, op: GroupOp) -> None:
        """Apply a GroupOp's loss/ECN scenario parameters to the fabric.

        Loss rate and ECN marking are *physical* — one fabric, one
        value — so they are engine-global here (the flow engines can
        honor them per-flow).  Two staged ops demanding different
        non-None values is a modeling error, not a race to resolve.
        """
        sim = self.net.sim
        for attr, val in (("loss_rate", op.loss_rate),
                          ("ecn_backlog", op.ecn_backlog)):
            if val is None:
                continue
            val = float(val)
            prev = self._op_phys.setdefault(attr, val)
            if prev != val:
                raise ValueError(
                    f"conflicting GroupOp.{attr} values on the packet "
                    f"engine: {prev!r} vs {val!r} (the fabric {attr} is "
                    "physical and global; run the ops in separate "
                    "engines)")
            setattr(sim, attr, val)

    def _group(self, members: Sequence[str]):
        """Get-or-register the group for a member set.

        Registration drives the simulator (the Appendix-A envelope
        exchange is itself simulated traffic), which is why data
        submissions are DEFERRED to ``run()``: staging op B must not
        silently drain already-staged op A's packets.
        """
        key = tuple(members)
        g = self._groups.get(key)
        if g is None:
            g = self.net.multicast_group(members, **self.group_kw)
            g.register()
            self._groups[key] = g
        return g

    def _stage_group_op(self, members, nbytes, source, submit) -> MsgRecord:
        g = self._group(members)
        rec = MsgRecord(-1, nbytes, self.net.sim.now)

        def thunk():
            if source is not None and source != g.source:
                g.switch_source(source)
            real = submit(g)
            # alias the group's bookkeeping to the record we handed out
            rec.msg_id, rec.t_submit = real.msg_id, real.t_submit
            g.records[real.msg_id] = rec

        self._staged.append(thunk)
        self._pending.append((rec, g.n_receivers(), None))
        return rec

    # ----------------------------------------------------------- lowering

    def _stage_native(self, op: GroupOp) -> MsgRecord:
        if op.events or op.faults:
            return self._stage_dynamic(op)
        if op.op == "write":
            return self._stage_group_op(
                op.members, op.nbytes, op.source,
                lambda g: g.write(op.nbytes, same_mr=op.same_mr))
        return self._stage_group_op(op.members, op.nbytes, op.source,
                                    lambda g: g.bcast(op.nbytes))

    def _stage_dynamic(self, op: GroupOp) -> MsgRecord:
        """Dynamic-membership lowering: the op's timed ``MemberEvent``s
        run natively on the live fabric — each event is an in-sim
        callback driving the group's membership control plane (in-band
        MFT-update envelopes, QP re-arm, failure isolation; see
        ``core/gleam.py``).

        Membership mutates the group, so a dynamic op always gets a
        FRESH group instead of the per-member-set cache.  The pending
        record waits for every *surviving* initial receiver (leavers
        and failed members are excused; joiners deliver from their
        join point but are not required to complete the in-flight
        message), which keeps ``run_many``'s quiesce/fork machinery
        working unchanged — events are scheduled relative to the
        submission instant inside the deferred thunk.

        ``FaultEvent``s lower the same way: each fault is a scheduled
        callback driving the group's self-healing ops (link/switch
        repair re-floods, switch-originated teardown confirm,
        master re-election — ``core/gleam.py``).  Fault scenarios get
        the RoCE-style bounded retry budget by default (an unreachable
        peer must surface as a QP error, never a hang); zero-fault ops
        keep ``max_retries=None`` so their records stay bit-identical
        to the pre-fault-plane tree."""
        kw = dict(self.group_kw)
        if op.faults:
            validate_fault_plan(self.topo, op)
            kw.setdefault("max_retries", DEFAULT_FAULT_RETRIES)
        g = self.net.multicast_group(list(op.members), **kw)
        g.register()
        sim = self.net.sim
        rec = MsgRecord(-1, op.nbytes, sim.now)
        events = op.sorted_events()
        faults = op.sorted_faults()

        def thunk():
            if op.source is not None and op.source != g.source:
                g.switch_source(op.source)
            if op.op == "write":
                real = g.write(op.nbytes, same_mr=op.same_mr)
            else:
                real = g.bcast(op.nbytes)
            rec.msg_id, rec.t_submit = real.msg_id, real.t_submit
            g.records[real.msg_id] = rec
            t0 = sim.now
            ops = {"join": g.join, "leave": g.leave, "fail": g.fail,
                   "master-switch": g.master_switch}
            for ev in events:
                sim.schedule(t0 + ev.at,
                             lambda now, fn=ops[ev.kind], m=ev.member:
                             fn(m, now=now))
            fops = {
                "link_down": lambda now, f:
                    g.link_fault(f.node, f.peer, now=now),
                "link_flap": lambda now, f:
                    g.link_fault(f.node, f.peer, now=now,
                                 duration=f.duration),
                "switch_fail": lambda now, f:
                    g.switch_fault(f.node, now=now),
                "host_gone_dark": lambda now, f:
                    g.host_gone_dark(f.node, now=now),
                "master_crash": lambda now, f: g.master_crash(now=now),
            }
            for f in faults:
                sim.schedule(t0 + f.at,
                             lambda now, fn=fops[f.kind], f=f: fn(now, f))

        self._staged.append(thunk)
        self._pending.append((rec, len(op.surviving_receivers()), None))
        return rec

    def _stage_overlay(self, op: GroupOp, transport: Transport) -> MsgRecord:
        """Relay transports run the ``baselines.py`` machinery: QPs are
        wired at stage time (silent), data submission is deferred.

        Overlay fault plans (the IR admits only ``host_gone_dark`` on
        overlays — fabric and master faults are native-transport
        concepts) lower to a scheduled NIC blackout plus, one
        ``fail_detect`` later, the relay-schedule splice
        (``repair_dead_relay``: the dead relay's children re-parent and
        the chunk stream is resubmitted).  A graceful ``leave``
        MemberEvent takes the same splice path, but immediately — the
        departing host announces itself, so there is no detection
        delay and no blackout."""
        members = op.ordered_members()
        kw = dict(self.relay_kw)
        if op.faults:
            validate_fault_plan(self.topo, op)
            kw.setdefault("max_retries", DEFAULT_FAULT_RETRIES)
        b = transport.packet_bcast(self.net, members, op.chunks, **kw)
        rec = MsgRecord(-1, op.nbytes, self.net.sim.now)
        b.t_deliver = rec.t_deliver             # deliveries land on rec
        sim = self.net.sim

        def thunk():
            rec.t_submit = sim.now
            b.start(op.nbytes)
            t0 = sim.now
            for ev in op.sorted_events():       # graceful leaves: splice now
                sim.schedule(t0 + ev.at,
                             lambda now, m=ev.member:
                             b.repair_dead_relay(m, now))
            if op.faults:
                detect = float(self.group_kw.get("fail_detect",
                                                 DEFAULT_FAIL_DETECT))
                for f in op.sorted_faults():
                    sim.schedule(t0 + f.at,
                                 lambda now, m=f.node: sim.host_dark(m))
                    sim.schedule(t0 + f.at + detect,
                                 lambda now, m=f.node:
                                 b.repair_dead_relay(m, now))

        self._staged.append(thunk)
        n = len(op.surviving_receivers()) if (op.faults or op.events) \
            else b.n_receivers()
        self._pending.append((rec, n, _cqe_from_deliveries))
        return rec

    def _stage_allreduce(self, op: GroupOp, transport: Transport
                         ) -> MsgRecord:
        """Fan-in reduce (every member unicasts its contribution to the
        root — the many-to-one analogue of the paper's feedback
        aggregation) followed by a bcast of the result over the op's
        transport, triggered when the last contribution lands."""
        sim = self.net.sim
        members = op.ordered_members()
        root = members[0]
        rec = MsgRecord(-1, op.nbytes, sim.now)

        if transport.native:
            g = self._group(tuple(members))
            overlay = None
        else:
            overlay = transport.packet_bcast(self.net, members, op.chunks,
                                             **self.relay_kw)
            overlay.t_deliver = rec.t_deliver

        def start_bcast(now: float) -> None:
            rec.t_deliver[root] = now           # root holds the result
            if overlay is not None:
                overlay.start(op.nbytes)
                return
            if root != g.source:
                g.switch_source(root)
            real = g.bcast(op.nbytes)
            g.records[real.msg_id] = rec        # deliveries + CQE -> rec

        arrived: set = set()
        pairs = []
        for m in members[1:]:
            qa, qb = self.net.unicast_qp(m, root)

            def on_deliver(mid, now, m=m):
                arrived.add(m)
                if len(arrived) == len(members) - 1:
                    start_bcast(now)

            qb.on_deliver = on_deliver
            pairs.append((m, qa))

        def thunk():
            rec.t_submit = sim.now
            for m, qa in pairs:
                qa.submit(op.nbytes, sim.now)
                sim.kick(sim.hosts[m], sim.now)

        self._staged.append(thunk)
        fin = _cqe_from_deliveries if overlay is not None else None
        self._pending.append((rec, len(members), fin))
        return rec

    def _stage_unicast(self, src: str, dst: str, nbytes: int,
                       key: int = 0) -> MsgRecord:
        chan = self._chans.get((src, dst))
        if chan is None:
            qa, qb = self.net.unicast_qp(src, dst)
            recs: Dict[int, MsgRecord] = {}
            qa.on_complete = lambda m, now: (
                recs[m.msg_id].__setattr__("t_sender_cqe", now)
                if m.msg_id in recs else None)
            qb.on_deliver = lambda mid, now: (
                recs[mid].t_deliver.__setitem__(dst, now)
                if mid in recs else None)
            chan = (qa, recs)
            self._chans[(src, dst)] = chan
        qa, recs = chan
        mid = len(recs)
        rec = MsgRecord(mid, nbytes, self.net.sim.now)
        recs[mid] = rec

        def thunk():
            sim = self.net.sim
            rec.t_submit = sim.now
            qa.submit(nbytes, sim.now, msg_id=mid)
            sim.kick(sim.hosts[src], sim.now)

        self._staged.append(thunk)
        self._pending.append((rec, 1, None))
        return rec

    # ------------------------------------------------------------ drivers

    def run(self, timeout: float = 30.0) -> float:
        sim = self.net.sim
        for thunk in self._staged:              # submit everything NOW —
            thunk()                             # staged ops run concurrently
        self._staged = []
        deadline = sim.now + timeout
        while self._pending:
            before = sim.events
            sim.run(until=deadline)
            still = []
            for r, n, fin in self._pending:
                if fin is not None and len(r.t_deliver) >= n \
                        and r.t_sender_cqe < 0:
                    fin(r)
                if r.error:
                    continue            # bounded-retry terminal error:
                                        # the op is complete, not stuck
                if len(r.t_deliver) < n or r.t_sender_cqe < 0:
                    still.append((r, n, fin))
            self._pending = still
            if not self._pending:
                break
            if sim.events == before or sim.now >= deadline:
                break                           # stalled or out of budget
        return sim.now

    def _quiesce(self, timeout: float) -> None:
        """Restore independent-experiment semantics between scenarios:
        drain residual events (stray ACKs, armed timers), then reset the
        clock and every clock-bearing piece of state (NIC egress
        reservations, rate-pacing gates, DCQCN rate machines, switch CNP
        counters and aging) so the next scenario starts on a fresh
        fabric — matching the flow engine's isolated scenarios.
        Connection state (groups, QPs, PSNs) survives: registration is
        setup the paper excludes from steady-state measurements."""
        sim = self.net.sim
        deadline = sim.now + timeout
        if sim._q:
            sim.run(until=deadline)             # drain to empty (bounded)
        # a stalled scenario (lossy fabric, armed timers) can hit the
        # deadline with events still queued — discard them rather than
        # let them fire into the next scenario off the reset clock
        sim._q.clear()
        sim.now = 0.0
        sim.reset_free()
        sim.clear_faults()      # restore links/hosts a fault scenario took
                                # down (no-op unless a fault ever fired)
        for host in sim.hosts.values():
            host._kick_t = math.inf
            for qp in host.qps.values():
                qp.next_emit_t = 0.0
                qp.timer_deadline = math.inf
                qp._timer_ev = math.inf
                qp.rate.rate = qp.rate.peak
                qp.rate.alpha = 1.0
                qp.rate.last_cnp = -math.inf
                qp.rate.last_inc = 0.0
                qp.last_cnp_t = -math.inf
        for sw in sim.switches.values():
            sw._cnp_t.clear()
            for t in sw.tables.tables.values():
                t.cnp_count.clear()

    # --------------------------------------------- scenario batch driving

    def _scenario_counters(self) -> Tuple[int, int, int, int, int]:
        sim = self.net.sim
        no_qp = sum(h.no_qp_drops for h in sim.hosts.values())
        rtx = sum(q.retransmitted for h in sim.hosts.values()
                  for q in h.qps.values())
        return (sim.events, sim.dropped, sim.tx_bytes, no_qp, rtx)

    def _run_scenario(self, index: int, staged: List, pending: List,
                      timeout: float) -> Tuple[float, Dict[str, int]]:
        """Drive one staged scenario on a quiesced fabric with its own
        deterministic RNG stream (seed ⊕ scenario index — never the
        residue of earlier scenarios' draws), so the result does not
        depend on which scenarios ran before it in this process.  That
        invariance is what makes the serial and process-parallel paths
        bit-identical, and it turns the scenario index into a free
        multi-seed axis for the loss sweeps."""
        sim = self.net.sim
        self._quiesce(timeout)
        sim.reseed_scenario(index)
        before = self._scenario_counters()
        self._staged, self._pending = staged, pending
        end = self.run(timeout)
        after = self._scenario_counters()
        stats = {"events": after[0] - before[0],
                 "dropped": after[1] - before[1],
                 "tx_bytes": after[2] - before[2],
                 "no_qp_drops": after[3] - before[3],
                 "retransmitted": after[4] - before[4]}
        return end, stats

    def run_many(self, scenarios: Sequence[Callable], timeout: float = 30.0,
                 workers: Optional[int] = None) -> List[float]:
        """Independent-experiment scenario batch.

        Every scenario is staged first (staging is silent: group
        registration traffic runs, data submission thunks are
        deferred), then each scenario is driven on a quiesced fabric
        with the clock reset to 0 and a per-scenario RNG stream
        (groups/QPs are reused across scenarios; records measure
        relative to their own ``t_submit``).

        ``workers=None`` (default) keeps the serial path.  ``workers=0``
        uses one process per CPU; ``workers=N`` forks N worker
        processes, each driving a round-robin share of the scenarios on
        a copy-on-write image of the staged engine and shipping record
        times + counter deltas back over a pipe.  Scenario records and
        the per-scenario ``last_run_stats`` deltas (events / dropped /
        tx_bytes / no_qp_drops / retransmitted) are bit-identical
        between the two paths — the determinism tests assert it.  The
        parent folds only the engine-level aggregates (``sim.events`` /
        ``dropped`` / ``tx_bytes``) back; per-host ``no_qp_drops`` and
        per-QP ``retransmitted`` attribution stays in the workers, so
        after a parallel run read those from ``last_run_stats``, not
        from the (never-driven) parent objects.  On platforms without
        ``fork`` the call silently degrades to serial.  Caveat: forking
        a process whose threads hold locks is never fully safe in
        CPython — workers touch only the pure-Python simulator and exit
        via ``os._exit``, which has been robust in practice (also after
        CUDA init on the card: ``chip_smoke.py``'s packet_vs_flow phase),
        but pass ``workers=None``/``1`` if your embedding process cannot
        tolerate ``fork``."""
        metas: List[Tuple[List, List]] = []
        for stage in scenarios:
            stage(self)
            metas.append((self._staged, self._pending))
            self._staged, self._pending = [], []
        if workers is not None and workers == 0:
            workers = os.cpu_count() or 1
        workers = min(workers or 1, len(metas))
        if workers > 1 and hasattr(os, "fork"):
            return self._run_many_parallel(metas, timeout, workers)
        ends: List[float] = []
        stats: List[Dict[str, int]] = []
        for i, (staged, pending) in enumerate(metas):
            end, st = self._run_scenario(i, staged, pending, timeout)
            ends.append(end)
            stats.append(st)
        self.last_run_stats = stats
        self.last_run_errors: List[str] = []
        return ends

    def _restore_records(self, pending: List, rec_times: List) -> None:
        """Back-fill a scenario's caller-held records from a worker's
        shipped completion times."""
        for (rec, _, _), (mid, t_sub, t_cqe, deliver, err) in zip(
                pending, rec_times):
            rec.msg_id = mid
            rec.t_submit = t_sub
            rec.t_sender_cqe = t_cqe
            rec.t_deliver.clear()
            rec.t_deliver.update(deliver)
            rec.error = err

    def _run_many_parallel(self, metas: List[Tuple[List, List]],
                           timeout: float, workers: int) -> List[float]:
        """Fork-based scenario parallelism (quiesce makes scenarios
        independent experiments, so they partition freely).  Each child
        inherits the fully-staged engine copy-on-write, drives scenarios
        ``w, w+workers, ...`` exactly like the serial path, and STREAMS
        one pickle frame per scenario back up the pipe (record
        completion times + counter deltas); the parent back-fills the
        caller's records and folds the deltas into its own
        (never-driven) simulator counters.

        Degradation is graceful and per-scenario: a scenario that
        raises in a worker is reported by index (frame tag ``"err"``)
        and the rest of that worker's share keeps running; a worker
        that dies outright (OOM kill, segfault, truncated frame) just
        stops producing frames.  Every scenario that did not come back
        clean is re-run serially in the parent — same
        ``_run_scenario``, same per-index reseed, so the results stay
        bit-identical to the serial path and a deterministic scenario
        error reproduces with a real traceback instead of an opaque
        EOF.  ``last_run_errors`` records what degraded and why."""
        children = []
        for w in range(workers):
            r_fd, w_fd = os.pipe()
            pid = os.fork()
            if pid == 0:                                  # ---- child
                try:
                    os.close(r_fd)
                    with os.fdopen(w_fd, "wb") as fh:
                        for i in range(w, len(metas), workers):
                            staged, pending = metas[i]
                            try:
                                end, st = self._run_scenario(
                                    i, staged, pending, timeout)
                                frame = ("ok", i, end, st,
                                         [(r.msg_id, r.t_submit,
                                           r.t_sender_cqe,
                                           dict(r.t_deliver), r.error)
                                          for r, _, _ in pending])
                            except BaseException:
                                frame = ("err", i, traceback.format_exc())
                            pickle.dump(frame, fh,
                                        protocol=pickle.HIGHEST_PROTOCOL)
                            fh.flush()
                except BaseException:
                    pass
                finally:
                    os._exit(0)
            os.close(w_fd)                                # ---- parent
            children.append((pid, r_fd, w))
        sim = self.net.sim
        ends = [0.0] * len(metas)
        stats: List[Optional[Dict[str, int]]] = [None] * len(metas)
        reported: set = set()
        errors: List[str] = []
        failed: List[int] = []
        for pid, r_fd, w in children:
            expected = list(range(w, len(metas), workers))
            with os.fdopen(r_fd, "rb") as fh:
                while True:
                    try:
                        frame = pickle.load(fh)
                    except EOFError:
                        break               # clean end of stream
                    except Exception:
                        break               # truncated frame: child died
                    if frame[0] == "err":
                        _, i, tb = frame
                        reported.add(i)
                        failed.append(i)
                        errors.append(
                            f"scenario {i} raised in worker {w}:\n{tb}")
                        continue
                    _, i, end, st, rec_times = frame
                    reported.add(i)
                    ends[i] = end
                    stats[i] = st
                    self._restore_records(metas[i][1], rec_times)
                    sim.events += st["events"]
                    sim.dropped += st["dropped"]
                    sim.tx_bytes += st["tx_bytes"]
            os.waitpid(pid, 0)
            lost = [i for i in expected if i not in reported]
            if lost:
                errors.append(
                    f"worker {w} (pid {pid}) died before reporting "
                    f"scenarios {lost}")
        retry = sorted(set(failed)
                       | {i for i in range(len(metas)) if i not in reported})
        self.last_run_errors = errors
        if retry:
            warnings.warn(
                f"parallel run_many degraded: re-running scenarios "
                f"{retry} serially ({len(errors)} worker report(s) — "
                f"see last_run_errors)", RuntimeWarning)
            for i in retry:
                staged, pending = metas[i]
                end, st = self._run_scenario(i, staged, pending, timeout)
                ends[i] = end
                stats[i] = st
        self.last_run_stats = stats
        return ends


# ============================================================= flow engine

def wire_bytes(nbytes: int, mtu: int = MTU, hdr: int = HDR) -> int:
    """Payload + per-MTU-segment header overhead actually on the wire."""
    return nbytes + max(1, math.ceil(nbytes / mtu)) * hdr


class FlowEngine(_WorkloadStaging):
    """Fluid backend: one max-min-fair flow per staged transfer.

    A gleam multicast (bcast/write) occupies the union of its tree
    links as a single flow (the switch replicates; the sender
    serializes once); a unicast occupies its ECMP path.  An overlay
    transport stages one concurrent chunk-flow per relay edge and a
    *finalizer* applies the schedule's pipelined-round structure on the
    solved steady-state hop time (see ``_stage_overlay``).  ``run()``
    hands the staged batch to the solver (``TorchFlowSim`` on
    ``device`` for ``backend='torch'``, the numpy ``FlowSim`` for
    ``backend='np'``), then back-fills the records: delivery time =
    flow completion + each receiver's path latency (propagation +
    per-hop store-and-forward of one segment); sender CQE = slowest
    delivery + the aggregated-ACK return propagation.
    """

    def __init__(self, topo: Topology, *, backend: str = "torch",
                 device="cuda", group_kw: Optional[dict] = None,
                 relay_kw: Optional[dict] = None, loss_rate: float = 0.0,
                 ecn_backlog: float = math.inf, seed: Optional[int] = None,
                 staging_cache: bool = True,
                 segment_solver: Optional[str] = None, **sim_kw):
        self.topo = topo
        # ``segment_solver`` picks how dynamic ops' per-segment fairness
        # snapshots are solved: "batched" (default) collects every
        # segment problem across the run/run_many batch and solves them
        # in a few bucketed ``segment_rates_many`` calls (device-
        # resident on the torch backend); "legacy" keeps the per-segment
        # ``static_maxmin_loops`` closure — the before-leg of the
        # ``dyn_segments`` benchmark.
        segment_solver = segment_solver or "batched"
        if segment_solver not in ("batched", "legacy"):
            raise ValueError(f"segment_solver {segment_solver!r}; "
                             "choose 'batched' or 'legacy'")
        self.segment_solver = segment_solver
        if sim_kw:
            # remaining packet-engine physics (p4_mode, ...) have no
            # fluid counterpart; refusing beats silently comparing a
            # lossy packet run against an unknowingly lossless flow run
            raise TypeError("flow engines do not support packet-engine "
                            f"options: {sorted(sim_kw)}")
        # loss_rate / ecn_backlog lower onto the expected-value loss
        # model (core/flowsim.py); ``seed`` is accepted for kw-compat
        # with the packet engine and ignored — the fluid loss model is
        # the per-packet process's expectation, not one sample of it
        if not 0.0 <= loss_rate < 1.0:
            raise ValueError(f"loss_rate must be in [0, 1), got {loss_rate}")
        if ecn_backlog <= 0.0:
            raise ValueError(
                f"ecn_backlog must be positive bytes, got {ecn_backlog}")
        self.loss_rate = float(loss_rate)
        self.ecn_backlog = float(ecn_backlog)
        # the slice of the packet engine's multicast-group tuning that
        # the fluid model consumes (``fail_detect``, go-back-N
        # ``window`` / ``rto`` for the loss model); ``relay_kw`` is the
        # same slice for the overlay relays' per-edge QPs.  Accepted so
        # one make_engine(**kw) dict drives both engines
        self.group_kw = dict(group_kw or {})
        self.relay_kw = dict(relay_kw or {})
        if backend not in ("torch", "np"):
            raise ValueError(f"unknown flow backend {backend!r}; "
                             "choose 'torch' or 'np'")
        self.name = "flow" if backend == "torch" else "flow-np"
        # ``staging_cache=False`` detaches this engine from the
        # topology's shared staging cache (private memos, no op-level
        # reuse, no batch pre-warm) — the scalar reference mode the
        # cache-on/off bit-identity tests compare against
        self.staging_cache = bool(staging_cache)
        self._sim = TorchFlowSim(topo, shared_cache=self.staging_cache,
                                 device=device) if backend == "torch" \
            else FlowSim(topo, shared_cache=self.staging_cache)
        # engine-config prefix of op-level staging-cache keys: two
        # engines on one topology share per-op layouts only when their
        # loss/tuning config agrees.  None (unhashable tuning) disables
        # the op-level layer; path/tree/latency caches still apply.
        try:
            self._cfg_key = (self.loss_rate, self.ecn_backlog,
                             tuple(sorted(self.group_kw.items())),
                             tuple(sorted(self.relay_kw.items())))
            hash(self._cfg_key)
        except TypeError:
            self._cfg_key = None
        self._staged: List[tuple] = []           # (links, volume, rec, info)
        self._post: List[Callable[[float], float]] = []   # composite fins
        # piecewise-membership timelines of dynamic ops, keyed by a
        # monotonic per-engine token (NOT ``id()`` — a GC'd hidden
        # record's id can be recycled by a later dynamic op mid-sweep,
        # silently aliasing two timelines): [(t_rel, tree_links), ...].
        # The finalizers' fairness snapshots look up what OTHER
        # scenario flows occupy at a segment boundary
        # (see _stage_dynamic); the token rides in the staged entry.
        self._dyn_links: Dict[int, List[Tuple[float, tuple]]] = {}
        self._dyn_seq = 0                        # next timeline token
        self._dyn_meta: Dict[int, tuple] = {}    # token -> (cap0, loss)
        self._seg_fair: Dict[int, List[float]] = {}   # batched snapshots
        self._fin_staged: Optional[List[tuple]] = None
        self._next_msg = 0
        self.now = 0.0

    # ------------------------------------------------------------ latency

    def _path_latency(self, src: str, dst: str, seg_wire: int,
                      key: int) -> Tuple[float, float]:
        """(one-way delivery latency, return propagation) src -> dst.

        Delivery latency counts every hop's propagation plus one
        segment's store-and-forward serialization at each hop after the
        first (the first serialization is part of the message wire time).
        Memoized in the shared staging cache — large-scale staging
        revisits the same (src, dst) pairs constantly, and sweeps
        revisit them per scenario.
        """
        cache = self._sim.cache.sync()
        memo = cache.lat.get((src, dst, seg_wire, key))
        if memo is None:
            cache.misses += 1
            sim = self._sim
            ids = sim.unicast_links(src, dst, key)
            prop = float(sum(sim.delay[i] for i in ids))
            sf = float(sum(seg_wire / sim.cap[i] for i in ids[1:]))
            memo = cache.lat[(src, dst, seg_wire, key)] = \
                (prop + sf, prop)
        else:
            cache.hits += 1
        return memo

    def staging_stats(self) -> Dict[str, float]:
        """Hit/miss telemetry of this engine's staging cache."""
        return self._sim.cache.stats()

    def stage(self, op: GroupOp) -> MsgRecord:
        # Identity fast path: figure sweeps reuse the exact GroupOp
        # objects pass after pass (fig14 memoizes its Workload IR), so
        # a replay row keyed on the op's identity skips transport
        # dispatch and layout-key hashing entirely.  Rows live in the
        # staging cache's ``misc`` store — fingerprint invalidation
        # drops them with every other artifact — hold the op reference
        # (a recycled ``id()`` can never alias) and the engine config
        # key (two engines with different loss tuning over one fabric
        # never replay each other's rows).
        if self.staging_cache and self._cfg_key is not None:
            rows = self._sim.cache.sync().misc.get("oprows")
            if rows is not None:
                row = rows.get(id(op))
                if row is not None and row[0] is op \
                        and row[1] == self._cfg_key:
                    _, _, links, volume, deliver, extra, loss, nb = row
                    self._sim.cache.hits += 1
                    return self._stage(links, volume, self._new_rec(nb),
                                       deliver, extra, loss)
        rec = super().stage(op)
        self._note_oprow(op)
        return rec

    def _note_oprow(self, op: GroupOp) -> None:
        """Record an identity replay row for ``stage``'s fast path.

        Only the flat single-flow lowerings (unicast, native bcast /
        write) are replayable from one row; overlay / allreduce /
        dynamic ops keep the full path (their op-level layout cache
        already carries the expensive parts)."""
        if op.op == "unicast":
            okey = self._op_key(
                "uni", (op.members[0], op.members[1], op.nbytes, op.key))
            if okey is None:
                return
            ent = self._sim.cache.ops.get(okey)
            if ent is None:
                return
            links, deliver, prop, loss = ent
            row = (op, self._cfg_key, links, wire_bytes(op.nbytes),
                   deliver, prop, loss, op.nbytes)
        elif op.op in ("bcast", "write") \
                and get_transport(op.transport).native:
            volume = float(wire_bytes(op.nbytes))
            if op.op == "write" and not op.same_mr:
                volume += wire_bytes(12 * (len(op.members) - 1) + 16)
            source = op.source or op.members[0]
            okey = self._op_key(
                "mcast",
                (source, tuple(op.members), op.nbytes, float(volume),
                 op.key), op)
            if okey is None:
                return
            ent = self._sim.cache.ops.get(okey)
            if ent is None:
                return
            links, deliver, back, loss = ent
            row = (op, self._cfg_key, links, volume, deliver, back, loss,
                   op.nbytes)
        else:
            return
        rows = self._sim.cache.misc.setdefault("oprows", {})
        if len(rows) < staging.MAX_ENTRIES:
            rows[id(op)] = row

    def _op_key(self, kind: str, fields: tuple,
                op: Optional[GroupOp] = None) -> Optional[tuple]:
        """Key of a STATIC op's cached layout, or None when the op is
        uncacheable (cache disabled, unhashable tuning, or dynamic
        events/faults — those re-derive every time)."""
        if not self.staging_cache or self._cfg_key is None:
            return None
        if op is not None and (op.events or op.faults):
            return None
        over = None if op is None else (op.loss_rate, op.ecn_backlog)
        return (kind, self._cfg_key, over) + fields

    def _fault_paths(self, src: str, members: Sequence[str], key: int,
                     downs: Sequence[Tuple[str, str]], seg_wire: int,
                     targets) -> Tuple[tuple, Dict[str, tuple]]:
        """(tree links, latency map) re-derived with ``downs`` applied.

        Bypasses the LinkMap memos (they cache pristine-topology paths
        only): temporarily marks the downed links in the topology, walks
        ``path_links`` per target, and restores.  Targets unroutable
        around the faults are skipped — their branch is simply gone.
        Tree links come from *present* members only; latencies cover
        every target so later steps (joins, prunes) can consult them.
        """
        sim = self._sim
        topo = self.topo
        links: set = set()
        lat: Dict[str, tuple] = {}
        present = set(members)
        try:
            for a, b in downs:
                topo.set_link_down(a, b, True)
            for m in sorted(targets):
                if m == src:
                    continue
                try:
                    ids = tuple(sim.link_id[hop]
                                for hop in topo.path_links(src, m, key))
                except (KeyError, ValueError):
                    continue            # unroutable while down
                if m in present:
                    links.update(ids)
                prop = float(sum(sim.delay[i] for i in ids))
                sf = float(sum(seg_wire / sim.cap[i] for i in ids[1:]))
                lat[m] = (prop + sf, prop)
        finally:
            topo.clear_down()
        return tuple(sorted(links)), lat

    # --------------------------------------------------------- loss model

    def _loss_params(self, links, *, nbytes: int, rtt: float, tuning: dict,
                     op: Optional[GroupOp] = None, parallel: int = 1):
        """Fold one flow's loss/ECN scenario into ``flowsim.LossParams``.

        ``links`` is the flow's link set (tree union or unicast path);
        ``rtt`` the sender's round trip (2x the slowest return
        propagation — the NACK/ACK turnaround the go-back-N replay
        sees); ``tuning`` the QP kwargs dict this flow would get on the
        packet engine (``group_kw`` for native multicast, ``relay_kw``
        for overlay relay edges), consulted for ``window`` / ``rto``.
        Op-level ``loss_rate`` / ``ecn_backlog`` override the
        engine-level setting.  Returns None when the flow is unaffected
        so zero-loss staging keeps the exact lossless path.
        """
        p, backlog = self.loss_rate, self.ecn_backlog
        if op is not None:
            if op.loss_rate is not None:
                p = float(op.loss_rate)
            if op.ecn_backlog is not None:
                backlog = float(op.ecn_backlog)
        ecn = math.isfinite(backlog)
        if (p <= 0.0 and not ecn) or not links:
            return None
        sim = self._sim
        return LossParams.build(
            loss_rate=p,
            # only switch-egress hops drop (packetsim drops iff
            # from_switch): count them over the whole tree — any tree
            # copy lost rolls the one go-back-N sender back
            lossy_hops=float(sum(sim.lossy[i] for i in links)),
            rtt=rtt,
            pkt_wire=float(wire_bytes(min(nbytes, MTU))),
            cap_min=float(min(sim.cap[i] for i in links)),
            window=float(tuning.get("window", 256)),
            n_pkts=float(max(1, math.ceil(nbytes / MTU))),
            rto=float(tuning.get("rto", 200e-6)),
            ecn=ecn,
            parallel=float(max(parallel, 1)))

    # ----------------------------------------------------------- lowering

    def _stage(self, links, volume: float, rec: MsgRecord,
               deliver: Dict[str, float], cqe_extra: float,
               loss=None, dyn: Optional[int] = None) -> MsgRecord:
        """``dyn`` is the ``_dyn_links`` timeline token of a dynamic
        op's hidden flow (None for static flows)."""
        self._staged.append((links, volume, rec, deliver, cqe_extra, loss,
                             dyn))
        return rec

    def _new_rec(self, nbytes: int) -> MsgRecord:
        rec = MsgRecord(self._next_msg, nbytes, self.now)
        self._next_msg += 1
        return rec

    def _mcast(self, members: Sequence[str], nbytes: int, volume: float,
               source: Optional[str], key: int,
               op: Optional[GroupOp] = None) -> MsgRecord:
        source = source or members[0]
        okey = self._op_key(
            "mcast", (source, tuple(members), nbytes, float(volume), key),
            op)
        cache = self._sim.cache.sync()
        ent = cache.ops.get(okey) if okey is not None else None
        if ent is None:
            links = self._sim.multicast_tree_links(source, members, key)
            seg = wire_bytes(min(nbytes, MTU))
            deliver, back = {}, 0.0
            for m in members:
                if m == source:
                    continue
                lat, prop = self._path_latency(source, m, seg, key)
                deliver[m] = lat
                back = max(back, prop)
            loss = self._loss_params(links, nbytes=nbytes, rtt=2.0 * back,
                                     tuning=self.group_kw, op=op)
            ent = (links, deliver, back, loss)
            if okey is not None:
                cache.ops[okey] = ent
        else:
            cache.hits += 1
        links, deliver, back, loss = ent
        rec = self._new_rec(nbytes)
        # deliver maps are cached read-only (backfill never mutates them)
        return self._stage(links, volume, rec, deliver, back, loss)

    def _stage_native(self, op: GroupOp) -> MsgRecord:
        if op.events or op.faults:
            return self._stage_dynamic(op)
        volume = float(wire_bytes(op.nbytes))
        if op.op == "write" and not op.same_mr:
            # §3.3: the MR_UPDATE preamble rides the same tree
            volume += wire_bytes(12 * (len(op.members) - 1) + 16)
        return self._mcast(op.members, op.nbytes, volume, op.source, op.key,
                           op=op)

    def _stage_dynamic(self, op: GroupOp) -> MsgRecord:
        """Dynamic-membership lowering: piecewise-membership segments.

        The fluid model has no in-band control plane, so the op's
        timeline is cut at each ``MemberEvent`` into segments of
        constant membership.  One hidden solver flow over the INITIAL
        tree yields the contended baseline rate ``r0``; segment ``k``
        runs at ``r0 * fair(T_k) / fair(T_0)``, where ``fair(T)`` is a
        static max-min snapshot (``flowsim.static_maxmin``) of this
        op's segment tree against every OTHER flow in the scenario —
        other dynamic ops contribute *their* segment tree at that
        instant (via the ``_dyn_links`` timeline registry), so two
        overlapping dynamic ops contend correctly through their
        membership changes.  For a scenario-lone flow the snapshot
        reduces to ``mincap(T_k)``, the max-min rate of each segment's
        tree (bit-identical to the pre-snapshot behavior).
        A ``fail`` wedges the sender (the dead port freezes the
        aggregate minimum) but the go-back-N window keeps draining to
        the live receivers: the fluid image lets ``min(remaining,
        window)`` wire bytes through at the pre-fail rate, then stalls
        until the master's isolation at ``+fail_detect`` un-wedges the
        stream — so a fail near the end of a message (tail fits in the
        window) correctly costs nothing, and an early fail costs the
        detection delay, exactly as the packet engine behaves (its
        window drain and post-isolation go-back-N resend cancel to
        first order).  Receivers present at completion deliver at
        completion + path latency (joiners included, matching the
        packet engine's last-packet delivery); members that left or
        failed earlier do not deliver.

        ``FaultEvent``s extend the same piecewise machinery with a
        detect+repair stall model (the fluid image of the packet
        engine's self-healing recovery):

        - link_down / link_flap / switch_fail — progress stops at the
          fault and resumes, on the tree re-derived over the surviving
          paths, at ``at + max(rto, link_detect + 2*repair_prop)``:
          the sender wedges on the dead branch until either its RTO
          go-back-N replay or the leaf-detect + repair-envelope
          round-trip un-wedges it, whichever the packet engine's
          timeline reaches first.  No drain credit — the repaired
          branch is resent from ``snd_una``.  A flap's repaired tree
          persists after the link heals, exactly as the packet
          engine's repaired installs do.
        - host_gone_dark — the ``fail`` drain model (live receivers
          keep their windowed bytes) with the sender CQE floored at
          ``at + link_detect + prune_prop``, the switch-originated
          teardown-confirm's arrival at the master.
        - master_crash — progress stops at the crash; the lowest-rank
          survivor resumes the remaining volume from its OWN root at
          ``at + fail_detect`` (re-election), on the tree re-rooted at
          the survivor; deliveries and the return path are measured
          from the new source."""
        members = list(op.members)
        source = op.source or members[0]
        volume = float(wire_bytes(op.nbytes))
        if op.op == "write" and not op.same_mr:
            volume += wire_bytes(12 * (len(members) - 1) + 16)
        sim = self._sim
        key = op.key
        fail_detect = float(self.group_kw.get("fail_detect",
                                              DEFAULT_FAIL_DETECT))
        link_detect = float(self.group_kw.get("link_detect",
                                              DEFAULT_LINK_DETECT))
        rto = float(self.group_kw.get("rto", 200e-6))

        def mincap(links) -> float:
            if not links:                   # no receivers left
                return cap0
            return float(min(sim.cap[i] for i in links))

        links0 = sim.multicast_tree_links(source, members, key)
        cap0 = float(min(sim.cap[i] for i in links0))
        events = op.sorted_events()
        seg = wire_bytes(min(op.nbytes, MTU))
        # membership timeline -> typed steps carrying the segment's
        # tree: ("cap", at, tree, extra) for join/leave, ("fail", ...)
        # for member fails, ("stall", ...) / ("dark", ...) for faults;
        # ``extra`` is None on the event-only path (bit-identical to
        # the pre-fault tree) and a dict carrying the step's resume
        # time / CQE floor, post-fault latency map, and source.
        present = list(members)
        steps: List[tuple] = []
        if op.faults:
            validate_fault_plan(self.topo, op)
            lat_targets = set(members) | {e.member for e in events
                                          if e.kind == "join"}
            downs: List[Tuple[str, str]] = []
            cur_src = source
            lat_cur = {m: self._path_latency(cur_src, m, seg, key)
                       for m in lat_targets if m != cur_src}
            merged = sorted(
                [(e.at, 0, e) for e in events]
                + [(f.at, 1, f) for f in op.sorted_faults()],
                key=lambda x: (x[0], x[1]))
            for at, is_fault, ev in merged:
                if not is_fault:
                    if ev.kind == "join":
                        present.append(ev.member)
                    elif ev.kind in ("leave", "fail"):
                        present.remove(ev.member)
                    # master-switch: no effect on the in-flight message
                    if ev.kind == "master-switch":
                        continue
                    links_next, lat_cur = self._fault_paths(
                        cur_src, present, key, downs, seg, lat_targets)
                    steps.append((("fail" if ev.kind == "fail"
                                   else "cap"), at, links_next,
                                  {"lat": lat_cur, "src": cur_src}))
                    continue
                if ev.kind in ("link_down", "link_flap"):
                    new_downs = [(ev.node, ev.peer)]
                elif ev.kind == "switch_fail":
                    new_downs = [(ev.node, peer) for _, (peer, _)
                                 in sorted(self.topo.ports[ev.node].items())]
                if ev.kind in ("link_down", "link_flap", "switch_fail"):
                    # a fault on links the live tree never used loses no
                    # data: the repair re-floods installs, but the
                    # stream never stalls (the packet engine's reuse
                    # path keeps the tree as-is) — lower it as a plain
                    # tree recompute, not a stall
                    cur_links = set(steps[-1][2] if steps else links0)
                    hit = False
                    for a, b in new_downs:
                        pa, pb = self.topo._link_ports(a, b)
                        if sim.link_id.get((a, pa)) in cur_links or \
                                sim.link_id.get((b, pb)) in cur_links:
                            hit = True
                            break
                    downs.extend(new_downs)
                    links_next, lat_cur = self._fault_paths(
                        cur_src, present, key, downs, seg, lat_targets)
                    if not hit:
                        steps.append(("cap", at, links_next,
                                      {"lat": lat_cur, "src": cur_src}))
                        continue
                    rep = max((lat_cur[m][1] for m in present
                               if m != cur_src and m in lat_cur),
                              default=0.0)
                    resume = at + max(rto, link_detect + 2.0 * rep)
                    steps.append(("stall", at, links_next,
                                  {"resume": resume, "lat": lat_cur,
                                   "src": cur_src}))
                elif ev.kind == "host_gone_dark":
                    prune = lat_cur.get(ev.node, (0.0, 0.0))[1]
                    present.remove(ev.node)
                    links_next, lat_cur = self._fault_paths(
                        cur_src, present, key, downs, seg, lat_targets)
                    steps.append(("dark", at, links_next,
                                  {"floor": at + link_detect + prune,
                                   "lat": lat_cur, "src": cur_src}))
                else:                       # master_crash
                    present.remove(cur_src)
                    cur_src = present[0]    # lowest-rank survivor
                    links_next, lat_cur = self._fault_paths(
                        cur_src, present, key, downs, seg, lat_targets)
                    steps.append(("stall", at, links_next,
                                  {"resume": at + fail_detect,
                                   "lat": lat_cur, "src": cur_src}))
        else:
            for ev in events:
                if ev.kind == "join":
                    present.append(ev.member)
                    steps.append(("cap", ev.at,
                                  sim.multicast_tree_links(source, present,
                                                           key), None))
                elif ev.kind in ("leave", "fail"):
                    present.remove(ev.member)
                    steps.append((("fail" if ev.kind == "fail" else "cap"),
                                  ev.at,
                                  sim.multicast_tree_links(source, present,
                                                           key), None))
                # master-switch: no effect on the in-flight message
        # go-back-N window in wire bytes: what the sender can still push
        # past a frozen cumulative ACK before it wedges
        window_wire = float(self.group_kw.get("window", 256)
                            * (MTU + HDR))
        seg = wire_bytes(min(op.nbytes, MTU))
        latency = {m: self._path_latency(source, m, seg, key)
                   for m in set(members) | {e.member for e in events}
                   if m != source}
        rec = self._new_rec(op.nbytes)
        hidden = self._new_rec(op.nbytes)
        back0 = max((latency[m][1] for m in members if m != source),
                    default=0.0)
        loss = self._loss_params(links0, nbytes=op.nbytes, rtt=2.0 * back0,
                                 tuning=self.group_kw, op=op)
        token = self._dyn_seq
        self._dyn_seq += 1
        self._stage(links0, volume, hidden, {}, 0.0, loss, dyn=token)
        self._dyn_links[token] = \
            [(0.0, links0)] + [(at, ls) for _, at, ls, _ in steps]
        self._dyn_meta[token] = (cap0, loss)

        def other_links_at(t_rel: float) -> List[tuple]:
            """Link sets every OTHER flow of the scenario occupies at
            ``t_rel`` (dynamic ops via their segment timeline)."""
            others = []
            for entry in self._fin_staged or []:
                o_links, o_dyn = entry[0], entry[6]
                if o_dyn == token:
                    continue
                timeline = self._dyn_links.get(o_dyn) \
                    if o_dyn is not None else None
                if timeline is not None:
                    for at, ls in timeline:
                        if at <= t_rel:
                            o_links = ls
                        else:
                            break
                if o_links:
                    others.append(o_links)
            return others

        def fair(links_now, t_rel: float) -> float:
            """Static max-min snapshot of this op's segment tree against
            the co-scenario flows; mincap for a scenario-lone flow.
            The legacy per-segment path — ``segment_solver='batched'``
            precomputes every snapshot through ``_solve_segments``
            instead and this closure never runs."""
            if not links_now:
                return cap0
            others = other_links_at(t_rel)
            if not others:
                return mincap(links_now)
            rates = static_maxmin_loops(sim.cap, others + [links_now])
            return float(rates[-1])

        def fin(t0: float) -> float:
            r0 = volume / (hidden.t_sender_cqe - t0)
            fairs = self._seg_fair.get(token)
            fair0 = fairs[0] if fairs is not None else fair(links0, 0.0)
            remaining, t_rel, fair_now = volume, 0.0, fair0
            cqe_floor = 0.0                 # fault recovery lower bound
            lat_now, src_now = latency, source
            for idx, (kind, at, links_next, extra) in enumerate(
                    steps + [("cap", math.inf, links0, None)]):
                rate = r0 * (fair_now / fair0)
                if at > t_rel:
                    if remaining <= rate * (at - t_rel):
                        t_rel += remaining / rate
                        remaining = 0.0
                        break
                    remaining -= rate * (at - t_rel)
                    t_rel = at
                if kind in ("fail", "dark"):
                    # the in-flight window drains to the live receivers
                    # at the pre-fail rate ...
                    if kind == "dark":
                        # ... but the CQE cannot beat the switch's
                        # teardown-confirm reaching the master
                        cqe_floor = max(cqe_floor, extra["floor"])
                    drain = min(remaining, window_wire)
                    if drain >= remaining:
                        t_rel += remaining / rate
                        remaining = 0.0
                        break
                    remaining -= drain
                    # ... then the sender wedges until isolation
                    floor = (extra["floor"] if kind == "dark"
                             else at + fail_detect)
                    t_rel = max(t_rel + drain / rate, floor)
                elif kind == "stall":
                    # fabric fault / master crash: no drain credit (the
                    # repaired branch is resent go-back-N), progress
                    # resumes on the repaired tree at detect+repair
                    t_rel = max(t_rel, extra["resume"])
                    cqe_floor = max(cqe_floor, extra["resume"])
                if extra is not None:
                    lat_now, src_now = extra["lat"], extra["src"]
                if fairs is None:
                    fair_now = fair(links_next, at)
                elif idx + 1 < len(fairs):
                    # the sentinel step's snapshot is never consumed —
                    # the batched solver doesn't compute it
                    fair_now = fairs[idx + 1]
            done = t0 + t_rel
            if op.faults:
                # replay the merged timeline up to completion; members
                # that went dark or ever held the source role are excused
                excused = {source}
                receivers = set(members)
                for at, snap_present, snap_src in \
                        op.fault_roles()["snaps"]:
                    if at > t_rel:
                        break
                    receivers = set(snap_present)
                    excused.add(snap_src)
                receivers -= excused
            else:
                receivers = set(members)
                for ev in events:           # membership at completion
                    if ev.at > t_rel:
                        break
                    if ev.kind == "join":
                        receivers.add(ev.member)
                    elif ev.kind in ("leave", "fail"):
                        receivers.discard(ev.member)
                receivers.discard(source)
            back = 0.0
            for m in receivers:
                lat, prop = lat_now[m]
                rec.t_deliver[m] = done + lat
                back = max(back, prop)
            rec.t_sender_cqe = (max(rec.t_deliver.values()) + back
                                if receivers else done)
            if cqe_floor > 0.0:
                rec.t_sender_cqe = max(rec.t_sender_cqe, t0 + cqe_floor)
            return rec.t_sender_cqe

        self._post.append(fin)
        return rec

    def _stage_overlay(self, op: GroupOp, transport: Transport) -> MsgRecord:
        """Relay lowering: one concurrent fluid flow per relay edge (so
        sender fan-out and shared fabric links contend max-min-fairly),
        then a finalizer replays the relay pipeline analytically on the
        solved steady-state hop time: member at ``h`` relay hops gets
        its last chunk at ``(chunks-1+h) * ser + cum_latency(h) +
        (h-1) * relay_overhead`` — ``ser`` the slowest edge's fluid
        chunk serialization, matching the packet relays' store-and-
        forward pipeline (chunks stream back-to-back; each hop adds its
        path latency plus the host forwarding cost)."""
        members = op.ordered_members()
        okey = self._op_key(
            "ovl", (transport.name, tuple(members), op.nbytes, op.key,
                    op.chunks), op)
        cache = self._sim.cache.sync()
        ent = cache.ops.get(okey) if okey is not None else None
        if ent is None:
            plan = relay_plan(transport, members)
            chunks = op.chunks if transport.chunked else 1
            chunk = op.nbytes if not transport.chunked else \
                max(1, math.ceil(op.nbytes / chunks))
            seg = wire_bytes(min(chunk, MTU))
            rows = []
            for parent, child, hops in plan:
                links = self._sim.unicast_links(parent, child, op.key)
                lat, prop = self._path_latency(parent, child, seg, op.key)
                # the op completes at the MAX over its relay flows
                loss = self._loss_params(links, nbytes=chunk,
                                         rtt=2.0 * prop,
                                         tuning=self.relay_kw, op=op,
                                         parallel=len(plan))
                rows.append((child, links, {child: lat}, lat, prop, loss))
            ent = (plan, rows, chunks, chunk, seg)
            if okey is not None:
                cache.ops[okey] = ent
        else:
            cache.hits += 1
        plan, rows, chunks, chunk, seg = ent
        rec = self._new_rec(op.nbytes)
        vol = float(wire_bytes(chunk))
        comp = []                               # (child, hidden, lat, prop)
        for child, links, dmap, lat, prop, loss in rows:
            hidden = self._new_rec(chunk)
            self._stage(links, vol, hidden, dmap, prop, loss)
            comp.append((child, hidden, lat, prop))

        # only host_gone_dark reaches an overlay transport (the IR
        # validator routes fabric/master faults to native lowerings);
        # graceful leaves splice immediately, darks after fail_detect.
        # Each splice is (node, t_depart, t_rep): chunks stop flowing
        # through the node at t_depart, the schedule is respliced at
        # t_rep.
        splices = [(e.member, e.at, e.at) for e in op.sorted_events()]
        if op.faults:
            detect = float(self.group_kw.get("fail_detect",
                                             DEFAULT_FAIL_DETECT))
            splices += [(f.node, f.at, f.at + detect)
                        for f in op.sorted_faults()]
            splices.sort(key=lambda s: s[2])

        if not transport.chunked:               # multiunicast: direct flows
            dead = {m for m, _, _ in splices}

            def fin(t0: float) -> float:
                for child, hidden, lat, prop in comp:
                    if child not in dead:
                        rec.t_deliver[child] = hidden.t_deliver[child]
                rec.t_sender_cqe = max(
                    hidden.t_deliver[child] + prop
                    for child, hidden, lat, prop in comp
                    if child not in dead)
                return rec.t_sender_cqe
        else:
            # cumulative path latency source -> member along the relay
            # chain (edges arrive parent-before-child in hop order)
            lat_edge = {child: lat for child, _, lat, _ in comp}
            parent_of = {child: parent for parent, child, _ in plan}
            overhead = self.relay_overhead

            def fin(t0: float) -> float:
                ser = max(hidden.t_deliver[child] - t0 - lat
                          for child, hidden, lat, _ in comp)
                back = max(prop for _, _, _, prop in comp)
                cum = {members[0]: 0.0}         # hop order: parent first
                for _, child, hops in sorted(plan, key=lambda e: e[2]):
                    cum[child] = cum[parent_of[child]] + lat_edge[child]
                    rec.t_deliver[child] = t0 + \
                        (chunks - 1 + hops) * ser + cum[child] + \
                        (hops - 1) * overhead
                if splices:
                    self._overlay_repair(op, rec, t0, ser, splices,
                                         parent_of, lat_edge, chunks,
                                         overhead, seg)
                rec.t_sender_cqe = max(rec.t_deliver.values()) + back
                return rec.t_sender_cqe

        self._post.append(fin)
        return rec

    def _overlay_repair(self, op: GroupOp, rec: MsgRecord, t0: float,
                        ser: float, splices, parent_of, lat_edge,
                        chunks: int, overhead: float, seg: int) -> None:
        """Analytic image of the packet relays' relay-schedule splice.

        ``splices`` is a time-ordered ``(node, t_depart, t_rep)`` list —
        darks repair at ``at + fail_detect``, graceful leaves at
        ``at`` (the departing host announces itself — no detection
        delay).  At
        ``t_rep`` the departed relay's children re-parent onto ITS
        parent over fresh edges and the full chunk stream is
        resubmitted on each (a software relay keeps no per-child
        progress state — conservative go-back-N, see
        ``baselines._RelayBcast.repair_dead_relay``).  So every member
        of the departed relay's subtree replays its repaired
        sub-schedule from the repair instant, with relay hops counted
        from the splice parent and the solved steady-state chunk time
        ``ser``; the departed member itself delivers nowhere."""
        parent_of = dict(parent_of)
        lat_edge = dict(lat_edge)
        children: Dict[str, List[str]] = {}
        for c, p in parent_of.items():
            children.setdefault(p, []).append(c)
        for dead, t_depart, t_rep in splices:
            if dead not in parent_of:
                continue
            par = parent_of.pop(dead)
            children[par] = [c for c in children[par] if c != dead]
            kids = children.pop(dead, [])
            rec.t_deliver.pop(dead, None)
            for c in kids:
                parent_of[c] = par
                children[par].append(c)
                lat_edge[c] = self._path_latency(par, c, seg, op.key)[0]
            # replay the subtree's deliveries with hops re-counted from
            # the splice parent
            stack = [(c, 1, lat_edge[c]) for c in kids]
            while stack:
                m, h, cum = stack.pop()
                # a member whose base-schedule delivery completed before
                # the departure (so the chunks really flowed) keeps it —
                # the packet relays' ``== chunks`` bookkeeping ignores
                # repair duplicates
                if not (m in rec.t_deliver
                        and rec.t_deliver[m] <= t0 + t_depart):
                    rec.t_deliver[m] = t0 + t_rep + \
                        (chunks - 1 + h) * ser + cum + (h - 1) * overhead
                for c in children.get(m, ()):
                    stack.append((c, h + 1, cum + lat_edge[c]))

    def _stage_allreduce(self, op: GroupOp, transport: Transport
                         ) -> MsgRecord:
        """Fan-in reduce + transport bcast, phase-sequenced by the
        finalizer (reduce and bcast flows solve concurrently — they
        occupy opposite link directions on duplex fabrics, so each
        phase sees its standalone rate — and the bcast timeline is
        shifted by the reduce completion)."""
        members = op.ordered_members()
        root = members[0]
        rec = self._new_rec(op.nbytes)
        seg = wire_bytes(min(op.nbytes, MTU))
        red = []
        for m in members[1:]:
            links = self._sim.unicast_links(m, root, op.key)
            lat, prop = self._path_latency(m, root, seg, op.key)
            hidden = self._new_rec(op.nbytes)
            loss = self._loss_params(links, nbytes=op.nbytes,
                                     rtt=2.0 * prop, tuning=self.relay_kw,
                                     op=op, parallel=len(members) - 1)
            self._stage(links, float(wire_bytes(op.nbytes)), hidden,
                        {root: lat}, 0.0, loss)
            red.append(hidden)

        bop = GroupOp("bcast", tuple(members), op.nbytes,
                      transport=op.transport, key=op.key, chunks=op.chunks,
                      loss_rate=op.loss_rate, ecn_backlog=op.ecn_backlog)
        brec = self._stage_native(bop) if transport.native \
            else self._stage_overlay(bop, transport)

        def fin(t0: float) -> float:
            r_done = max(h.t_deliver[root] for h in red)
            shift = r_done - t0
            rec.t_deliver[root] = r_done
            for m in members[1:]:
                rec.t_deliver[m] = brec.t_deliver[m] + shift
            rec.t_sender_cqe = brec.t_sender_cqe + shift
            return rec.t_sender_cqe

        self._post.append(fin)
        return rec

    def _stage_unicast(self, src: str, dst: str, nbytes: int,
                       key: int = 0) -> MsgRecord:
        okey = self._op_key("uni", (src, dst, nbytes, key))
        cache = self._sim.cache.sync()
        ent = cache.ops.get(okey) if okey is not None else None
        if ent is None:
            links = self._sim.unicast_links(src, dst, key)
            seg = wire_bytes(min(nbytes, MTU))
            lat, prop = self._path_latency(src, dst, seg, key)
            loss = self._loss_params(links, nbytes=nbytes, rtt=2.0 * prop,
                                     tuning=self.relay_kw)
            ent = (links, {dst: lat}, prop, loss)
            if okey is not None:
                cache.ops[okey] = ent
        else:
            cache.hits += 1
        links, deliver, prop, loss = ent
        rec = self._new_rec(nbytes)
        return self._stage(links, wire_bytes(nbytes), rec, deliver, prop,
                           loss)

    # ---------------------------------------------------------- pre-warm

    def _op_pairs(self, op: GroupOp, pairs: set, lats: set) -> None:
        """Collect the (src, dst, key) path requests and (src, dst,
        seg_wire, key) latency requests a static op's staging will make
        (mirrors the lowering methods' access patterns)."""
        transport = get_transport(op.transport)
        key = op.key
        if op.op == "unicast":
            seg = wire_bytes(min(op.nbytes, MTU))
            pairs.add((op.members[0], op.members[1], key))
            lats.add((op.members[0], op.members[1], seg, key))
            return
        if op.op == "allreduce":
            members = op.ordered_members()
            root = members[0]
            seg = wire_bytes(min(op.nbytes, MTU))
            for m in members[1:]:
                pairs.add((m, root, key))
                lats.add((m, root, seg, key))
            # fall through: the bcast half routes like a plain bcast
        if transport.native:
            members = list(op.members) if op.op != "allreduce" \
                else list(op.ordered_members())
            source = (op.source or members[0]) if op.op != "allreduce" \
                else members[0]
            seg = wire_bytes(min(op.nbytes, MTU))
            for m in members:
                if m != source:
                    pairs.add((source, m, key))
                    lats.add((source, m, seg, key))
            return
        members = op.ordered_members()
        chunks = op.chunks if transport.chunked else 1
        chunk = op.nbytes if not transport.chunked else \
            max(1, math.ceil(op.nbytes / chunks))
        seg = wire_bytes(min(chunk, MTU))
        for parent, child, _ in relay_plan(transport, members):
            pairs.add((parent, child, key))
            lats.add((parent, child, seg, key))

    def _warm_workloads(self, workloads: Sequence[Workload]) -> None:
        """Batch-derive the whole batch's paths/latencies up front.

        One vectorized multi-destination sweep (``Topology.paths_many``
        via ``LinkMap.warm_paths``) replaces thousands of per-pair
        Python BFS walks — the staging half of the fleet-sweep speedup.
        Only runs against a cold cache: once artifacts exist, per-op
        lookups are already cheap and re-collecting requests would cost
        more than it saves.  Dynamic ops are skipped (they re-derive
        against mutated topologies).
        """
        cache = self._sim.cache.sync()
        if cache.paths:
            return
        pairs: set = set()
        lats: set = set()
        for wl in workloads:
            for op in wl.ops:
                if op.events or op.faults:
                    continue
                self._op_pairs(op, pairs, lats)
        self._sim.warm_paths(sorted(pairs))
        self._sim.warm_latencies(sorted(lats))

    def run_workloads(self, workloads: Sequence[Workload],
                      timeout: float = 30.0,
                      workers: Optional[int] = None
                      ) -> List[List[MsgRecord]]:
        if self.staging_cache:
            self._warm_workloads(workloads)
        out: List[List[MsgRecord]] = [[] for _ in workloads]
        fast_ok = self.staging_cache and self._cfg_key is not None

        # Scenario closures replay ``stage``'s identity fast path with
        # the per-op bookkeeping hoisted out of the loop.  The hoist is
        # only sound for all-static workloads: a dynamic op's fault
        # staging can move the fingerprint mid-scenario, so those keep
        # the per-op ``sync`` inside ``stage``.
        def scenario(wl: Workload, recs: List[MsgRecord]):
            dyn = any(op.events or op.faults for op in wl.ops)

            def fn(eng):
                rows = self._sim.cache.sync().misc.get("oprows") \
                    if fast_ok and not dyn else None
                if rows is None:
                    recs.extend(self.stage(op) for op in wl.ops)
                    return
                cfg = self._cfg_key
                cache = self._sim.cache
                staged = self._staged
                now = self.now
                for op in wl.ops:
                    row = rows.get(id(op))
                    if row is None or row[0] is not op or row[1] != cfg:
                        recs.append(self.stage(op))
                        continue
                    _, _, links, volume, deliver, extra, loss, nb = row
                    rec = MsgRecord(self._next_msg, nb, now)
                    self._next_msg += 1
                    cache.hits += 1
                    staged.append((links, volume, rec, deliver, extra,
                                   loss, None))
                    recs.append(rec)
            return fn

        self.run_many([scenario(wl, recs)
                       for wl, recs in zip(workloads, out)], timeout,
                      workers=workers)
        return out

    # ------------------------------------------------- dynamic segments

    def _solve_segments(self, scenarios: Sequence[List[tuple]]) -> None:
        """Batch-solve every dynamic op's per-segment fairness snapshot.

        The batched replacement for the per-segment ``fair()`` closure
        of ``_stage_dynamic``: walk each scenario's event timelines
        (MemberEvents + FaultEvents, already merged into ``_dyn_links``
        entries at staging time), build one max-min problem per segment
        — the segment's tree against every other co-scenario flow at
        that instant, the own flow LAST exactly as the closure orders
        it — and solve all of them in a few bucketed
        ``segment_rates_many`` calls (device-resident on the torch
        backend, vectorized numpy otherwise).  Results land in
        ``_seg_fair[token]``; the finalizers consume them instead of
        re-solving.

        Exactness rules (the ``check_faults`` frozen refs depend on
        them): an empty segment tree snapshots at ``cap0`` and a
        scenario-lone op at ``min(cap[links])`` — both computed with
        the closure's exact scalar expressions, no solver involved.
        Adjacent segments usually differ by one event, so their
        problems often coincide for other ops' snapshots — the dedup
        map IS the warm start (each distinct problem is solved once per
        batch), and solved values persist in the staging cache
        (``misc['segrates']``) so sweep re-passes skip the solve
        entirely.
        """
        if self.segment_solver != "batched":
            return
        sim = self._sim
        cap = sim.cap
        probs: List[tuple] = []          # unique (link_sets, loss)
        keys: Dict[tuple, int] = {}      # problem key -> probs index
        fills: List[tuple] = []          # (fairs, seg_idx, probs_idx, key)
        memo = sim.cache.sync().misc.setdefault("segrates", {})
        for staged in scenarios:
            tokens = [e[6] for e in staged if e[6] is not None]
            for token in tokens:
                timeline = self._dyn_links[token]
                cap0, lp = self._dyn_meta[token]
                fairs = [0.0] * len(timeline)
                self._seg_fair[token] = fairs
                for k, (t_k, links_k) in enumerate(timeline):
                    if not links_k:     # no receivers left
                        fairs[k] = cap0
                        continue
                    others = []
                    for entry in staged:
                        o_links, o_dyn = entry[0], entry[6]
                        if o_dyn == token:
                            continue
                        tl = self._dyn_links.get(o_dyn) \
                            if o_dyn is not None else None
                        if tl is not None:
                            for at, ls in tl:
                                if at <= t_k:
                                    o_links = ls
                                else:
                                    break
                        if o_links:
                            others.append(o_links)
                    if not others:      # scenario-lone: exact mincap
                        fairs[k] = float(min(cap[i] for i in links_k))
                        continue
                    sets = tuple(others) + (tuple(links_k),)
                    key = (sets, lp)
                    val = memo.get(key)
                    if val is not None:
                        fairs[k] = val
                        continue
                    pi = keys.get(key)
                    if pi is None:
                        pi = keys[key] = len(probs)
                        probs.append((sets, lp))
                    fills.append((fairs, k, pi, key))
        if not probs:
            return
        vals = sim.segment_rates_many(probs)
        bound = len(memo) < staging.MAX_ENTRIES
        for fairs, k, pi, key in fills:
            fairs[k] = vals[pi]
            if bound:
                memo[key] = vals[pi]

    def _clear_dynamics(self) -> None:
        self._dyn_links.clear()
        self._dyn_meta.clear()
        self._seg_fair.clear()

    # ------------------------------------------------------------ drivers

    def _backfill(self, staged, flows, t0: float) -> float:
        """Turn solver completion times into record bookkeeping;
        returns the scenario's end time (latest sender CQE)."""
        end = t0
        for f, (_, _, rec, deliver, back, _, _) in zip(flows, staged):
            done = t0 + f.done_t
            if deliver:
                td = rec.t_deliver
                for m, lat in deliver.items():
                    td[m] = done + lat
                rec.t_sender_cqe = max(td.values()) + back
            else:
                rec.t_sender_cqe = done
            if rec.t_sender_cqe > end:
                end = rec.t_sender_cqe
        return end

    def _finalize(self, staged, post, flows, t0: float) -> float:
        end = self._backfill(staged, flows, t0)
        self._fin_staged = staged               # fairness-snapshot scope
        for fin in post:                        # composite records
            end = max(end, fin(t0))
        self._fin_staged = None
        return end

    def run(self, timeout: float = 30.0) -> float:
        if not self._staged and not self._post:
            return self.now
        sim = self._sim                          # reuse routing + caps
        sim.flows, sim.now = [], 0.0             # fresh batch, epoch-local t
        flows = sim.add_many((links, volume, loss)
                             for links, volume, _, _, _, loss, _
                             in self._staged)
        sim.run()
        self._solve_segments([self._staged])
        self.now = max(self.now, self._finalize(self._staged, self._post,
                                                flows, self.now))
        self._staged, self._post = [], []
        self._clear_dynamics()
        return self.now

    def run_many(self, scenarios: Sequence[Callable], timeout: float = 30.0,
                 workers: Optional[int] = None) -> List[float]:
        """Batched scenarios: every scenario is an isolated fabric (no
        cross-scenario bandwidth sharing) whose clock starts at the
        engine's current ``now``.  On the torch solver the whole batch is
        one batched solve (``solve_many``); the numpy solver falls back
        to per-scenario solves.  ``workers`` is accepted for contract
        uniformity and ignored — the batched solve already exploits all
        device parallelism.  Returns per-scenario end times; the engine
        clock advances to the latest one."""
        if self._staged or self._post:
            raise RuntimeError("pending staged ops; run() them first or "
                               "stage them inside a scenario")
        sim = self._sim
        t0 = self.now
        metas = []
        for stage in scenarios:
            stage(self)
            metas.append((self._staged, self._post))
            self._staged, self._post = [], []
        sim.flows, sim.now = [], 0.0
        epoch_flows = [sim.add_many((links, volume, loss)
                                    for links, volume, _, _, _, loss, _
                                    in staged)
                       for staged, _ in metas]
        if hasattr(sim, "solve_many"):           # batched lanes (torch)
            sim.solve_many(epoch_flows)
        else:                                    # numpy: epoch-serial
            for flows in epoch_flows:
                sim.flows, sim.now = flows, 0.0
                sim.run()
        self._solve_segments([staged for staged, _ in metas])
        ends = [self._finalize(staged, post, flows, t0)
                for (staged, post), flows in zip(metas, epoch_flows)]
        self.now = max([self.now] + ends)
        self._clear_dynamics()
        return ends


# ================================================================= factory

def make_engine(name: str, topo: Topology, **kw):
    """Build an engine by name (see ENGINE_CHOICES).

    ``packet`` builds a ``PacketEngine``, which forwards its kwargs to
    ``GleamNetwork``/``PacketSim`` (``loss_rate``, ``seed``, ``p4_mode``,
    ``ecn_backlog``, plus ``group_kw`` / ``relay_kw`` /
    ``staging_cache``) and takes no ``device``.  ``flow`` solves on
    ``TorchFlowSim`` (``device`` kwarg, default ``"cuda"``: raises without
    a card); ``flow-np`` on the numpy ``FlowSim``.  The flow engines take
    the same ``loss_rate`` / ``ecn_backlog`` / ``seed`` / ``group_kw`` /
    ``relay_kw`` / ``staging_cache`` slice plus ``segment_solver``, so one
    kwargs dict drives a packet-vs-flow comparison.  Unknown names raise
    ValueError listing the valid ones.
    """
    if name == "packet":
        if "device" in kw:
            raise TypeError("the packet engine runs on the host; it takes "
                            "no device")
        return PacketEngine(topo, **kw)
    if name == "flow":
        return FlowEngine(topo, backend="torch", **kw)
    if name == "flow-np":
        if "device" in kw:
            raise TypeError("flow-np runs on the host; it takes no device")
        return FlowEngine(topo, backend="np", **kw)
    raise ValueError(f"unknown engine {name!r}; choose from {ENGINE_CHOICES}")
