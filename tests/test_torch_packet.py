"""The port's packet engine against the reference, bit for bit.

``repro_torch.core``'s packet layer (``packet``, ``ftable``, ``endpoint``,
``switch``, ``packetsim``, ``gleam``, ``baselines`` and ``PacketEngine``
in ``engine``) is a copy of the reference's.  Every scenario here runs
once on each package, both fed the same fabric (built by the
reference's ``fattree`` and carried over by
``convert.topology_from_reference``) and the same ops (carried over by
``convert.workload_from_reference`` at the engine level), and the two
results must be exactly equal (rtol 0): every record field (``msg_id``,
``t_submit``, ``t_sender_cqe``, ``t_deliver``, ``error``), every counter
(``events``, ``dropped``, ``tx_bytes``, ``retransmitted``, per-scenario
``last_run_stats``) and the fabric's state (every QP, switch counter and
forwarding table).

The scenarios are those of ``tests/test_protocol.py``,
``test_ftable.py``, ``test_membership.py``, ``test_faults.py`` and the
packet cases of ``test_engines.py``, the reference's own assertions
left to those files.  The re-election schedule that fails the
reference's ``test_reelection_converges_for_any_crash_schedule`` is
compared here, not asserted to converge (the fault is the reference's,
and the port inherits it).
"""
from __future__ import annotations

import dataclasses
import random
import types

import pytest

from repro.core import baselines as ref_baselines
from repro.core import engine as ref_engine
from repro.core import fattree as ref_fattree
from repro.core import ftable as ref_ftable
from repro.core import gleam as ref_gleam
from repro.core import packet as ref_packet
from repro.core import switch as ref_switch
from repro.core import workload as ref_workload
from repro_torch.convert import topology_from_reference, \
    workload_from_reference
from repro_torch.core import baselines as port_baselines
from repro_torch.core import engine as port_engine
from repro_torch.core import fattree as port_fattree
from repro_torch.core import ftable as port_ftable
from repro_torch.core import gleam as port_gleam
from repro_torch.core import packet as port_packet
from repro_torch.core import switch as port_switch
from repro_torch.core import workload as port_workload

REF = types.SimpleNamespace(
    baselines=ref_baselines, engine=ref_engine, fattree=ref_fattree,
    ftable=ref_ftable, gleam=ref_gleam, packet=ref_packet,
    switch=ref_switch, workload=ref_workload,
    topo=lambda t: t, ops=lambda ops: list(ops))
PORT = types.SimpleNamespace(
    baselines=port_baselines, engine=port_engine, fattree=port_fattree,
    ftable=port_ftable, gleam=port_gleam, packet=port_packet,
    switch=port_switch, workload=port_workload,
    topo=topology_from_reference,
    ops=lambda ops: workload_from_reference(
        ref_workload.Workload("t", list(ops))).ops)

GroupOp, MemberEvent, FaultEvent = (ref_workload.GroupOp,
                                    ref_workload.MemberEvent,
                                    ref_workload.FaultEvent)
MEMBERS = ["h0", "h1", "h2", "h3"]
MEMBERS8 = [f"h{i}" for i in range(8)]
AT = 3e-5


# ============================================================ snapshots

QP_FIELDS = ("qpn", "ip", "dst_ip", "dst_qpn", "alive", "error", "retries",
             "max_retries", "window", "sq_psn", "snd_una", "snd_nxt",
             "rq_psn", "retransmitted", "delivered_bytes", "mr_violations",
             "next_emit_t", "timer_deadline", "last_cnp_t")
PKT_FIELDS = tuple(f for f in ref_packet.Packet.__slots__ if f != "uid")


def qp_state(qp):
    return tuple(getattr(qp, f) for f in QP_FIELDS) + (
        qp.rate.rate, qp.rate.alpha, sorted(qp.mrs.items()))


def table_state(t):
    return (t.group_ip, t.last_ack_psn, t.ack_out_port, t.master_ip,
            t.nack_epsn, t.psn_window, t.table_bytes(),
            list(t.cnp_count.items()), list(t.port_refs.items()),
            list(t.member_port.items()),
            [dataclasses.astuple(e) for e in t.entries.values()])


def tables_state(ft):
    return (ft.window, ft.capacity, ft.evictions, ft.salvages,
            ft.total_bytes(), [table_state(t) for t in ft.tables.values()])


def fabric_state(sim):
    """The simulator's clock and counters, every host's QPs and every
    switch's counters and forwarding tables, in their dicts' order."""
    return (sim.now, sim.events, sim.dropped, sim.fault_dropped,
            sim.tx_bytes,
            [(n, h.no_qp_drops, h.dead_drops, h.dark,
              [(k, qp_state(q)) for k, q in h.qps.items()])
             for n, h in sim.hosts.items()],
            [(n, dataclasses.astuple(sw.stats), list(sw.port_util.items()),
              tables_state(sw.tables))
             for n, sw in sim.switches.items()])


def record(r):
    return (r.msg_id, r.t_submit, r.t_sender_cqe, sorted(r.t_deliver.items()),
            r.error)


def packets(out):
    return [(port, tuple(getattr(p, f) for f in PKT_FIELDS))
            for port, p in out]


def group_state(g):
    return (g.state, g.source, g.master, list(g.members), g.group_ip,
            [(r.kind, r.member, r.t_request, r.t_done)
             for r in g.events_log])


SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def net(m, topo=None, **kw):
    return m.gleam.GleamNetwork(m.topo(topo or ref_fattree.testbed()), **kw)


def registered(m, members=MEMBERS, topo=None, **kw):
    n = net(m, topo, **kw)
    g = n.multicast_group(list(members))
    g.register()
    return n, g


def bcast_state(m, nbytes, *, members=MEMBERS, topo=None, write=False,
                timeout=30.0, **kw):
    n, g = registered(m, members, topo, **kw)
    rec = g.write(nbytes) if write else g.bcast(nbytes)
    jct = g.run_until_delivered(rec, timeout=timeout)
    return jct, record(rec), fabric_state(n.sim)


# ====================================================== test_protocol.py

@scenario
def registration_testbed(m):
    n = net(m)
    g = n.multicast_group(MEMBERS)
    return g.register(), group_state(g), fabric_state(n.sim)


@scenario
def registration_fig4_tree(m):
    n = net(m, ref_fattree.fig4())
    g = n.multicast_group(MEMBERS)
    return g.register(), group_state(g), fabric_state(n.sim)


@scenario
def envelope_over_200_members(m):
    n = net(m, ref_fattree.testbed(n_hosts=200))
    g = n.multicast_group([f"h{i}" for i in range(200)])
    return g.register(), fabric_state(n.sim)


@scenario
def bcast_1mib(m):
    return bcast_state(m, 1 << 20)


@scenario
def bcast_64kib_fig4(m):
    return bcast_state(m, 64 << 10, topo=ref_fattree.fig4())


@scenario
def bcast_without_rewrite_drops(m):
    n, g = registered(m)
    for e in n.sim.switches["SW0"].tables.get(g.group_ip).entries.values():
        e.type = m.ftable.FORWARDED
    rec = g.bcast(16 << 10)
    n.sim.run(until=n.sim.now + 0.05)
    return record(rec), fabric_state(n.sim)


@pytest.fixture(params=["MultiUnicastBcast", "RingBcast", "BinaryTreeBcast"])
def relay(request):
    return request.param


def relay_state(m, cls, nbytes, **kw):
    n = net(m)
    b = getattr(m.baselines, cls)(n, MEMBERS, **kw)
    b.start(nbytes)
    return b.run(), sorted(b.t_deliver.items()), fabric_state(n.sim)


@scenario
def write_256kib(m):
    return bcast_state(m, 256 << 10, write=True)


@scenario
def write_same_mr_appendix_c(m):
    n, g = registered(m)
    rkey0 = next(iter(g.qps["h0"].mrs.keys()))
    va0 = g.qps["h0"].mrs[rkey0][0]
    for h in ("h1", "h2", "h3"):
        g.qps[h].register_mr(rkey0, va0, 1 << 30)
    for e in n.sim.switches["SW0"].tables.get(g.group_ip).entries.values():
        e.va, e.rkey = va0, rkey0
    rec = g.write(64 << 10, same_mr=True)
    return g.run_until_delivered(rec), record(rec), fabric_state(n.sim)


@scenario
def loss_recovery_1e3(m):
    return bcast_state(m, 2 << 20, loss_rate=1e-3, seed=7, timeout=10.0)


@scenario
def loss_goodput_1e4(m):
    return bcast_state(m, 4 << 20, loss_rate=1e-4, seed=3)


def switch_unit(m):
    topo = m.topo(ref_fattree.testbed())
    hosts = m.fattree.host_ip_map(topo)
    sw = m.switch.GleamSwitch("SW0", topo, hosts)
    t = sw.tables.create(group_ip=999)
    for port, h in enumerate(("h0", "h1", "h2")):
        t.add_connected(port, dest_ip=hosts[h], dest_qpn=17 + port)
    t.ack_out_port = 0
    return sw, hosts


@scenario
def nack_filtering_fig7(m):
    sw, hosts = switch_unit(m)
    pk = m.packet
    out = [sw.on_packet(pk.ack_packet(hosts["h1"], 999, 0), 1, 0.0),
           sw.on_packet(pk.ack_packet(hosts["h2"], 999, 1), 2, 0.0),
           sw.on_packet(pk.nack_packet(hosts["h2"], 999, 2), 2, 0.0),
           sw.on_packet(pk.nack_packet(hosts["h1"], 999, 1), 1, 0.0)]
    return [packets(o) for o in out], tables_state(sw.tables)


@scenario
def ack_aggregation_is_min(m):
    sw, hosts = switch_unit(m)
    pk = m.packet
    out = [sw.on_packet(pk.ack_packet(hosts["h1"], 999, 5), 1, 0.0),
           sw.on_packet(pk.ack_packet(hosts["h2"], 999, 3), 2, 0.0)]
    return [packets(o) for o in out], tables_state(sw.tables)


@scenario
def cnp_filtering_hot_port(m):
    sw, hosts = switch_unit(m)
    pk = m.packet
    out, now = [], 0.0
    for h, port in (("h1", 1), ("h1", 1), ("h1", 1), ("h2", 2)):
        now += 1e-6
        out.append(sw.on_packet(pk.cnp_packet(hosts[h], 999), port, now))
    return [packets(o) for o in out], tables_state(sw.tables), \
        dataclasses.astuple(sw.stats)


@scenario
def source_switching_and_psn_sync(m):
    n, g = registered(m)
    rec0 = g.bcast(128 << 10)
    g.run_until_delivered(rec0)
    g.switch_source("h1")
    rec1 = g.bcast(128 << 10)
    jct = g.run_until_delivered(rec1)
    return jct, record(rec0), record(rec1), group_state(g), \
        fabric_state(n.sim)


@scenario
def cc_slows_sender(m):
    return bcast_state(m, 2 << 20, ecn_backlog=20e-6)


@scenario
def dcqcn_incast_with_multicast(m):
    """Three unicasts into h0 beside a group that h0 belongs to: ECN
    marks, CNPs, DCQCN cuts and recovery on the senders."""
    return engine_state(m, ref_fattree.testbed(n_hosts=6), [
        GroupOp("unicast", (s, "h0"), 1 << 20) for s in ("h1", "h2", "h3")
    ] + [GroupOp("bcast", ("h4", "h0", "h5"), 1 << 20)], ecn_backlog=5e-6)


@scenario
def p4_mode_bcast(m):
    return bcast_state(m, 1 << 20, p4_mode=True)


# ======================================================== test_ftable.py

@scenario
def ftable_group_table_ops(m):
    ft = m.ftable
    t = ft.GroupTable(group_ip=7)
    t.add_connected(3, dest_ip=42, dest_qpn=17, va=0x1000, rkey=0x9)
    t.add_connected(1, dest_ip=5, dest_qpn=20)
    t.add_forwarded(1)
    t.add_forwarded(4)
    t.entries[3].ack_psn, t.entries[1].ack_psn = 10, 4
    mins = [t.min_ack()]
    t.last_ack_psn = 99
    t.retarget(3, dest_ip=77, dest_qpn=23, va=0x2000, rkey=0xA)
    t.cnp_count[4] = 5.0
    mins.append(t.min_ack())
    removed = [t.remove_port(4) is not None, t.remove_port(4) is None]
    t.add_forwarded(5)
    with pytest.raises(ValueError, match="not a connected"):
        t.retarget(5, 1, 2)
    return mins, removed, table_state(t), t.table_bytes()


@scenario
def ftable_store_lru(m):
    out = []
    for kw in ({"capacity": 2}, {"p4_mode": True}, {}):
        fts = m.ftable.ForwardingTables(**kw)
        fts.create(1)
        fts.create(2)
        fts.get(1)
        fts.create(3)
        fts.create(3)
        out.append((fts.get(2) is None, tables_state(fts)))
        out.append((fts.remove(1) is not None, fts.remove(1) is None,
                    tables_state(fts)))
    return out


@scenario
def ftable_1k_groups_churn(m):
    fts = m.ftable.ForwardingTables()
    for g in range(1000):
        t = fts.create(g)
        for p in range(32):
            t.add_connected(p, dest_ip=100 + p, dest_qpn=16 + p)
    sizes = [fts.total_bytes()]
    for g in range(1000):
        for p in range(0, 32, 2):
            fts.get(g).remove_port(p)
    sizes.append(fts.total_bytes())
    for g in range(1000):
        for p in range(0, 32, 2):
            fts.get(g).add_connected(p, dest_ip=100 + p, dest_qpn=16 + p)
    sizes.append(fts.total_bytes())
    state = tables_state(fts)
    for g in range(1000):
        fts.remove(g)
    return sizes, state, fts.total_bytes()


@scenario
def ftable_mid_stream_salvage(m):
    out = []
    for mid_stream, deregister in ((True, False), (False, False),
                                   (True, True)):
        fts = m.ftable.ForwardingTables(capacity=1)
        t = fts.create(1)
        if mid_stream:
            t.ack_out_port = 0
        t.last_ack_psn = 1234
        fts.create(2)
        if deregister:
            fts.remove(1)
        t1b = fts.create(1)
        t1b.add_connected(3, dest_ip=9, dest_qpn=17)
        t1b.add_forwarded(4)
        out.append(tables_state(fts))
    return out


@scenario
def switch_capacity_evicts_oldest(m):
    n = net(m)
    sw = n.sim.switches["SW0"]
    sw.tables.capacity = 1
    g1 = n.multicast_group(["h0", "h1", "h2"])
    g1.register()
    g2 = n.multicast_group(["h0", "h2", "h3"])
    g2.register()
    before = fabric_state(n.sim)
    sw.tables.remove(g2.group_ip)
    return before, list(sw.port_util.items())


@scenario
def eviction_during_live_bcast(m):
    n = net(m, ref_fattree.testbed(n_hosts=6))
    g = n.multicast_group(MEMBERS)
    g.register()
    sim, sw = n.sim, n.sim.switches["SW0"]
    rec = g.bcast(1 << 17, now=0.0)

    def squeeze(now):
        sw.tables.capacity = 1
        sw.tables.create(9999)
        g.reinstall(now=now)

    sim.schedule(3e-6, squeeze)
    sim.run(until=0.1)
    return record(rec), fabric_state(sim)


# ==================================================== test_membership.py

def fresh(m, n=4, spares=2, **kw):
    nt = net(m, ref_fattree.testbed(n_hosts=n + spares), **kw)
    return nt, nt.multicast_group([f"h{i}" for i in range(n)])


@scenario
def membership_lifecycle(m):
    n, g = fresh(m)
    g.register(run=False)
    states = [g.state]
    n.sim.run(until=1.0)
    rec = g.join("h4")
    states.append(g.state)
    g._run_until_op(rec)
    g.leave("h4", run=True)
    g.join("h5", run=True)
    states.append(g.state)
    snap = fabric_state(n.sim)
    g.close()
    return states, group_state(g), snap, fabric_state(n.sim)


@scenario
def join_mid_stream(m):
    n, g = fresh(m)
    g.register()
    warm = g.bcast(64 << 10)
    g.run_until_delivered(warm)
    rec = g.bcast(1 << 20)
    n.sim.run(until=n.sim.now + 20e-6)
    g.join("h4")
    jct = g.run_until_delivered(rec)
    return jct, record(rec), group_state(g), fabric_state(n.sim)


@scenario
def leave_of_straggler_unwedges(m):
    n, g = fresh(m)
    g.register()
    rec = g.bcast(1 << 20)
    n.sim.run(until=n.sim.now + 10e-6)
    g.qps["h3"].deactivate()
    n.sim.run(until=n.sim.now + 100e-6)
    g.leave("h3")
    g.run_until_delivered(rec, timeout=5.0)
    return record(rec), group_state(g), fabric_state(n.sim)


@scenario
def fail_recovery_detection_bound(m):
    n, g = fresh(m)
    g.register()
    rec = g.bcast(4 << 20)
    n.sim.run(until=n.sim.now + 20e-6)
    g.fail("h3")
    jct = g.run_until_delivered(rec, timeout=10.0)
    return jct, record(rec), group_state(g), fabric_state(n.sim)


@scenario
def master_handover_and_new_master_ops(m):
    n, g = fresh(m)
    g.register()
    g.run_until_delivered(g.bcast(128 << 10))
    g.master_switch("h2")
    rec = g.bcast(128 << 10)
    g.run_until_delivered(rec)
    g.leave("h3", run=True)
    g.join("h4", run=True)
    rec2 = g.bcast(128 << 10)
    g.run_until_delivered(rec2)
    return record(rec), record(rec2), group_state(g), fabric_state(n.sim)


@scenario
def handover_then_leave_and_fail_fig4(m):
    out = []
    for then in ("leave", "fail"):
        n = net(m, ref_fattree.fig4())
        g = n.multicast_group(["h0", "h1", "h2"])
        g.register()
        g.master_switch("h1")
        if then == "leave":
            g.leave("h2", run=True)
            rec = g.bcast(256 << 10)
            g.run_until_delivered(rec)
        else:
            rec = g.bcast(2 << 20)
            n.sim.run(until=n.sim.now + 20e-6)
            g.fail("h2")
            g.run_until_delivered(rec, timeout=10.0)
        out.append((record(rec), group_state(g), fabric_state(n.sim)))
    return out


@scenario
def rejoin_within_detection_window(m):
    n, g = fresh(m)
    g.register()
    g.fail("h3")
    n.sim.run(until=n.sim.now + 100e-6)
    g.join("h3", run=True)
    n.sim.run(until=n.sim.now + 2 * g.fail_detect)
    rec = g.bcast(256 << 10)
    g.run_until_delivered(rec)
    return record(rec), group_state(g), fabric_state(n.sim)


@scenario
def whole_group_teardown(m):
    n, g = fresh(m, n=3)
    g.register()
    g.leave("h2", run=True)
    g.leave("h1", run=True)
    g.close()
    return group_state(g), fabric_state(n.sim)


def engine_state(m, topo, ops, *, timeout=60.0, **kw):
    eng = m.engine.make_engine("packet", m.topo(topo), **kw)
    recs = [eng.stage(op) for op in m.ops(ops)]
    eng.run(timeout=timeout)
    return [record(r) for r in recs], fabric_state(eng.net.sim)


DYNAMIC = {
    "join": (MemberEvent("join", "h8", 30e-6),),
    "leave": (MemberEvent("leave", "h7", 30e-6),),
    "fail": (MemberEvent("fail", "h7", 30e-6),),
    "mix": (MemberEvent("master-switch", "h1", 10e-6),
            MemberEvent("leave", "h6", 20e-6),
            MemberEvent("join", "h8", 40e-6),
            MemberEvent("fail", "h5", 60e-6)),
}


@pytest.fixture(params=sorted(DYNAMIC))
def dynamic(request):
    return request.param


@scenario
def dynamic_on_multihop_topology(m):
    return engine_state(m, ref_fattree.fig4(), [GroupOp(
        "bcast", ("h0", "h1", "h2"), 2 << 20,
        events=(MemberEvent("join", "h3", 20e-6),
                MemberEvent("fail", "h2", 50e-6)))])


@scenario
def overlapping_dynamic_ops(m):
    return engine_state(m, ref_fattree.testbed(n_hosts=5), [
        GroupOp("bcast", ("h0", "h1", "h2"), 1 << 20,
                events=(MemberEvent("leave", "h2", 30e-6),)),
        GroupOp("bcast", ("h3", "h1", "h4"), 1 << 20,
                events=(MemberEvent("leave", "h1", 30e-6),))],
        group_kw={"window": 32})


@scenario
def churn_under_loss(m):
    return engine_state(m, ref_fattree.testbed(n_hosts=10),
                        [GroupOp("bcast", tuple(MEMBERS8), 1 << 20,
                                 events=DYNAMIC["mix"])],
                        loss_rate=1e-3, seed=5)


def churn_trace(m, base, events):
    """``_membership_props.run_churn_case``'s replay, recording the
    cached aggregate and the emitted ACK stream at every step."""
    pk = m.packet
    topo = m.topo(ref_fattree.testbed(n_hosts=8))
    sw = m.switch.GleamSwitch("SW0", topo, m.fattree.host_ip_map(topo))
    t = sw.tables.create(group_ip=4242)
    t.last_ack_psn = pk.psn_sub(base, 1)
    t.add_connected(0, dest_ip=1, dest_qpn=16)
    t.ack_out_port = 0
    for port in (1, 2, 3):
        t.add_connected(port, dest_ip=port + 1, dest_qpn=16 + port)
    trace = []
    for kind, port, delta in events:
        if kind == "ack" and port in t.entries:
            out = sw.on_packet(pk.ack_packet(port + 1, 4242,
                                             pk.psn_add(base, delta)),
                               port, 0.0)
        elif kind == "add" and port not in t.entries:
            t.add_connected(port, dest_ip=port + 1, dest_qpn=16 + port)
            out = []
        elif kind == "remove" and port in t.entries and len(t.entries) > 2:
            t.remove_port(port)
            out = sw._generate(t, 0.0)
        else:
            continue
        trace.append((t.agg_min, packets(out)))
    return trace, table_state(t)


@scenario
def agg_min_under_churn_fuzz(m):
    rng = random.Random(0x61EA)
    out = []
    for _ in range(60):
        base = rng.choice([rng.randrange(ref_packet.PSN_MOD),
                           ref_packet.PSN_MOD - rng.randrange(1, 200),
                           rng.randrange(200)])
        events = [(rng.choice(["ack", "ack", "ack", "add", "remove"]),
                   rng.randrange(1, 7), rng.randrange(301))
                  for _ in range(rng.randrange(1, 80))]
        out.append(churn_trace(m, base, events))
    return out


# ======================================================== test_faults.py

FAULTS = {
    "link_down": (FaultEvent("link_down", AT, node="L4", peer="S3"),),
    "link_flap": (FaultEvent("link_flap", AT, node="L4", peer="S3",
                             duration=2e-5),),
    "switch_fail": (FaultEvent("switch_fail", AT, node="S3"),),
    "host_gone_dark": (FaultEvent("host_gone_dark", AT, node="h3"),),
    "master_crash": (FaultEvent("master_crash", AT),),
}


@pytest.fixture(params=sorted(FAULTS))
def fault(request):
    return request.param


def fault_state(m, faults=(), transport="gleam", events=()):
    eng = m.engine.make_engine("packet", m.topo(ref_fattree.fig4()), seed=7)
    rec = eng.stage(m.ops([GroupOp("bcast", tuple(MEMBERS), 1 << 17,
                                   transport=transport, faults=faults,
                                   events=events)])[0])
    eng.run(timeout=60.0)
    qps = [(g.group_ip, [(h, q.max_retries) for h, q in g.qps.items()])
           for g in eng.net.groups_by_ip.values()]
    return record(rec), qps, sorted(eng.net.topo._down), \
        fabric_state(eng.net.sim)


@scenario
def clean_fig4_bcast(m):
    return fault_state(m)


@scenario
def overlay_relay_dark_resplices(m):
    return fault_state(m, (FaultEvent("host_gone_dark", AT, node="h2"),),
                       transport="ring")


@pytest.fixture(params=["ring", "binary-tree", "multiunicast"])
def overlay(request):
    return request.param


def reelection_state(m, offsets, nbytes=1 << 17):
    """``_fault_props.run_reelection_case`` without its assertions."""
    n = net(m, ref_fattree.fig4())
    g = n.multicast_group(MEMBERS, max_retries=7)
    g.register()
    rec = g.bcast(nbytes, now=0.0)
    for at in offsets:
        n.sim.schedule(at, lambda now: g.master_crash(now=now))
    n.sim.run(until=max(offsets) + 0.05)
    out = (record(rec), group_state(g), fabric_state(n.sim))
    g.close()
    return out, fabric_state(n.sim)


@scenario
def reelection_single_crash(m):
    return reelection_state(m, [AT])


@scenario
def reelection_double_crash(m):
    return reelection_state(m, [AT, 1.2e-3], nbytes=1 << 22)


@scenario
def reelection_after_completion(m):
    return reelection_state(m, [5e-4], nbytes=1 << 14)


@scenario
def reelection_schedule_of_the_known_fault(m):
    """ROADMAP queue 3: the reference fails to converge at this
    schedule (first=0.001418036272251779, gap=0.0); the port must fail
    the same way, so only the two runs are compared."""
    first = 0.001418036272251779
    return reelection_state(m, [first, first + ref_gleam.DEFAULT_FAIL_DETECT
                                + 1e-4 + 0.0], nbytes=1 << 16)


def bounded_retry_state(m, cap, sever_at, nbytes=1 << 17):
    """``_fault_props.run_bounded_retry_case`` without its assertions."""
    n = net(m, ref_fattree.fig4())
    g = n.multicast_group(MEMBERS, max_retries=cap)
    g.register()
    sim = n.sim
    rec = g.bcast(nbytes, now=0.0)
    leaf = n.topo.ports["h0"][0][0]

    def sever(now):
        for p in sorted(n.topo.ports[leaf]):
            peer = n.topo.ports[leaf][p][0]
            if not peer.startswith("h"):
                sim.link_down(leaf, peer)

    sim.schedule(sever_at, sever)
    sim.run(until=sever_at + 2.0)
    first = (record(rec), fabric_state(sim))
    sim.run(until=sim.now + 1.0)
    return first, fabric_state(sim)


@pytest.fixture(params=[(2, AT), (0, AT), (3, 1.0)],
                ids=["cap2", "cap0", "after_completion"])
def retry(request):
    return request.param


# ======================================================= test_engines.py

@pytest.fixture(params=[64 << 10, 1 << 20, 8 << 20])
def testbed_nbytes(request):
    return request.param


def two_pod_fat_tree():
    return ref_fattree.fat_tree(n_pods=2, leaves_per_pod=2, hosts_per_leaf=2,
                                aggs_per_pod=2, bw=100 * ref_fattree.GBPS)


@scenario
def two_pod_fat_tree_bcast(m):
    topo = two_pod_fat_tree()
    return [engine_state(m, topo, [GroupOp("bcast", tuple(topo.hosts),
                                           nbytes)])
            for nbytes in (256 << 10, 4 << 20)]


@scenario
def concurrent_groups_share_fabric(m):
    return engine_state(m, ref_fattree.testbed(n_hosts=5), [
        GroupOp("bcast", ("h0", "h1", "h2"), 1 << 20),
        GroupOp("bcast", ("h0", "h3", "h4"), 1 << 20)])


@scenario
def unicast_and_write(m):
    return engine_state(m, ref_fattree.testbed(), [
        GroupOp("unicast", ("h0", "h1"), 256 << 10),
        GroupOp("write", tuple(MEMBERS), 256 << 10)])


@scenario
def source_rotation(m):
    """Two epochs on one engine: the second rotates the source."""
    eng = m.engine.make_engine("packet", m.topo(ref_fattree.testbed()))
    recs = []
    for source in (None, "h2"):
        recs.append(eng.stage(m.ops([GroupOp("bcast", tuple(MEMBERS),
                                             64 << 10, source=source)])[0]))
        eng.run()
    return [record(r) for r in recs], len(eng._groups), \
        fabric_state(eng.net.sim)


# ================================================================ tests

@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(name):
    assert SCENARIOS[name](PORT) == SCENARIOS[name](REF)


def test_relay_bcast_matches_reference(relay):
    kw = {} if relay == "MultiUnicastBcast" else {"chunks": 8}
    assert relay_state(PORT, relay, 1 << 20, **kw) == \
        relay_state(REF, relay, 1 << 20, **kw)


def test_testbed_bcast_matches_reference(testbed_nbytes):
    ops = [GroupOp("bcast", tuple(MEMBERS), testbed_nbytes)]
    assert engine_state(PORT, ref_fattree.testbed(), ops) == \
        engine_state(REF, ref_fattree.testbed(), ops)


def test_dynamic_op_matches_reference(dynamic):
    ops = [GroupOp("bcast", tuple(MEMBERS8), 1 << 20,
                   events=DYNAMIC[dynamic])]
    topo = ref_fattree.testbed(n_hosts=10)
    assert engine_state(PORT, topo, ops) == engine_state(REF, topo, ops)


def test_fault_class_matches_reference(fault):
    assert fault_state(PORT, FAULTS[fault]) == fault_state(REF, FAULTS[fault])


def test_overlay_graceful_leave_matches_reference(overlay):
    events = (MemberEvent("leave", "h2", AT),)
    assert fault_state(PORT, transport=overlay, events=events) == \
        fault_state(REF, transport=overlay, events=events)


def test_bounded_retry_matches_reference(retry):
    assert bounded_retry_state(PORT, *retry) == \
        bounded_retry_state(REF, *retry)


def test_psn_arithmetic_matches_reference():
    vals = [0, 1, 5, 1 << 22, (1 << 23) - 1, 1 << 23, ref_packet.PSN_MOD - 10,
            ref_packet.PSN_MOD - 1]
    for name in ("psn_add", "psn_sub", "psn_geq", "psn_gt", "psn_max",
                 "psn_min"):
        for window in ((), (ref_packet.PSN_WINDOW_P4,)):
            if name in ("psn_add", "psn_sub") and window:
                continue
            got = [getattr(port_packet, name)(a, b, *window)
                   for a in vals for b in vals]
            want = [getattr(ref_packet, name)(a, b, *window)
                    for a in vals for b in vals]
            assert got == want, name
    for c in ("MTU", "HDR", "ACK_SIZE", "PSN_MOD", "PSN_WINDOW",
              "PSN_WINDOW_P4"):
        assert getattr(port_packet, c) == getattr(ref_packet, c), c


# ========================================== run_many: serial vs workers

def dynamic_batch(m, workers):
    """``test_membership``'s run_many batch: four dynamic scenarios on
    one lossy fabric."""
    evsets = [(), (MemberEvent("leave", "h5", 10e-6),),
              (MemberEvent("fail", "h4", 15e-6),),
              (MemberEvent("join", "h7", 12e-6),)]
    eng = m.engine.make_engine("packet",
                               m.topo(ref_fattree.testbed(n_hosts=9)),
                               loss_rate=1e-4, seed=7)
    recs = []

    def scen(evs):
        op = m.ops([GroupOp("bcast", tuple(MEMBERS8[:6]), 1 << 19,
                            events=evs)])[0]
        return lambda e: recs.append(e.stage(op))

    ends = eng.run_many([scen(e) for e in evsets], timeout=60.0,
                        workers=workers)
    return ends, [record(r) for r in recs], eng.last_run_stats


def fault_batch(m, workers):
    """``test_faults``'s run_many batch: clean, master crash, host dark."""
    eng = m.engine.make_engine("packet", m.topo(ref_fattree.fig4()), seed=7)
    ops = m.ops([GroupOp("bcast", tuple(MEMBERS), 1 << 17, faults=f)
                 for f in ((), FAULTS["master_crash"],
                           FAULTS["host_gone_dark"])])
    recs = []
    ends = eng.run_many([lambda e, op=op: recs.append(e.stage(op))
                         for op in ops], timeout=60.0, workers=workers)
    return ends, [record(r) for r in recs], eng.last_run_stats


def shared_group_batch(m, workers):
    """Four lossy scenarios of one bcast on one group: its message ids
    count on across the scenarios of a process, so a forked run's ids
    restart per worker (the reference's behaviour, copied)."""
    eng = m.engine.make_engine("packet", m.topo(ref_fattree.testbed(
        n_hosts=8)), loss_rate=1e-3, seed=11, group_kw={"window": 64})
    op = m.ops([GroupOp("bcast", tuple(MEMBERS8), 1 << 18)])[0]
    recs = []
    ends = eng.run_many([lambda e: recs.append(e.stage(op))] * 4,
                        timeout=60.0, workers=workers)
    return ends, [record(r) for r in recs], eng.last_run_stats


@pytest.mark.parametrize("batch", [dynamic_batch, fault_batch],
                         ids=["dynamic", "faults"])
def test_run_many_serial_and_workers_match_reference(batch):
    serial = batch(PORT, None)
    assert serial == batch(REF, None)
    assert batch(PORT, 2) == serial


def test_run_many_on_a_shared_group_matches_reference():
    serial, forked = shared_group_batch(PORT, None), \
        shared_group_batch(PORT, 2)
    assert serial == shared_group_batch(REF, None)
    assert forked == shared_group_batch(REF, 2)
    # only the message ids tell the two runs apart
    strip = [[rec[1:] for rec in run[1]] for run in (serial, forked)]
    assert strip[0] == strip[1] and serial[2] == forked[2]
    assert [rec[0] for rec in forked[1]] == [0, 0, 1, 1]
