"""Multi-tenant fleet sweep: N tenants share one fabric.

The fleet-scale sweep plane's workload half: a seeded builder that
declares N tenants' multicast groups (overlapping member sets — the
whole point of fabric sharing is that trees collide on links and MFT
slots) plus background unicast mesh / incast traffic, all as ONE
contended ``Workload``.  Per-tenant SLO metrics come from the op
records (the tenants' ops carry ``phase="tenant-XX"`` tags, background
flows ``"bg-*"``), and connection-state accounting reports what the
sharing costs in fabric state:

- **QP census** (per NIC): the packet engine counts live QPs on every
  host; the flow engines mirror the packet engine's connection reuse
  rules analytically (one multicast QP per member per DISTINCT member
  tuple, one RC pair per DISTINCT unicast (src, dst) channel) — the
  two censuses must agree exactly (tests/test_fleet.py).
- **MFT census** (per switch): the packet engine reads the real
  forwarding tables (occupancy, byte size, LRU evictions/salvages —
  ``core/ftable.py``); the flow engines derive occupancy from their
  staged multicast trees.  Exact per-switch equality is NOT promised:
  the packet control plane floods MFT state along simulated envelope
  paths, the fluid engine derives trees geometrically — the aggregate
  entry counts are comparable, the per-switch split can differ.

``run_fleet`` drives either engine and returns one plain-dict report
(benchmarks/fig_fleet.py and tools/check_fleet.py consume it).

The port's own copy of the reference ``apps/fleet.py``: the port imports
nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence

from repro_torch.apps import metrics as appm
from repro_torch.core import ftable
from repro_torch.core.engine import FlowEngine, make_engine
from repro_torch.core.workload import Workload, get_transport

__all__ = ["FleetSpec", "fleet_workload", "tenant_quantiles",
           "connection_census", "mft_pressure_report", "run_fleet"]


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """Seeded description of one multi-tenant scenario (plain data, so
    a sweep point is replayable from its spec alone)."""

    n_tenants: int = 4
    groups_per_tenant: int = 4
    group_size: int = 8
    nbytes: int = 1 << 20               # per multicast message
    transport: str = "gleam"
    bg_unicasts: int = 12               # background mesh RC flows
    bg_incasts: int = 2                 # background fan-ins
    bg_fan_in: int = 4                  # senders per incast
    bg_nbytes: int = 2 << 20
    seed: int = 0

    def __post_init__(self):
        if self.n_tenants < 1 or self.groups_per_tenant < 1:
            raise ValueError("need >= 1 tenant and >= 1 group each")
        if self.group_size < 2:
            raise ValueError("multicast groups need >= 2 members")

    def tenant_phase(self, t: int) -> str:
        return f"tenant-{t:02d}"


def fleet_workload(hosts: Sequence[str], spec: FleetSpec) -> Workload:
    """The N-tenant contended scenario as one Workload.

    Member sets are drawn per group from ``random.Random(spec.seed)``
    (platform-stable), so tenants' trees overlap by construction once
    ``n_tenants * groups_per_tenant * group_size`` approaches the host
    count.  Every op is static — the scenario stays cacheable by the
    staging plane, and repeated sweep passes hit."""
    hosts = list(hosts)
    if len(hosts) < max(spec.group_size, 2 + spec.bg_fan_in):
        raise ValueError(f"fleet spec needs more hosts than {len(hosts)}")
    rng = random.Random(spec.seed)
    wl = Workload(f"fleet/{spec.n_tenants}x{spec.groups_per_tenant}"
                  f"/{spec.transport}")
    for t in range(spec.n_tenants):
        phase = spec.tenant_phase(t)
        for g in range(spec.groups_per_tenant):
            members = rng.sample(hosts, spec.group_size)
            wl.bcast(members, spec.nbytes, transport=spec.transport,
                     key=t * spec.groups_per_tenant + g, phase=phase)
    for i in range(spec.bg_unicasts):
        a, b = rng.sample(hosts, 2)
        wl.unicast(a, b, spec.bg_nbytes, key=i, phase="bg-mesh")
    for i in range(spec.bg_incasts):
        picks = rng.sample(hosts, 1 + spec.bg_fan_in)
        sink, senders = picks[0], picks[1:]
        for s in senders:
            wl.unicast(s, sink, spec.bg_nbytes, key=i, phase="bg-incast")
    return wl


# ------------------------------------------------------------ SLO metrics

def tenant_quantiles(wl: Workload, recs) -> Dict[str, Dict[str, float]]:
    """Per-phase JCT quantiles: one entry per tenant + the bg phases.

    Quantiles are nearest-rank (``apps.metrics.quantile``) over the
    phase's op JCTs; ``latency`` is the phase barrier (max JCT)."""
    by_phase: Dict[str, List[float]] = {}
    for op, rec in zip(wl.ops, recs):
        by_phase.setdefault(op.phase, []).append(appm.jct(rec))
    out = {}
    for phase, lats in by_phase.items():
        q = appm.request_quantiles(lats)
        q["n_ops"] = len(lats)
        q["latency"] = q.pop("max")
        out[phase] = q
    return out


# ------------------------------------------------------ connection census

def _native_groups(wl: Workload):
    """Distinct member tuples the packet engine would register one
    multicast group for (its per-member-set group memo)."""
    seen, groups = set(), []
    for op in wl.ops:
        if op.op in ("bcast", "write") and not op.events \
                and not op.faults and get_transport(op.transport).native:
            key = tuple(op.members)
            if key not in seen:
                seen.add(key)
                groups.append(op)
    return groups


def _unicast_pairs(wl: Workload):
    """Distinct (src, dst) channels the packet engine would wire one RC
    QP pair for (its per-pair channel memo)."""
    pairs = []
    seen = set()
    for op in wl.ops:
        if op.op == "unicast":
            p = (op.members[0], op.members[1])
            if p not in seen:
                seen.add(p)
                pairs.append(p)
    return pairs


def connection_census(eng, wl: Optional[Workload] = None) -> dict:
    """Fabric connection state after a run: QPs per NIC + MFT per
    switch.

    Packet engine: measured (live ``Host.qps`` and
    ``GleamSwitch.tables``).  Flow engines: analytic from the workload
    (mirrors the packet engine's reuse rules; MFT occupancy from the
    staged multicast trees)."""
    if hasattr(eng, "net"):                       # packet: measured
        sim = eng.net.sim
        qp = {n: len(h.qps) for n, h in sim.hosts.items() if h.qps}
        switches = {}
        for name, sw in sim.switches.items():
            t = sw.tables
            if t.tables or t.evictions or t.salvages:
                switches[name] = {
                    "occupancy": len(t.tables),
                    "capacity": t.capacity,
                    "evictions": t.evictions,
                    "salvages": t.salvages,
                    "bytes": t.total_bytes(),
                    "port_peak": max(sw.port_util.values(), default=0),
                }
        return _census_report(qp, switches, measured=True)

    if wl is None:
        raise ValueError("flow-engine census needs the workload")
    assert isinstance(eng, FlowEngine)
    sim = eng._sim
    topo = eng.topo
    rev: Dict[int, tuple] = {}                 # link id -> (node, port)
    for hop, i in sim.link_id.items():
        rev[i] = hop
    switch_set = set(topo.switches)
    qp: Dict[str, int] = {}
    occ: Dict[str, int] = {}
    ebytes: Dict[str, int] = {}
    for op in _native_groups(wl):
        members = list(op.members)
        for m in members:
            qp[m] = qp.get(m, 0) + 1
        source = op.source or members[0]
        links = sim.multicast_tree_links(source, members, op.key)
        per_sw: Dict[str, int] = {}
        for i in links:
            node, port = rev[i]
            if node not in switch_set:
                continue
            # ftable model: a host-facing tree port holds a connected
            # entry, a transit port a forwarded one (+4 LRU bytes each)
            peer = topo.ports[node][port][0]
            kind = ftable.FORWARDED if peer in switch_set \
                else ftable.CONNECTED
            per_sw[node] = per_sw.get(node, 0) + \
                ftable.ENTRY_BYTES[kind] + 4
        for s, nb in per_sw.items():
            occ[s] = occ.get(s, 0) + 1
            ebytes[s] = ebytes.get(s, 0) + ftable.GROUP_BYTES + nb
    for a, b in _unicast_pairs(wl):
        qp[a] = qp.get(a, 0) + 1
        qp[b] = qp.get(b, 0) + 1
    switches = {}
    for s in sorted(occ):
        switches[s] = {"occupancy": occ[s], "capacity": None,
                       "evictions": 0, "salvages": 0,
                       "bytes": ebytes[s], "port_peak": 0}
    return _census_report(qp, switches, measured=False)


def _census_report(qp: Dict[str, int], switches: dict,
                   measured: bool) -> dict:
    return {
        "measured": measured,
        "qp_per_host": dict(sorted(qp.items())),
        "qp_total": sum(qp.values()),
        "nic_qp_peak": max(qp.values(), default=0),
        "switches": switches,
        "mft_groups_total": sum(s["occupancy"]
                                for s in switches.values()),
        "mft_bytes_total": sum(s["bytes"] for s in switches.values()),
        "mft_evictions": sum(s["evictions"] for s in switches.values()),
    }


# ------------------------------------------------------- LRU pressure

def mft_pressure_report(topo, *, n_groups: int, group_size: int,
                        capacity: int, nbytes: int = 256 << 10,
                        seed: int = 0) -> dict:
    """Registration churn against capacity-bounded switch tables.

    The LRU-pressure experiment: register ``n_groups`` multicast groups
    through the packet control plane with every switch pinned to
    ``capacity`` table slots — the deployment shape where group
    registrations outlive their tenants (``core/ftable.py``).  Old
    groups' entries get LRU-evicted as new tenants register; the most
    recent group must still be installed end to end, which the report
    proves by running one broadcast on it.  (Deliberately NOT concurrent
    traffic: evicting a group mid-stream wedges it on go-back-N retries
    until an explicit repair re-flood — tests/test_ftable.py covers that
    recovery path in isolation.)"""
    from repro_torch.core.gleam import GleamNetwork

    rng = random.Random(seed)
    net = GleamNetwork(topo)
    for sw in net.sim.switches.values():
        sw.tables.capacity = capacity
    last = None
    for _ in range(n_groups):
        last = net.multicast_group(rng.sample(topo.hosts, group_size))
        last.register()
    t0 = net.sim.now
    rec = last.bcast(nbytes, now=t0)
    net.sim.run(until=t0 + 1.0)
    switches = {}
    for name, sw in net.sim.switches.items():
        t = sw.tables
        if t.tables or t.evictions:
            switches[name] = {"occupancy": len(t.tables),
                              "capacity": t.capacity,
                              "evictions": t.evictions,
                              "salvages": t.salvages,
                              "bytes": t.total_bytes()}
    return {
        "capacity": capacity,
        "n_groups": n_groups,
        "switches": switches,
        "evictions": sum(s["evictions"] for s in switches.values()),
        "salvages": sum(s["salvages"] for s in switches.values()),
        "occupancy_peak": max((s["occupancy"]
                               for s in switches.values()), default=0),
        "last_group_ok": bool(rec.t_sender_cqe > 0 and not rec.error
                              and len(rec.t_deliver) == group_size - 1),
        "last_group_jct": appm.jct(rec),
    }


# -------------------------------------------------------------- driver

def run_fleet(engine_name: str, topo, spec: FleetSpec,
              timeout: float = 60.0, **engine_kw) -> dict:
    """One fleet scenario end to end on the named engine.

    Returns a plain-dict report: per-tenant quantiles, connection
    census, staging-cache telemetry (flow engines), and the scenario
    makespan."""
    eng = make_engine(engine_name, topo, **engine_kw)
    wl = fleet_workload(topo.hosts, spec)
    recs = eng.run_workloads([wl], timeout=timeout)[0]
    tenants = tenant_quantiles(wl, recs)
    census = connection_census(eng, wl) if isinstance(eng, FlowEngine) \
        else connection_census(eng)
    report = {
        "engine": engine_name,
        "spec": dataclasses.asdict(spec),
        "tenants": tenants,
        "census": census,
        "makespan_s": max((r.t_sender_cqe for r in recs), default=0.0),
        "errors": sum(1 for r in recs if r.error),
    }
    if isinstance(eng, FlowEngine):
        report["staging"] = eng.staging_stats()
    return report
