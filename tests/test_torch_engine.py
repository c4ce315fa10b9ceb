"""The port's engines against the reference, and the port's rules.

Records of ``repro_torch``'s ``make_engine("flow", topo, device="cpu")``
(the torch solver) and ``"flow-np"`` (its numpy copy) are held against
the reference package's ``make_engine("flow-np")`` on the scenarios of
``tests/test_engines.py`` and ``tests/test_segments.py``, both packages
fed the same topology and Workload through ``repro_torch.convert``.
Where the reference runs its packet engine on a scenario, the port's
``make_engine("packet")`` runs it too and is held to it bit for bit
(rtol 0): every record field and the run's counters.

The rules: ``repro_torch`` and ``chip_smoke.py`` import neither ``jax``
nor ``repro``; the port runs with both absent; its engine runs on the
card unless the caller asks for the CPU; ``chip_smoke.py`` refuses to
report without a card.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import fattree as ref_fattree
from repro.core.engine import make_engine as ref_make_engine
from repro.core.workload import GroupOp as RefGroupOp
from repro.core.workload import Workload as RefWorkload
from repro_torch.convert import topology_from_reference, \
    workload_from_reference
from repro_torch.core import engine as port_engine
from repro_torch.core.engine import make_engine, wire_bytes

from _segment_props import random_dynamic_ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
TRANSPORTS = ("gleam", "multiunicast", "ring", "binary-tree")
PORT = {"flow": {"device": "cpu"}, "flow-np": {}}
#: the flow ports and the packet engine, which is compared exactly
ENGINES = sorted(PORT) + ["packet"]


def two_pod_fat_tree():
    return ref_fattree.fat_tree(n_pods=2, leaves_per_pod=2, hosts_per_leaf=2,
                                aggs_per_pod=2, bw=100 * ref_fattree.GBPS)


def records(recs):
    return [(r.t_sender_cqe, sorted(r.t_deliver.items())) for r in recs]


def packet_records(eng, recs):
    """Every record field and the run's counters (packet engines)."""
    sim = eng.net.sim
    return ([(r.msg_id, r.t_submit, r.t_sender_cqe,
              sorted(r.t_deliver.items()), r.error) for r in recs],
            (sim.events, sim.dropped, sim.tx_bytes,
             sum(q.retransmitted for h in sim.hosts.values()
                 for q in h.qps.values())),
            eng.last_run_stats)


def run_both(ref_topo, ops, port_name, *, scenarios=False, **kw):
    """Records of the same ops on the reference engine (its packet engine
    for ``port_name="packet"``, else its flow-np) and on a port engine;
    ``scenarios`` runs each op as its own run_many scenario, else all ops
    contend in one run()."""
    wl = RefWorkload("t", list(ops))
    out = []
    for maker, topo, w, extra in (
            (ref_make_engine, ref_topo, wl, {}),
            (make_engine, topology_from_reference(ref_topo),
             workload_from_reference(wl), PORT.get(port_name, {}))):
        name = port_name if maker is make_engine or port_name == "packet" \
            else "flow-np"
        eng = maker(name, topo, **kw, **extra)
        if scenarios:
            recs = [rs[0] for rs in eng.run_workloads(
                [type(w)("s", [op]) for op in w.ops])]
        else:
            recs = [eng.stage(op) for op in w.ops]
            eng.run()
        out.append(packet_records(eng, recs) if port_name == "packet"
                   else records(recs))
    return out


def assert_records_close(got, want, rtol):
    """Flow records within ``rtol``; packet records (``packet_records``)
    exactly equal."""
    if isinstance(got, tuple):
        assert got == want
        return
    assert len(got) == len(want)
    for (gc, gd), (wc, wd) in zip(got, want):
        assert gc == pytest.approx(wc, rel=rtol), (gc, wc)
        assert [m for m, _ in gd] == [m for m, _ in wd]
        for (_, gt), (_, wt) in zip(gd, wd):
            assert gt == pytest.approx(wt, rel=rtol), (gt, wt)


# ====================================================== engine parity

@pytest.mark.parametrize("port_name", ENGINES)
@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("nbytes", [256 << 10, 1 << 20])
def test_transport_bcast_matches_reference(port_name, transport, nbytes):
    members = ("h0", "h1", "h2", "h3")
    got, want = run_both(ref_fattree.testbed(n_hosts=4),
                         [RefGroupOp("bcast", members, nbytes,
                                     transport=transport)], port_name)
    assert_records_close(got, want, 1e-3)


@pytest.mark.parametrize("port_name", ENGINES)
@pytest.mark.parametrize("transport", TRANSPORTS)
def test_allreduce_matches_reference(port_name, transport):
    got, want = run_both(ref_fattree.testbed(),
                         [RefGroupOp("allreduce", ("h0", "h1", "h2", "h3"),
                                     1 << 20, transport=transport)],
                         port_name)
    assert_records_close(got, want, 1e-3)


@pytest.mark.parametrize("port_name", ENGINES)
def test_contended_fat_tree_matches_reference(port_name):
    """All hosts of a 2-pod fat tree, a write, a unicast and a second
    group contending in one run."""
    topo = two_pod_fat_tree()
    hosts = tuple(topo.hosts)
    ops = [RefGroupOp("bcast", hosts, 1 << 20),
           RefGroupOp("write", hosts[:4], 256 << 10),
           RefGroupOp("unicast", (hosts[1], hosts[6]), 512 << 10, key=3),
           RefGroupOp("bcast", hosts[2:7], 2 << 20, transport="ring",
                      key=1)]
    got, want = run_both(topo, ops, port_name)
    assert_records_close(got, want, 1e-3)


@pytest.mark.parametrize("port_name", ENGINES)
@pytest.mark.parametrize("loss", [1e-4, 1e-2])
def test_lossy_scenarios_match_reference(port_name, loss):
    hosts = ("h0", "h1", "h2", "h3", "h4", "h5")
    ops = [RefGroupOp("bcast", hosts, 1 << 20),
           RefGroupOp("bcast", hosts[:4], 1 << 20, transport="multiunicast",
                      key=1)]
    got, want = run_both(ref_fattree.testbed(n_hosts=6), ops, port_name,
                         scenarios=True, loss_rate=loss,
                         group_kw={"window": 512}, relay_kw={"window": 512})
    assert_records_close(got, want, 1e-3)


@pytest.mark.parametrize("port_name", sorted(PORT))
@pytest.mark.parametrize("seed", range(3))
def test_dynamic_ops_match_reference(port_name, seed):
    """Random join/leave/fail timelines (test_segments' generator)."""
    ops = random_dynamic_ops(np.random.default_rng(seed), 3)
    got, want = run_both(ref_fattree.testbed(n_hosts=14), ops, port_name)
    assert_records_close(got, want, 1e-3)


@pytest.mark.parametrize("port_name", ENGINES)
def test_faults_under_loss_match_reference(port_name):
    """A churn x loss x link-flap cell (fig_matrix's smoke fabric)."""
    from repro.core.workload import FaultEvent, MemberEvent
    topo = ref_fattree.fat_tree(n_pods=2, leaves_per_pod=2,
                                hosts_per_leaf=4, aggs_per_pod=2)
    h = topo.hosts
    ops = [RefGroupOp("bcast", (h[0], h[1], h[4], h[5]), 1 << 19,
                      events=(MemberEvent("leave", h[5], 2e-5),
                              MemberEvent("join", h[6], 4e-5)),
                      faults=(FaultEvent("link_flap", 3e-6, node="L0.1",
                                         peer="A0.0", duration=20e-6),)),
           RefGroupOp("bcast", (h[8], h[12], h[13], h[2]), 1 << 19,
                      faults=(FaultEvent("link_flap", 8e-6, node="L1.1",
                                         peer="A1.0", duration=20e-6),))]
    got, want = run_both(topo, ops, port_name, loss_rate=1e-3)
    assert_records_close(got, want, 1e-3)


def test_numpy_copy_is_bit_identical_to_reference():
    """The port's flow-np is the reference's numpy engine, copied."""
    ops = random_dynamic_ops(np.random.default_rng(4), 3)
    got, want = run_both(ref_fattree.testbed(n_hosts=14), ops, "flow-np")
    assert got == want


@pytest.mark.parametrize("port_name", sorted(PORT))
def test_zero_event_ops_bit_identical_across_segment_modes(port_name):
    """Static ops never touch the segment machinery: batched and legacy
    segment solvers give bit-identical records."""
    topo = topology_from_reference(ref_fattree.testbed(n_hosts=10))
    out = []
    for mode in ("batched", "legacy"):
        eng = make_engine(port_name, topo, segment_solver=mode,
                          **PORT[port_name])
        recs = [eng.stage(op) for op in (
            port_engine.GroupOp("bcast", [f"h{i}" for i in range(5)],
                                1 << 18),
            port_engine.GroupOp("bcast", ["h5", "h6", "h7"], 1 << 16))]
        eng.run()
        out.append(records(recs))
    assert out[0] == out[1]


@pytest.mark.parametrize("seed", range(2))
def test_batched_segments_match_legacy_on_torch(seed):
    """Lossless dynamic ops: the batched float64 lanes agree with the
    legacy per-segment closures to <= 1e-6 relative (the legacy closures
    predate loss-native snapshots, so lossy runs differ by design)."""
    ops = random_dynamic_ops(np.random.default_rng(seed), 3)
    wl = workload_from_reference(RefWorkload("t", ops))
    topo = topology_from_reference(ref_fattree.testbed(n_hosts=14))
    out = []
    for mode in ("batched", "legacy"):
        eng = make_engine("flow", topo, segment_solver=mode, device="cpu")
        recs = [eng.stage(op) for op in wl.ops]
        eng.run()
        out.append(records(recs))
    assert_records_close(out[0], out[1], 1e-6)


def test_run_many_matches_serial_fresh_engines():
    topo = topology_from_reference(ref_fattree.testbed(n_hosts=5))
    recs: list = []
    eng = make_engine("flow", topo, device="cpu")
    eng.run_many([
        lambda e: recs.append(e.stage(port_engine.GroupOp(
            "bcast", ("h0", "h1", "h2"), 1 << 20))),
        lambda e: recs.append(e.stage(port_engine.GroupOp(
            "bcast", ("h0", "h3", "h4"), 2 << 20)))])
    for rec, members, nbytes in ((recs[0], ("h0", "h1", "h2"), 1 << 20),
                                 (recs[1], ("h0", "h3", "h4"), 2 << 20)):
        solo = make_engine("flow", topo, device="cpu")
        r = solo.stage(port_engine.GroupOp("bcast", members, nbytes))
        solo.run()
        assert rec.jct(2) == pytest.approx(r.jct(2), rel=1e-5)


def test_wire_bytes_includes_per_segment_headers():
    assert wire_bytes(1) == 1 + port_engine.HDR
    assert wire_bytes(port_engine.MTU) == port_engine.MTU + port_engine.HDR
    assert wire_bytes(port_engine.MTU + 1) == \
        port_engine.MTU + 1 + 2 * port_engine.HDR


def test_copied_constants_equal_the_reference():
    """The engine imports its constants from the port's own packet and
    faults modules (``gleam`` re-exports ``DEFAULT_FAIL_DETECT``), which
    equal the reference's."""
    from repro.core import faults, gleam, packet
    from repro_torch.core import faults as port_faults
    from repro_torch.core import gleam as port_gleam
    from repro_torch.core import packet as port_packet
    assert (port_engine.MTU, port_engine.HDR) == \
        (port_packet.MTU, port_packet.HDR) == (packet.MTU, packet.HDR)
    assert port_engine.DEFAULT_FAIL_DETECT == \
        port_faults.DEFAULT_FAIL_DETECT == \
        port_gleam.DEFAULT_FAIL_DETECT == gleam.DEFAULT_FAIL_DETECT
    assert port_engine.DEFAULT_LINK_DETECT == \
        port_faults.DEFAULT_LINK_DETECT == faults.DEFAULT_LINK_DETECT
    assert port_engine.ENGINE_CHOICES == ("packet", "flow", "flow-np")


def test_workload_round_trip_and_transports():
    from repro_torch.core.workload import transport_names
    ops = random_dynamic_ops(np.random.default_rng(1), 2)
    wl = RefWorkload("rt", ops + [RefGroupOp("bcast", ("h0", "h1"), 100,
                                             transport="bintree")])
    port = workload_from_reference(wl)
    assert port.to_dict() == wl.to_dict()
    assert transport_names() == ("binary-tree", "gleam", "multiunicast",
                                 "ring")


# ============================================================ device rule

def test_make_engine_flow_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    topo = topology_from_reference(ref_fattree.testbed())
    with pytest.raises(RuntimeError, match="cuda"):
        make_engine("flow", topo)
    assert make_engine("flow", topo, device="cpu").name == "flow"
    assert make_engine("flow-np", topo).name == "flow-np"


def test_make_engine_rejects_unknown_names():
    topo = topology_from_reference(ref_fattree.testbed())
    with pytest.raises(ValueError, match="flow-np"):
        make_engine("ns3", topo)
    with pytest.raises(TypeError):
        make_engine("flow-np", topo, device="cpu")
    with pytest.raises(TypeError):
        make_engine("packet", topo, device="cpu")
    assert make_engine("packet", topo).name == "packet"


# ============================================================== isolation

PORT_FILES = sorted(
    [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(SRC,
                                                             "repro_torch"))
     for f in fs if f.endswith(".py")] + [os.path.join(REPO,
                                                       "chip_smoke.py")])


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[os.path.relpath(p, REPO) for p in PORT_FILES])
def test_port_source_imports_neither_jax_nor_repro(path):
    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    imports = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", src, re.M)
    bad = [m for m in imports
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
    assert not re.search(r"\bjax\b", src), "mentions jax"


FIG09_POINT = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import json
from repro_torch.core import fattree
from repro_torch.core.engine import make_engine
from repro_torch.core.workload import Workload
members = [f"h{i}" for i in range(8)]
eng = make_engine("flow", fattree.testbed(n_hosts=8), device="cpu")
wg, wb = Workload("g"), Workload("b")
wg.bcast(members, 1 << 20)
wb.bcast(members, 1 << 20, transport="multiunicast", chunks=8)
(rg,), (rb,) = eng.run_workloads([wg, wb])
assert "repro" not in sys.modules or sys.modules["repro"] is None
assert not any(m.startswith(("jax.", "repro.")) for m in sys.modules)
print(json.dumps([rg.jct(7), rb.jct(7)]))
"""


def test_port_runs_with_jax_and_repro_absent():
    """One fig09 point with ``jax`` and ``repro`` blocked from import,
    within the reference's 10% gate of its recorded flow values."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", FIG09_POINT], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    jg, jb = json.loads(proc.stdout.strip().splitlines()[-1])
    with open(os.path.join(REPO, "benchmarks", "ref_fig09_flow.json")) as fh:
        ref = json.load(fh)["rows_us"]
    sw = 18e-6                          # fig09's MPI software latency
    assert (jg + sw) * 1e6 == pytest.approx(
        ref["fig09/bcast_1MB/gleam_us"], rel=0.10)
    assert (jb + sw) * 1e6 == pytest.approx(
        ref["fig09/bcast_1MB/multiunicast_us"], rel=0.10)


FLOW_ONLY = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
SIM = ("gleam", "packetsim", "switch", "endpoint", "ftable", "baselines")
def loaded():
    return sorted(m for m in SIM if "repro_torch.core." + m in sys.modules)
from repro_torch.core import workload
from repro_torch.core.engine import make_engine
from repro_torch.core import fattree
from repro_torch.core.faults import FaultEvent
assert loaded() == [], loaded()
members = [f"h{i}" for i in range(8)]
dark = (FaultEvent("host_gone_dark", 2e-6, node="h3"),)
for name, kw in (("flow", {"device": "cpu"}), ("flow-np", {})):
    eng = make_engine(name, fattree.testbed(n_hosts=8), **kw)
    w = workload.Workload("w")
    w.bcast(members, 1 << 16)
    w.bcast(members, 1 << 16, transport="ring", chunks=4, faults=dark)
    w.bcast(members, 1 << 16, faults=dark)
    (recs,) = eng.run_workloads([w])
    assert len(recs) == 3
assert loaded() == [], loaded()
make_engine("packet", fattree.testbed(n_hosts=8))
assert loaded() == ["endpoint", "ftable", "gleam", "packetsim", "switch"], \
    loaded()
print("ok")
"""


def test_flow_engine_never_loads_the_packet_simulator():
    """Importing ``workload`` and ``engine`` and running both flow
    engines on static, overlay and faulted ops loads none of the packet
    simulator's modules; building a packet engine loads them."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", FLOW_ONLY], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without a card chip_smoke exits non-zero and prints no result;
    alone in a directory, without the repository, it fails too."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    script = os.path.join(REPO, "chip_smoke.py")
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(script, lone)
    for path, cwd in ((script, REPO), (str(lone), str(tmp_path))):
        proc = subprocess.run([sys.executable, path], cwd=cwd,
                              capture_output=True, text=True, timeout=120,
                              env=dict(os.environ, PYTHONPATH=""))
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
