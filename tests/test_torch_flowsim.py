"""``repro_torch.core.flowsim_torch.TorchFlowSim`` against the reference.

The torch solver runs with ``device="cpu"`` (the plain PyTorch versions
of the kernels) and is held against the reference package's numpy
solver — ``repro.core.flowsim.FlowSim`` and
``LinkMap.segment_rates_many`` — on the same topology, carried across by
``repro_torch.convert``.  The numpy modules the port copied are held to
their originals bit for bit.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import fattree as ref_fattree
from repro.core import flowsim as ref_flowsim
from repro_torch.convert import topology_from_reference
from repro_torch.core import flowsim as port_flowsim
from repro_torch.core import flowsim_torch as fts
from repro_torch.core.flowsim_torch import TorchFlowSim, compact_links

from _segment_props import random_loss_params, random_problem


def small_fat_tree():
    return ref_fattree.fat_tree(n_pods=2, leaves_per_pod=2, hosts_per_leaf=2,
                                aggs_per_pod=2, bw=100 * ref_fattree.GBPS)


def random_flows(rng, sim, n_lo=3, n_hi=12):
    hosts = list(sim.topo.hosts)
    out = []
    for _ in range(int(rng.integers(n_lo, n_hi + 1))):
        key = int(rng.integers(0, 4))
        if rng.random() < 0.5:
            src, dst = (str(h) for h in rng.choice(hosts, 2, replace=False))
            links = sim.unicast_links(src, dst, key)
        else:
            k = int(rng.integers(2, min(6, len(hosts)) + 1))
            members = [str(h) for h in rng.choice(hosts, k, replace=False)]
            links = sim.multicast_tree_links(members[0], members, key)
        out.append((links, float(rng.uniform(1e5, 5e6))))
    return out


def pair(ref_topo):
    """(reference numpy FlowSim, port TorchFlowSim on the CPU)."""
    return ref_flowsim.FlowSim(ref_topo), \
        TorchFlowSim(topology_from_reference(ref_topo), device="cpu")


# ======================================================== copies and links

def test_port_topology_has_reference_link_ids():
    """Carried-across fabrics index links exactly as the reference."""
    for topo in (ref_fattree.fig4(), small_fat_tree(),
                 ref_fattree.testbed(n_hosts=6)):
        ref_sim, sim = pair(topo)
        assert sim.link_id == ref_sim.link_id
        np.testing.assert_array_equal(sim.cap, ref_sim.cap)
        np.testing.assert_array_equal(sim.delay, ref_sim.delay)
        assert sim.unicast_links(topo.hosts[0], topo.hosts[-1], 1) == \
            ref_sim.unicast_links(topo.hosts[0], topo.hosts[-1], 1)


@pytest.mark.parametrize("seed", range(4))
def test_copied_static_maxmin_is_bit_identical(seed):
    rng = np.random.default_rng(seed)
    cap, sets = random_problem(rng, 24, 12)
    assert (port_flowsim.static_maxmin(cap, sets)
            == ref_flowsim.static_maxmin(cap, sets)).all()
    assert (port_flowsim.static_maxmin_loops(cap, sets)
            == ref_flowsim.static_maxmin_loops(cap, sets)).all()


def test_compact_links_renumbers_per_lane():
    fl = np.array([[[5, 9, 9], [2, 5, 9]], [[7, 9, 9], [9, 9, 9]]],
                  np.int32)                      # sentinel 9
    cap = np.arange(10, dtype=np.float64) + 1.0
    cap[-1] = np.inf
    local, capl = compact_links(fl, cap)
    assert capl.shape == (2, 3)                  # 2 real links + sentinel
    np.testing.assert_array_equal(local[0], [[1, 2, 2], [0, 1, 2]])
    np.testing.assert_array_equal(local[1], [[0, 2, 2], [2, 2, 2]])
    np.testing.assert_array_equal(capl[0], [3.0, 6.0, np.inf])
    np.testing.assert_array_equal(capl[1], [8.0, np.inf, np.inf])
    assert (np.take_along_axis(capl, local.reshape(2, -1), 1)
            == cap[fl.reshape(2, -1)]).all()


# ================================================== event loop vs numpy

@pytest.mark.parametrize("seed", range(3))
def test_run_completion_times_match_numpy(seed):
    """Full event loop (epochs + warm start) vs the numpy FlowSim, 0.1%."""
    rng = np.random.default_rng(100 + seed)
    ref_sim, sim = pair(small_fat_tree())
    flows = random_flows(rng, ref_sim)
    fn = [ref_sim.add(links, vol) for links, vol in flows]
    ft = [sim.add(links, vol) for links, vol in flows]
    ref_sim.run()
    sim.run()
    np.testing.assert_allclose([f.done_t for f in ft],
                               [f.done_t for f in fn], rtol=1e-3)
    assert sim.solve_dtype == np.float32


@pytest.mark.parametrize("seed", range(3))
def test_lossy_run_matches_numpy(seed):
    """Loss factors scale each epoch's rates and the RTO tail lands on
    the completion time, as in the numpy solver."""
    rng = np.random.default_rng(200 + seed)
    ref_sim, sim = pair(ref_fattree.fig4())
    flows = random_flows(rng, ref_sim)
    lps = [random_loss_params(rng) if rng.random() < 0.7 else None
           for _ in flows]
    lps = [None if lp is None else
           ref_flowsim.LossParams(lp.q, lp.wsq, lp.wnd, 1e-5, lp.ecn)
           for lp in lps]
    fn = [ref_sim.add(links, vol, loss=lp)
          for (links, vol), lp in zip(flows, lps)]
    ft = [sim.add(links, vol, loss=None if lp is None else
                  port_flowsim.LossParams(lp.q, lp.wsq, lp.wnd, lp.tail,
                                          lp.ecn))
          for (links, vol), lp in zip(flows, lps)]
    ref_sim.run()
    sim.run()
    np.testing.assert_allclose([f.done_t for f in ft],
                               [f.done_t for f in fn], rtol=1e-3)


def test_large_volumes_promote_to_float64():
    """Multi-GB volumes solve in float64 and agree with numpy to 1e-9."""
    ref_sim, sim = pair(ref_fattree.testbed())
    rng = np.random.default_rng(3)
    pairs = [("h0", "h1"), ("h0", "h2"), ("h1", "h3"), ("h2", "h3")]
    fn, ft = [], []
    for a, b in pairs:
        vol = float(2 << 30) * (1.0 + float(rng.uniform(0, 0.5)))
        fn.append(ref_sim.add(ref_sim.unicast_links(a, b), vol))
        ft.append(sim.add(sim.unicast_links(a, b), vol))
    ref_sim.run()
    sim.run()
    assert sim.solve_dtype == np.float64
    np.testing.assert_allclose([f.done_t for f in ft],
                               [f.done_t for f in fn], rtol=1e-9)


def test_f32_boundary_is_safe_integer_range():
    topo = topology_from_reference(ref_fattree.testbed())
    for vol, want in ((fts.F32_SAFE_MAX, np.float32),
                      (fts.F32_SAFE_MAX * 1.01, np.float64)):
        sim = TorchFlowSim(topo, device="cpu")
        sim.add(sim.unicast_links("h0", "h1"), vol)
        sim.run()
        assert sim.solve_dtype == want


def test_solve_many_matches_serial_runs():
    """Independent epochs batched as lanes == each epoch run alone."""
    rng = np.random.default_rng(9)
    topo = topology_from_reference(small_fat_tree())
    sim = TorchFlowSim(topo, device="cpu")
    epochs_spec = [random_flows(rng, sim) for _ in range(4)]
    epochs = [[port_flowsim.Flow(tuple(l), v) for l, v in ep]
              for ep in epochs_spec]
    ends = sim.solve_many(epochs)
    for ep_spec, ep, end in zip(epochs_spec, epochs, ends):
        alone = TorchFlowSim(topo, device="cpu")
        fs = [alone.add(l, v) for l, v in ep_spec]
        alone.run()
        np.testing.assert_allclose([f.done_t for f in ep],
                                   [f.done_t for f in fs], rtol=1e-6)
        assert end == pytest.approx(max(f.done_t for f in fs), rel=1e-6)


def test_solvers_preserve_staged_volume():
    """run() records completion via done_t/remaining and never touches
    the staged volume."""
    sim = TorchFlowSim(topology_from_reference(ref_fattree.testbed()),
                       device="cpu")
    f = sim.add(sim.unicast_links("h0", "h1"), 1 << 20)
    sim.run()
    assert f.volume == float(1 << 20)
    assert f.remaining == 0.0
    assert f.done_t > 0.0


def test_solve_stats_count_calls_and_host_syncs():
    fts.reset_solve_stats()
    sim = TorchFlowSim(topology_from_reference(ref_fattree.testbed()),
                       device="cpu")
    sim.add(sim.unicast_links("h0", "h1"), 1 << 20)
    sim.add(sim.unicast_links("h2", "h1"), 2 << 20)
    sim.run()
    st = fts.SOLVE_STATS
    assert st["calls"] == 1 and st["shapes"] == [(1, 16, 8)]
    # two completion epochs + the exit test, plus the result copy
    assert st["syncs"] == 4
    assert st["solve_s"] > 0.0


# ===================================================== dynamic segments

@pytest.mark.parametrize("with_loss", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_segment_rates_many_match_numpy(seed, with_loss):
    """Batched float64 segment lanes vs the reference numpy oracle
    ``LinkMap.segment_rates_many``, <= 1e-6 relative."""
    topo = ref_fattree.testbed(n_hosts=12)
    ref_sim, sim = pair(topo)
    rng = np.random.default_rng(seed)
    problems, port_problems = [], []
    for _ in range(6):
        _, sets = random_problem(rng, len(ref_sim.cap),
                                 int(rng.integers(2, 9)))
        lp = random_loss_params(rng) \
            if with_loss and rng.random() < 0.7 else None
        problems.append((tuple(sets), lp))
        port_problems.append((tuple(sets), None if lp is None else
                              port_flowsim.LossParams(lp.q, lp.wsq, lp.wnd,
                                                      lp.tail, lp.ecn)))
    want = ref_sim.segment_rates_many(problems)
    got = sim.segment_rates_many(port_problems)
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-6 * w, (g, w)


# ================================================================ device

def test_default_device_is_the_card():
    """No card and no device="cpu": the solver refuses to start."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    topo = topology_from_reference(ref_fattree.testbed())
    with pytest.raises(RuntimeError, match="cuda"):
        TorchFlowSim(topo)
    with pytest.raises(ValueError):
        TorchFlowSim(topo, device="meta")
