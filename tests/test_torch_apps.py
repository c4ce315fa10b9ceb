"""The port's application plane (``repro_torch.apps``) against the
reference's ``repro.apps``.

Both packages get the same configuration by name, the same fabric
(built by the reference's ``fattree`` and carried over by
``convert.topology_from_reference``) and the same seeds.  The lowering
math, the generated workloads (compared through ``to_dict``), the
arrivals and every report of a run on the packet engine must be exactly
equal (rtol 0).  A run on the port's flow-np engine must equal the
reference's flow-np run exactly; on the port's torch solver
(``make_engine("flow", device="cpu")``) the reports are held to the
reference's flow-np within the flow parity tests' rtol of 1e-3, except
where the reference's numpy solver ends small flows early (ROADMAP
queue 3, ``test_small_flows_contend_on_the_torch_solver``).  The
port's ``param_count`` must equal its own
``count_params(model_defs(cfg))`` for every configuration, the anchor of
``tests/test_apps.py``.
"""
from __future__ import annotations

import pytest

from repro.apps import collectives_lowering as ref_cl
from repro.apps import fleet as ref_fleet
from repro.apps import metrics as ref_metrics
from repro.apps import traffic as ref_traffic
from repro.configs import base as ref_base
from repro.core import engine as ref_engine
from repro.core import fattree as ref_fattree
from repro.core import workload as ref_workload
from repro.core.engine import make_engine as ref_make_engine
from repro_torch.apps import collectives_lowering as port_cl
from repro_torch.apps import fleet as port_fleet
from repro_torch.apps import metrics as port_metrics
from repro_torch.apps import traffic as port_traffic
from repro_torch.configs import base as port_base
from repro_torch.convert import topology_from_reference, \
    workload_from_reference
from repro_torch.core.engine import make_engine as port_make_engine
from repro_torch.models.blocks import count_params
from repro_torch.models.model import model_defs

ARCHS = ("granite_3_2b", "h2o_danube_3_4b", "internvl2_26b",
         "jamba_v0_1_52b", "llama3_2_3b", "mamba2_370m", "mixtral_8x7b",
         "qwen1_5_110b", "qwen3_moe_235b_a22b", "whisper_medium")
APP_ARCHS = ("llama3_2_3b", "mixtral_8x7b", "jamba_v0_1_52b")


def configs(arch, smoke):
    return (ref_base.get_config(arch, smoke=smoke),
            port_base.get_config(arch, smoke=smoke))


def close(got, want, rtol):
    """Nested reports: numbers within ``rtol``, everything else equal."""
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            close(got[k], want[k], rtol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w, rtol)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=rtol)
    else:
        assert got == want


# ======================================================== lowering math

@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_reference_and_model_defs(arch, smoke):
    """Decoder-only configurations count exactly; both packages refuse
    the encoder and vision frontends with the same message."""
    ref_cfg, cfg = configs(arch, smoke)
    if cfg.enc_layers > 0 or cfg.vision_prefix > 0:
        with pytest.raises(ValueError) as want:
            ref_cl.param_count(ref_cfg)
        with pytest.raises(ValueError, match="decoder-only") as got:
            port_cl.param_count(cfg)
        assert str(got.value) == str(want.value)
        return
    assert port_cl.param_count(cfg) == ref_cl.param_count(ref_cfg) == \
        count_params(model_defs(cfg))


@pytest.mark.parametrize("arch", APP_ARCHS)
def test_collective_sizes_match_reference(arch):
    ref_cfg, cfg = configs(arch, True)
    for fn, args in (("kv_cache_bytes", (64,)),
                     ("tp_allreduce_bytes", (64, 8, 2)),
                     ("moe_a2a_pair_bytes", (64, 8, 2)),
                     ("pp_boundary_bytes", (64, 2)),
                     ("prefill_comm_bytes", (64, 2)),
                     ("decode_comm_bytes", (16, 2)),
                     ("moe_uses_ep", (2,))):
        assert getattr(port_cl, fn)(cfg, *args) == \
            getattr(ref_cl, fn)(ref_cfg, *args), fn


@pytest.mark.parametrize("arch", APP_ARCHS)
def test_train_step_workload_matches_reference(arch):
    ref_cfg, cfg = configs(arch, True)
    pipe = 2 if cfg.n_blocks % 2 == 0 else 1
    for transport in ("gleam", "ring"):
        kw = dict(seq=64, batch=8, accum=2, transport=transport)
        got = port_cl.train_step_workload(
            cfg, port_cl.MeshShape(data=2, model=2, pipe=pipe), **kw)
        want = ref_cl.train_step_workload(
            ref_cfg, ref_cl.MeshShape(data=2, model=2, pipe=pipe), **kw)
        assert got.to_dict() == want.to_dict()
        assert [p.to_dict() for p in port_metrics.split_phases(got)] == \
            [p.to_dict() for p in ref_metrics.split_phases(want)]
    assert port_cl.weight_bcast_workload(cfg, 4, 2).to_dict() == \
        ref_cl.weight_bcast_workload(ref_cfg, 4, 2).to_dict()


def test_arrivals_and_quantiles_match_reference():
    for kw in (dict(rate=1e4, n=32, seed=7), dict(rate=5e3, n=16, seed=3),
               dict(kind="trace", trace=(3e-4, 1e-4, 2e-4))):
        spec = port_traffic.ArrivalSpec(**kw)
        assert spec.arrivals() == ref_traffic.ArrivalSpec(**kw).arrivals()
        assert spec.to_dict() == ref_traffic.ArrivalSpec(**kw).to_dict()
    xs = [float(x) for x in range(1, 101)] + [0.5, 1e-6]
    for q in (0.5, 0.99, 0.999):
        assert port_metrics.quantile(xs, q) == ref_metrics.quantile(xs, q)
    assert port_metrics.request_quantiles(xs) == \
        ref_metrics.request_quantiles(xs)


# ============================================= runs on the two engines

def fabric(n_hosts):
    return ref_fattree.testbed(n_hosts=n_hosts)


PORT_FLOW = {"flow": {"device": "cpu"}, "flow-np": {}}


def engines(name, topo):
    """The reference's engine and the port's for one engine name (the
    reference's flow-np stands for both flow engines)."""
    ref_name = "packet" if name == "packet" else "flow-np"
    return (ref_make_engine(ref_name, topo),
            port_make_engine(name, topology_from_reference(topo),
                             **PORT_FLOW.get(name, {})))


def rtol(name):
    return 1e-3 if name == "flow" else 0.0


def step_report(metrics, eng, wl, workers=None):
    ops, recs = metrics.run_phased(eng, wl, timeout=120.0, workers=workers)
    return (metrics.step_time(ops, recs),
            {k: v.to_dict() for k, v in
             metrics.phase_stats(ops, recs).items()},
            [(r.t_sender_cqe, sorted(r.t_deliver.items())) for r in recs])


@pytest.mark.parametrize("name", ["packet", "flow", "flow-np"])
@pytest.mark.parametrize("transport", ["gleam", "multiunicast"])
def test_train_step_run_matches_reference(transport, name):
    ref_cfg, cfg = configs("llama3_2_3b", True)
    kw = dict(seq=64, batch=8, transport=transport)
    ref_eng, eng = engines(name, fabric(4))
    want = step_report(ref_metrics, ref_eng, ref_cl.train_step_workload(
        ref_cfg, ref_cl.MeshShape(data=2, model=2), **kw))
    got = step_report(port_metrics, eng, port_cl.train_step_workload(
        cfg, port_cl.MeshShape(data=2, model=2), **kw))
    close(got, want, rtol(name))


def test_packet_workers_match_serial_and_reference():
    """App batches on packet ``run_many``: the port's forked workers equal
    its serial run, which equals the reference's."""
    ref_cfg, cfg = configs("llama3_2_3b", True)
    kw = dict(seq=64, batch=8)
    ref_eng, eng = engines("packet", fabric(4))
    want = step_report(ref_metrics, ref_eng, ref_cl.train_step_workload(
        ref_cfg, ref_cl.MeshShape(data=2, model=2), **kw))
    wl = port_cl.train_step_workload(cfg, port_cl.MeshShape(data=2, model=2),
                                     **kw)
    assert step_report(port_metrics, eng, wl) == want
    _, eng2 = engines("packet", fabric(4))
    assert step_report(port_metrics, eng2, wl, workers=2) == want
    assert eng2.last_run_stats == eng.last_run_stats


@pytest.mark.parametrize("name", ["packet", "flow-np"])
def test_serving_generator_matches_reference(name):
    """The torch solver is left out: the serving windows' 3 KiB decode
    all-reduces meet the reference flow-np's early-completion fault
    (``test_small_flows_contend_on_the_torch_solver``)."""
    ref_cfg, cfg = configs("llama3_2_3b", True)
    kw = dict(n_replicas=4, tp=2, prompt_len=32, decode_len=8,
              kv_replicas=2)
    spec = dict(rate=2e4, n=16, seed=0)
    ref_gen = ref_traffic.ServingGenerator(ref_cfg, **kw)
    gen = port_traffic.ServingGenerator(cfg, **kw)
    assert [w.to_dict() for w in gen.workloads(
        port_traffic.ArrivalSpec(**spec))] == \
        [w.to_dict() for w in ref_gen.workloads(
            ref_traffic.ArrivalSpec(**spec))]
    ref_eng, eng = engines(name, fabric(8))
    close(gen.run(eng, port_traffic.ArrivalSpec(**spec)).to_dict(),
          ref_gen.run(ref_eng, ref_traffic.ArrivalSpec(**spec)).to_dict(),
          rtol(name))


def test_small_flows_contend_on_the_torch_solver():
    """ROADMAP queue 3: the reference's numpy solver ends every flow
    within 1 us of its end at the next completion (``FlowSim.run``:
    ``remaining <= 1e-6 * rate`` bytes), so two 3 KiB all-reduces on one
    pair stop contending once a third, disjoint op completes.  The
    port's torch solver keeps the contention: each op equals the
    reference's run of its own contention class alone, where the
    reference's answer is whole (rtol 1e-3)."""
    pair, lone = ("h0", "h1"), ("h2", "h3")

    def jcts(eng, ops):
        wl = ref_workload.Workload("d", [ref_workload.GroupOp(
            "allreduce", m, 3072) for m in ops])
        if not isinstance(eng, ref_engine.FlowEngine):
            wl = workload_from_reference(wl)
        return [r.t_sender_cqe - r.t_submit
                for r in eng.run_workloads([wl])[0]]

    ref_eng, eng = engines("flow", fabric(8))
    got = jcts(eng, [pair, pair, lone])
    want = jcts(ref_eng, [pair, pair]) + jcts(ref_eng, [lone])
    assert got == pytest.approx(want, rel=1e-3)
    # the reference's own mixed run loses the pair's contention
    mixed = jcts(ref_eng, [pair, pair, lone])
    assert mixed[0] == mixed[2] < want[0]


def fleet_fabric():
    return ref_fattree.fat_tree(n_pods=2, leaves_per_pod=2, hosts_per_leaf=4,
                                aggs_per_pod=2, bw=100 * ref_fattree.GBPS)


FLEET = dict(n_tenants=3, groups_per_tenant=2, group_size=5,
             nbytes=4 << 20, bg_unicasts=6, bg_incasts=1, bg_fan_in=3,
             bg_nbytes=2 << 20, seed=0)


@pytest.mark.parametrize("name", ["packet", "flow", "flow-np"])
def test_run_fleet_matches_reference(name):
    kw = {"seed": 1} if name == "packet" else {}
    want = ref_fleet.run_fleet("packet" if name == "packet" else "flow-np",
                               fleet_fabric(), ref_fleet.FleetSpec(**FLEET),
                               **kw)
    got = port_fleet.run_fleet(name, topology_from_reference(fleet_fabric()),
                               port_fleet.FleetSpec(**FLEET),
                               **kw, **PORT_FLOW.get(name, {}))
    want["engine"] = name
    close(got, want, rtol(name))


def test_mft_pressure_report_matches_reference():
    kw = dict(n_groups=24, group_size=5, capacity=4, seed=1)
    assert port_fleet.mft_pressure_report(
        topology_from_reference(fleet_fabric()), **kw) == \
        ref_fleet.mft_pressure_report(fleet_fabric(), **kw)


def test_fleet_workload_and_census_rules_match_reference():
    hosts = fleet_fabric().hosts
    for seed in (0, 1):
        spec = dict(FLEET, seed=seed)
        assert port_fleet.fleet_workload(
            hosts, port_fleet.FleetSpec(**spec)).to_dict() == \
            ref_fleet.fleet_workload(hosts,
                                     ref_fleet.FleetSpec(**spec)).to_dict()
    with pytest.raises(ValueError):
        port_fleet.FleetSpec(group_size=1)
