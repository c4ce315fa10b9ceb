"""Plain PyTorch kernels of ``repro_torch.kernels`` against the reference.

The port's max-min round and loss factors are held against the JAX
package's oracles (``repro.kernels.ref``) and its Pallas kernels in
interpret mode, on the same numpy-seeded inputs, in float32 and — under
``jax.enable_x64`` — float64; the filling loop against the numpy
``FlowSim`` progressive filling.  On CPU tensors the wrappers run the
plain versions; the CUDA kernels themselves are held against them on the
card (``gpu`` marker here, and ``chip_smoke.py``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fattree as ref_fattree
from repro.core.flowsim import DCQCN_MIN_RATE, DCQCN_RATE_NUM, FlowSim
from repro.kernels import maxmin as ref_maxmin
from repro.kernels.ref import loss_factors_reference, maxmin_round_reference
from repro_torch.kernels import build, maxmin, ref

DTYPES = {"float32": (np.float32, torch.float32, 1e-6, 1e-6),
          "float64": (np.float64, torch.float64, 1e-12, 1e-12)}


def round_problem(seed, n_flows=23, n_hops=4, n_links=17, lanes=None):
    """Sentinel-padded ragged link lists, capacities, a frozen mask."""
    rng = np.random.default_rng(seed)
    shape = (n_flows, n_hops) if lanes is None else (lanes, n_flows, n_hops)
    links = rng.integers(0, n_links, shape).astype(np.int32)
    lens = rng.integers(1, n_hops + 1, shape[:-1])
    links[np.arange(n_hops) >= lens[..., None]] = n_links
    cap = np.append(rng.uniform(1.0, 10.0, n_links), np.inf)
    frozen = (rng.random(shape[:-1]) < 0.3).astype(np.float64)
    frozen[..., 0] = 0.0                   # at least one live flow per lane
    rates = np.where(frozen > 0.5, rng.uniform(0.1, 1.0, shape[:-1]), 0.0)
    return links, cap, frozen, rates


def loss_problem(seed, n_flows=24, n_hops=4, n_links=12):
    rng = np.random.default_rng(seed)
    links, cap, _, _ = round_problem(seed, n_flows, n_hops, n_links)
    cap = cap * 1e9
    rates = rng.uniform(1e8, 5e9, n_flows)
    active = (rng.random(n_flows) < 0.8).astype(np.float64)
    q = rng.uniform(0.0, 0.05, n_flows)
    wsq = rng.uniform(0.0, 1e-4, n_flows)
    wnd = rng.choice([64.0, 256.0, 512.0], n_flows)
    ecn = (rng.random(n_flows) < 0.5).astype(np.float64)
    zero = rng.random(n_flows) < 0.3       # lossless rows: factor 1
    for a in (q, wsq, wnd, ecn):
        a[zero] = 0.0
    return links, rates, active, cap, q, wsq, wnd, ecn, zero


def _jax(dtype_name, fn, *args, **kw):
    """Run a reference function on numpy inputs in the given dtype."""
    np_dt = DTYPES[dtype_name][0]
    conv = [jnp.asarray(a) if a.dtype == np.int32 else
            jnp.asarray(a.astype(np_dt)) for a in args]
    out = fn(*conv, **kw)
    return [np.asarray(o) for o in out] if isinstance(out, (list, tuple)) \
        else np.asarray(out)


def _with_x64(dtype_name):
    return jax.enable_x64(True) if dtype_name == "float64" \
        else jax.enable_x64(False)


def _torch(dtype_name, *arrays):
    t_dt = DTYPES[dtype_name][1]
    return [torch.from_numpy(a) if a.dtype == np.int32 else
            torch.from_numpy(a).to(t_dt) for a in arrays]


# ======================================================== one filling round

@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("seed", range(4))
def test_round_matches_reference_oracle(dtype_name, seed):
    """Same freeze set, rates and remaining capacity as
    ``repro.kernels.ref.maxmin_round_reference``."""
    links, cap, frozen, rates = round_problem(seed)
    tol = DTYPES[dtype_name][2]
    with _with_x64(dtype_name):
        want = _jax(dtype_name, maxmin_round_reference, links, frozen,
                    rates, cap, tol=tol)
    got = maxmin.maxmin_round(*_torch(dtype_name, links, frozen, rates, cap),
                              tol=tol)
    rtol = DTYPES[dtype_name][3]
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    for g, w, name in zip(got, want, ("rates", "frozen", "cap_rem")):
        assert g.dtype == DTYPES[dtype_name][1]
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_round_matches_pallas_interpret(dtype_name):
    """Same round as the Pallas TPU kernel run by its interpreter."""
    links, cap, frozen, rates = round_problem(7)
    tol = DTYPES[dtype_name][2]
    with _with_x64(dtype_name):
        want = _jax(dtype_name, ref_maxmin.maxmin_round_pallas, links,
                    frozen, rates, cap, block_f=8, interpret=True, tol=tol)
    got = maxmin.maxmin_round(*_torch(dtype_name, links, frozen, rates, cap),
                              tol=tol)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=DTYPES[dtype_name][3])


def test_round_batched_equals_per_lane():
    """A (B, F, H) batch with per-lane capacities == B single rounds."""
    links, cap, frozen, rates = round_problem(3, lanes=5)
    caps = np.stack([cap * (1.0 + i) for i in range(5)])
    t = _torch("float64", links, frozen, rates, caps)
    got = maxmin.maxmin_round(*t, tol=1e-12)
    for i in range(5):
        one = maxmin.maxmin_round(t[0][i], t[1][i], t[2][i], t[3][i],
                                  tol=1e-12)
        for g, w in zip(got, one):
            assert torch.equal(g[i], w)


# =================================================== the whole filling loop

def small_fat_tree():
    return ref_fattree.fat_tree(n_pods=2, leaves_per_pod=2, hosts_per_leaf=2,
                                aggs_per_pod=2, bw=100 * ref_fattree.GBPS)


def random_flows(rng, sim, n_lo=3, n_hi=12):
    """Random unicast paths and multicast trees (the reference tests')."""
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


def pack_links(flows, n_links):
    h = max(len(links) for links, _ in flows)
    fl = np.full((len(flows), h), n_links, np.int32)
    for i, (links, _) in enumerate(flows):
        fl[i, :len(links)] = links
    return fl


@pytest.mark.parametrize("seed", range(5))
def test_maxmin_rates_match_numpy_filling(seed):
    """Filling rates agree with the numpy FlowSim to 0.1% (the contract
    of the reference's kernel test)."""
    rng = np.random.default_rng(seed)
    topo = small_fat_tree() if seed % 2 else ref_fattree.fig4()
    ref_sim = FlowSim(topo)
    flows = random_flows(rng, ref_sim)
    staged = [ref_sim.add(links, vol) for links, vol in flows]
    ref_sim._allocate(staged)
    want = np.asarray([f.rate for f in staged])
    fl = torch.from_numpy(pack_links(flows, len(ref_sim.cap)))
    cap = torch.from_numpy(np.append(ref_sim.cap, np.inf).astype(np.float32))
    active = torch.ones(len(flows), dtype=torch.bool)
    got = maxmin.maxmin_rates(fl, cap, active)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_maxmin_rates_match_reference_loop(dtype_name):
    """The filling loop == the reference ``maxmin_rates`` (jnp oracle
    mode): same round bound, same 1e-9 floor, inactive flows ~0."""
    links, cap, _, _ = round_problem(11, n_flows=30, n_hops=5, n_links=20)
    active = (np.random.default_rng(2).random(30) < 0.8)
    tol, max_rounds = (1e-12, 64) if dtype_name == "float64" else (1e-6,
                                                                   None)
    with _with_x64(dtype_name):
        np_dt = DTYPES[dtype_name][0]
        want = np.asarray(ref_maxmin.maxmin_rates(
            jnp.asarray(links), jnp.asarray(cap.astype(np_dt)),
            jnp.asarray(active), mode="ref", tol=tol, max_rounds=max_rounds))
    fl, c = _torch(dtype_name, links, cap)
    got = maxmin.maxmin_rates(fl, c, torch.from_numpy(active), tol=tol,
                              max_rounds=max_rounds)
    np.testing.assert_allclose(got.numpy(), want, rtol=DTYPES[dtype_name][3])
    assert (got.numpy()[~active] == np.asarray(1e-9, np_dt)).all()


def test_maxmin_rates_batched_lanes_are_independent():
    """Lanes of one batch fill as they would alone (the vmap axis)."""
    links, cap, _, _ = round_problem(5, n_flows=16, n_hops=4, n_links=10,
                                     lanes=4)
    rng = np.random.default_rng(5)
    active = rng.random((4, 16)) < 0.7
    active[:, 0] = True
    fl, c = _torch("float64", links, cap)
    act = torch.from_numpy(active)
    got = maxmin.maxmin_rates(fl, c, act, tol=1e-12, max_rounds=64)
    for i in range(4):
        one = maxmin.maxmin_rates(fl[i], c, act[i], tol=1e-12, max_rounds=64)
        assert torch.equal(got[i], one)


def test_max_rounds_caps_the_filling():
    """``max_rounds=1`` is exactly one round from the all-live state."""
    links, cap, _, _ = round_problem(9, n_flows=20, n_hops=3, n_links=8)
    fl, c = _torch("float64", links, cap)
    act = torch.ones(20, dtype=torch.float64)
    one_round = maxmin.maxmin_rates(fl, c, act, max_rounds=1)
    r, _, _ = maxmin.maxmin_round(fl, 1.0 - act, torch.zeros_like(act), c)
    assert torch.equal(one_round, torch.clamp(r, min=1e-9))


# ============================================================= loss factors

@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("seed", range(3))
def test_loss_factors_match_reference(dtype_name, seed):
    """Within 1e-6 of the reference oracle and of the Pallas kernel in
    interpret mode; all-zero loss rows are exactly 1."""
    *arrays, zero = loss_problem(seed)
    kw = dict(dcqcn_num=DCQCN_RATE_NUM, dcqcn_min=DCQCN_MIN_RATE)
    with _with_x64(dtype_name):
        want = _jax(dtype_name, loss_factors_reference, *arrays, **kw)
        want_pallas = _jax(dtype_name, ref_maxmin.loss_factors_pallas,
                           *arrays, block_f=8, interpret=True, **kw)
    got = maxmin.loss_factors(*_torch(dtype_name, *arrays), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, want_pallas, atol=1e-6, rtol=0)
    assert (got[zero] == 1.0).all()
    assert ((got > 0.0) & (got <= 1.0)).all()


def test_loss_factors_hot_links_need_two_saturating_flows():
    """Two ECN flows filling one link are DCQCN-hot; a lone flow at the
    same rate is not."""
    links = np.array([[0, 2], [1, 2]], np.int32)
    cap = np.array([1e9, 1e9, np.inf])
    kw = dict(dcqcn_num=DCQCN_RATE_NUM, dcqcn_min=DCQCN_MIN_RATE)
    ones = np.ones(2)
    zeros = np.zeros(2)

    def fac(lk, rates):
        return maxmin.loss_factors(*_torch(
            "float64", lk, rates, ones, cap, zeros, zeros, zeros, ones),
            **kw).numpy()

    shared = fac(np.array([[0, 2], [0, 2]], np.int32), np.full(2, 5e8))
    alone = fac(links, np.full(2, 1e9))
    assert (shared < 1.0).all()
    assert (alone == 1.0).all()


# ================================================ dispatch and the card

def test_wrappers_refuse_other_devices():
    links, cap, frozen, rates = round_problem(0)
    t = [x.to("meta") for x in _torch("float32", links, frozen, rates, cap)]
    with pytest.raises(ValueError):
        maxmin.maxmin_round(*t)


def test_plain_versions_launch_nothing():
    """CPU tensors never reach a kernel: the launch counts stay 0."""
    maxmin.reset_launches()
    links, cap, frozen, rates = round_problem(1)
    maxmin.maxmin_round(*_torch("float32", links, frozen, rates, cap))
    assert maxmin.LAUNCHES == {"maxmin_fill": 0, "loss_factors": 0}


def test_build_targets_hopper():
    """The nvcc line builds sm_90a with fused multiply-add off, and the
    library name follows the source so a stale build never loads."""
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags and "-shared" in flags
    assert build.library_path().parent == build.BUILD_DIR
    assert build.SOURCE.exists()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_cuda_fill_matches_plain_on_card(dtype_name):
    _card()
    links, cap, _, _ = round_problem(4, n_flows=300, n_hops=8, n_links=200,
                                     lanes=3)
    act = torch.ones((3, 300), dtype=DTYPES[dtype_name][1], device="cuda")
    fl, c = (x.cuda() for x in _torch(dtype_name, links, cap))
    tol = DTYPES[dtype_name][2]
    got = maxmin.maxmin_rates(fl, c, act, tol=tol)
    want = ref.maxmin_rates_reference(fl, c, act, tol=tol)
    torch.testing.assert_close(got, want, rtol=DTYPES[dtype_name][3],
                               atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_cuda_loss_factors_match_plain_on_card(dtype_name):
    _card()
    *arrays, zero = loss_problem(2, n_flows=500, n_links=64)
    t = [x.cuda() for x in _torch(dtype_name, *arrays)]
    kw = dict(dcqcn_num=DCQCN_RATE_NUM, dcqcn_min=DCQCN_MIN_RATE)
    got = maxmin.loss_factors(*t, **kw)
    want = ref.loss_factors_reference(*t, **kw)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    assert (got.cpu().numpy()[zero] == 1.0).all()
