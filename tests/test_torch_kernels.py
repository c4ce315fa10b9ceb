"""Plain PyTorch kernels of ``repro_torch.kernels`` against the reference.

The port's max-min round and loss factors are held against the JAX
package's oracles (``repro.kernels.ref``) and its Pallas kernels in
interpret mode, on the same numpy-seeded inputs, in float32 and — under
``jax.enable_x64`` — float64; the filling loop against the numpy
``FlowSim`` progressive filling.  The port's flash decode
``(out, m, l)`` against the Pallas ``flash_decode`` in interpret mode
and ``decode_reference``, in float32 and bfloat16; its flash attention
and SSD scan against ``mha_reference`` / ``ssd_reference`` and, for a
few cases, the Pallas kernels in interpret mode, with the SSD scan also
held across chunk sizes and to the model's ``ssd_chunked``.  On CPU
tensors the wrappers run the plain versions; the CUDA kernels themselves
are held against them on the card (``gpu`` marker here, and
``chip_smoke.py``).
"""
from __future__ import annotations

import contextlib
import ctypes
import importlib.util
import os
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fattree as ref_fattree
from repro.core.flowsim import DCQCN_MIN_RATE, DCQCN_RATE_NUM, FlowSim
from repro.kernels import maxmin as ref_maxmin
from repro.kernels import ops as ref_ops
from repro.kernels.ref import decode_reference as ref_decode_reference
from repro.kernels.ref import loss_factors_reference, maxmin_round_reference
from repro.kernels.ref import mha_reference as ref_mha_reference
from repro.kernels.ref import ssd_reference as ref_ssd_reference
from repro.models.ssm import ssd_chunked as ref_ssd_chunked
from repro_torch.kernels import build, maxmin, ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import attention as port_attn
from repro_torch.models import ssm as port_ssm

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


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_round_at_an_infinite_bottleneck_matches_reference(dtype_name):
    """A live flow over the +inf sentinel alone makes the round's
    bottleneck +inf: the plain round and the JAX oracle then agree, NaNs
    included, on every link a row crosses (0 * inf and inf - inf)."""
    frozen, rates = np.array([0.0, 1.0]), np.array([0.0, 3.0])
    with _with_x64(dtype_name):
        want = _jax(dtype_name, maxmin_round_reference, B_INF_LINKS, frozen,
                    rates, B_INF_CAP)
    got = maxmin.maxmin_round(*_torch(dtype_name, B_INF_LINKS, frozen, rates,
                                      B_INF_CAP))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert np.isnan(got[2].numpy()[[0, 2]]).all() and got[2][1] == 20.0


def test_wrappers_refuse_what_the_kernel_cannot_take(monkeypatch):
    """On the card path the wrappers raise on a wrong dtype, shape,
    device or a non-contiguous input before anything is launched."""
    monkeypatch.setattr(maxmin, "on_card", lambda t: True)
    links, cap, frozen, rates = round_problem(2)
    fl, fz, r, c = _torch("float32", links, frozen, rates, cap)
    bad = {
        "links dtype": (fl.long(), fz, r, c),
        "cap dtype": (fl, fz.half(), r.half(), c.half()),
        "vector dtype": (fl, fz.double(), r, c),
        "vector shape": (fl, fz[:-1], r[:-1], c),
        "cap shape": (fl, fz, r, c[None].expand(3, -1)),
        "links shape": (fl[None, None], fz, r, c),
        "non-contiguous": (fl.t().contiguous().t(), fz, r, c),
        "device": (fl, fz.to("meta"), r, c)}
    for name, args in bad.items():
        with pytest.raises(ValueError):
            maxmin.maxmin_round(*args)
    with pytest.raises(ValueError):
        maxmin.maxmin_rates(fl, c, fz.int())
    *arrays, _ = loss_problem(1)
    t = _torch("float32", *arrays)
    kw = dict(dcqcn_num=DCQCN_RATE_NUM, dcqcn_min=DCQCN_MIN_RATE)
    with pytest.raises(ValueError):
        maxmin.loss_factors(*t[:2], t[2] > 0.5, *t[3:], **kw)
    with pytest.raises(ValueError):
        maxmin.loss_factors(t[0], t[1][::2], *t[2:], **kw)


def test_fill_dispatch_is_one_call_with_outputs_only(monkeypatch):
    """On a CUDA tensor ``maxmin_rates`` makes one call of the C entry
    point with as many arguments as its ctypes signature declares,
    allocates its rates and nothing else per call (the state lives in
    shared memory or in the scratch kept per device and stream), and
    hands a bool mask over as it is; ``maxmin_round`` allocates its
    three outputs; ``loss_factors`` its factors.  The card is stood in
    for by a library that records the calls."""
    calls, made = [], []
    lib = SimpleNamespace(
        maxmin_fill_f32=lambda *a: calls.append(("fill", a)) or 0,
        maxmin_fill_f64=lambda *a: calls.append(("fill", a)) or 0,
        loss_factors_f32=lambda *a: calls.append(("loss", a)) or 0)
    _fake_card(monkeypatch, maxmin, lib)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    monkeypatch.setattr(maxmin, "_SCRATCH", {})
    real_empty, real_like = torch.empty, torch.empty_like
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: made.append(
        tuple(a[0]) if isinstance(a[0], tuple) else a[0])
        or real_empty(*a, **kw))
    monkeypatch.setattr(torch, "empty_like", lambda t, **kw: made.append(
        tuple(t.shape)) or real_like(t, **kw))
    links, cap, frozen, rates = round_problem(3, lanes=2)
    fl, fz, r, c = _torch("float32", links, frozen, rates, cap)
    maxmin.reset_launches()
    maxmin.maxmin_rates(fl, c, fz < 0.5)
    n_fill = len(build._SIGNATURES["maxmin"]["maxmin_fill_f32"])
    n_bytes = maxmin._fill_bytes(2, 23, 18, 4)
    assert [k for k, _ in calls] == ["fill"] and len(calls[0][1]) == n_fill
    assert calls[0][1][8] == 1 and calls[0][1][14] == n_bytes  # bool mask
    assert made == [(2, 23), n_bytes]      # rates, then the scratch once
    made.clear()
    maxmin.maxmin_rates(fl, c, 1.0 - fz)
    assert made == [(2, 23)] and calls[1][1][8] == 0
    made.clear()
    maxmin.maxmin_round(fl, fz, r, c)
    assert made == [(2, 23), (2, 23), (2, 18)] and calls[2][1][8] == 2
    made.clear()
    maxmin.maxmin_round(fl[0], fz[0], r[0], c)      # one lane
    assert made == [(1, 23), (1, 23), (1, 18)]
    *arrays, _ = loss_problem(4)
    made.clear()
    maxmin.loss_factors(*_torch("float32", *arrays),
                        dcqcn_num=DCQCN_RATE_NUM, dcqcn_min=DCQCN_MIN_RATE)
    n_loss = len(build._SIGNATURES["maxmin"]["loss_factors_f32"])
    assert calls[4][0] == "loss" and len(calls[4][1]) == n_loss
    assert made == [(1, 24)]           # the scratch is large enough
    assert maxmin.LAUNCHES == {"maxmin_fill": 4, "loss_factors": 1}


def test_plain_versions_launch_nothing():
    """CPU tensors never reach a kernel: the launch counts stay 0."""
    maxmin.reset_launches()
    links, cap, frozen, rates = round_problem(1)
    maxmin.maxmin_round(*_torch("float32", links, frozen, rates, cap))
    assert maxmin.LAUNCHES == {"maxmin_fill": 0, "loss_factors": 0}


def test_build_targets_hopper():
    """Each library's nvcc line builds sm_90a into a shared library;
    maxmin keeps fused multiply-add off (bit-exact with the plain
    version), and a library's name follows its source and flags so a
    stale build never loads."""
    for name in build.LIBRARIES:
        flags = " ".join(build.flags(name))
        assert "arch=compute_90a,code=sm_90a" in flags
        assert "-shared" in flags
        assert build.library_path(name).parent == build.BUILD_DIR
        assert build.source(name).exists()
    assert "-fmad=false" in build.flags("maxmin")
    assert "-fmad=false" not in build.flags("flash_decode")
    assert len({build.library_path(n) for n in build.LIBRARIES}) == \
        len(build.LIBRARIES)


#: C parameter type -> the ctypes type that binds it
_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float, "double": ctypes.c_double}


def _c_entry_points(path):
    """name -> ctypes types of the parameters of every function defined in
    the source's ``extern "C"`` block (pointers as ``c_void_p``)."""
    text = open(path).read().split('extern "C" {', 1)[1]
    found = {}
    for name, params in re.findall(r"^[\w ]+?[\s*]+(\w+)\(([^)]*)\)\s*\{",
                                   text, re.M):
        types = []
        for param in filter(None, (p.strip() for p in params.split(","))):
            kind = re.sub(r"\bconst\b|\s+\w+$", "", param).strip()
            types.append(ctypes.c_void_p if "*" in kind
                         else _C_TYPES[" ".join(kind.split())])
        found[name] = types
    return found


@pytest.mark.parametrize("name", sorted(build.LIBRARIES))
def test_entry_points_match_their_ctypes_signatures(name):
    """Every function ``build.py`` binds is defined in its library's
    source with the parameters its ctypes signature declares, one for
    one in type; the kernel counters take none."""
    defined = _c_entry_points(build.source(name))
    for fn, argtypes in build._SIGNATURES[name].items():
        assert defined[fn] == argtypes, fn
    assert build._ERROR_STRING[name] in defined
    if name in build.KERNEL_COUNT:
        assert defined[build.KERNEL_COUNT[name]] == []


def test_kernels_launched_reads_each_librarys_count(monkeypatch):
    """``kernels_launched()`` of the decode, SSD and max-min wrappers
    reads the counter of its own library."""
    libs = {"flash_decode": SimpleNamespace(
                flash_decode_kernels_launched=lambda: 7),
            "ssd_scan": SimpleNamespace(ssd_scan_kernels_launched=lambda: 9),
            "maxmin": SimpleNamespace(maxmin_kernels_launched=lambda: 11)}
    monkeypatch.setattr(build, "library", libs.__getitem__)
    assert fd.kernels_launched() == 7 and ssd.kernels_launched() == 9
    assert maxmin.kernels_launched() == 11


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("traces, want", [
    ([(9, [50])], (1.0, 1)),                      # whole at once
    ([(9, [0]), (9, [49]), (0, [50]), (200, [50])],
     (1.0, 1)),                                   # lost: all, one, fills
    ([(9, [50, 50, 50])], (3.0, 3)),              # three kernels a call
    ([(9, []), (9, [0]), (9, [48]), (9, [51])],
     (None, None)),                               # never whole
])
def test_chip_smoke_device_time_keeps_only_whole_traces(monkeypatch, traces,
                                                        want):
    """``chip_smoke.device_time`` leaves out the fills that open a trace
    and traces again, with four times more fills, when the tracer lost
    all of the fills or lost or added events of the calls (a kernel's
    count not a whole multiple of the calls), up to four traces; it
    reports "not measured" (None), never 0, when none was whole.
    ``kernels_per_call`` reads the library's own count."""
    from torch.autograd import DeviceType
    cs = _chip_smoke()
    left, pads = list(traces), []

    class FakeProfile:
        def __init__(self, activities):
            self.fills, self.counts = left.pop(0)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            cuda = [SimpleNamespace(device_type=DeviceType.CUDA,
                                    key=f"kernel_{i}", count=n,
                                    self_device_time_total=20.0 * n)
                    for i, n in enumerate(self.counts) if n]
            if self.fills:
                cuda.append(SimpleNamespace(
                    device_type=DeviceType.CUDA, count=self.fills,
                    key=f"fill<{cs.PAD_KERNEL}<float>>",
                    self_device_time_total=1e6))
            return cuda + [SimpleNamespace(device_type=DeviceType.CPU,
                                           key="flash_decode", count=50,
                                           self_device_time_total=0.0)]

    class FakePad:
        def fill_(self, value):
            pads.append(value)

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch, "zeros", lambda *a, **kw: FakePad())
    calls = []
    ms, per_call, used = cs.device_time(lambda: calls.append(1), 50)
    assert (ms and round(ms, 6), per_call) == \
        ((round(want[0] * 0.02, 6) if want[0] else None), want[1])
    assert used == len(traces) - len(left) and len(calls) == 100 * used
    assert len(pads) == sum(64 * 4 ** i for i in range(used))
    count = iter(range(0, 100, 3))
    assert cs.kernels_per_call(lambda: next(count), lambda: None, 5) == 0.6


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


#: the lane whose second round's bottleneck is +inf: a live flow over the
#: sentinel alone beside one frozen at a 0-capacity link
B_INF_LINKS = np.array([[2, 2], [0, 2]], np.int32)
B_INF_CAP = np.array([0.0, 20.0, np.inf])


def sentinel_heavy_problem(seed, lanes, n_flows, n_hops, n_links, real):
    """Rows of ``n_hops`` ids of which at most ``real`` are links (drawn
    over ``n_links``), the rest the sentinel: a multicast tree's rows."""
    rng = np.random.default_rng(seed)
    links = np.full((lanes, n_flows, n_hops), n_links, np.int32)
    lens = rng.integers(1, real + 1, (lanes, n_flows))
    for b in range(lanes):
        for f in range(n_flows):
            links[b, f, :lens[b, f]] = rng.choice(n_links, lens[b, f],
                                                  replace=False)
    cap = np.stack([np.append(rng.uniform(1e9, 2.5e10, n_links), np.inf)
                    for _ in range(lanes)])
    return links, cap


def _hold_fill_to_plain(fl, cap, active, dtype_name, variant="auto", **kw):
    """Kernel against plain on the card: every round of ``maxmin_round``
    (the same freeze set, rates and remaining capacity, NaNs where the
    plain round has them) until no flow is live, then ``maxmin_rates``;
    on the kernel the wrapper picks, or on the one named."""
    rtol = DTYPES[dtype_name][3]
    tol = kw.get("tol", 1e-6)
    bound = fl.shape[-2] if kw.get("max_rounds") is None \
        else kw["max_rounds"] - 1
    frozen = 1.0 - active
    rates = torch.zeros_like(active)
    cap_rem = cap.expand(fl.shape[0], -1).contiguous() \
        if cap.dim() == 1 and fl.dim() == 3 else cap
    for _ in range(fl.shape[-2] + 1):
        if not bool((frozen < 0.5).any()):
            break
        want = ref.maxmin_round_reference(fl, frozen, rates, cap_rem, tol=tol)
        got = maxmin._fill(fl, cap_rem, frozen, rates, tol=tol, bound=0,
                           one_round=True, floor_rates=False,
                           variant=variant)
        assert torch.equal(got[1], want[1])
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=rtol, atol=0,
                                       equal_nan=True)
        rates, frozen, cap_rem = want
    got = maxmin._fill(fl, cap, active, None, tol=tol, bound=bound,
                       one_round=False, floor_rates=True, variant=variant)[0]
    torch.testing.assert_close(got, ref.maxmin_rates_reference(
        fl, cap, active, **kw), rtol=rtol, atol=0)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("case", ["sentinel_heavy", "one_lane_in_smem",
                                  "two_lanes_past_smem"])
def test_cuda_fill_matches_plain_at_the_flow_engines_shapes(case,
                                                           dtype_name):
    """The kernel takes each shape of the main path's lanes as the plain
    version does: a lane of 16 rows of 8,192 ids over 4,000 links, most
    of them the sentinel (fig15's trees), and one lane of 4,096 x 8 ids,
    both of which fit shared memory (each held on the lane kernel and on
    the grid kernel the wrapper picks for so few, long lanes); two lanes
    of 30,000 links that do not fit (the grid kernel)."""
    _card()
    lanes, n_flows, n_hops, n_links, real = {
        "sentinel_heavy": (1, 16, 8192, 4000, 4000),
        "one_lane_in_smem": (1, 4096, 8, 3000, 8),
        "two_lanes_past_smem": (2, 4096, 8, 30000, 8)}[case]
    links, cap = sentinel_heavy_problem(5, lanes, n_flows, n_hops, n_links,
                                        real)
    t_dt = DTYPES[dtype_name][1]
    fl, c = torch.from_numpy(links).cuda(), torch.from_numpy(cap).to(
        t_dt).cuda()
    act = torch.ones(fl.shape[:2], dtype=t_dt, device="cuda")
    if case == "two_lanes_past_smem":
        assert maxmin.variant_of("maxmin_fill", fl, c) == "grid"
        _hold_fill_to_plain(fl, c, act, dtype_name)
        return
    assert maxmin.variant_of("maxmin_fill", fl, c) == "grid, lane fits"
    for variant in ("lane", "grid"):
        _hold_fill_to_plain(fl, c, act, dtype_name, variant)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("variant", ["lane", "grid"])
def test_cuda_round_at_an_infinite_bottleneck_is_the_plain_round(
        dtype_name, variant):
    """At a round whose bottleneck is +inf the kernel returns the plain
    round's remaining capacity, NaN on every link a row crosses; so does
    a lane with no live flow (one round whatever is live), on both
    kernels."""
    _card()
    t_dt = DTYPES[dtype_name][1]
    fl = torch.from_numpy(B_INF_LINKS).cuda()
    cap = torch.tensor(B_INF_CAP, dtype=t_dt, device="cuda")
    for frozen in ([0.0, 1.0], [1.0, 1.0]):
        fz = torch.tensor(frozen, dtype=t_dt, device="cuda")
        rates = torch.tensor([0.0, 3.0], dtype=t_dt, device="cuda")
        want = ref.maxmin_round_reference(fl, fz, rates, cap)
        got = maxmin._fill(fl, cap, fz, rates, tol=1e-6, bound=0,
                           one_round=True, floor_rates=False,
                           variant=variant)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    act = torch.ones(2, dtype=t_dt, device="cuda")
    _hold_fill_to_plain(fl, cap, act, dtype_name, variant)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_cuda_fill_stops_at_the_round_bound(dtype_name):
    """``max_rounds=1`` (bound 0) runs one round: the plain round's rates,
    floored, with the flows it left live at the floor."""
    _card()
    links, cap, _, _ = round_problem(6, n_flows=64, n_hops=8, n_links=40)
    fl, c = (x.cuda() for x in _torch(dtype_name, links, cap))
    act = torch.ones(64, dtype=DTYPES[dtype_name][1], device="cuda")
    one = maxmin.maxmin_rates(fl, c, act, max_rounds=1)
    r, f, _ = ref.maxmin_round_reference(fl, 1.0 - act, torch.zeros_like(act),
                                         c)
    assert bool((f < 0.5).any())
    torch.testing.assert_close(one, torch.clamp(r, min=1e-9), rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_cuda_calls_are_one_kernel_and_repeatable(dtype_name):
    """A second ``maxmin_rates`` call is bit-identical to the first (the
    scratch buffer is reset by the kernel); each call of either wrapper
    launches one kernel by the library's count, and a bool active mask
    gives the float mask's rates."""
    _card()
    links, cap = sentinel_heavy_problem(7, 3, 64, 16, 300, 6)
    t_dt = DTYPES[dtype_name][1]
    fl, c = torch.from_numpy(links).cuda(), torch.from_numpy(cap).to(
        t_dt).cuda()
    act = torch.ones((3, 64), dtype=t_dt, device="cuda")
    act[:, ::5] = 0.0
    first = maxmin.maxmin_rates(fl, c, act)
    before = maxmin.kernels_launched()
    second = maxmin.maxmin_rates(fl, c, act)
    assert maxmin.kernels_launched() - before == 1
    assert torch.equal(first, second)
    assert torch.equal(maxmin.maxmin_rates(fl, c, act > 0.5), first)
    *arrays, _ = loss_problem(3, n_flows=64, n_links=30)
    t = [x.cuda() for x in _torch(dtype_name, *arrays)]
    kw = dict(dcqcn_num=DCQCN_RATE_NUM, dcqcn_min=DCQCN_MIN_RATE)
    before = maxmin.kernels_launched()
    maxmin.loss_factors(*t, **kw)
    assert maxmin.kernels_launched() - before == 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_cuda_loss_factors_grid_matches_plain_on_card(dtype_name):
    """The loss kernel's grid variant (lanes past shared memory) against
    the plain version, at a sentinel-heavy lane forced onto it."""
    _card()
    links, cap = sentinel_heavy_problem(8, 2, 16, 512, 400, 300)
    rng = np.random.default_rng(8)
    vec = [rng.uniform(1e8, 5e9, (2, 16)), (rng.random((2, 16)) < 0.8) * 1.0,
           rng.uniform(0.0, 0.05, (2, 16)), rng.uniform(0.0, 1e-4, (2, 16)),
           rng.choice([64.0, 256.0], (2, 16)), (rng.random((2, 16)) < 0.5)
           * 1.0]
    t_dt = DTYPES[dtype_name][1]
    fl = torch.from_numpy(links).cuda()
    rates, active, c, q, wsq, wnd, ecn = (torch.from_numpy(a).to(t_dt).cuda()
                                          for a in (vec[0], vec[1], cap,
                                                    *vec[2:]))
    kw = dict(dcqcn_num=DCQCN_RATE_NUM, dcqcn_min=DCQCN_MIN_RATE,
              util_eps=1e-3)
    want = ref.loss_factors_reference(fl, rates, active, c, q, wsq, wnd, ecn,
                                      **kw)
    for variant in ("lane", "grid"):
        got = maxmin._loss(fl, rates, active, c, q, wsq, wnd, ecn, **kw,
                           variant=variant)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


# ============================================================ flash decode

#: tests/test_kernels.py's DECODE_CASES, and granite_3_2b's head shape
#: with ragged fills and an empty row: (B, S, H, KVH, D, kv_lens)
DECODE_CASES = [
    (1, 512, 4, 4, 64, [512]),
    (2, 1024, 8, 2, 64, [1000, 37]),
    (2, 512, 4, 1, 32, [1, 512]),
    (1, 768, 2, 2, 128, [600]),
]
GRANITE_CASE = (2, 512, 32, 8, 64, [300, 0])
DECODE_DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
                 "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def decode_problem(case, seed=0):
    b, s, h, kvh, d, kv_lens = case
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, d)).astype(np.float32),
            rng.standard_normal((b, s, kvh, d)).astype(np.float32),
            rng.standard_normal((b, s, kvh, d)).astype(np.float32),
            np.asarray(kv_lens, np.int32))


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("case", DECODE_CASES + [GRANITE_CASE])
@pytest.mark.parametrize("dtype_name", sorted(DECODE_DTYPES))
def test_flash_decode_matches_pallas_and_oracle(case, dtype_name):
    """``(out, m, l)`` of the port's flash decode equal the Pallas
    kernel's (interpret mode) and ``out`` the reference oracle, within
    the reference's tolerances (2e-5 in f32, 2e-2 in bf16)."""
    j_dt, t_dt, tol = DECODE_DTYPES[dtype_name]
    q, k, v, kv_len = decode_problem(case)
    jq, jk, jv = (jnp.asarray(a).astype(j_dt) for a in (q, k, v))
    want = ref_ops.flash_decode(jq, jk, jv, jnp.asarray(kv_len),
                                interpret=True)
    got = ops.flash_decode(*(torch.from_numpy(a).to(t_dt)
                             for a in (q, k, v)), torch.from_numpy(kv_len))
    assert got[0].dtype == t_dt and got[1].dtype == got[2].dtype == \
        torch.float32
    for g, w in zip(got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=tol, atol=tol)
    oracle = ref_decode_reference(jq, jk, jv, kv_len=jnp.asarray(kv_len))
    full = kv_len > 0
    np.testing.assert_allclose(_f32(got[0])[full], _f32(oracle)[full],
                               rtol=tol, atol=tol)


def test_flash_decode_empty_row_is_zero():
    """kv_len 0 gives out 0, m -1e30, l 0, as the Pallas kernel does when
    it skips every block."""
    q, k, v, kv_len = decode_problem(GRANITE_CASE)
    out, m, l = ops.flash_decode(*map(torch.from_numpy, (q, k, v, kv_len)))
    assert (out[1] == 0).all() and (m[1] == -1e30).all() and \
        (l[1] == 0).all()
    assert (l[0] > 0).all()


def test_flash_decode_split_merge_equals_full():
    """Two halves of the cache, merged with the associative (m, l)
    combine (acc = out * l), equal the whole: the combine the kernel's
    split-KV pass uses, as ``tests/test_kernels.py`` checks it."""
    q, k, v, _ = decode_problem((2, 1024, 4, 2, 64, [0, 0]), seed=3)
    q, k, v = map(torch.from_numpy, (q, k, v))
    s = k.shape[1]
    full, _, _ = ops.flash_decode(q, k, v, torch.tensor([s, s]))
    half = s // 2
    hl = torch.tensor([half, half])
    o1, m1, l1 = ops.flash_decode(q, k[:, :half], v[:, :half], hl)
    o2, m2, l2 = ops.flash_decode(q, k[:, half:], v[:, half:], hl)
    m = torch.maximum(m1, m2)
    w1, w2 = l1 * torch.exp(m1 - m), l2 * torch.exp(m2 - m)
    merged = (o1 * w1[..., None] + o2 * w2[..., None]) \
        / (w1 + w2)[..., None]
    torch.testing.assert_close(merged, full, rtol=2e-5, atol=2e-5)


def test_flash_decode_splits_fill_the_card():
    """The kernel's KV splits: enough (row, CTA group, split) CTAs for two
    per SM on 132 SMs, never more splits than 64-key tiles, nor than 8 (the
    splits of a group are one portable thread-block cluster).  At
    granite's serve step (pool 8, 8 kv heads, 4 q heads each: one head
    group) that is 5 splits, so a CTA walks up to 4 of the 17 tiles of the
    longest row at the last step (kv_len 1,033): the depth of the ring."""
    assert fd.n_splits(8, 8, 4096, 132) == 5          # granite, pool 8
    assert 8 * 8 * fd.n_splits(8, 8, 4096, 132) >= 2 * 132
    assert -(-(-(-1033 // fd.TILE)) // 5) == 4
    assert fd.n_splits(1, 1, 100, 132) == 2           # two tiles only
    assert fd.n_splits(1, 1, 4096, 132) == fd.MAX_SPLITS == 8
    assert fd.n_splits(64, 8, 4096, 132) == 1
    assert fd.n_splits(512, 8, 4096, 132) == 1
    # head groups of 16 are CTA groups of their own in the tensor-core
    # variant; the FMA variant holds all rep heads in one CTA
    assert fd.head_groups(4, "mma") == 1 and fd.head_groups(32, "mma") == 2
    assert fd.head_groups(32, "simt") == 1
    assert fd.n_splits(1, 1 * fd.head_groups(32, "mma"), 4096, 132) == 8


def _fake_card(monkeypatch, module, lib):
    """Stand the card in for ``module``'s CUDA path with ``lib``."""
    monkeypatch.setattr(module, "on_card", lambda t: True)
    monkeypatch.setattr(build, "library", lambda name: lib)
    monkeypatch.setattr(build, "check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


def test_flash_decode_dispatch_matches_its_ctypes_signature(monkeypatch):
    """On a CUDA tensor the wrapper makes one call of the C entry point,
    with as many arguments as its ctypes signature declares and the split
    count of the rule, allocates its outputs and nothing else (the splits
    merge in shared memory: no scratch, no counters), and counts one
    launch in the total and in the variant its dtypes pick (tensor cores
    for bf16 on bf16 only).  The card is stood in for by a library that
    records the call."""
    calls, made = [], []
    lib = SimpleNamespace(flash_decode=lambda *a: calls.append(a) or 0)
    _fake_card(monkeypatch, fd, lib)
    monkeypatch.setattr(fd, "_sm_count", lambda index: 132)
    real_empty, real_like = torch.empty, torch.empty_like
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: made.append(
        tuple(a[0])) or real_empty(*a, **kw))
    monkeypatch.setattr(torch, "empty_like", lambda t, **kw: made.append(
        tuple(t.shape)) or real_like(t, **kw))
    n_args = len(build._SIGNATURES["flash_decode"]["flash_decode"])
    bf16, f32 = torch.bfloat16, torch.float32
    for q_dt, kv_dt, want in ((bf16, bf16, "mma"), (f32, f32, "simt"),
                              (f32, bf16, "simt"), (bf16, f32, "simt")):
        q = torch.zeros((8, 32, 64), dtype=q_dt)
        k = torch.zeros((8, 512, 8, 64), dtype=kv_dt)
        assert fd.variant(q, k) == want
        v = k.clone()
        fd.reset_launches()
        calls.clear()
        made.clear()
        out, m, l = ops.flash_decode(q, k, v,
                                     torch.ones(8, dtype=torch.int32))
        assert len(calls) == 1 and len(calls[0]) == n_args
        assert calls[0][12] == fd.n_splits(8, 8, 512, 132) == 5
        assert calls[0][2] == calls[0][0]           # out in q's dtype
        assert made == [(8, 32, 64), (2, 8, 32)]  # out; m and l
        assert out.shape == q.shape and out.dtype == q_dt
        assert m.shape == l.shape == (8, 32) and m.dtype == torch.float32
        assert fd.LAUNCHES == {"flash_decode": 1,
                               f"flash_decode_{want}": 1,
                               **{f"flash_decode_{o}": 0 for o in
                                  {"mma", "simt"} - {want}}}
    # bf16 q on a bf16 cache may ask the tensor-core variant for a
    # float32 out; no other pair may change out's dtype
    q = torch.zeros((8, 32, 64), dtype=bf16)
    k = torch.zeros((8, 512, 8, 64), dtype=bf16)
    calls.clear()
    out, _, _ = ops.flash_decode(q, k, k.clone(),
                                 torch.ones(8, dtype=torch.int32), f32)
    assert out.dtype == f32 and calls[0][:3] == (1, 1, 0)
    with pytest.raises(ValueError, match="out"):
        ops.flash_decode(q.float(), k, k.clone(),
                         torch.ones(8, dtype=torch.int32), bf16)


def test_flash_decode_plain_path_launches_nothing():
    fd.reset_launches()
    q, k, v, kv_len = decode_problem(DECODE_CASES[0])
    ops.flash_decode(*map(torch.from_numpy, (q, k, v, kv_len)))
    assert fd.LAUNCHES == {"flash_decode": 0, "flash_decode_mma": 0,
                           "flash_decode_simt": 0}
    with pytest.raises(ValueError):
        fd.flash_decode(*(torch.from_numpy(a).to("meta")
                          for a in (q, k, v, kv_len)))


#: chip_smoke.py's DECODE_EDGE_CASES, the cases the one-launch kernel
#: makes risky: kv_len 0 and kv_len > S, rows of very unequal length,
#: splits that get no tile, rep 1 / 8 / 32 (two head groups of 16), D 120,
#: 128 and 256
DECODE_EDGE_CASES = [
    (2, 256, 8, 2, 64, [0, 300]),
    (4, 4096, 32, 8, 64, [1, 4096, 65, 2000]),
    (1, 4096, 4, 1, 64, [70]),
    (2, 512, 8, 8, 64, [300, 512]),
    (2, 512, 16, 2, 64, [129, 7]),
    (1, 256, 32, 1, 64, [200]),
    (1, 300, 8, 2, 120, [250]),
    (1, 600, 8, 2, 128, [600]),
    (2, 300, 8, 1, 256, [257, 33]),
]
#: (q dtype, cache dtype) pairs, the serve path's, the cross path's and
#: the other two
DECODE_PAIRS = ["float32/float32", "bfloat16/bfloat16", "float32/bfloat16",
                "bfloat16/float32"]


def _pair(name):
    return tuple(getattr(torch, n) for n in name.split("/"))


@pytest.mark.parametrize("case", DECODE_EDGE_CASES)
def test_flash_decode_edge_cases_match_reference_oracle(case):
    """The port's flash decode (its plain version on the CPU) equals the
    reference's ``decode_reference`` at the edge cases, with kv_len past
    the cache taken as the whole cache and kv_len 0 as an empty row."""
    q, k, v, kv_len = decode_problem(case, seed=5)
    got = ops.flash_decode(*map(torch.from_numpy, (q, k, v, kv_len)))
    want = ref_decode_reference(*map(jnp.asarray, (q, k, v)),
                                kv_len=jnp.asarray(kv_len))
    full = kv_len > 0
    np.testing.assert_allclose(got[0].numpy()[full], np.asarray(want)[full],
                               rtol=2e-5, atol=2e-5)
    assert (got[0].numpy()[~full] == 0).all()
    assert (got[2].numpy()[full] > 0).all()


def test_flash_decode_float32_out_is_the_unrounded_sum():
    """A float32 out of bf16 q on a bf16 cache (the mesh path's, whose
    merge rounds once) is the plain version's float32 sum: rounded to bf16
    it is the default out bit for bit, and it is closer to float64 than
    that out; m and l are the same."""
    q, k, v, kv_len = decode_problem(GRANITE_CASE)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    kv_len = torch.from_numpy(kv_len)
    wide = ops.flash_decode(q, k, v, kv_len, torch.float32)
    narrow = ops.flash_decode(q, k, v, kv_len)
    assert wide[0].dtype == torch.float32
    assert torch.equal(wide[0].bfloat16(), narrow[0])
    assert torch.equal(wide[1], narrow[1]) and torch.equal(wide[2],
                                                           narrow[2])
    exact = ref.decode_reference(q.double(), k.double(), v.double(),
                                 kv_len)[0]
    assert (wide[0].double() - exact).abs().max() < \
        (narrow[0].double() - exact).abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("case", [GRANITE_CASE] + DECODE_EDGE_CASES)
def test_cuda_flash_decode_float32_out_matches_plain_on_card(case):
    """The tensor-core variant's float32 out against the plain version's
    float32 sum, within the float32 tolerance (the kernel rounds nothing
    to bf16 there, and the bf16 band is as wide as a long row's values);
    its bf16 rounding within one ulp of the default out; m and l
    identical to the default call's."""
    _card()
    q, k, v, kv_len = (torch.from_numpy(a).cuda()
                       for a in decode_problem(case, seed=5))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got = ops.flash_decode(q, k, v, kv_len, torch.float32)
    base = ops.flash_decode(q, k, v, kv_len)
    want = ref.decode_reference(q, k, v, kv_len, torch.float32)
    assert got[0].dtype == torch.float32
    tol = DECODE_DTYPES["float32"][2]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w.float(), rtol=tol, atol=tol)
    assert torch.equal(got[1], base[1]) and torch.equal(got[2], base[2])
    torch.testing.assert_close(got[0].bfloat16().float(), base[0].float(),
                               rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.gpu
@pytest.mark.parametrize("case",
                         DECODE_CASES + [GRANITE_CASE] + DECODE_EDGE_CASES)
@pytest.mark.parametrize("pair", DECODE_PAIRS)
def test_cuda_flash_decode_matches_plain_on_card(case, pair):
    """The kernel against its plain version at the decode cases and the
    edge cases in every dtype pair (the tolerance of q's dtype): one
    launch counted and one device kernel a call, and a second call
    bit-identical to the first."""
    _card()
    q_dt, kv_dt = _pair(pair)
    q, k, v, kv_len = (torch.from_numpy(a).cuda()
                       for a in decode_problem(case, seed=5))
    q, k, v = q.to(q_dt), k.to(kv_dt), v.to(kv_dt)
    tol = DECODE_DTYPES[str(q_dt)[6:]][2]
    before, kernels = dict(fd.LAUNCHES), fd.kernels_launched()
    got = ops.flash_decode(q, k, v, kv_len)
    again = ops.flash_decode(q, k, v, kv_len)
    kind = "flash_decode_" + fd.variant(q, k)
    assert fd.LAUNCHES["flash_decode"] == before["flash_decode"] + 2
    assert fd.LAUNCHES[kind] == before[kind] + 2
    assert fd.kernels_launched() == kernels + 2
    want = ref.decode_reference(q, k, v, kv_len)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)


# ========================================================= flash attention

#: tests/test_kernels.py's ATTN_CASES, then the prefill path's head shapes
#: (granite_3_2b's 32/8 x 64; h2o_danube_3_4b's 32/8 x 120 with a window):
#: (B, Sq, Skv, H, KVH, D, causal, window)
ATTN_CASES = [
    (1, 128, 128, 4, 4, 64, True, 0),
    (2, 256, 256, 8, 2, 64, True, 0),
    (1, 128, 128, 4, 2, 32, False, 0),
    (2, 256, 256, 4, 4, 64, True, 128),
    (1, 384, 384, 4, 2, 64, True, 96),
    (1, 192, 192, 2, 1, 16, True, 0),
    (1, 100, 100, 2, 2, 64, True, 0),
]
PATH_ATTN_CASES = [(1, 96, 96, 32, 8, 64, True, 0),
                   (1, 80, 80, 32, 8, 120, True, 32)]
#: edges of the wgmma variant's tiling (128 query rows = 128 / rep
#: positions x rep heads, 128-key tiles): rep 3 with D 128 (llama3_2_3b's
#: 24/8 x 128 heads: 42 positions, 126 rows), D 120 with a window smaller
#: than a tile, Sq not a multiple of the q tile, Sq != Skv (causal and
#: not, D 32 zero-filled to a 64-column panel), and B > 1 with rep 5 (25
#: positions), whose tile 125..149 puts the causal diagonal across the
#: key tiles' edge at 128 and a position across the two warpgroups
WGMMA_CASES = [(1, 100, 100, 24, 8, 128, True, 0),
               (1, 300, 300, 32, 8, 120, True, 40),
               (1, 77, 77, 8, 2, 64, True, 0),
               (1, 150, 260, 8, 4, 32, True, 0),
               (2, 96, 200, 8, 2, 64, False, 0),
               (2, 200, 200, 10, 2, 64, True, 0)]
#: the cases also held against the Pallas kernel in interpret mode (the
#: rest against ``repro.kernels.ref``: interpret mode is slow here)
PALLAS_ATTN = {ATTN_CASES[1], ATTN_CASES[4], ATTN_CASES[6]}
ATTN_DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
               "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def attn_problem(case, seed=0):
    b, sq, skv, h, kvh, d = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, skv, kvh, d), (b, skv, kvh, d))]


@pytest.mark.parametrize("case", ATTN_CASES + PATH_ATTN_CASES + WGMMA_CASES)
@pytest.mark.parametrize("dtype_name", sorted(ATTN_DTYPES))
def test_flash_attention_matches_reference(case, dtype_name):
    """The port's flash attention (its plain version on the CPU) equals
    the reference's oracle ``mha_reference`` and, for a few cases, its
    Pallas kernel in interpret mode, within 2e-5 in f32 and 2e-2 in
    bf16 (``tests/test_kernels.py``'s tolerances)."""
    j_dt, t_dt, tol = ATTN_DTYPES[dtype_name]
    causal, window = case[6], case[7]
    arrays = attn_problem(case)
    jq, jk, jv = (jnp.asarray(a).astype(j_dt) for a in arrays)
    got = ops.flash_attention(*(torch.from_numpy(a).to(t_dt)
                                for a in arrays), causal=causal,
                              window=window)
    assert got.dtype == t_dt and got.shape == arrays[0].shape
    want = ref_mha_reference(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    if case in PALLAS_ATTN:
        pallas = ref_ops.flash_attention(jq, jk, jv, causal=causal,
                                         window=window, interpret=True)
        np.testing.assert_allclose(_f32(got), _f32(pallas), rtol=tol,
                                   atol=tol)


def test_mha_reference_query_blocks_change_nothing():
    """The plain version takes the query axis in blocks of 1024 (to bound
    its f32 logits at full width): over 1100 queries, two blocks, it
    equals attention computed over the whole axis at once."""
    assert ref.MHA_BLOCK_Q == 1024
    for causal, window in ((True, 0), (True, 300), (False, 0)):
        q, k, v = map(torch.from_numpy, attn_problem(
            (1, 1100, 1100, 2, 1, 8), seed=1))
        got = ref.mha_reference(q, k, v, causal=causal, window=window)
        want = port_attn.dense_attention(q, k, v, causal=causal,
                                         window=window)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_flash_attention_plain_path_launches_nothing():
    fa.reset_launches()
    q, k, v = map(torch.from_numpy, attn_problem(ATTN_CASES[0]))
    for dtype in (torch.float32, torch.bfloat16):
        ops.flash_attention(q.to(dtype), k.to(dtype), v.to(dtype))
    assert fa.LAUNCHES == {"flash_attention": 0, "flash_attention_wgmma": 0,
                           "flash_attention_simt": 0}
    with pytest.raises(ValueError):
        fa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def test_flash_attention_checks_refuse_what_the_kernel_cannot_take():
    """The CUDA path's checks (run before any launch): head dims that are
    not multiples of 8 or above 128, mismatched GQA shapes, dtypes other
    than f32/bf16, and a negative window raise."""
    def problem(shape_q, shape_kv, dtype=torch.float32):
        return (torch.zeros(shape_q, dtype=dtype),
                torch.zeros(shape_kv, dtype=dtype),
                torch.zeros(shape_kv, dtype=dtype))
    fa._check(*problem((1, 8, 4, 120), (1, 8, 2, 120)), 0)
    for args, window in ((problem((1, 8, 4, 12), (1, 8, 2, 12)), 0),
                         (problem((1, 8, 4, 136), (1, 8, 2, 136)), 0),
                         (problem((1, 8, 4, 16), (1, 8, 3, 16)), 0),
                         (problem((1, 8, 4, 16), (1, 8, 2, 16),
                                  torch.float16), 0),
                         (problem((1, 8, 4, 16), (1, 8, 2, 16)), -1)):
        with pytest.raises(ValueError):
            fa._check(*args, window)


def test_flash_attention_variant_is_chosen_by_dtype(monkeypatch):
    """On a CUDA tensor the wrapper launches the wgmma kernel for bf16 q
    with bf16 k/v and the SIMT kernel for every other dtype pair, by
    dtype alone, counting the launch in the total and in its variant; a
    bf16 input beyond the wgmma kernel's tensor maps raises in
    ``_check`` and is not sent to the SIMT kernel.  The card is stood in
    for by a library that records which entry point was called, and with
    as many arguments as its ctypes signature declares."""
    calls = []
    lib = SimpleNamespace(
        flash_attention=lambda *a: calls.append(("simt", len(a))) or 0,
        flash_attention_wgmma=lambda *a: calls.append(("wgmma", len(a)))
        or 0)
    entry = {"simt": "flash_attention", "wgmma": "flash_attention_wgmma"}
    _fake_card(monkeypatch, fa, lib)
    bf16, f32 = torch.bfloat16, torch.float32
    for q_dt, kv_dt, want in ((bf16, bf16, "wgmma"), (f32, f32, "simt"),
                              (f32, bf16, "simt"), (bf16, f32, "simt")):
        q = torch.zeros((1, 8, 4, 16), dtype=q_dt)
        k = torch.zeros((1, 8, 2, 16), dtype=kv_dt)
        assert fa.variant(q, k) == want
        fa.reset_launches()
        calls.clear()
        ops.flash_attention(q, k, k.clone())
        n_args = len(build._SIGNATURES["flash_attention"][entry[want]])
        assert calls == [(want, n_args)]
        assert fa.LAUNCHES == {"flash_attention": 1,
                               "flash_attention_wgmma": int(want == "wgmma"),
                               "flash_attention_simt": int(want == "simt")}
    # a batch stride of 2**40 bytes: the SIMT kernel's checks take it in
    # float32, the wgmma kernel's refuse it in bf16
    fa.reset_launches()
    calls.clear()
    for dtype in (f32, bf16):
        q, k = (torch.empty((1, 2 ** 36, 1, 8), dtype=dtype, device="meta")
                for _ in range(2))
        if dtype == f32:
            fa._check(q, k, k, 0)
            continue
        with pytest.raises(ValueError, match="tensor maps"):
            fa.flash_attention(q, k, k)
    assert calls == [] and fa.LAUNCHES["flash_attention"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", ATTN_CASES + PATH_ATTN_CASES + WGMMA_CASES)
@pytest.mark.parametrize("dtype_name", sorted(ATTN_DTYPES))
def test_cuda_flash_attention_matches_plain_on_card(case, dtype_name):
    _card()
    _, t_dt, tol = ATTN_DTYPES[dtype_name]
    q, k, v = (torch.from_numpy(a).cuda().to(t_dt)
               for a in attn_problem(case))
    kind = "flash_attention_" + ("wgmma" if t_dt == torch.bfloat16
                                 else "simt")
    before = dict(fa.LAUNCHES)
    got = ops.flash_attention(q, k, v, causal=case[6], window=case[7])
    assert fa.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert fa.LAUNCHES[kind] == before[kind] + 1
    want = ref.mha_reference(q, k, v, causal=case[6], window=case[7])
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


def large_logit_problem(seed=11):
    """bf16 q (1, 128, 4, 128), k and v (1, 8192, 2, 128) whose scaled
    logits all lie near 2085 (3008 in log2 units) within a few units of
    each other, the first key holding the max: q = 8 and k = 23 + 0.125
    n (n in {-1, 0, 1}) make every product an integer, so q k^T is exact
    in any order.  v is +64 on the first half of the keys and -64 on the
    second, so an output moves by 64 times any drift between the weights
    of early and late key tiles."""
    rng = np.random.default_rng(seed)
    q = np.full((1, 128, 4, 128), 8.0, np.float32)
    n = rng.integers(-1, 2, size=(1, 8192, 2, 128)).astype(np.float32)
    n[:, 0] = 0.0
    n[:, 0, :, :40] = 1.0                # key 0: 8 units above the rest
    half = np.where(np.arange(8192) < 4096, 64.0, -64.0)[None, :, None, None]
    v = half + rng.standard_normal((1, 8192, 2, 128))
    return [torch.tensor(x, dtype=torch.float32).bfloat16()
            for x in (q, 23.0 + 0.125 * n, v)]


@pytest.mark.gpu
def test_cuda_flash_attention_rescale_is_exact_at_large_logits():
    """The wgmma kernel's online-softmax rescale between key tiles must be
    exactly 2^(ms_old - ms_new) of the scaled maxima it subtracted: one
    that keeps m_old c's float32 rounding (up to half an ulp of 3008)
    weighs the earlier tiles by it once more each of the 64 tiles, which
    moves these outputs about 3x the 2e-2 band."""
    _card()
    q, k, v = (t.cuda() for t in large_logit_problem())
    got = ops.flash_attention(q, k, v, causal=False)
    want = ref.mha_reference(q, k, v, causal=False)
    tol = ATTN_DTYPES["bfloat16"][2]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


#: query rows at a global offset (the sequence-parallel attention of a
#: mesh: each model rank's block of rows against the whole K/V):
#: (B, S, H, KVH, D, blocks, causal, window); the sequence is cut into
#: ``blocks`` blocks of rows, block i at q_offset i S / blocks.  llama's
#: 3/1 heads, granite's 4/2 with danube's window of 32, a window that
#: straddles the blocks, bidirectional with a window, and three blocks
#: whose offsets are not a multiple of the kernels' tiles
Q_OFFSET_CASES = [(2, 64, 3, 1, 16, 4, True, 0),
                  (2, 64, 4, 2, 16, 4, True, 32),
                  (1, 96, 4, 2, 16, 4, True, 40),
                  (1, 96, 4, 2, 16, 2, False, 24),
                  (1, 150, 8, 2, 32, 3, True, 0)]
#: the reference's ``dense_attention`` and ``chunked_attention`` take q
#: and k to float32 for the logits even under ``jax.enable_x64``, so a
#: float64 input is held to them at the float32 band too
Q_OFFSET_TOL = {"float32": 2e-5, "float64": 2e-5}


def q_offset_blocks(case, dtype, seed=3):
    """Whole q, k, v (torch, ``dtype``) of a ``Q_OFFSET_CASES`` case and
    its blocks of query rows: ``[(q_offset, rows)]``."""
    b, s, h, kvh, d, n = case[:6]
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)).to(dtype)
               for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d)))
    rows = s // n
    return q, k, v, [(i * rows, slice(i * rows, (i + 1) * rows))
                     for i in range(n)]


@pytest.mark.parametrize("case", Q_OFFSET_CASES)
@pytest.mark.parametrize("dtype_name", sorted(Q_OFFSET_TOL))
def test_mha_q_offset_matches_reference(case, dtype_name):
    """Each block of query rows at its ``q_offset``: the plain version's
    forward against the reference's ``dense_attention(q_offset=)`` and,
    without a window, ``chunked_attention(q_offset=)`` (the two branches
    of its sequence-parallel call), and ``mha_backward(q_offset=)``
    against ``jax.vjp`` of ``dense_attention``, in float32 and float64
    (the reference under ``jax.enable_x64``)."""
    from repro.models import attention as ref_attn
    causal, window = case[6], case[7]
    tol = Q_OFFSET_TOL[dtype_name]
    dtype = getattr(torch, dtype_name)
    q, k, v, blocks = q_offset_blocks(case, dtype)
    rng = np.random.default_rng(4)
    with jax.enable_x64(dtype_name == "float64"):
        jk, jv = jnp.asarray(k.numpy()), jnp.asarray(v.numpy())
        for off, rows in blocks:
            qb = q[:, rows].contiguous()
            jq = jnp.asarray(qb.numpy())
            got = ref.mha_reference(qb, k, v, causal=causal, window=window,
                                    q_offset=off)

            def dense(a, b_, c):
                return ref_attn.dense_attention(a, b_, c, causal=causal,
                                                window=window, q_offset=off)
            want, vjp = jax.vjp(dense, jq, jk, jv)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=tol, atol=tol)
            if not window:
                chunked = ref_attn.chunked_attention(
                    jq, jk, jv, causal=causal, kv_chunk=16, q_offset=off)
                np.testing.assert_allclose(got.numpy(), np.asarray(chunked),
                                           rtol=tol, atol=tol)
            dout = rng.standard_normal(qb.shape)
            grads = ref.mha_backward(qb, k, v, got, torch.from_numpy(
                dout).to(dtype), causal=causal, window=window, q_offset=off)
            for g, w in zip(grads, vjp(jnp.asarray(dout, jq.dtype))):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=tol, atol=tol)


@pytest.mark.parametrize("case", Q_OFFSET_CASES)
def test_q_offset_blocks_are_the_whole_call(case):
    """The blocks of query rows, each at its offset, concatenated, are the
    whole call (float64): forward, dq, and dk and dv summed over the
    blocks (each block's keys get the gradient of its rows)."""
    causal, window = case[6], case[7]
    q, k, v, blocks = q_offset_blocks(case, torch.float64)
    whole = ref.mha_reference(q, k, v, causal=causal, window=window)
    dout = torch.from_numpy(np.random.default_rng(5).standard_normal(
        q.shape))
    dq, dk, dv = ref.mha_backward(q, k, v, whole, dout, causal=causal,
                                  window=window)
    parts, dq_parts = [], []
    dk_sum, dv_sum = torch.zeros_like(k), torch.zeros_like(v)
    for off, rows in blocks:
        qb = q[:, rows].contiguous()
        out = ops.flash_attention(qb, k, v, causal=causal, window=window,
                                  q_offset=off)
        parts.append(out)
        g = ref.mha_backward(qb, k, v, out, dout[:, rows].contiguous(),
                             causal=causal, window=window, q_offset=off)
        dq_parts.append(g[0])
        dk_sum += g[1]
        dv_sum += g[2]
    torch.testing.assert_close(torch.cat(parts, 1), whole, rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(torch.cat(dq_parts, 1), dq, rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(dk_sum, dk, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dv_sum, dv, rtol=1e-12, atol=1e-12)


def test_flash_attention_q_offset_zero_is_the_call_without_it():
    """``q_offset=0`` is the call without it, bit for bit, forward and
    backward; a negative offset is refused before any launch."""
    q, k, v = map(torch.from_numpy, attn_problem(ATTN_CASES[3]))
    for causal, window in ((True, 0), (True, 128), (False, 0)):
        a = ops.flash_attention(q, k, v, causal=causal, window=window)
        b = ops.flash_attention(q, k, v, causal=causal, window=window,
                                q_offset=0)
        assert torch.equal(a, b)
        da = ref.mha_backward(q, k, v, a, q, causal=causal, window=window)
        db = ref.mha_backward(q, k, v, a, q, causal=causal, window=window,
                              q_offset=0)
        assert all(torch.equal(x, y) for x, y in zip(da, db))
    with pytest.raises(ValueError, match="q_offset"):
        fa._check(q, k, v, 0, -1)


@pytest.mark.gpu
@pytest.mark.parametrize("case", Q_OFFSET_CASES)
@pytest.mark.parametrize("dtype_name", sorted(ATTN_DTYPES))
def test_cuda_flash_attention_q_offset_matches_plain_on_card(case,
                                                             dtype_name):
    """Each block of rows at its offset through the kernel (wgmma for
    bf16, SIMT for float32) against the plain version on the same block,
    at the kernel tests' bands; the blocks together against one whole
    call of the kernel at the same band."""
    _card()
    _, t_dt, tol = ATTN_DTYPES[dtype_name]
    causal, window = case[6], case[7]
    q, k, v, blocks = q_offset_blocks(case, torch.float32)
    q, k, v = (t.cuda().to(t_dt) for t in (q, k, v))
    parts = []
    for off, rows in blocks:
        qb = q[:, rows].contiguous()
        got = ops.flash_attention(qb, k, v, causal=causal, window=window,
                                  q_offset=off)
        want = ref.mha_reference(qb, k, v, causal=causal, window=window,
                                 q_offset=off)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        parts.append(got)
    whole = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(torch.cat(parts, 1).float(), whole.float(),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
def test_cuda_wide_mm_gradient_is_the_products_in_the_inputs_dtype():
    """``blocks.wide_mm`` on the card (a float32 product of bf16 inputs,
    the partial sums a mesh all-reduces) has the gradient of the bf16
    product, bit for bit: ``torch.mm(out_dtype=)`` has no derivative of
    its own."""
    _card()
    from repro_torch.models.blocks import wide_mm
    gen = torch.Generator(device="cuda").manual_seed(0)
    a, b = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
            for shape in ((2, 96, 64), (64, 80)))
    g = torch.randn((2, 96, 80), generator=gen, device="cuda").bfloat16()
    ins = [t.clone().requires_grad_() for t in (a, b)]
    out = wide_mm(*ins)
    assert out.dtype == torch.float32
    got = torch.autograd.grad(out, ins, g.float())
    ref_ins = [t.clone().requires_grad_() for t in (a, b)]
    want = torch.autograd.grad(ref_ins[0] @ ref_ins[1], ref_ins, g)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


# ================================================================ ssd scan

#: tests/test_kernels.py's SSD_CASES, then mamba2_370m's head shape
#: (P 64, N 128) at the model's chunk of 256 over a ragged length:
#: (B, S, H, P, N, chunk)
SSD_CASES = [
    (1, 256, 2, 64, 64, 128),
    (2, 128, 4, 32, 64, 64),
    (1, 384, 2, 64, 128, 128),
    (1, 100, 2, 16, 32, 64),
]
PATH_SSD_CASES = [(1, 300, 2, 64, 128, 256)]
PALLAS_SSD = {SSD_CASES[1], SSD_CASES[3]}
#: (y tolerance, state tolerance) by dtype, ``tests/test_kernels.py``'s
SSD_DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4, 1e-3),
              "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2, 1e-3)}


def ssd_problem(case, seed=0):
    """x, dt = softplus(N(0,1)), a = -0.1 |N(0,1)|, B_, C_ as in
    ``tests/test_kernels.py``, drawn with numpy."""
    b, s, h, p, n = case[:5]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(np.float32)
    a = (-np.abs(rng.standard_normal((b, s, h))) * 0.1).astype(np.float32)
    B_ = rng.standard_normal((b, s, n)).astype(np.float32)
    C_ = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, a, B_, C_


def _ssd_torch(arrays, t_dt):
    x, dt, a, B_, C_ = map(torch.from_numpy, arrays)
    return x.to(t_dt), dt, a, B_.to(t_dt), C_.to(t_dt)


def _ssd_jax(arrays, j_dt):
    x, dt, a, B_, C_ = map(jnp.asarray, arrays)
    return x.astype(j_dt), dt, a, B_.astype(j_dt), C_.astype(j_dt)


@pytest.mark.parametrize("case", SSD_CASES + PATH_SSD_CASES)
@pytest.mark.parametrize("dtype_name", sorted(SSD_DTYPES))
def test_ssd_scan_matches_reference(case, dtype_name):
    """The port's SSD scan (its plain version on the CPU) equals the
    reference's ``ssd_reference`` and, for a few cases, its Pallas
    kernel in interpret mode: y within 1e-4 in f32 and 3e-2 in bf16, the
    final state within 1e-3 (``tests/test_kernels.py``)."""
    j_dt, t_dt, tol, s_tol = SSD_DTYPES[dtype_name]
    arrays = ssd_problem(case)
    y, state = ops.ssd_scan(*_ssd_torch(arrays, t_dt), chunk=case[5])
    assert y.dtype == t_dt and state.dtype == torch.float32
    jargs = _ssd_jax(arrays, j_dt)
    wants = [ref_ssd_reference(*jargs)]
    if case in PALLAS_SSD:
        wants.append(ref_ops.ssd_scan(*jargs, chunk=case[5], interpret=True))
    for y_want, s_want in wants:
        np.testing.assert_allclose(_f32(y), _f32(y_want), rtol=tol, atol=tol)
        np.testing.assert_allclose(state.numpy(), np.asarray(s_want),
                                   rtol=s_tol, atol=s_tol)


def test_ssd_scan_y_dtype_and_chunk_invariance():
    """y comes back in the dtype asked for (f32 from bf16 x, as the
    model's ``ssm_apply`` asks) and does not depend on the chunk (64,
    128, 256), as ``tests/test_kernels.py:test_ssd_chunk_invariance``
    holds the Pallas kernel."""
    args = _ssd_torch(ssd_problem((1, 256, 2, 32, 64), seed=2),
                      torch.bfloat16)
    y_bf, s_bf = ops.ssd_scan(*args, chunk=64)
    y_f32, s_f32 = ops.ssd_scan(*args, chunk=64, y_dtype=torch.float32)
    assert y_bf.dtype == torch.bfloat16 and y_f32.dtype == torch.float32
    assert torch.equal(y_f32.bfloat16(), y_bf) and torch.equal(s_bf, s_f32)
    args = _ssd_torch(ssd_problem((1, 256, 2, 32, 64), seed=3),
                      torch.float32)
    y64, s64 = ops.ssd_scan(*args, chunk=64)
    for chunk in (128, 256):
        y, s = ops.ssd_scan(*args, chunk=chunk)
        torch.testing.assert_close(y, y64, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(s, s64, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("chunk", [64, 128, 256])
def test_ssd_scan_matches_model_chunked_impl(chunk):
    """The scan and the model's plain chunked ``ssd_chunked`` (the port's
    and the reference's) agree at every chunk: the kernel can stand in
    for it, as ``tests/test_kernels.py`` holds the Pallas kernel."""
    arrays = ssd_problem((1, 256, 2, 32, 64), seed=4)
    args = _ssd_torch(arrays, torch.float32)
    y, state = ops.ssd_scan(*args, chunk=chunk)
    y_model, s_model = port_ssm.ssd_chunked(*args, chunk)
    torch.testing.assert_close(y, y_model, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(state, s_model, rtol=1e-3, atol=1e-3)
    y_ref, s_ref = ref_ssd_chunked(*_ssd_jax(arrays, jnp.float32), chunk)
    np.testing.assert_allclose(y_model.numpy(), np.asarray(y_ref),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s_model.numpy(), np.asarray(s_ref),
                               rtol=1e-4, atol=1e-4)


def test_ssd_scan_plain_path_launches_nothing_and_checks():
    ssd.reset_launches()
    args = _ssd_torch(ssd_problem(SSD_CASES[3]), torch.float32)
    ops.ssd_scan(*args, chunk=64)
    assert ssd.LAUNCHES == {"ssd_scan": 0, "ssd_scan_mma": 0,
                            "ssd_scan_simt": 0}
    with pytest.raises(ValueError):
        ssd.ssd_scan(*(t.to("meta") for t in args))
    ssd._check(*args, 64, torch.float32)
    x, dt, a, B_, C_ = args
    for bad in ((x, dt, a, B_, C_, 512, torch.float32),
                (x, dt.double(), a, B_, C_, 64, torch.float32),
                (x, dt, a, B_.bfloat16(), C_, 64, torch.float32),
                (x[..., :12].contiguous(), dt, a, B_, C_, 64, torch.float32),
                (x, dt, a, B_, C_, 64, torch.float16)):
        with pytest.raises(ValueError):
            ssd._check(*bad)


def test_ssd_chunk_states_shape():
    """The chunk-parallel variant's scratch: every chunk's state (B,
    chunks, H, N, P) and each chunk's decay (B, chunks, H), f32, chunks
    rounded up over a ragged last one; 134 MB at mamba2_370m's prefill."""
    states, decay = ssd.chunk_states_shape(8, 4096, 32, 128, 64, 256)
    assert states == (8, 16, 32, 128, 64) and decay == (8, 16, 32)
    assert np.prod(states) * 4 == 134_217_728
    assert ssd.chunk_states_shape(1, 300, 2, 128, 64, 256)[0] == \
        (1, 2, 2, 128, 64)
    assert ssd.chunk_states_shape(2, 100, 3, 32, 16, 256) == \
        ((2, 1, 3, 32, 16), (2, 1, 3))


def test_ssd_scan_dispatch_matches_its_ctypes_signature(monkeypatch):
    """On a CUDA tensor the wrapper makes one call of the C entry point
    with as many arguments as its ctypes signature declares; bf16 x
    takes the chunk-parallel variant and hands it scratch of
    ``chunk_states_shape``, f32 x the FMA variant and null scratch; one
    launch counted in the total and in the variant."""
    calls = []
    lib = SimpleNamespace(ssd_scan=lambda *a: calls.append(a) or 0)
    _fake_card(monkeypatch, ssd, lib)
    made = []
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: made.append(
        tuple(a[0])) or real_empty(*a, **kw))
    n_args = len(build._SIGNATURES["ssd_scan"]["ssd_scan"])
    for dtype, want in ((torch.bfloat16, "mma"), (torch.float32, "simt")):
        args = _ssd_torch(ssd_problem((1, 300, 2, 64, 128)), dtype)
        assert ssd.variant(args[0]) == want
        ssd.reset_launches()
        calls.clear()
        made.clear()
        y, state = ops.ssd_scan(*args, chunk=256, y_dtype=torch.float32)
        assert len(calls) == 1 and len(calls[0]) == n_args
        scratch = calls[0][9:11]
        if want == "mma":
            assert all(scratch) and made[2:] == list(
                ssd.chunk_states_shape(1, 300, 2, 128, 64, 256))
        else:
            assert scratch == (None, None) and len(made) == 2
        assert y.shape == args[0].shape and state.shape == (1, 2, 128, 64)
        assert ssd.LAUNCHES == {"ssd_scan": 1, f"ssd_scan_{want}": 1,
                                **{f"ssd_scan_{o}": 0 for o in
                                   {"mma", "simt"} - {want}}}


#: chip_smoke.py's SSD_EDGE_CASES, the cases the chunk-parallel scan makes
#: risky: ragged last chunks, S < chunk, a single chunk, chunks 64 / 128 /
#: 256 with N 32 / 128 and P 16 / 64, and N 40 with P 24:
#: (B, S, H, P, N, chunk)
SSD_EDGE_CASES = [
    (1, 300, 2, 64, 128, 256),
    (2, 200, 3, 32, 64, 64),
    (1, 100, 2, 64, 128, 256),
    (2, 256, 2, 64, 128, 256),
    (1, 512, 2, 16, 32, 64),
    (1, 512, 4, 64, 128, 128),
    (1, 640, 2, 16, 128, 256),
    (2, 384, 2, 64, 32, 128),
    (1, 200, 2, 24, 40, 64),
]
#: (x dtype, y dtype) pairs: f32, bf16 with y in bf16 and in f32 (the
#: model's ssm_apply)
SSD_PAIRS = ["float32/float32", "bfloat16/bfloat16", "bfloat16/float32"]


@pytest.mark.parametrize("case", SSD_EDGE_CASES)
def test_ssd_scan_edge_cases_match_model_chunked_impl(case):
    """At the edge cases the port's scan (its plain version on the CPU)
    equals the reference's ``ssd_chunked`` at the chunk given (the whole
    sequence where the chunk does not divide it, as ``ssd_chunked``
    does): y within 1e-4, the final state within 1e-3."""
    arrays = ssd_problem(case, seed=6)
    y, state = ops.ssd_scan(*_ssd_torch(arrays, torch.float32),
                            chunk=case[5])
    y_ref, s_ref = ref_ssd_chunked(*_ssd_jax(arrays, jnp.float32), case[5])
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(state.numpy(), np.asarray(s_ref), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("case",
                         SSD_CASES + PATH_SSD_CASES + SSD_EDGE_CASES)
@pytest.mark.parametrize("pair", SSD_PAIRS)
def test_cuda_ssd_scan_matches_plain_on_card(case, pair):
    """The kernels against the plain recurrence at the SSD cases and the
    edge cases: y in the dtype asked for within x's tolerance, the state
    within 1e-3, one launch counted in x's variant (three device kernels
    for the chunk-parallel one, one for the FMA one)."""
    _card()
    x_dt, y_dt = _pair(pair)
    _, _, tol, s_tol = SSD_DTYPES[str(x_dt)[6:]]
    args = [t.cuda() for t in _ssd_torch(ssd_problem(case, seed=6), x_dt)]
    before, kernels = dict(ssd.LAUNCHES), ssd.kernels_launched()
    y, state = ops.ssd_scan(*args, chunk=case[5], y_dtype=y_dt)
    kind = "ssd_scan_" + ssd.variant(args[0])
    assert ssd.LAUNCHES["ssd_scan"] == before["ssd_scan"] + 1
    assert ssd.LAUNCHES[kind] == before[kind] + 1
    assert ssd.kernels_launched() == kernels + (3 if kind.endswith("mma")
                                                else 1)
    assert y.dtype == y_dt
    y_want, s_want = ref.ssd_reference(*args)
    torch.testing.assert_close(y.float(), y_want, rtol=tol, atol=tol)
    torch.testing.assert_close(state, s_want, rtol=s_tol, atol=s_tol)
