"""The port's ``launch/roofline.py`` against the reference's, and the
yardsticks it defines once: the H100's peaks, each kernel's operations
and bytes (``kernels/*.cost``), the model FLOPs of a train step and the
kernel calls of a path; and the kernel wrappers' dry-run branch.

The reference side runs once, in one subprocess (``tests/conftest.py``
``run_devices``): ``model_flops`` of every configuration, shape and chip
count, and ``Roofline``'s properties with its module constants set to
the port's (the H100's), so that the port's formulas are held to the
reference's at the port's peaks.
"""
from __future__ import annotations

import functools
import json
import math

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import trace
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch import roofline as rl
from repro_torch.launch import steps
from repro_torch.models.blocks import count_params
from repro_torch.models.model import model_defs
from tests.conftest import run_devices

CHIPS = (1, 16, 256, 512)

#: synthetic roofline cases: (flops, bytes, collective bytes, link,
#: model flops); each dominated by another term
CASES = {"compute": (5e15, 1e11, 1e9, "nvlink", 2e15),
         "memory": (1e12, 8e12, 1e9, "ib", 4e11),
         "collective": (1e12, 1e11, 6e11, "ib", 5e11),
         "collective_nvlink": (1e12, 1e11, 6e11, "nvlink", 5e11),
         "idle": (0.0, 0.0, 0.0, "ib", 0.0)}

REF_SRC = r"""
import json
from repro.configs.base import ARCH_IDS, get_config
from repro.launch import roofline as R
from repro.launch.steps import SHAPE_TABLE
from repro.models.blocks import count_params
from repro.models.model import model_defs

flops = {}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    n = count_params(model_defs(cfg))
    for shape, info in SHAPE_TABLE.items():
        for chips in %(chips)r:
            flops[f"{arch}/{shape}/{chips}"] = R.model_flops(cfg, info, n,
                                                             chips)
props = {}
R.PEAK_FLOPS, R.HBM_BW = %(peak)r, %(hbm)r
for name, (f, b, c, link, mf) in %(cases)r.items():
    R.LINK_BW = %(links)r[link]
    r = R.Roofline("a", "s", "m", 16, f, b, c, {}, mf, {})
    props[name] = {k: getattr(r, k) for k in (
        "t_compute", "t_memory", "t_collective", "bottleneck",
        "useful_flops_ratio", "roofline_fraction")}
print("REF " + json.dumps({"flops": flops, "props": props}))
"""


@functools.lru_cache(maxsize=None)
def reference():
    out = run_devices(REF_SRC % dict(
        chips=CHIPS, peak=rl.PEAK_FLOPS[torch.bfloat16], hbm=rl.HBM_BW,
        cases=CASES, links=rl.LINK_BW), n_devices=16, timeout=600)
    return json.loads(out.split("REF ", 1)[1])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_reference(arch):
    """The reference's 6 N D / 2 N D / 2 N formula (MoE: active experts),
    bit for bit, at every shape and chip count."""
    cfg = get_config(arch)
    n = count_params(model_defs(cfg))
    want = reference()["flops"]
    for shape, info in steps.SHAPE_TABLE.items():
        for chips in CHIPS:
            assert rl.model_flops(cfg, info, n, chips) \
                == want[f"{arch}/{shape}/{chips}"], (shape, chips)


@pytest.mark.parametrize("case", sorted(CASES))
def test_roofline_properties_follow_reference(case):
    """Every property of ``Roofline`` is the reference's formula at the
    H100's peaks: bf16 compute, HBM, and the rate of the one link the
    case's collectives take."""
    f, b, c, link, mf = CASES[case]
    port = rl.Roofline("a", "s", "m", 16, f, b, c,
                       {"by_link": {link: c}}, mf, {})
    want = reference()["props"][case]
    for key, value in want.items():
        got = getattr(port, key)
        if isinstance(value, str):
            assert got == value, key
        else:
            assert got == pytest.approx(value, rel=1e-15, abs=0), key
    d = port.to_dict()
    assert d["t_compute_s"] == port.t_compute
    assert d["bottleneck"] == want["bottleneck"]


def test_collective_time_charges_each_link_its_rate():
    r = rl.Roofline("a", "s", "m", 256, 0.0, 0.0, 5e11,
                    {"by_link": {"nvlink": 4.5e11, "ib": 5e10}}, 0.0, {})
    assert r.t_collective == pytest.approx(4.5e11 / rl.NVLINK_BW
                                           + 5e10 / rl.IB_BW)
    assert r.t_collective == pytest.approx(2.0)


def test_the_peaks_are_the_h100_datasheet_values():
    """The values chip_smoke.py and tools/chip_mesh.py held before they
    moved into the package."""
    assert rl.PEAK_FLOPS == {torch.bfloat16: 989e12, torch.float32: 67e12,
                             torch.float64: 34e12}
    assert (rl.HBM_BW, rl.NVLINK_BW, rl.IB_BW, rl.NODE_CARDS) \
        == (3.35e12, 450e9, 50e9, 8)


def test_links_follow_the_nodes_of_eight_cards():
    """On the pod a ``model`` line (16 consecutive ranks) spans two nodes,
    a ``data`` line (stride 16) sixteen; a group of one node's ranks is
    NVLink's."""
    assert rl.link(range(16)) == "ib"
    assert rl.link(range(0, 256, 16)) == "ib"
    assert rl.link((0, 256)) == "ib"
    assert rl.link(range(8, 16)) == "nvlink"
    assert rl.link((0, 1, 2, 3)) == "nvlink"
    assert rl.link((0, 4, 8, 12)) == "ib"


def test_summarize_sums_collectives_by_kind_and_link():
    cfg = get_config("granite_3_2b")
    counts = {"flops": 10, "bytes": 20, "argument_bytes": 3,
              "peak_bytes": 7, "collectives": [
                  {"kind": "all-gather", "link": "ib", "calls": 2,
                   "bytes": 100},
                  {"kind": "all-gather", "link": "nvlink", "calls": 1,
                   "bytes": 40},
                  {"kind": "all-reduce", "link": "ib", "calls": 3,
                   "bytes": 9}]}
    r = rl.summarize(counts, cfg, "decode_32k",
                     steps.SHAPE_TABLE["decode_32k"], "pod", 256, 1000)
    assert r.coll_bytes_per_device == 149
    assert r.coll_detail == {"bytes": {"all-gather": 140, "all-reduce": 9},
                             "counts": {"all-gather": 3, "all-reduce": 3},
                             "total_bytes": 149,
                             "by_link": {"nvlink": 40, "ib": 109}}
    assert r.memory_stats == {"argument_bytes": 3, "peak_bytes": 7}
    assert r.model_flops_per_device == rl.model_flops(
        cfg, steps.SHAPE_TABLE["decode_32k"], 1000, 256)


#: ``chip_smoke.py``'s ``model_flops(cfg, 2, 4096)`` and launch formulas
#: before they moved into the package (``train_step_flops``,
#: ``train_launches(cfg, 2)``, ``path_launches``)
BEFORE = {
    "mixtral_8x7b": (653026155036672.0, {"flash_attention": 128}, 32,
                     (32, 0)),
    "qwen3_moe_235b_a22b": (1215199256248320.0, {"flash_attention": 376},
                            94, (94, 0)),
    "granite_3_2b": (141024747847680, {"flash_attention": 160}, 40, (40, 0)),
    "llama3_2_3b": (175234464350208, {"flash_attention": 112}, 28, (28, 0)),
    "h2o_danube_3_4b": (207251130286080, {"flash_attention": 96}, 24,
                        (24, 0)),
    "qwen1_5_110b": (5536933862178816, {"flash_attention": 320}, 80,
                     (80, 0)),
    "whisper_medium": (38504868347904, {"flash_attention": 288}, 48,
                       (72, 0)),
    "mamba2_370m": (19995731951616, {"ssd_scan": 192}, 0, (0, 48)),
    "internvl2_26b": (1006027501731840, {"flash_attention": 192}, 48,
                      (48, 0)),
    "jamba_v0_1_52b": (581729474052096.0, {"flash_attention": 16,
                                           "ssd_scan": 112}, 4, (4, 28)),
}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_step_flops_and_launches_are_unchanged(arch):
    cfg = get_config(arch)
    flops, train, decode, (attn, scan) = BEFORE[arch]
    assert rl.train_step_flops(cfg, 2, 4096) == flops
    assert rl.train_launches(cfg, 2) == train
    assert rl.path_launches(cfg, decode=True) == {"flash_decode": decode}
    assert rl.path_launches(cfg, decode=False) == {"flash_attention": attn,
                                                   "ssd_scan": scan}


@pytest.mark.parametrize("sq,skv,causal,window,q_offset", [
    (1, 1, True, 0, 0), (100, 100, True, 0, 0), (100, 100, True, 7, 0),
    (64, 300, True, 0, 200), (64, 300, True, 33, 150), (50, 80, False, 0, 0),
    (50, 80, False, 9, 3), (10, 20, True, 0, 40)])
def test_attention_pairs_are_the_mask_s_kept_pairs(sq, skv, causal, window,
                                                   q_offset):
    """``attn_pairs`` against the plain version's mask counted whole."""
    qpos = torch.arange(sq)[:, None] + q_offset
    kpos = torch.arange(skv)[None, :]
    keep = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        keep &= kpos <= qpos
    if window:
        keep &= kpos > qpos - window
    assert fa.attn_pairs(sq, skv, causal, window, q_offset) \
        == int(keep.sum())


def test_kernel_costs_are_unchanged():
    """``kernels/*.cost`` at the values ``chip_smoke.py``'s bounds counted
    before they moved into the package."""
    q = torch.empty(2, 1000, 8, 64, dtype=torch.bfloat16)
    k = torch.empty(2, 1000, 2, 64, dtype=torch.bfloat16)
    assert fa.cost(q, k, True, 0) == (2050048000, 5120000)
    assert fa.cost(q, k, True, 100, 37) == (398721024, 5120000)
    assert fa.cost(q, k, False, 0) == (4096000000, 5120000)
    qd = torch.empty(3, 8, 64, dtype=torch.bfloat16)
    kd = torch.empty(3, 500, 2, 64, dtype=torch.bfloat16)
    assert fd.cost(qd, kd, 800) == (1638400, 415936)
    x = torch.empty(2, 300, 4, 64, dtype=torch.bfloat16)
    b = torch.empty(2, 300, 128, dtype=torch.bfloat16)
    assert ssd.cost(x, b, 128, torch.float32) == (105526272, 1510144)
    assert ssd.cost(x.float(), b.float(), 64, torch.bfloat16) \
        == (92943360, 1817344)


def test_ssd_ops_sum_the_chunks():
    b, s, h, p, n, chunk = 2, 300, 4, 64, 128, 128
    lens = (128, 128, 44)
    want = sum(b * ln * (ln + 1) * n + b * h * (ln * (ln + 1) * p
                                               + 4 * ln * n * p)
               for ln in lens)
    assert ssd.ssd_ops(b, s, h, p, n, chunk) == want


# ------------------------------------------------ the wrappers' fake branch

def _launches():
    return (dict(fa.LAUNCHES), dict(fd.LAUNCHES), dict(ssd.LAUNCHES))


def _inputs(rng, device):
    """One input set for each wrapper: drawn from ``rng`` on the CPU, or,
    with no ``rng``, empty (a fake tensor's) on ``device``."""
    def t(*shape, dtype=torch.bfloat16):
        if rng is None:
            return torch.empty(shape, dtype=dtype, device=device)
        return torch.tensor(rng.standard_normal(shape), dtype=dtype)
    b, s, h, kvh, d = 2, 96, 8, 2, 64
    attn = (t(b, s, h, d), t(b, s, kvh, d), t(b, s, kvh, d))
    kv_len = t(b, dtype=torch.int32) if rng is None else torch.tensor(
        [128, 77], dtype=torch.int32)
    dec = (t(b, h, d), t(b, 128, kvh, d), t(b, 128, kvh, d), kv_len)
    n, p = 16, 32
    scan = (t(b, s, 4, p), t(b, s, 4, dtype=torch.float32),
            t(b, s, 4, dtype=torch.float32), t(b, s, n), t(b, s, n))
    if rng is not None:
        scan = (scan[0], scan[1].abs(), -scan[2].abs(), *scan[3:])
    return attn, dec, scan


def _call_all(attn, dec, scan):
    return (fa.flash_attention(*attn, causal=True, window=0),
            fd.flash_decode(*dec),
            fd.flash_decode(*dec, out_dtype=torch.float32),
            ssd.ssd_scan(*scan, chunk=32, y_dtype=torch.float32),
            ssd.ssd_scan(*scan, chunk=32))


def _meta(out):
    if isinstance(out, torch.Tensor):
        return (tuple(out.shape), out.dtype)
    return tuple(_meta(o) for o in out)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_fake_tensors_take_the_counting_branch(device):
    """A fake tensor (on the card's device or the CPU) through each of
    the three wrappers: the plain version's output shapes and dtypes, no
    launch counted, and each call's cost added to the dry run's count;
    a real CPU tensor takes the plain version and counts nothing."""
    real = _inputs(np.random.default_rng(0), "cpu")
    want = _meta(_call_all(*real))
    before = _launches()
    mode = FakeTensorMode()
    with mode:
        fake = _inputs(None, device)
    with trace.counting() as counts, mode:
        got = _meta(_call_all(*fake))
    assert got == want
    assert _launches() == before
    attn, dec, scan = fake
    assert counts.kernels == {
        "flash_attention": [1, *fa.cost(attn[0], attn[1], True, 0)],
        "flash_decode": [2, *(2 * v for v in fd.cost(dec[0], dec[1],
                                                     2 * 128))],
        "ssd_scan": [2, *(a + b for a, b in zip(
            ssd.cost(scan[0], scan[3], 32, torch.float32),
            ssd.cost(scan[0], scan[3], 32, torch.bfloat16)))]}
    with trace.counting() as counts:
        _call_all(*real)
    assert counts.kernels == {} and _launches() == before


def test_fake_branch_keeps_the_kernels_limits():
    """A shape the kernel cannot take raises on a fake tensor too."""
    with FakeTensorMode():
        q = torch.empty(1, 8, 2, 12, dtype=torch.bfloat16, device="cuda")
        with pytest.raises(ValueError, match="head dim"):
            fa.flash_attention(q, q, q)
        with pytest.raises(ValueError, match="head dim"):
            fd.flash_decode(torch.empty(1, 2, 12, dtype=torch.bfloat16,
                                        device="cuda"), q, q,
                            torch.empty(1, dtype=torch.int32,
                                        device="cuda"))


def test_public_wrappers_reach_the_fake_branch_under_autograd():
    """``ops.flash_attention`` and ``ops.ssd_scan`` go through their
    autograd Functions: a fake CPU tensor that requires a gradient runs
    the counting forward and the plain backward (``kernels/ref.py``)."""
    mode = FakeTensorMode()
    with trace.counting() as counts, mode:
        q = torch.empty(1, 64, 4, 16, requires_grad=True)
        k = torch.empty(1, 64, 2, 16, requires_grad=True)
        out = ops.flash_attention(q, k, k)
        out.sum().backward()
        assert q.grad.shape == q.shape and k.grad.shape == k.shape
    assert counts.kernels["flash_attention"][0] == 1


def test_counting_records_nothing_outside_a_dry_run():
    trace.kernel("flash_attention", 1, 2)
    trace.collective("all-reduce", 4, (0, 1))
    assert trace.ACTIVE is None
    with trace.counting() as counts:
        with pytest.raises(RuntimeError):
            with trace.counting():
                pass
    assert counts.kernels == {} and counts.collectives == {}


def test_tally_counts_bytes_views_and_the_peak():
    """Each aten op's arguments read once and results written once; a
    view 0; the peak of live storage, the held arguments included."""
    with FakeTensorMode():
        a = torch.empty(4, 8)
        b = torch.empty(8, 2)
        with trace.Tally(a, b) as t:
            c = a @ b                   # 128 + 64 read, 32 written
            d = c.view(-1)              # a view: 0
            d.add_(1.0)                 # 32 read, 32 written
            e = torch.empty(1000)       # an allocation: 0
            del e
            f = c.t().contiguous()      # a copy: 32 + 32
        assert t.bytes == 224 + 64 + 64
        assert t.flops == 2 * 4 * 8 * 2
        assert t.peak == 128 + 64 + 32 + 4000
        del c, d
        assert t.current == 128 + 64 + math.prod(f.shape) * 4


def test_reference_kernel_plain_versions_are_untouched_by_counting():
    """The plain versions count nothing and match themselves inside and
    outside ``counting()`` (the dry run changes no real path)."""
    rng = np.random.default_rng(1)
    attn, _, _ = _inputs(rng, "cpu")
    want = ref.mha_reference(*attn, causal=True)
    with trace.counting() as counts:
        got = fa.flash_attention(*attn, causal=True)
    assert torch.equal(got, want) and counts.kernels == {}
