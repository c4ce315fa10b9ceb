"""The port's dry run (``launch/dryrun.py``; ``launch/steps.lowering_spec``
and ``lower_cell``; ``launch/mesh.fake_world``) against the reference's.

The reference side (``tests/_torch_dryrun_ref.py``) runs once, in one
subprocess on 16 forced host devices, in a thread so that the port's
cells trace meanwhile.

The port's full-width cells run through the CLI, one subprocess a cell,
started with the module.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import threading

import pytest
import torch.distributed as dist

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.launch import roofline as rl
from repro_torch.launch import steps
from repro_torch.launch.mesh import (abstract_mesh, fake_world,
                                     production_shape, single_device_mesh)
from repro_torch.models.blocks import count_params
from repro_torch.models.model import model_defs
from tests._torch_dryrun_ref import SMOKE_ARCHS, SMOKE_TABLE, run_reference
from tests.conftest import REPO, SRC

#: the full-width cells run through the CLI: (arch, shape, mesh)
CLI_CELLS = (("granite_3_2b", "train_4k", "pod"),
             ("granite_3_2b", "prefill_32k", "pod"),
             ("granite_3_2b", "decode_32k", "pod"),
             ("granite_3_2b", "long_500k", "pod"),
             ("granite_3_2b", "decode_32k", "multipod"))
#: a cell made to fail: a head dim the decode kernel cannot take
FAILING = ("granite_3_2b", "decode_32k", "pod", "head_dim=12")


class Background:
    """The module's subprocesses: the reference in a thread, each CLI
    cell a process, all started at once."""

    def __init__(self, out_dir):
        self.out_dir = out_dir
        self.ref = {}
        self.thread = threading.Thread(target=self._reference, daemon=True)
        self.thread.start()
        env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
                   + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
        self.procs = {}
        for arch, shape, mesh in CLI_CELLS:
            self.procs[(arch, shape, mesh)] = self._cli(
                env, "--arch", arch, "--shape", shape, "--mesh", mesh,
                "--out", str(out_dir))
        arch, shape, mesh, kv = FAILING
        self.procs["failing"] = self._cli(
            env, "--arch", arch, "--shape", shape, "--mesh", mesh, "--set",
            kv, "--out", str(out_dir / "failing"))

    @staticmethod
    def _cli(env, *args):
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)

    def _reference(self):
        try:
            self.ref.update(run_reference())
        except Exception as e:  # noqa: BLE001 — raised in the tests
            self.ref["error"] = repr(e)

    def reference(self):
        self.thread.join(timeout=900)
        assert "error" not in self.ref, self.ref.get("error")
        return self.ref

    def finish(self, key):
        """``(exit code, output)`` of a CLI process, waited for."""
        proc = self.procs[key]
        out, _ = proc.communicate(timeout=900)
        return proc.returncode, out

    def record(self, arch, shape, mesh, sub=""):
        code, out = self.finish((arch, shape, mesh))
        assert code == 0, out[-3000:]
        path = self.out_dir / sub / f"{arch}-{shape}-{mesh}.json"
        return json.loads(path.read_text())


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory):
    bg = Background(tmp_path_factory.mktemp("dryrun"))
    yield bg
    for proc in bg.procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    bg.thread.join(timeout=900)


@functools.lru_cache(maxsize=None)
def smoke_cell(arch, shape):
    """The port's trace of a smoke cell on rank 0 of a (4, 4) fake
    world, and its ``LoweringSpec``'s fields."""
    cfg = get_config(arch, smoke=True)
    with fake_world((4, 4), ("data", "model")) as mesh:
        counts, spec = steps.lower_cell(cfg, shape, mesh, table=SMOKE_TABLE)
    return counts, spec.accum


# ---------------------------------------------------------------- tables

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_runnable_params_and_accum_match_reference(arch, background):
    """Every shape on the pod and the multipod: the reference's
    ``shape_runnable``, parameter count, step kind and the train step's
    microbatches after its clamp."""
    table = background.reference()["table"]
    cfg = get_config(arch)
    for name in ("pod", "multipod"):
        mesh = abstract_mesh(*production_shape(name == "multipod"))
        for shape, info in steps.SHAPE_TABLE.items():
            want = table[f"{arch}/{shape}/{name}"]
            assert steps.shape_runnable(cfg, shape)[0] == want["runnable"]
            assert count_params(model_defs(cfg)) == want["n_params"]
            assert info["kind"] == want["kind"]
            if info["kind"] == "train":
                assert steps.cell_accum(cfg, info, mesh) == want["accum"]


# ----------------------------------------------------------- smoke cells

@pytest.mark.parametrize("arch", SMOKE_ARCHS)
@pytest.mark.parametrize("shape", tuple(SMOKE_TABLE))
def test_argument_bytes_match_reference(arch, shape, background):
    """The trace's argument bytes on (4, 4) equal the reference's compiled
    ``argument_size_in_bytes`` and this rank's ``input_specs`` sum."""
    counts, _ = smoke_cell(arch, shape)
    cfg = get_config(arch, smoke=True)
    specs = steps.input_specs(cfg, shape, abstract_mesh((4, 4),
                                                        ("data", "model")),
                              table=SMOKE_TABLE)
    assert counts["argument_bytes"] == sum(steps.spec_bytes(t)
                                           for t in specs)
    want = background.reference()["cells"][f"{arch}/{shape}"]
    assert counts["argument_bytes"] == want["argument_bytes"]


def test_granite_train_flops_within_band_of_reference(background):
    """The product FLOPs a rank lie in [0.5, 1.0] of the reference's
    ``probe_terms`` FLOPs (XLA's count, elementwise work included).
    Without the backward the ratio would read near 0.23, without the
    second microbatch near 0.35."""
    counts, accum = smoke_cell("granite_3_2b", "train_4k")
    assert accum == 2
    want = background.reference()["cells"]["granite_3_2b/train_4k"]["flops"]
    assert 0.5 <= counts["flops"] / want <= 1.0


def test_mixtral_train_flops_reach_the_band_s_floor(background):
    """mixtral's smoke step: at least 0.5 of the reference's FLOPs (the
    band's floor, which a missing backward or microbatch would break).
    Its products exceed the reference's whole count (1.053 of it, the
    band's ceiling not held): the plain attention backward
    (``ref.mha_backward``) computes every key of a 1024-row block's band,
    so at a window of 32 over 256 positions its five products take the
    whole 256 x 256 square, 84 M of the step's 479 M product FLOPs."""
    counts, accum = smoke_cell("mixtral_8x7b", "train_4k")
    assert accum == 2
    want = background.reference()["cells"]["mixtral_8x7b/train_4k"]["flops"]
    assert counts["flops"] / want >= 0.5


def _by_kind(counts):
    out = {}
    for c in counts["collectives"]:
        key = (c["kind"], tuple(c["ranks"]))
        calls, n = out.get(key, (0, 0))
        out[key] = (calls + c["calls"], n + c["bytes"])
    return out


DATA, MODEL = (0, 4, 8, 12), (0, 1, 2, 3)


def test_train_collectives_match_a_hand_count():
    """granite smoke (D 64, 4 q heads and 2 kv heads of 16, d_ff 128,
    vocab 257, 2 layers, remat of whole blocks), 16 x 256 in 2
    microbatches, on (4, 4): rank 0's collectives, counted from the
    step's own code.  r = 2 rows a microbatch, S = 256; bf16 = 2 bytes,
    f32 = 4."""
    bf, f32, d, ff, v, hd, r, s, layers, mb = 2, 4, 64, 128, 257, 16, 2, \
        256, 2, 2
    # all-gather over data: the batch's three entries whole (for the
    # microbatches); each weight's FSDP block whole in bf16 in every
    # forward pass of a layer (the forward and the remat recompute): wq
    # (its one head of 4) and wo of the attention (D x hd each), wk and
    # wv (D x 2 x hd each), and the MLP's wg, wi (D x d_ff / 4) and wo
    # (d_ff / 4 x D); lm_head (D x V) once a microbatch
    layer = 2 * d * hd * bf + 2 * d * 2 * hd * bf + 3 * d * (ff // 4) * bf
    passes = layers * 2 * mb
    gather = (3 + 7 * passes + mb, 3 * 16 * s * 4 + layer * passes
              + mb * d * v * bf)
    # reduce-scatter over data: each gather's gradient once a microbatch,
    # this rank's quarter of it
    scatter = (7 * layers * mb + mb, (layer * layers + d * v * bf) * mb // 4)
    # all-reduce over model: the partial sums of the attention's and the
    # MLP's down projections in f32 (r x S x D) in the forward, and the
    # attention's again in the recompute (it stops after the last tensor
    # the backward needs, before the MLP's); in the backward the bf16
    # gradients entering the split products (grad_psum): the attention's
    # input, k and v together (each rank reads its kv head), the MLP's
    # input; AdamW's norm: one f32 square a leaf split over both axes (5)
    act = r * s * d
    model = (3 * layers * mb + 3 * layers * mb + 1,
             3 * layers * mb * act * f32 + 3 * layers * mb * act * bf
             + 5 * f32)
    # all-reduce over data: the loss's sum and its mask's weight a
    # microbatch; AdamW's norm (5 leaves split over both axes, 3 over
    # data alone); the gradients of the leaves no axis splits: embed,
    # each layer's two norms (stacked) and the final norm
    data = (2 * mb + 2 + 4, 2 * mb * f32 + 5 * f32 + 3 * f32
            + (v * d + 2 * layers * d + d) * f32)
    counts, _ = smoke_cell("granite_3_2b", "train_4k")
    assert _by_kind(counts) == {("all-gather", DATA): gather,
                                ("reduce-scatter", DATA): scatter,
                                ("all-reduce", MODEL): model,
                                ("all-reduce", DATA): data}


def test_decode_collectives_match_a_hand_count():
    """granite smoke decode, 16 rows (4 a rank of data) against a 256-slot
    cache split over model (split-KV, 64 slots a rank), one token: a
    layer all-gathers q's heads over model (bf16, 4 rows x 4 heads x
    16), merges the partials (a pmax of m, one psum of l and acc in
    f32), and all-reduces the f32 partial sums of the attention's and
    the MLP's down projections (4 rows x D)."""
    layers, rows, heads, hd, d = 2, 4, 4, 16, 64
    gather = (layers, layers * rows * heads * hd * 2)
    reduce = (4 * layers, layers * (rows * heads * 4
                                    + rows * heads * (1 + hd) * 4
                                    + 2 * rows * d * 4))
    counts, _ = smoke_cell("granite_3_2b", "decode_32k")
    assert _by_kind(counts) == {("all-gather", MODEL): gather,
                                ("all-reduce", MODEL): reduce}


def test_trace_keeps_no_state_that_grows_with_the_step():
    """Twice the layers: the same number of counted entries, each a sum."""
    sizes = []
    for n in (2, 4):
        cfg = get_config("granite_3_2b", smoke=True).replace(n_layers=n)
        with fake_world((4, 4), ("data", "model")) as mesh:
            counts, _ = steps.lower_cell(cfg, "train_4k", mesh,
                                         table=SMOKE_TABLE)
        sizes.append((len(counts["collectives"]), len(counts["kernels"]),
                      counts["kernels"]["flash_attention"]["calls"]))
    assert sizes[0][:2] == sizes[1][:2]
    assert sizes[1][2] == 2 * sizes[0][2]


# ----------------------------------------------------------- full width

def _check_full_width(rec, arch, shape, mesh_name):
    cfg = get_config(arch)
    assert rec["status"] == "ok", rec.get("traceback")
    mesh = abstract_mesh(*production_shape(mesh_name == "multipod"))
    r = rec["roofline"]
    assert r["memory_stats"]["argument_bytes"] == sum(
        steps.spec_bytes(t) for t in steps.input_specs(cfg, shape, mesh))
    assert r["memory_stats"]["peak_bytes"] \
        >= r["memory_stats"]["argument_bytes"]
    kind = steps.SHAPE_TABLE[shape]["kind"]
    if kind == "train":
        assert rec["accum"] == steps.cell_accum(
            cfg, steps.SHAPE_TABLE[shape], mesh)
        want = rl.train_launches(cfg, rec["accum"])
    else:
        want = {k: n for k, n in rl.path_launches(
            cfg, decode=kind == "decode").items() if n}
    assert {k: v["calls"] for k, v in rec["kernels"].items()} == want
    assert 0 < r["useful_flops_ratio"] <= 1
    assert r["n_chips"] == (512 if mesh_name == "multipod" else 256)
    for key in ("t_compute_s", "t_memory_s", "t_collective_s"):
        assert r[key] > 0


@pytest.mark.parametrize("shape", ("train_4k", "prefill_32k", "decode_32k"))
def test_granite_full_width_cells_on_the_pod(shape, background):
    """granite_3_2b at full width through the CLI: status ok, argument
    bytes the ``input_specs`` sum, kernel calls ``train_launches`` of the
    cell's microbatches (``path_launches`` for prefill and decode), and a
    useful share of the FLOPs in (0, 1]."""
    rec = background.record("granite_3_2b", shape, "pod")
    _check_full_width(rec, "granite_3_2b", shape, "pod")


def test_granite_long_500k_is_skipped(background):
    rec = background.record("granite_3_2b", "long_500k", "pod")
    assert rec["status"] == "skipped"
    assert "full-attention" in rec["reason"]


def test_granite_decode_on_the_multipod(background):
    rec = background.record("granite_3_2b", "decode_32k", "multipod")
    _check_full_width(rec, "granite_3_2b", "decode_32k", "multipod")
    pod = background.record("granite_3_2b", "decode_32k", "pod")
    assert rec["roofline"]["flops_per_device"] \
        < pod["roofline"]["flops_per_device"]


def test_roofline_table_renders_the_records(background):
    """``tools/roofline_table.py`` as it stands renders the CLI's records:
    the status row and a roofline row of each ok cell."""
    for cell in CLI_CELLS:
        background.finish(cell)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "roofline_table.py"),
         str(background.out_dir)], capture_output=True, text=True,
        check=True).stdout
    assert "| granite_3_2b | OK/? | OK/? | OK/OK | skip/? |" in out
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        assert f"| granite_3_2b | {shape} |" in out


def test_a_failing_cell_is_recorded_and_exits_1(background):
    """A cell whose step raises (a head dim the decode kernel refuses) is
    written with ``status: "error"`` and its traceback; the CLI exits
    1."""
    code, out = background.finish("failing")
    assert code == 1, out[-3000:]
    arch, shape, mesh, _ = FAILING
    rec = json.loads((background.out_dir / "failing"
                      / f"{arch}-{shape}-{mesh}.json").read_text())
    assert rec["status"] == "error"
    assert "head dim 12" in rec["error"]
    assert "Traceback" in rec["traceback"]


# ------------------------------------------------------------- the world

def test_fake_world_leaves_no_process_group():
    assert not dist.is_initialized()
    with fake_world((4, 4), ("data", "model")) as mesh:
        assert dist.get_world_size() == 16
        assert mesh.coords == (0, 0)
        assert mesh.lines == (DATA, MODEL)
        assert mesh.device.type == "cpu"
    assert not dist.is_initialized()


def test_fake_world_keeps_an_existing_world():
    """Inside a world that already exists the mesh takes its groups from
    it and leaves it initialised; a world of another size raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    try:
        with fake_world((2, 4), ("data", "model")) as mesh:
            assert mesh.lines == ((0, 4), (0, 1, 2, 3))
        assert dist.is_initialized()
        with pytest.raises(ValueError, match="needs 16 ranks"):
            with fake_world((4, 4), ("data", "model")):
                pass
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()


def test_decode_budget_off_the_card_is_the_h100_s():
    """Off the card (an abstract mesh, the dry run's CPU mesh) the decode
    plan is sized by ``CARD_BYTES``."""
    want = steps.DECODE_WEIGHT_SHARE * steps.CARD_BYTES
    assert steps.decode_budget(abstract_mesh((16, 16),
                                             ("data", "model"))) == want
    assert steps.decode_budget(single_device_mesh("cpu")) == want
