"""Four-card runs of the port's serve step on a mesh, its collectives, its
pipeline, and its prefill and train steps on a mesh.

On a machine with four CUDA cards:

    python3 -m torch.distributed.run --standalone --nproc-per-node 4 \\
        tools/chip_mesh.py

A rehearsal on the CPU (gloo ranks, smoke configs, short caches, small
collectives; no kernel is launched there):

    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 4 tools/chip_mesh.py --rehearse

Every rank runs every phase; rank 0 reports, one line a phase, writes
``chiprun_out/chip_mesh.json`` and prints a last line ``{"ok": ...}``.
Any failed gate exits non-zero on every rank.  Weights are drawn on each
card from seed 0 one layer at a time (``blocks.init_sharded_params``: the
same bits on any mesh), caches filled from a seed.

These random models are chaotic in their depth and steps
(``tools/decode_sensitivity.py``, on the CPU): one bf16 ulp on 1% of one
layer's cache moves granite's logits (40 layers) by 4.4 at magnitudes
of 5, and 1e-6 moves its float32 logits (16 layers) by 0.019 at the
first step and 1.2 four steps on.  Two right evaluations that round
differently (a kernel variant, a summation order) part as far, so the
gates are held where no depth amplifies a rounding: one sublayer, or a
model cut to 2 layers in float32 at every step; the full depth is
recorded.

1. ``pieces``: qwen1_5_110b's layer 0 at full width on a (1, 4) mesh,
   each sublayer against the same sublayer on the whole layer: attention
   (under both ``softmax_combine`` schedules; the cache after its write)
   and MLP, bf16 and float32, within 2e-2 of the output's largest
   magnitude (a sublayer's sums cancel: bf16 rounds them on that scale).
2. ``qwen_cut``: qwen1.5 cut to 2 layers on (1, 4) (the batch of 4 does
   not shard, so the KV cache's 32,768 slots split over ``model``)
   against the same cut on rank 0 alone, 16 steps from 8,184 filled
   slots (the owner's write crosses from rank 0's block into rank 1's,
   ranks 2-3 hold no valid key) and from 32,752; every float32 step
   within the band, bf16's distances recorded.
3. ``qwen``: all 80 layers at full width on (1, 4), bf16, a 32,768-slot
   cache filled to 8,184 and then to 32,752, 16 steps from each under
   both schedules, and once more under xla with one bf16 ulp on 1% of
   layer 0's cache.  Gates: finite logits identical on every rank, 80
   ``flash_decode`` launches a rank and step (the tensor-core variant).
   Recorded: ms a step, tokens/s, peak GB per rank, every step's
   distance between the schedules and from the perturbed run, and from
   torch.profiler (steps 12-15 of the last fill) the device's compute
   and NCCL time a step, the ``softmax_combine`` range's device and host
   ms a step against the wall step, the top host ops; the combine's
   bytes a step.
4. ``granite22``: granite_3_2b at full width on a (2, 2) mesh, batch 8
   (over ``data``), a 32,768-slot cache (over ``model``) filled to
   24,576, 8 steps against the same steps on rank 0 alone: cut to 2
   layers in float32, every step within the band; all 40 layers in
   float32 (beside rank 0 alone pushed by 1e-7) and bf16 recorded.
5. ``collectives``: every function of ``core/collectives.py`` on NCCL at
   4 ranks, 1 MiB and 256 MiB a rank, against its result on gloo at 4
   ranks: broadcasts bit for bit, reductions within 1e-6 of the largest
   magnitude; NCCL and gloo times.
6. ``pipeline``: the GPipe pipeline, 4 stages of 4 layers (d 32, 4
   microbatches of 2), against the unpipelined layers within 1e-5.
7. ``moe_pieces``: at full width on (1, 4), 128 rows, bf16 and float32,
   each against the same sublayer whole on every rank within the band
   of its output's largest magnitude: mixtral's layer 0 MoE (2 experts a
   rank), qwen3-MoE-235B's (128 experts top 8: 32 a rank), jamba's first
   Mamba-2 step (32 of 128 heads a rank, the gated norm across ranks;
   its conv window and state too) and whisper's cross-attention over
   8,192 frames.
8. ``mixtral``: mixtral_8x7b whole (32 layers) on (1, 4), batch 128 of
   ``decode_32k`` (not shardable on (1, 4)), the 4,096-slot rolling
   buffer over ``model``; first cut to 2 layers in float32 against rank 0
   alone, every step within the band (the gate); then bf16, 16 steps
   from a seeded fill past the window under both schedules.  Gates:
   finite logits identical on every rank, 32 ``flash_decode`` launches a
   rank and step.  Recorded: ms a step, tokens/s, the GB a rank
   resident before the steps and the steps' peak (the fill left out),
   the plan, host ops a step and the ``moe_combine`` and
   ``softmax_combine`` ranges' device and host ms a step against the
   wall step (steps 12-15).
9. ``jamba``: jamba_v0_1_52b whole (28 Mamba-2, 4 attention, 16 MoE
   layers) on (1, 4), batch 128 x 32,768 slots, as ``mixtral``; its cut
   is one 8-layer pattern block in float32 at 4,096 slots (the whole
   cache would not fit one card in float32); 4 launches a rank and step.

10. ``prefill_pieces``: qwen1_5_110b's layer 0 at full width on (1, 4),
    the prefill's attention sublayer (16 of 64 q heads and 2 of 8 kv
    heads a rank, ``wo``'s float32 partial sums all-reduced) and MLP
    against the whole sublayer on every rank: bf16 at 1 x 32,768, float32
    at 1 x 4,096, within the band of the output's largest magnitude.
11. ``prefill_qwen``: qwen1_5_110b whole (80 layers) on (1, 4), its bf16
    weights placed as ``qwen``'s (55.6 GB a rank), one prompt of 32,768
    tokens through ``make_prefill_step(mesh=)``: two timed calls, one
    profiled.  Gates: finite last-position logits, the same on every
    rank.  Recorded: ms, prompt tok/s, resident and peak GB a rank, NCCL
    ms and ``TRAIN_RANGES``.
12. ``train_granite22``: granite_3_2b on (2, 2) at 4 x 4096 (2 rows a
    data rank), accum 2.  Gate: the float32 cut to 2 layers, one step
    against the same step on rank 0 alone (``gate_faults``), and the two
    ``WRONG_STEPS`` on the same cut, which it must reject.  Then all 40
    layers in bf16 compute, 3 steps and one profiled: ms a step, tok/s,
    mfu, peak GB a rank, NCCL ms, the compute stream's idle share and
    ``TRAIN_RANGES``; finite losses.
13. ``train_qwen22``: qwen1_5_110b at full width cut to 2 layers (5.21 B
    parameters, 83.3 GB of float32 state: no one card holds it) on (2,
    2), the same batch and numbers.  Gates: finite losses, every rank's
    ``grad_norm`` equal.

14. ``train_mixtral14``: mixtral_8x7b at full width cut to 2 layers
    (3.17 B parameters) on (1, 4), its 8 experts 2 a rank (``"ep"``):
    each rank's quarter of the sequence dispatched to the experts'
    owners and back by ``all_to_all`` on NCCL.  Gate: the float32 cut,
    one step at 2 x 2048 in 2 against the same step on rank 0 alone by
    ``train_granite22``'s rule (``gate_faults``), at capacity factor 4
    (``gate_capacity``: neither side can drop a row there; the mesh drops
    at each source's slots a destination, one device at each expert's,
    so at the config's 1.25 the two can drop different rows), with no
    dropped row on either side (``Drops`` counts them, at 1.25 too), the
    router loss left out of its gradient (a mesh's is the mean of the
    ranks' own, the reference's pmean, not the one device's), and the two
    ``MOE_WRONG_STEPS`` (the return skipped, the input's gradient psum
    left out) rejected by it.  Then bf16 compute,
    ``steps`` steps and one profiled: ms a step, peak GB a rank, and
    ``TRAIN_RANGES`` with ``moe_dispatch`` and ``moe_return`` (device and
    host ms against the wall step); finite losses, every rank's
    ``grad_norm`` equal.
15. ``probe_mixtral14`` (only when named): that gate taken apart.  The
    mesh step against rank 0 alone in float64 compute at 1 layer (the
    attention through its plain version), and rank 0 pushed by 1e-7
    against itself in float32 by the gate's own rule.  With
    ``--rehearse --d-model 512`` both mixtral phases run on gloo ranks
    at the full vocabulary, head counts and gate batch.

Four cards for the new families alone (~10 min of command):

    python3 -m torch.distributed.run --standalone --nproc-per-node 4 \\
        tools/chip_mesh.py --phases moe_pieces,mixtral,jamba
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import math
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))
sys.path.insert(0, os.path.join(REPO, "tests"))   # the MoE mutants

import _torch_mesh_cases as cases  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import collectives as coll  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.launch.mesh import make_mesh, single_device_mesh  # noqa: E402
from repro_torch.launch.roofline import PEAK_FLOPS, train_step_flops  # noqa: E402
from repro_torch.launch.steps import make_serve_step  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models.blocks import (count_params, init_sharded_params,  # noqa: E402
                                       param_specs, rms_norm, tree_leaves,
                                       tree_map)
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.parallel.pipeline import pipeline, pipeline_stages  # noqa: E402

BAND = 2e-2
FAILURES: list = []
#: this rank's device, for the flags the ranks agree on
DEV = [torch.device("cpu")]
#: the full runs' sizes and the rehearsal's
FULL = dict(qwen=dict(arch="qwen1_5_110b", smoke=False, batch=4, seq=32768,
                      fills=(8184, 32752), steps=16, profile=(12, 4)),
            granite=dict(arch="granite_3_2b", smoke=False, batch=8,
                         seq=32768, fill=24576, steps=8),
            sizes=(1 << 20, 256 << 20),
            moe_pieces=dict(batch=128, seq=32768),
            mixtral=dict(arch="mixtral_8x7b", smoke=False, batch=128,
                         seq=32768, fill=32752, steps=16, profile=(12, 4),
                         cut_layers=2, cut_seq=32768, cut_fill=32752),
            jamba=dict(arch="jamba_v0_1_52b", smoke=False, batch=128,
                       seq=32768, fill=32752, steps=16, profile=(12, 4),
                       cut_layers=8, cut_seq=4096, cut_fill=4000),
            train_granite22=dict(arch="granite_3_2b", smoke=False, batch=4,
                                 seq=4096, accum=2, steps=3),
            train_qwen22=dict(arch="qwen1_5_110b", smoke=False, layers=2,
                              batch=4, seq=4096, accum=2, steps=3),
            # the gate's float32 step on rank 0 alone holds the whole
            # 50.7 GB state: its batch is cut to 2 x 2048
            train_mixtral14=dict(arch="mixtral_8x7b", smoke=False, layers=2,
                                 batch=4, seq=4096, accum=2, steps=3,
                                 gate=(2, 2048)),
            prefill_qwen=dict(arch="qwen1_5_110b", smoke=False, seq=32768),
            prefill_pieces=dict(arch="qwen1_5_110b", smoke=False,
                                seq16=32768, seq32=4096))
SMALL = dict(qwen=dict(arch="qwen1_5_110b", smoke=True, batch=4, seq=64,
                       fills=(21, 60), steps=4, profile=None),
             granite=dict(arch="granite_3_2b", smoke=True, batch=8, seq=64,
                          fill=40, steps=4),
             sizes=(1 << 10, 64 << 10),
             moe_pieces=dict(batch=8, seq=64),
             mixtral=dict(arch="mixtral_8x7b", smoke=True, batch=8, seq=64,
                          fill=60, steps=4, profile=None, cut_layers=2,
                          cut_seq=64, cut_fill=60),
             jamba=dict(arch="jamba_v0_1_52b", smoke=True, batch=8, seq=64,
                        fill=60, steps=4, profile=None, cut_layers=8,
                        cut_seq=64, cut_fill=40),
             train_granite22=dict(arch="granite_3_2b", smoke=True, batch=4,
                                  seq=64, accum=2, steps=2),
             train_qwen22=dict(arch="qwen1_5_110b", smoke=True, layers=2,
                               batch=4, seq=64, accum=2, steps=2),
             train_mixtral14=dict(arch="mixtral_8x7b", smoke=True, layers=2,
                                  batch=4, seq=64, accum=2, steps=2,
                                  gate=(4, 64)),
             prefill_qwen=dict(arch="qwen1_5_110b", smoke=True, seq=64),
             prefill_pieces=dict(arch="qwen1_5_110b", smoke=True, seq16=64,
                                 seq32=32))


def log(*parts):
    if dist.get_rank() == 0:
        print(*parts, flush=True)


def fail(msg):
    FAILURES.append(msg)
    log(f"[chip_mesh] FAIL {msg}")


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def within_band(a, b):
    return bool(((a - b).abs() <= BAND + BAND * b.abs()).all())


def _seed(*parts):
    h = 0
    for p in parts:
        h = (h * 1_000_003 + p) % (1 << 63)
    return h


def agree(flag: bool) -> bool:
    """True when ``flag`` holds on every rank."""
    t = torch.tensor([int(flag)], device=DEV[0])
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def fill_caches(caches, cfg, batch, seq, fill, seed, mesh, batch_shardable):
    """Every layer's k and v: slots below ``fill`` N(0, 1) from a
    generator seeded by (seed, layer, k or v), drawn whole on the rank's
    device and cut to its block (the same bits on any mesh), the rest 0."""
    layer = caches["layers"]["sub0"]
    spec = mdl.kv_cache_spec(mesh, batch_shardable)
    shape = (batch, mdl.cache_len(cfg, seq), cfg.n_kv_heads, cfg.hd)
    gen = torch.Generator(device=mesh.device)
    for i in range(cfg.n_blocks):
        for j, name in enumerate(("k", "v")):
            gen.manual_seed(_seed(seed, i, j))
            whole = torch.randn(shape, generator=gen, device=mesh.device)
            whole[:, fill:] = 0
            layer[name][i].copy_(shd.shard(whole.to(layer[name].dtype),
                                           spec, mesh))
            del whole


def fill_every_leaf(caches, cfg, batch, seq, fill, seed, mesh,
                    batch_shardable):
    """Every layer of every cache leaf drawn whole on the rank's device
    from a generator seeded by (seed, leaf, layer) and cut to its block
    (the same bits on any mesh): k and v N(0, 1) below ``fill`` (all of a
    rolling buffer shorter than it) and 0 above, each Mamba-2 conv
    window and state N(0, 1)."""
    structs = dict(tree_leaves(mdl.cache_structs(cfg, batch, seq)))
    specs = dict(tree_leaves(mdl.cache_specs(cfg, batch, seq, mesh,
                                             batch_shardable)))
    gen = torch.Generator(device=mesh.device)
    for j, (name, t) in enumerate(tree_leaves(caches)):
        shape = structs[name][0]
        for i in range(shape[0]):
            gen.manual_seed(_seed(seed, j, i))
            whole = torch.randn(shape[1:], generator=gen, device=mesh.device)
            if name.endswith((".k", ".v")):
                whole[:, fill:] = 0
            t[i].copy_(shd.shard(whole.to(t.dtype), specs[name][1:], mesh))
            del whole


def tokens_for(cfg, batch, steps, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (steps, batch, 1))).long()


def decode_run(step_fn, params, caches, toks, start, mesh, tok_spec,
               profile=None):
    """Steps ``start``, ``start + 1``, ... on this rank's blocks; returns
    the whole logits of every step (on the CPU), the wall ms of each step
    and the profile summary of steps ``profile = (first, n)``."""
    logits, ms, summary, prof = [], [], None, None
    dev = mesh.device
    for i in range(len(toks)):
        if profile and i == profile[0]:
            sync(dev)
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            t_prof = time.perf_counter()
        tok = shd.shard(toks[i].to(dev), tok_spec, mesh)
        sync(dev)
        t0 = time.perf_counter()
        got, caches = step_fn(params, caches, tok, start + i)
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(shd.gather(got, tok_spec + (None,), mesh).cpu())
        if prof is not None and i == profile[0] + profile[1] - 1:
            sync(dev)
            wall = (time.perf_counter() - t_prof) * 1e3
            prof.__exit__(None, None, None)
            summary = profile_summary(prof, wall, profile[1])
            prof = None
    return torch.stack(logits), ms, summary


#: the profiler ranges of the mesh path's combines: the split-KV merge
#: and the MoE's many-to-one sum
RANGES = ("softmax_combine", "moe_combine")
#: the ranges of the mesh train and prefill steps: the FSDP gathers, the
#: psums over ``model`` of the products' partial sums, the psum of a
#: replicated activation's gradient over ``model`` (``grad_psum``'s
#: backward), the FSDP gathers' gradient reduce-scatters, the all-reduce
#: of the gradients of leaves replicated over the batch axes, and AdamW
TRAIN_RANGES = ("fsdp_gather", "model_psum", "grad_psum",
                "grad_reduce_scatter", "train_step.grad_sync",
                "train_step.adamw")
#: the MoE train step's ranges besides: the expert-parallel dispatch
#: (the rows and their expert ids, all_to_all) and the return
MOE_TRAIN_RANGES = TRAIN_RANGES + ("moe_dispatch", "moe_return")


def _short(name):
    """A range's key in a summary: the combines' first word, else the
    name."""
    return name.split("_")[0] if name in RANGES else name.replace(".", "_")


def profile_summary(prof, wall_ms, steps, ranges=RANGES):
    """From a trace of ``steps`` steps taking ``wall_ms`` in all: the
    device's compute ms a step (its own events, NCCL's kernels apart:
    they spin while a rank waits for the others, on a stream of their
    own, so they can outlast the step) and the share of the wall the
    compute stream is idle; NCCL's device ms a step; each range of
    ``RANGES`` as device ms (its kernels, NCCL's included) and host ms a
    step and each as a share of the wall step; host ops a step, the top
    device and host events."""
    from torch.autograd import DeviceType
    avgs = prof.key_averages()
    # a named range leaves a device-side span too, which would count its
    # kernels a second time
    dev = sorted(((a.key, a.self_device_time_total / 1e3, a.count)
                  for a in avgs if a.device_type != DeviceType.CPU
                  and a.key not in ranges), key=lambda r: -r[1])
    nccl = sum(r[1] for r in dev if "nccl" in r[0].lower())
    busy = sum(r[1] for r in dev) - nccl
    host = sorted(((a.key, a.self_cpu_time_total / 1e3 / steps, a.count)
                   for a in avgs if a.device_type == DeviceType.CPU),
                  key=lambda r: -r[1])
    step_ms = wall_ms / steps
    out = {"steps": steps, "wall_ms": wall_ms, "wall_ms_per_step": step_ms,
           "top_host_ms": host[:12],
           "host_ops_per_step": sum(a.count for a in avgs
                                    if a.device_type == DeviceType.CPU
                                    and a.key.startswith("aten::")) / steps,
           "device_compute_ms_per_step": busy / steps,
           "nccl_device_ms_per_step": nccl / steps,
           "compute_idle_share": 1 - busy / wall_ms if busy else None,
           "top_device_ms": dev[:10]}
    for name in ranges:
        rows = [a for a in avgs
                if a.device_type == DeviceType.CPU and a.key == name]
        short = _short(name)
        for side, attr in (("device", "device_time_total"),
                           ("host", "cpu_time_total")):
            ms = sum(getattr(a, attr) for a in rows) / 1e3 / steps
            out[f"{short}_{side}_ms_per_step"] = ms
            out[f"{short}_{side}_share_of_wall"] = ms / step_ms
    return out


def profile_line(prof, ranges=RANGES):
    """The log line of a ``profile_summary``."""
    return (f"wall {prof['wall_ms_per_step']:.3f} ms/step, device compute "
            f"{prof['device_compute_ms_per_step']:.3f} (idle share "
            f"{prof['compute_idle_share']}), NCCL "
            f"{prof['nccl_device_ms_per_step']:.3f}; host ops a step "
            f"{prof['host_ops_per_step']}; " + ", ".join(
                f"{r} device {prof[s + '_device_ms_per_step']:.3f} ms/step "
                f"({prof[s + '_device_share_of_wall']:.4f} of the wall), "
                f"host {prof[s + '_host_ms_per_step']:.3f} "
                f"({prof[s + '_host_share_of_wall']:.4f})"
                for r, s in ((r, _short(r)) for r in ranges))
            + f"; top host {prof['top_host_ms'][:4]}")


def same_on_every_rank(t):
    mine = t.to(DEV[0])
    ref = mine.clone()
    dist.broadcast(ref, 0)
    return agree(torch.equal(ref, mine))


def combine_bytes(cfg, batch, n_ranks):
    """Bytes a step of the merged partials: (m, l, acc) f32 per layer,
    and what one rank sends of them under each schedule (the library's
    ring all-reduce 2 (n - 1) / n of m, l and acc; the butterfly all of
    them, log2 n rounds)."""
    payload = (2 * batch * cfg.n_heads + batch * cfg.n_heads * cfg.hd) * 4
    per_step = payload * cfg.n_blocks
    return {"partials_bytes_per_step": per_step,
            "xla_sent_per_rank": 2 * (n_ranks - 1) / n_ranks * per_step,
            "gleam_tree_sent_per_rank": int(math.log2(n_ranks)) * per_step}


# ------------------------------------------------------------------ phases

def per_step(a, b):
    """Max |a - b| of each step, and whether each step is in the band."""
    return ([float((x - y).abs().max()) for x, y in zip(a, b)],
            [within_band(x, y) for x, y in zip(a, b)])


def perturb(caches, eps, seed, dev):
    """Layer 0's cached k and v scaled by (1 + eps) at 1% of their
    elements: a rounding-sized push, the yardstick of how far a later
    step or layer carries one."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    for t in caches["layers"]["sub0"].values():
        pick = torch.rand(t[0].shape, generator=gen, device=dev) < 0.01
        t[0].copy_(torch.where(pick, (t[0].float() * (1 + eps)).to(t.dtype),
                               t[0]))


def alone_run(cfg, b, seq, fill, seed, toks, dev, dtype, eps=0.0,
              filler=None):
    """The same steps on rank 0 alone (``single_device_mesh``), whole
    weights and cache (filled by ``filler``, ``fill_caches`` by default;
    ``perturb``-ed by ``eps`` when given); None on the other ranks."""
    if dist.get_rank() != 0:
        return None
    one = single_device_mesh(device=str(dev))
    step1 = make_serve_step(cfg, one, batch_shardable=False)
    p1 = init_sharded_params(mdl.model_defs(cfg), step1.plan, one, seed=0,
                             dtype=dtype)
    c1 = mdl.init_caches(cfg, b, seq, dtype=dtype, device=dev)
    (filler or fill_caches)(c1, cfg, b, seq, fill, seed, one, False)
    if eps:
        perturb(c1, eps, 9, dev)
    logits, ms, _ = decode_run(step1, p1, c1, toks, fill, one, (None, None))
    del p1, c1
    return logits, ms


def within_scale(got, want):
    """``got`` within the band of ``want``'s largest magnitude: a
    sublayer's output sums terms of that size, so its rounding is on
    that scale wherever the sum cancels."""
    return float((got - want).abs().max()) <= BAND * (
        1 + float(want.abs().max()))


def free(dev):
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def pieces_phase(spec, dev_kind):
    """Layer 0 of qwen1.5 at full width on (1, 4), its sublayers one at a
    time against the same sublayer on the whole layer (gathered from the
    blocks) on every rank, on the same input and cache filled to 32,752:
    the attention sublayer (projections, rope, the heads' gather, the
    owner's cache write, split-KV ``flash_decode`` and the combine, the
    output projection's partial sums) under both schedules, and the MLP;
    bf16 and float32.  One sublayer, one step: no depth or step amplifies
    a rounding here, so each is held to the band of its output's largest
    magnitude (``within_scale``)."""
    base = get_config(spec["arch"], smoke=spec["smoke"]).replace(n_layers=1)
    mesh = make_mesh((1, 4), ("data", "model"), device=dev_kind)
    dev, b, seq = mesh.device, spec["batch"], spec["seq"]
    fill = spec["fills"][-1]
    rows = []
    for dt in ("bfloat16", "float32"):
        cdt = getattr(torch, dt)
        cfg = base.replace(compute_dtype=dt)
        step_fn = make_serve_step(cfg, mesh, batch_shardable=False)
        blocks = init_sharded_params(mdl.model_defs(cfg), step_fn.plan, mesh,
                                     seed=0, dtype=cdt)["blocks"]["sub0"]
        specs = param_specs(mdl.model_defs(cfg), step_fn.plan)
        lsp = {part: tree_map(lambda sp: sp[1:],
                                  specs["blocks"]["sub0"][part])
               for part in ("mixer", "ffn")}
        mine = {part: tree_map(lambda a: a[0], blocks[part])
                for part in lsp}
        whole = {part: tree_map(lambda a, sp: shd.gather(a, sp, mesh),
                                    mine[part], lsp[part]) for part in lsp}
        gen = torch.Generator(device=dev).manual_seed(5)
        x = torch.randn(b, 1, cfg.d_model, device=dev, generator=gen).to(cdt)
        kv = {n: torch.randn(b, seq, cfg.n_kv_heads, cfg.hd, device=dev,
                             generator=gen).to(cdt) for n in ("k", "v")}
        for t in kv.values():
            t[:, fill:] = 0
        spec_kv = mdl.kv_cache_spec(mesh, False)
        positions = torch.full((b, 1), fill, dtype=torch.long, device=dev)
        index, _ = shd.block(mesh, ("model",))
        owner, local = divmod(fill, seq // 4)
        for sched in ("xla", "gleam_tree"):
            c = cfg.replace(collective_schedule=sched)
            cache = {n: shd.shard(t, spec_kv, mesh).clone()
                     for n, t in kv.items()}
            cache1 = {n: t.clone() for n, t in kv.items()}

            def insert(kc, vc, k, v):
                if owner == index:
                    return mdl.cache_insert(kc, vc, k, v, local)
                return kc, vc

            def core(q, kc, vc, c=c):
                return mdl.split_kv_attention(q, kc, vc, fill, c, mesh,
                                              ("model",))
            def insert1(kc, vc, k, v):
                return mdl.cache_insert(kc, vc, k, v, fill)

            def core1(q, kc, vc, c=c):
                return mdl.decode_attn_core(q, kc, vc, torch.full(
                    (b,), fill + 1, dtype=torch.int32, device=dev), c)
            got = mdl.attn_decode_apply(mine["mixer"], x, cache, positions,
                                        insert, core, c, sp=lsp["mixer"],
                                        mesh=mesh)
            want = mdl.attn_decode_apply(whole["mixer"], x, cache1,
                                         positions, insert1, core1, c)
            k_err = float((shd.gather(cache["k"], spec_kv, mesh).float()
                           - cache1["k"].float()).abs().max())
            rows.append({"sublayer": "attention", "dtype": dt,
                         "schedule": sched,
                         "max_abs_diff": float((got - want).abs().max()),
                         "max_abs": float(want.abs().max()),
                         "cache_k_max_abs_diff": k_err,
                         "ok": within_scale(got.float(), want.float())})
        got, _ = mdl.ffn_apply(mine["ffn"], x, "mlp", cfg, sp=lsp["ffn"],
                               mesh=mesh)
        want, _ = mdl.ffn_apply(whole["ffn"], x, "mlp", cfg)
        rows.append({"sublayer": "mlp", "dtype": dt,
                     "max_abs_diff": float((got - want).abs().max()),
                     "max_abs": float(want.abs().max()),
                     "ok": within_scale(got.float(), want.float())})
        del blocks, mine, whole, kv
        free(dev)
    for r in rows:
        log(f"[pieces] qwen1.5 layer 0 {r['sublayer']} {r['dtype']} "
            f"{r.get('schedule', '')}: max |diff| {r['max_abs_diff']!r} at "
            f"max |y| {r['max_abs']!r}, within band {r['ok']}")
    if not agree(all(r["ok"] for r in rows)):
        fail("pieces: a sublayer on 4 ranks left the band of the whole")
    return {"pieces": rows}


def qwen_phase(spec, dev_kind):
    """The cut model against rank 0 alone, then the 80-layer runs."""
    out = {}
    base = get_config(spec["arch"], smoke=spec["smoke"])
    mesh = make_mesh((1, 4), ("data", "model"), device=dev_kind)
    dev = mesh.device
    b, seq, steps = spec["batch"], spec["seq"], spec["steps"]
    toks = tokens_for(base, b, steps, 1)
    tok_spec = (None, None)

    # 1. cut to 2 layers: 4 ranks against rank 0 alone at each fill,
    # float32 (the gate, every step) and bf16 (recorded)
    cut_rows = {}
    for fill in spec["fills"]:
        for dt in ("float32", "bfloat16"):
            cdt = getattr(torch, dt)
            cut = base.replace(n_layers=2, compute_dtype=dt)
            step_fn = make_serve_step(cut, mesh, batch_shardable=False)
            params = init_sharded_params(mdl.model_defs(cut), step_fn.plan,
                                         mesh, seed=0, dtype=cdt)
            caches = mdl.init_caches(cut, b, seq, mesh=mesh,
                                     batch_shardable=False, dtype=cdt,
                                     device=dev)
            fill_caches(caches, cut, b, seq, fill, 0, mesh, False)
            mesh_logits, _, _ = decode_run(step_fn, params, caches, toks,
                                           fill, mesh, tok_spec)
            del params, caches
            free(dev)
            alone = alone_run(cut, b, seq, fill, 0, toks, dev, cdt)
            if alone is not None:
                diffs, bands = per_step(mesh_logits, alone[0])
                cut_rows[f"{dt}_{fill}"] = {
                    "layers": 2, "dtype": dt, "steps": steps, "start": fill,
                    "max_abs_diff_per_step": diffs,
                    "within_band_per_step": bands,
                    "finite": bool(torch.isfinite(mesh_logits).all()),
                    "max_abs_logit": float(alone[0].abs().max())}
                log(f"[qwen_cut] 2 layers {dt}, (1, 4) vs rank 0 alone, "
                    f"{steps} steps from {fill}: max |diff| a step {diffs}")
            free(dev)
    ok = all(all(r["within_band_per_step"]) and r["finite"]
             for r in cut_rows.values() if r["dtype"] == "float32") \
        if dist.get_rank() == 0 else True
    if not agree(ok):
        fail("qwen_cut: a step of the 4-rank float32 cut model left the "
             "band of rank 0 alone")
    out["qwen_cut"] = cut_rows
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # 2. all layers, bf16
    t0 = time.perf_counter()
    step_fn = make_serve_step(base, mesh, batch_shardable=False)
    params = init_sharded_params(mdl.model_defs(base), step_fn.plan, mesh,
                                 seed=0)
    caches = mdl.init_caches(base, b, seq, mesh=mesh, batch_shardable=False,
                             device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    runs = {}
    for fill in spec["fills"]:
        toks = tokens_for(base, b, steps, fill)
        for sched in ("xla", "gleam_tree", "xla_ulp"):
            cfg = step_fn.cfg.replace(
                collective_schedule=sched.replace("_ulp", ""))
            run = make_serve_step(cfg, mesh, batch_shardable=False)
            fill_caches(caches, base, b, seq, fill, 1, mesh, False)
            if sched == "xla_ulp":
                if fill != spec["fills"][-1]:
                    continue
                perturb(caches, 2 ** -7, 9 + dist.get_rank(), dev)
            fd.reset_launches()
            logits, ms, prof = decode_run(
                run, params, caches, toks, fill, mesh, tok_spec,
                profile=spec["profile"] if fill == spec["fills"][-1]
                and sched != "xla_ulp" else None)
            launches = dict(fd.LAUNCHES)
            finite = bool(torch.isfinite(logits).all())
            same = same_on_every_rank(logits)
            timed = ms[1:spec["profile"][0]] if spec["profile"] else ms[1:]
            row = {"fill": fill, "schedule": sched, "steps": steps,
                   "ms_per_step": float(np.mean(timed)),
                   "ms_first_step": ms[0],
                   "tokens_per_s": b / (np.mean(timed) / 1e3),
                   "flash_decode_launches_per_step":
                       launches["flash_decode"] / steps,
                   "launches": launches, "finite": finite,
                   "identical_on_every_rank": same,
                   "max_abs_logit": float(logits.abs().max()),
                   "profile": prof}
            runs[(fill, sched)] = (logits, row)
            log(f"[qwen] {base.n_layers} layers (1, 4), fill {fill}, {sched}: "
                f"{row['ms_per_step']:.3f} ms/step, "
                f"{row['tokens_per_s']:.1f} tok/s, flash_decode "
                f"{row['flash_decode_launches_per_step']} a step, finite "
                f"{finite}, identical on every rank {same}")
            if prof:
                log(f"[qwen]   profile: {profile_line(prof)}")
            if not finite or not same:
                fail(f"qwen fill {fill} {sched}: finite {finite}, identical "
                     f"on every rank {same}")
            want = steps * base.n_blocks if dev.type == "cuda" else 0
            if launches["flash_decode"] != want \
                    or launches["flash_decode_mma"] != want:
                fail(f"qwen fill {fill} {sched}: flash_decode launched "
                     f"{launches['flash_decode']} times (mma "
                     f"{launches['flash_decode_mma']}), not {want}")
    for fill in spec["fills"]:
        x, _ = runs[(fill, "xla")]
        for other in ("gleam_tree", "xla_ulp"):
            if (fill, other) not in runs:
                continue
            a, ra = runs[(fill, other)]
            ra["max_abs_diff_vs_xla_per_step"], _ = per_step(a, x)
            log(f"[qwen] fill {fill}: {other} vs xla max |diff| a step "
                f"{ra['max_abs_diff_vs_xla_per_step']}")
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else None)
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, peak)
    out["qwen"] = {"layers": base.n_layers, "batch": b, "seq": seq,
                   "plan": "default" if step_fn.cfg.fsdp_weights
                   else "inference",
                   "init_s": init_s, "peak_gb_per_rank": peaks,
                   **combine_bytes(base, b, 4),
                   "runs": [row for _, row in runs.values()]}
    del params, caches
    free(dev)
    return out


def granite_phase(spec, dev_kind):
    """granite on (2, 2) against rank 0 alone: cut to 2 layers in float32
    (the gate, every step; both model blocks of the cache hold keys), then all 40 layers in float32 (with rank 0 alone once more on
    a cache pushed by 1e-7, the yardstick) and bf16 (the timing)."""
    mesh = make_mesh((2, 2), ("data", "model"), device=dev_kind)
    dev = mesh.device
    b, seq, steps, fill = (spec[k] for k in ("batch", "seq", "steps",
                                             "fill"))
    out = {}
    base = get_config(spec["arch"], smoke=spec["smoke"])
    for label, cfg in (("cut_float32", base.replace(
            n_layers=2, compute_dtype="float32")),
            ("float32", base.replace(compute_dtype="float32")),
            ("bfloat16", base)):
        cdt = getattr(torch, cfg.compute_dtype)
        toks = tokens_for(cfg, b, steps, 2)
        step_fn = make_serve_step(cfg, mesh, batch_shardable=True)
        params = init_sharded_params(mdl.model_defs(cfg), step_fn.plan, mesh,
                                     seed=0, dtype=cdt)
        caches = mdl.init_caches(cfg, b, seq, mesh=mesh, batch_shardable=True,
                                 dtype=cdt, device=dev)
        fill_caches(caches, cfg, b, seq, fill, 2, mesh, True)
        logits, ms, _ = decode_run(step_fn, params, caches, toks, fill, mesh,
                                   (mdl._bspec(mesh), None))
        del params, caches
        free(dev)
        alone = alone_run(cfg, b, seq, fill, 2, toks, dev, cdt)
        if alone is not None:
            diffs, bands = per_step(logits, alone[0])
            out[label] = {"layers": cfg.n_layers, "mesh": [2, 2],
                          "batch": b, "seq": seq, "fill": fill,
                          "steps": steps,
                          "plan": "default" if step_fn.cfg.fsdp_weights
                          else "inference",
                          "ms_per_step": float(np.mean(ms[1:])),
                          "ms_per_step_rank0_alone":
                              float(np.mean(alone[1][1:])),
                          "finite": bool(torch.isfinite(logits).all()),
                          "max_abs_diff_per_step": diffs,
                          "within_band_per_step": bands,
                          "max_abs_logit": float(alone[0].abs().max())}
            if label == "float32":
                pushed = alone_run(cfg, b, seq, fill, 2, toks, dev, cdt,
                                   eps=1e-7)
                out[label]["pushed_1e-7_max_abs_diff_per_step"], _ = \
                    per_step(pushed[0], alone[0])
            log(f"[granite22] {label} (2, 2) batch {b}: "
                f"{out[label]['ms_per_step']:.3f} ms/step (rank 0 alone "
                f"{out[label]['ms_per_step_rank0_alone']:.3f}); max |diff| "
                f"a step vs rank 0 alone {diffs}"
                + (f"; rank 0 alone pushed by 1e-7: "
                   f"{out[label]['pushed_1e-7_max_abs_diff_per_step']}"
                   if label == "float32" else ""))
        free(dev)
    ok = (all(out["cut_float32"]["within_band_per_step"])
          and all(r["finite"] for r in out.values())) \
        if dist.get_rank() == 0 else True
    if not agree(ok):
        fail("granite22: a step of the (2, 2) float32 cut left the band of "
             "rank 0 alone")
    return {"granite22": out}


def _sublayer(cfg, mesh, plan_step, j, part, dtype):
    """Layer 0's sublayer ``j`` ``part`` ("mixer" or "ffn"): this rank's
    blocks, their specs and the whole sublayer gathered on every rank."""
    params = init_sharded_params(mdl.model_defs(cfg), plan_step.plan, mesh,
                                 seed=0, dtype=dtype)["blocks"][f"sub{j}"]
    specs = param_specs(mdl.model_defs(cfg), plan_step.plan)
    lsp = tree_map(lambda sp: sp[1:], specs["blocks"][f"sub{j}"][part])
    mine = tree_map(lambda a: a[0], params[part])
    del params
    whole = tree_map(lambda a, sp: shd.gather(a, sp, mesh), mine, lsp)
    return mine, lsp, whole


#: the MoE / Mamba-2 / cross-attention sublayers at full width on (1, 4):
#: (label, arch, layers drawn, sublayer index, part)
MOE_PIECES = (("mixtral layer 0 MoE", "mixtral_8x7b", 1, 0, "ffn"),
              ("qwen3_moe layer 0 MoE", "qwen3_moe_235b_a22b", 1, 0, "ffn"),
              ("jamba layer 0 Mamba-2", "jamba_v0_1_52b", 8, 0, "mixer"),
              ("whisper layer 0 cross-attention", "whisper_medium", 1, 0,
               "mixer"))


def moe_pieces_phase(spec, dev_kind, smoke):
    """The sublayers this slice puts on a mesh, each at full width on a
    (1, 4) mesh against the same sublayer whole on every rank, on the
    same input (and caches): mixtral's MoE (2 experts a rank), qwen3's
    MoE (128 experts top 8: 32 a rank), jamba's first Mamba-2 step (128
    heads, N 16: 32 heads a rank, the gated norm across ranks; its new
    conv window and state too) and whisper's cross-attention over an
    encoder memory of ``seq / 4`` frames; bf16 and float32, each within
    the band of its output's largest magnitude (``within_scale``)."""
    mesh = make_mesh((1, 4), ("data", "model"), device=dev_kind)
    dev, b = mesh.device, spec["batch"]
    rows = []
    for label, arch, layers, j, part in MOE_PIECES:
        base = get_config(arch, smoke=smoke).replace(n_layers=layers)
        for dt in ("bfloat16", "float32"):
            cdt = getattr(torch, dt)
            cfg = base.replace(compute_dtype=dt)
            step_fn = make_serve_step(cfg, mesh, batch_shardable=False)
            cfg = step_fn.cfg
            mine, lsp, whole = _sublayer(cfg, mesh, step_fn, j, part, cdt)
            gen = torch.Generator(device=dev).manual_seed(7)
            x = torch.randn(b, 1, cfg.d_model, generator=gen,
                            device=dev).to(cdt)
            extra = {}
            if part == "ffn":
                got, _ = mdl.ffn_apply(mine, x, "moe", cfg, decode=True,
                                       sp=lsp, mesh=mesh)
                want, _ = mdl.ffn_apply(whole, x, "moe", cfg, decode=True)
            elif cfg.enc_layers:
                enc = max(spec["seq"] // cfg.audio_stride, 8)
                memory = torch.randn(b, enc, cfg.d_model, generator=gen,
                                     device=dev).to(cdt)
                got = mdl._cross(mine, x, memory, cfg, cdt,
                                 attn.cross_attention, lsp, mesh)
                want = mdl._cross(whole, x, memory, cfg, cdt,
                                  attn.cross_attention)
                del memory
            else:
                d_in, h, hp, n, k = ssm_mod.ssm_dims(cfg)
                cache = {"conv": torch.randn(b, k - 1, d_in + 2 * n,
                                             generator=gen,
                                             device=dev).to(cdt),
                         "state": torch.randn(b, h, n, hp, generator=gen,
                                              device=dev)}
                state_spec = (None, "model")
                mc = {"conv": cache["conv"].clone(),
                      "state": shd.shard(cache["state"], state_spec, mesh)}
                drop = lambda p: {n_: v for n_, v in p.items()  # noqa: E731
                                  if n_ != "norm"}
                hm = rms_norm(x, whole["norm"], cfg.norm_eps)
                got, new = ssm_mod.ssm_decode_step(drop(mine), hm, mc, cfg,
                                                   sp=drop(lsp), mesh=mesh)
                want, new1 = ssm_mod.ssm_decode_step(drop(whole), hm, cache,
                                                     cfg)
                state = shd.gather(new["state"], state_spec, mesh)
                extra = {"conv_max_abs_diff": float(
                    (new["conv"].float() - new1["conv"].float()).abs().max()),
                         "state_max_abs_diff": float(
                    (state - new1["state"]).abs().max()),
                         "conv_ok": within_scale(new["conv"].float(),
                                                 new1["conv"].float()),
                         "state_ok": within_scale(state, new1["state"])}
            row = {"sublayer": label, "dtype": dt,
                   "plan": "default" if cfg.fsdp_weights else "inference",
                   "max_abs_diff": float((got.float() - want.float())
                                         .abs().max()),
                   "max_abs": float(want.float().abs().max()),
                   "ok": within_scale(got.float(), want.float())
                   and extra.get("conv_ok", True)
                   and extra.get("state_ok", True), **extra}
            rows.append(row)
            log(f"[moe_pieces] {label} {dt} on (1, 4): max |diff| "
                f"{row['max_abs_diff']!r} at max |y| {row['max_abs']!r}"
                + (f", conv {extra['conv_max_abs_diff']!r}, state "
                   f"{extra['state_max_abs_diff']!r}" if extra else "")
                + f", within band {row['ok']}")
            del mine, whole
            free(dev)
    if not agree(all(r["ok"] for r in rows)):
        fail("moe_pieces: a sublayer on 4 ranks left the band of the whole")
    return {"moe_pieces": rows}


def family_phase(name, spec, dev_kind):
    """A model no card holds, whole on (1, 4) (the batch does not shard:
    the KV cache's sequence splits over ``model``): first cut to
    ``cut_layers`` in float32 against the same cut on rank 0 alone, every
    step within the band (the gate); then every layer in bf16 under both
    ``softmax_combine`` schedules, every cache leaf filled from a seed
    (``fill_every_leaf``), 16 steps from ``fill``.  Gates: finite logits
    identical on every rank, one ``flash_decode`` launch per attention
    layer, rank and step (the tensor-core variant).  Recorded: ms a step,
    tokens/s, the GB a rank resident before the steps and the steps'
    peak (each reset after the fill, whose whole-layer draws it leaves
    out), the plan, and from torch.profiler (steps 12-15) the device's
    compute and NCCL time, the compute stream's idle share, host ops a
    step and the ``softmax_combine`` and ``moe_combine`` ranges' device
    and host ms a step against the wall step."""
    out = {}
    base = get_config(spec["arch"], smoke=spec["smoke"])
    mesh = make_mesh((1, 4), ("data", "model"), device=dev_kind)
    dev = mesh.device
    b, seq, steps, fill = (spec[k] for k in ("batch", "seq", "steps",
                                             "fill"))
    toks = tokens_for(base, b, steps, 3)
    tok_spec = (None, None)

    # 1. the float32 cut against rank 0 alone
    cut = base.replace(n_layers=spec["cut_layers"], compute_dtype="float32")
    cseq, cfill = spec["cut_seq"], spec["cut_fill"]
    step_fn = make_serve_step(cut, mesh, batch_shardable=False)
    params = init_sharded_params(mdl.model_defs(cut), step_fn.plan, mesh,
                                 seed=0, dtype=torch.float32)
    caches = mdl.init_caches(cut, b, cseq, mesh=mesh, batch_shardable=False,
                             dtype=torch.float32, device=dev)
    fill_every_leaf(caches, cut, b, cseq, cfill, 0, mesh, False)
    mesh_logits, _, _ = decode_run(step_fn, params, caches, toks, cfill,
                                   mesh, tok_spec)
    del params, caches
    free(dev)
    alone = alone_run(cut, b, cseq, cfill, 0, toks, dev, torch.float32,
                      filler=fill_every_leaf)
    ok = True
    if alone is not None:
        diffs, bands = per_step(mesh_logits, alone[0])
        finite = bool(torch.isfinite(mesh_logits).all())
        out[f"{name}_cut"] = {
            "layers": cut.n_layers, "dtype": "float32", "batch": b,
            "seq": cseq, "start": cfill, "steps": steps,
            "max_abs_diff_per_step": diffs, "within_band_per_step": bands,
            "finite": finite, "max_abs_logit": float(alone[0].abs().max())}
        ok = all(bands) and finite
        log(f"[{name}_cut] {cut.n_layers} layers float32, (1, 4) vs rank 0 "
            f"alone, {steps} steps from {cfill}: max |diff| a step {diffs}")
    free(dev)
    if not agree(ok):
        fail(f"{name}_cut: a step of the 4-rank float32 cut left the band "
             f"of rank 0 alone")

    # 2. every layer, bf16
    t0 = time.perf_counter()
    step_fn = make_serve_step(base, mesh, batch_shardable=False)
    params = init_sharded_params(mdl.model_defs(base), step_fn.plan, mesh,
                                 seed=0)
    caches = mdl.init_caches(base, b, seq, mesh=mesh, batch_shardable=False,
                             device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    n_attn = [m for m, _ in base.pattern].count("attn") * base.n_blocks
    runs, resident, peak = {}, None, None
    for sched in ("xla", "gleam_tree"):
        run = make_serve_step(step_fn.cfg.replace(collective_schedule=sched),
                              mesh, batch_shardable=False)
        fill_every_leaf(caches, base, b, seq, fill, 1, mesh, False)
        if dev.type == "cuda":
            # the steps' own peak: the fill's whole-layer draws left out
            sync(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            resident = torch.cuda.memory_allocated(dev) / 1e9
        fd.reset_launches()
        logits, ms, prof = decode_run(run, params, caches, toks, fill, mesh,
                                      tok_spec, profile=spec["profile"])
        if dev.type == "cuda":
            peak = max(peak or 0.0,
                       torch.cuda.max_memory_allocated(dev) / 1e9)
        launches = dict(fd.LAUNCHES)
        finite = bool(torch.isfinite(logits).all())
        same = same_on_every_rank(logits)
        timed = ms[1:spec["profile"][0]] if spec["profile"] else ms[1:]
        row = {"schedule": sched, "fill": fill, "steps": steps,
               "ms_per_step": float(np.mean(timed)), "ms_first_step": ms[0],
               "tokens_per_s": b / (np.mean(timed) / 1e3),
               "flash_decode_launches_per_step":
                   launches["flash_decode"] / steps,
               "launches": launches, "finite": finite,
               "identical_on_every_rank": same,
               "max_abs_logit": float(logits.abs().max()), "profile": prof}
        runs[sched] = (logits, row)
        log(f"[{name}] {base.n_layers} layers (1, 4), batch {b}, {seq} "
            f"slots, fill {fill}, {sched}: {row['ms_per_step']:.3f} ms/step, "
            f"{row['tokens_per_s']:.1f} tok/s, flash_decode "
            f"{row['flash_decode_launches_per_step']} a step, finite "
            f"{finite}, identical on every rank {same}")
        if prof:
            log(f"[{name}]   profile: {profile_line(prof)}")
        if not finite or not same:
            fail(f"{name} {sched}: finite {finite}, identical on every rank "
                 f"{same}")
        want = steps * n_attn if dev.type == "cuda" else 0
        if launches["flash_decode"] != want \
                or launches["flash_decode_mma"] != want:
            fail(f"{name} {sched}: flash_decode launched "
                 f"{launches['flash_decode']} times (mma "
                 f"{launches['flash_decode_mma']}), not {want}")
    a, ra = runs["gleam_tree"]
    ra["max_abs_diff_vs_xla_per_step"], _ = per_step(a, runs["xla"][0])
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, (resident, peak))
    log(f"[{name}] resident (weights and caches) / the steps' peak GB a "
        f"rank {peaks}, plan "
        f"{'default' if step_fn.cfg.fsdp_weights else 'inference'}, init "
        f"{init_s:.1f} s")
    out[name] = {"layers": base.n_layers, "batch": b, "seq": seq,
                 "plan": "default" if step_fn.cfg.fsdp_weights
                 else "inference",
                 "init_s": init_s,
                 "resident_gb_per_rank": [r for r, _ in peaks],
                 "peak_gb_per_rank": [p for _, p in peaks],
                 "runs": [row for _, row in runs.values()]}
    del params, caches
    free(dev)
    return out


COLLECTIVE_CASES = (
    ("tree_broadcast", dict(root=0)), ("tree_broadcast", dict(root=3)),
    ("unicast_broadcast", dict(root=0)),
    ("ring_broadcast", dict(root=0, chunks=1)),
    ("ring_broadcast", dict(root=1, chunks=4)),
    ("tree_reduce", dict(combine="add", root=0)),
    ("tree_allreduce", dict(combine="add", root=2)),
    ("butterfly_allreduce", dict(combine="add")),
    ("butterfly_allreduce", dict(combine="min")),
    ("allreduce_sum", dict(schedule="xla")),
    ("allreduce_sum", dict(schedule="gleam_tree")),
    ("allreduce_sum", dict(schedule="ring")),
    ("allreduce_sum", dict(schedule="unicast")),
    ("softmax_combine", dict(schedule="xla")),
    ("softmax_combine", dict(schedule="gleam_tree")),
)
COMBINE = {"add": torch.add, "min": torch.minimum}


def collective_inputs(nbytes, rank):
    gen = torch.Generator().manual_seed(_seed(nbytes, rank))
    x = torch.randn(nbytes // 4, generator=gen)
    rows = nbytes // (4 * 66)
    parts = (3 * torch.randn(rows, generator=gen),
             torch.rand(rows, generator=gen) + 0.5,
             torch.randn(rows, 64, generator=gen))
    return x, parts


def call(fn, kw, x, parts, mesh):
    f = getattr(coll, fn)
    if fn == "softmax_combine":
        return f(parts, mesh, ("x",), schedule=kw["schedule"])
    if fn == "allreduce_sum":
        return f(x, mesh, ("x",), schedule=kw["schedule"])
    if "combine" in kw:
        extra = {k: v for k, v in kw.items() if k != "combine"}
        return f(x, mesh, "x", COMBINE[kw["combine"]], **extra)
    return f(x, mesh, "x", **kw)


def collectives_phase(sizes, dev_kind):
    nccl = make_mesh((4,), ("x",), device=dev_kind)
    gloo = make_mesh((4,), ("x",), device="cpu", backend="gloo")
    dev = nccl.device
    rows, ok = [], True
    for nbytes in sizes:
        x, parts = collective_inputs(nbytes, dist.get_rank())
        xd, pd = x.to(dev), tuple(p.to(dev) for p in parts)
        for fn, kw in COLLECTIVE_CASES:
            got = call(fn, kw, xd, pd, nccl)            # warm-up and result
            sync(dev)
            t0 = time.perf_counter()
            reps = 3
            for _ in range(reps):
                call(fn, kw, xd, pd, nccl)
            sync(dev)
            card_ms = (time.perf_counter() - t0) * 1e3 / reps
            dist.barrier()
            t0 = time.perf_counter()
            want = call(fn, kw, x, parts, gloo)
            host_ms = (time.perf_counter() - t0) * 1e3
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max(float((g.cpu() - w).abs().max()) for g, w in
                      zip(got, want))
            scale = max(float(w.abs().max()) for w in want)
            exact = fn.endswith("broadcast")
            good = err == 0 if exact else err <= 1e-6 * scale
            good = agree(good)
            ok &= good
            rows.append({"function": fn, **kw, "bytes_per_rank": nbytes,
                         "nccl_ms": card_ms, "gloo_ms": host_ms,
                         "max_abs_diff": err, "scale": scale,
                         "bit_for_bit": exact, "ok": good})
            log(f"[collectives] {fn} {kw} {nbytes >> 10} KiB: nccl "
                f"{card_ms:.3f} ms, gloo {host_ms:.1f} ms, max |diff| "
                f"{err!r} ({'exact' if exact else 'rel 1e-6'}) ok {good}")
    if not ok:
        fail("collectives: NCCL and gloo disagree")
    return {"collectives": rows}


def pipeline_phase(dev_kind):
    mesh = make_mesh((4,), ("stage",), device=dev_kind)
    dev = mesh.device
    gen = torch.Generator().manual_seed(0)
    w = (torch.randn(16, 32, 32, generator=gen) * 0.3).to(dev)
    b = (torch.randn(16, 32, generator=gen) * 0.1).to(dev)
    xs = torch.randn(4, 2, 32, generator=gen).to(dev)

    def stage_fn(params, x):
        for wi, bi in zip(*params):
            x = torch.tanh(x @ wi + bi)
        return x
    staged = pipeline_stages((w, b), 4)
    sid = mesh.axis_index("stage")
    got = pipeline(stage_fn, mesh, "stage")((staged[0][sid], staged[1][sid]),
                                            xs)
    want = torch.stack([stage_fn((w, b), x) for x in xs])
    last = torch.zeros_like(got)
    if sid == 3:
        last.copy_(got)
    dist.all_reduce(last)           # the last stage's result on every rank
    err = float((last - want).abs().max())
    ok = err <= 1e-5
    log(f"[pipeline] 4 stages x 4 layers, 4 microbatches: max |diff| vs "
        f"unpipelined {err!r}, ok {ok}")
    if not ok:
        fail("pipeline: the pipelined result left 1e-5 of the layers'")
    return {"pipeline": {"stages": 4, "layers": 16, "max_abs_diff": err,
                         "ok": ok}}


# ------------------------------------------------------- train, prefill

#: the float32 gate of a mesh train step against rank 0 alone
#: (``tests/test_torch_train.py``'s ``TOL`` and ``ORACLE_FACTOR``)
TRAIN_TOL, ORACLE_FACTOR = 1e-4, 8.0
#: the most of a step's updated elements the float64 rule may excuse:
#: 0.101 measured on the float32 2-layer granite cut at full width on
#: four H100s, with room above it
NOISE_CAP = 0.2
#: wrong mesh steps that the train gate must reject: the ``model`` psum of
#: a replicated activation's gradient left out, and the loss over each
#: rank's own mask sum (as ``tests/_torch_mesh_worker.py``'s mutants)
WRONG_STEPS = {"no_model_psum": (coll, "grad_psum",
                                 lambda x, mesh, axes: x),
               "own_mask_sum": (mdl, "_mask_total",
                                lambda mask, mesh, axes: mask.sum())}


#: wrong expert-parallel steps that ``train_mixtral14``'s gate must reject
#: (``tests/_torch_mesh_cases.MOE_MUTANTS``, the gloo worlds' own)
MOE_WRONG_STEPS = {name: (moe_mod, "coll", cases.MoEMutant(name, coll))
                   for name, _ in cases.MOE_MUTANTS}
#: the card's bf16 peak (dense, H100 SXM datasheet), for mfu
PEAK_BF16 = PEAK_FLOPS[torch.bfloat16]


def train_batch(cfg, batch, seq, mesh, seed):
    """A global train batch drawn whole from a generator seeded by
    ``seed`` on the rank's device (the same bits on any mesh): tokens,
    targets (the tokens shifted by one) and a loss mask of ones but for
    the first quarter of row 0; and this rank's block of its rows."""
    gen = torch.Generator(device=mesh.device).manual_seed(seed)
    rows = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=gen,
                         device=mesh.device)
    mask = torch.ones((batch, seq), device=mesh.device)
    mask[0, :seq // 4] = 0.0
    whole = {"tokens": rows[:, :-1], "targets": rows[:, 1:],
             "loss_mask": mask}
    spec = (mdl._bspec(mesh), None)
    return whole, {k: shd.shard(v, spec, mesh) for k, v in whole.items()}


def gate_step(cfg, mesh, batch, accum, push=0.0, wrong=None):
    """One ``make_train_step`` step (AdamW warmup 1) from the seed-0
    float32 state on ``mesh``: its metrics, and the gradient it hands
    AdamW and the updated parameters gathered whole (on the CPU).
    ``push`` scales 1% of every leaf's elements by (1 + push) first (a
    rounding-sized push on one rank alone: the yardstick of how far the
    gradient moves with a float32 rounding).  ``wrong`` names one of
    ``WRONG_STEPS`` to put in place of the right part for this step.
    The gathered trees are kept on rank 0 alone (None elsewhere)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw
    defs = mdl.model_defs(cfg)
    specs = mdl.train_specs(cfg, mesh)
    params = init_sharded_params(defs, shd.ShardingPlan(mesh), mesh, seed=0,
                                 dtype=torch.float32)
    gen = torch.Generator(device=mesh.device).manual_seed(11)
    for _, t in tree_leaves(params) if push else ():
        pick = torch.rand(t.shape, generator=gen, device=t.device) < 0.01
        t.copy_(torch.where(pick, t * (1 + push), t))

    def whole(tree):
        # a copy (AdamW scales the gradient by the clip factor in place),
        # kept on rank 0 alone, the one that compares
        keep = dist.get_rank() == 0
        return {n: g.to("cpu", copy=True) if keep else None
                for n, g in ((n, shd.gather(t, sp, mesh))
                             for (n, t), (_, sp) in zip(
                                 tree_leaves(tree), tree_leaves(specs)))}
    seen, apply = [], adamw.apply

    def recorded(opt_cfg, p, state, grads, **kw):
        seen.append(whole(grads))
        return apply(opt_cfg, p, state, grads, **kw)
    patches = [(adamw, "apply", recorded)]
    if wrong:
        patches.append({**WRONG_STEPS, **MOE_WRONG_STEPS}[wrong])
    saved = [(module, name, getattr(module, name))
             for module, name, _ in patches]
    for module, name, fn in patches:
        setattr(module, name, fn)
    try:
        step = make_train_step(cfg, adamw.AdamWConfig(warmup_steps=1), accum,
                               mesh=mesh)
        params, _, m = step(params, adamw.init(params), batch)
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)
    return ({k: float(v) for k, v in m.items()}, seen[0], whole(params))


def gate_faults(got, want, pushed=None, push_faults=None):
    """Where the (2, 2) step leaves rank 0 alone: the loss and
    ``grad_norm`` beyond ``TRAIN_TOL``; every updated leaf beyond it
    outside the elements whose first AdamW step is held by the float64
    rule of ``tests/test_torch_train.py`` (their gradient nonzero and no
    larger than the leaf's float32 error, here the largest distance
    between the two float32 gradients, as no float64 kernel exists on the
    card: AdamW's g / (|g| + 1e-8) may take either's sign or a size set
    by the 1e-8); and each gradient leaf's largest distance over its
    largest magnitude beyond ``ORACLE_FACTOR`` times that of ``pushed``,
    rank 0 alone from a rounding-sized push (the float32 gradient's own
    sensitivity).  The share of elements held by the float64 rule must
    stay within ``NOISE_CAP``: at full width the gradient is
    ill-conditioned (a 1e-7 push on 1% of the parameters moves it by up
    to 1e-3 of its largest magnitude), so that share is far above the
    smoke configs' 1%, and the gradient itself is held to the push as
    well.  ``WRONG_STEPS`` are the faults this gate must reject.  The
    trees lie on the host; each leaf is compared on the rank's device."""
    (m, g, p), (m1, g1, p1) = got, want
    out = {"metrics": [k for k in ("loss", "grad_norm")
                       if abs(m[k] - m1[k]) > TRAIN_TOL * (1 + abs(m1[k]))],
           "leaves": {}, "grad_rel": {}}
    noise = total = 0
    for name in p1:
        gn, g1n, pn, w = (t[name].to(DEV[0]) for t in (g, g1, p, p1))
        err = float((gn - g1n).abs().max())
        out["grad_rel"][name] = err / max(float(g1n.abs().max()), 1e-30)
        kept = (g1n == 0) | (g1n.abs() > err)
        noise += int((~kept).sum())
        total += kept.numel()
        far = (pn - w).abs() > TRAIN_TOL * (1 + w.abs())
        if bool((far & kept).any()):
            out["leaves"][name] = float((pn - w).abs()[kept].max())
        del gn, g1n, pn, w, kept, far
    out["noise_share"] = noise / total
    if pushed is not None:
        push_faults = push_faults or gate_faults(pushed, want)
        out["pushed_1e-7_grad_rel"] = push_faults["grad_rel"]
        out["grads"] = {n: r for n, r in out["grad_rel"].items()
                        if r > ORACLE_FACTOR * max(
                            out["pushed_1e-7_grad_rel"][n], 1e-7)}
    out["ok"] = not (out["metrics"] or out["leaves"] or out.get("grads")
                     or out["noise_share"] > NOISE_CAP)
    return out


def timed_train(cfg, mesh, whole, mine, accum, steps, label,
                ranges=TRAIN_RANGES):
    """``steps`` steps of ``make_train_step`` on ``mesh`` from the seed-0
    float32 state (``init_sharded_params``), then one more under
    torch.profiler: ms a step (after the first), tok/s, mfu (the
    one-card train phase's model FLOPs, ``roofline.train_step_flops``, over
    four cards' bf16 peak), the steps' peak GB a rank, and the profile
    (NCCL device ms a step, the compute stream's idle share,
    ``TRAIN_RANGES``)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw
    dev = mesh.device
    params = init_sharded_params(mdl.model_defs(cfg), shd.ShardingPlan(mesh),
                                 mesh, seed=0, dtype=torch.float32)
    state = adamw.init(params)
    step = make_train_step(cfg, adamw.AdamWConfig(), accum, mesh=mesh)
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launches()
    losses, norms, ms = [], [], []
    for _ in range(steps):
        sync(dev)
        t0 = time.perf_counter()
        params, state, m = step(params, state, mine)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(fa.LAUNCHES)
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    sync(dev)
    with prof:
        t0 = time.perf_counter()
        params, state, m = step(params, state, mine)
        float(m["loss"])
        sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
    summary = profile_summary(prof, wall, 1, ranges)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 \
        if dev.type == "cuda" else 0.0
    b, seq = whole["tokens"].shape
    flops = train_step_flops(cfg, b, seq)
    step_s = float(np.mean(ms[1:])) / 1e3 if steps > 1 else ms[0] / 1e3
    norm_all = torch.tensor(norms, device=DEV[0])
    row = {"arch": cfg.name, "n_layers": cfg.n_layers, "mesh": list(
        mesh.dims), "batch": b, "seq": seq, "accum": accum,
        "n_params": count_params(mdl.model_defs(cfg)),
        "losses": losses, "grad_norms": norms, "ms_per_step_all": ms,
        "ms_per_step": step_s * 1e3, "tokens_per_s": b * seq / step_s,
        "model_flops_per_step": flops,
        "mfu": flops / step_s / (mesh.size * PEAK_BF16),
        "peak_gb_rank0": peak, "peak_gb_max": None,
        "grad_norms_equal_on_every_rank": same_on_every_rank(norm_all),
        "launches": launches, "profile": summary}
    peaks = torch.tensor([peak], device=DEV[0])
    dist.all_reduce(peaks, op=dist.ReduceOp.MAX)
    row["peak_gb_max"] = float(peaks.item())
    log(f"[{label}] {cfg.name} ({cfg.n_layers} layers, "
        f"{row['n_params'] / 1e9:.3f} B parameters) on {tuple(mesh.dims)}, "
        f"{b} x {seq} in {accum} microbatches: losses {losses}, grad norms "
        f"{norms} (equal on every rank "
        f"{row['grad_norms_equal_on_every_rank']}), "
        f"{row['ms_per_step']:.1f} ms a step after the first ({ms}), "
        f"{row['tokens_per_s']:.1f} tok/s, mfu {row['mfu']:.4f}, peak "
        f"{row['peak_gb_max']:.2f} GB a rank, launches a rank {launches}; "
        f"profiled step: {profile_line(summary, ranges)}")
    for key, t, n in summary["top_device_ms"]:
        log(f"[{label}]   device {t:10.3f} ms  {n:6d}x  {key[:90]}")
    del params, state, step
    free(dev)
    return row


def wgmma_launches(row, cfg, accum, steps):
    """Whether a rank launched the attention kernel (the wgmma variant,
    or nothing on the CPU) twice a layer and microbatch: forward and
    remat recompute."""
    want = 2 * cfg.n_layers * accum * steps if DEV[0].type == "cuda" else 0
    return row["launches"]["flash_attention_wgmma"] == want \
        and row["launches"]["flash_attention"] == want


def train_granite_phase(spec, dev_kind):
    """granite_3_2b on (2, 2): the float32 cut to 2 layers, one step
    against the same step on rank 0 alone (the gate); then all 40 layers
    in bf16 compute, ``steps`` steps and one profiled."""
    mesh = make_mesh((2, 2), ("data", "model"), device=dev_kind)
    base = get_config(spec["arch"], smoke=spec["smoke"])
    b, seq, accum = spec["batch"], spec["seq"], spec["accum"]
    cut = base.replace(n_layers=2, compute_dtype="float32")
    whole, mine = train_batch(cut, b, seq, mesh, 4)
    got = gate_step(cut, mesh, mine, accum)
    wrong = {name: gate_step(cut, mesh, mine, accum, wrong=name)
             for name in WRONG_STEPS}
    out = {}
    if dist.get_rank() == 0:
        one = single_device_mesh(device=str(mesh.device))
        want = gate_step(cut, one, whole, accum)
        pushed = gate_step(cut, one, whole, accum, push=1e-7)
        out["gate"] = gate_faults(got, want, pushed)
        out["wrong_steps"] = {}
        for name, res in wrong.items():
            faults = gate_faults(res, want, pushed)
            out["wrong_steps"][name] = {
                "rejected": not faults["ok"], "metrics": faults["metrics"],
                "leaves_off": len(faults["leaves"]),
                "grad_leaves_off": len(faults["grads"]),
                "noise_share": faults["noise_share"],
                "largest_grad_rel": max(faults["grad_rel"].values())}
            log(f"[train_granite22] wrong step {name} on the float32 cut: "
                f"{out['wrong_steps'][name]}")
        del pushed
        out["gate"].update(loss=got[0]["loss"], loss_alone=want[0]["loss"],
                           grad_norm=got[0]["grad_norm"],
                           grad_norm_alone=want[0]["grad_norm"])
        log(f"[train_granite22] float32 cut to 2 layers on (2, 2) vs rank 0 "
            f"alone, one step: loss {got[0]['loss']!r} / "
            f"{want[0]['loss']!r}, grad_norm {got[0]['grad_norm']!r} / "
            f"{want[0]['grad_norm']!r}, leaves off {out['gate']['leaves']}, "
            f"gradient leaves off {out['gate']['grads']}, share held by "
            f"the float64 rule {out['gate']['noise_share']!r}, gradient "
            f"distance / max by leaf {out['gate']['grad_rel']}; rank 0 alone "
            f"pushed by 1e-7 on 1% of each leaf: "
            f"{out['gate']['pushed_1e-7_grad_rel']}")
        del want
    del got, wrong
    free(mesh.device)
    if not agree(out["gate"]["ok"] if dist.get_rank() == 0 else True):
        fail("train_granite22: the float32 cut's step left the tolerance "
             "of rank 0 alone")
    if not agree(all(w["rejected"] for w in out["wrong_steps"].values())
                 if dist.get_rank() == 0 else True):
        fail(f"train_granite22: the gate passed a wrong step "
             f"{out['wrong_steps']}")
    whole, mine = train_batch(base, b, seq, mesh, 5)
    out["run"] = timed_train(base, mesh, whole, mine, accum, spec["steps"],
                             "train_granite22")
    if not agree(all(np.isfinite(out["run"]["losses"]))
                 and wgmma_launches(out["run"], base, accum, spec["steps"])):
        fail("train_granite22: a loss is not finite or the attention "
             "kernel's launches are not two a layer and microbatch")
    return {"train_granite22": out}


def train_qwen_phase(spec, dev_kind):
    """qwen1_5_110b at full width, 2 of its 80 layers, on (2, 2): a train
    state one card cannot hold.  Gates: finite losses, every rank's
    ``grad_norm`` equal."""
    mesh = make_mesh((2, 2), ("data", "model"), device=dev_kind)
    cfg = get_config(spec["arch"], smoke=spec["smoke"]).replace(
        n_layers=spec["layers"])
    whole, mine = train_batch(cfg, spec["batch"], spec["seq"], mesh, 6)
    row = timed_train(cfg, mesh, whole, mine, spec["accum"], spec["steps"],
                      "train_qwen22")
    if not agree(all(np.isfinite(row["losses"]))
                 and row["grad_norms_equal_on_every_rank"]
                 and wgmma_launches(row, cfg, spec["accum"], spec["steps"])):
        fail("train_qwen22: a loss is not finite or the ranks' grad norms "
             "differ")
    return {"train_qwen22": row}


class Drops:
    """``models/moe._bucket_ffn`` counting the (token, k) rows the experts
    keep: an expert keeps its first ``cap_e`` rows (the stable rank), so
    ``sum(min(rows_e, cap_e))``; a row dropped before (at a mesh source's
    ``cap`` slots a destination) never reaches it.  ``calls`` counts the
    rank's calls (one a MoE sublayer and microbatch)."""

    def __enter__(self):
        self.real, self.kept, self.calls = moe_mod._bucket_ffn, 0, 0
        moe_mod._bucket_ffn = self.counted
        return self

    def __exit__(self, *exc):
        moe_mod._bucket_ffn = self.real

    def counted(self, rows, eids, n_exp, cap_e, *args):
        per = torch.bincount(eids[eids < n_exp], minlength=n_exp)
        self.kept += int(torch.clamp(per, max=cap_e).sum())
        self.calls += 1
        return self.real(rows, eids, n_exp, cap_e, *args)


def dropped_rows(cfg, mesh, batch, accum, global_tokens):
    """The (token, k) rows ``cfg``'s MoE forward drops on ``mesh`` (all
    ranks together) from ``gate_step``'s seed-0 float32 state, over the
    ``accum`` microbatches of ``batch`` (this rank's rows of a batch of
    ``global_tokens``): every row routed less every row an expert kept,
    summed over the sublayers.  Forward only."""
    from repro_torch.launch.steps import microbatches
    params = init_sharded_params(mdl.model_defs(cfg), shd.ShardingPlan(mesh),
                                 mesh, seed=0, dtype=torch.float32)
    with torch.no_grad(), Drops() as seen:
        for mb in microbatches(batch, accum, mesh):
            mdl.loss_fn(params, mb, cfg, mesh=mesh)
    kept = torch.tensor([seen.kept], device=DEV[0])
    if mesh.size > 1:
        dist.all_reduce(kept)
    routed = seen.calls * global_tokens // accum * cfg.top_k
    del params
    free(mesh.device)
    return routed - int(kept.item())


def gate_capacity(cfg, ep):
    """The least capacity factor at which neither side of the MoE gate
    can drop a row: a mesh source's ``cap`` slots a destination
    (``cf n / ep`` of its n rows) hold them all when cf >= ep, and an
    expert's slots (``cf n / E`` on one device; ``ep cap / e_local``, the
    same, on the mesh) hold every token once when cf >= E / k (a token's
    k rows go to k different experts)."""
    return float(max(ep, cfg.n_experts / cfg.top_k))


def mixtral_base(spec):
    """The mixtral phases' config: ``spec``'s depth, and its ``width``
    where given (the head counts, vocabulary and experts kept)."""
    cfg = get_config(spec["arch"], smoke=spec["smoke"]).replace(
        n_layers=spec["layers"])
    if "width" in spec:
        w = spec["width"]
        cfg = cfg.replace(d_model=w, head_dim=w // cfg.n_heads, d_ff=2 * w,
                          moe_d_ff=2 * w)
    return cfg


def train_mixtral_phase(spec, dev_kind):
    """mixtral_8x7b at full width, 2 of its 32 layers, on (1, 4) with
    expert-parallel dispatch: the float32 cut's step against rank 0 alone
    (``train_granite22``'s gate, at ``gate_capacity``, where neither side
    can drop a row; the rows each side drops at the config's own capacity
    factor and at that one counted), then bf16 compute, ``steps`` steps
    and one profiled with the dispatch's ranges."""
    label = "train_mixtral14"
    mesh = make_mesh((1, 4), ("data", "model"), device=dev_kind)
    base = mixtral_base(spec)
    b, seq, accum = spec["batch"], spec["seq"], spec["accum"]
    # the router loss of a mesh is the mean of each rank's over its own
    # tokens (the reference's pmean), not the one device's over all of
    # them: the gate's step leaves it out of the gradient.  A mesh drops
    # rows at each source's slots a destination, one device at each
    # expert's slots: the gate runs where neither drops any
    cf = gate_capacity(base, mesh.shape["model"])
    cut = base.replace(compute_dtype="float32", router_aux_coef=0.0,
                       capacity_factor=cf)
    whole, mine = train_batch(cut, *spec["gate"], mesh, 7)
    tokens = spec["gate"][0] * spec["gate"][1]
    cfs = (base.capacity_factor, cf)
    drops = {"mesh": {c: dropped_rows(cut.replace(capacity_factor=c), mesh,
                                      mine, accum, tokens) for c in cfs}}
    got = gate_step(cut, mesh, mine, accum)
    wrong = {name: gate_step(cut, mesh, mine, accum, wrong=name)
             for name in MOE_WRONG_STEPS}
    free(mesh.device)
    out = {}
    if dist.get_rank() == 0:
        one = single_device_mesh(device=str(mesh.device))
        drops["alone"] = {c: dropped_rows(cut.replace(capacity_factor=c),
                                          one, whole, accum, tokens)
                          for c in cfs}
        drops["rows"] = tokens * cut.top_k * cut.n_layers
        want = gate_step(cut, one, whole, accum)
        free(mesh.device)
        pushed = gate_step(cut, one, whole, accum, push=1e-7)
        out["gate"] = gate_faults(got, want, pushed)
        out["gate"]["capacity_factor"] = cf
        out["gate"]["dropped_rows"] = drops
        out["gate"]["ok"] &= drops["mesh"][cf] == drops["alone"][cf] == 0
        out["wrong_steps"] = {}
        for name, res in wrong.items():
            faults = gate_faults(res, want, pushed)
            out["wrong_steps"][name] = {
                "rejected": not faults["ok"], "metrics": faults["metrics"],
                "leaves_off": len(faults["leaves"]),
                "grad_leaves_off": len(faults["grads"]),
                "noise_share": faults["noise_share"],
                "largest_grad_rel": max(faults["grad_rel"].values())}
            log(f"[{label}] wrong step {name}: {out['wrong_steps'][name]}")
        del pushed
        out["gate"].update(loss=got[0]["loss"], loss_alone=want[0]["loss"],
                           grad_norm=got[0]["grad_norm"],
                           grad_norm_alone=want[0]["grad_norm"])
        log(f"[{label}] float32 on (1, 4) vs rank 0 alone, one step at "
            f"{spec['gate'][0]} x {spec['gate'][1]} in {accum}, capacity "
            f"factor {cf}: loss {got[0]['loss']!r} / {want[0]['loss']!r}, "
            f"grad_norm {got[0]['grad_norm']!r} / "
            f"{want[0]['grad_norm']!r}, metrics off "
            f"{out['gate']['metrics']}, leaves off {out['gate']['leaves']}, "
            f"gradient leaves off {out['gate']['grads']}, share held by "
            f"the float64 rule {out['gate']['noise_share']!r}, gradient "
            f"distance / max by leaf {out['gate']['grad_rel']}; rank 0 alone "
            f"pushed by 1e-7 on 1% of each leaf: "
            f"{out['gate']['pushed_1e-7_grad_rel']}; (token, k) rows "
            f"dropped by capacity factor {drops}; ok {out['gate']['ok']}")
        del want
    del got, wrong
    free(mesh.device)
    if not agree(out["gate"]["ok"] if dist.get_rank() == 0 else True):
        fail(f"{label}: the float32 step left the tolerance of rank 0 "
             f"alone, or a side dropped rows")
    if not agree(all(w["rejected"] for w in out["wrong_steps"].values())
                 if dist.get_rank() == 0 else True):
        fail(f"{label}: the gate passed a wrong step {out['wrong_steps']}")
    whole, mine = train_batch(base, b, seq, mesh, 8)
    out["run"] = timed_train(base, mesh, whole, mine, accum, spec["steps"],
                             label, MOE_TRAIN_RANGES)
    if not agree(all(np.isfinite(out["run"]["losses"]))
                 and out["run"]["grad_norms_equal_on_every_rank"]
                 and wgmma_launches(out["run"], base, accum, spec["steps"])):
        fail(f"{label}: a loss is not finite, the ranks' grad norms differ "
             f"or the attention kernel's launches are not two a layer and "
             f"microbatch")
    return {label: out}


@contextlib.contextmanager
def plain_attention(on):
    """``kernels.flash_attention`` through its plain version
    (``ref.mha_reference``) while ``on``: float64 attention, which no
    kernel takes.  A probe's switch, never the gate's."""
    real = fa.flash_attention
    if on:
        fa.flash_attention = (lambda q, k, v, **kw:
                              fa.ref.mha_reference(q, k, v, **kw))
    try:
        yield
    finally:
        fa.flash_attention = real


def probe_mixtral_phase(spec, dev_kind):
    """``train_mixtral14``'s gate taken apart.  (a) The mesh step against
    rank 0 alone in float64 compute (weights, gradient and AdamW state
    float32; attention through its plain version, as no kernel takes
    float64), cut to 1 layer to fit one card: the program's arithmetic
    at full width on NCCL, where a fault would read far above the
    float32 storage of the gradient.  (b) The float32 gate's yardstick,
    rank 0 alone pushed by 1e-7 against itself, by the gate's own rule:
    how far a rounding-sized push moves the metrics, the leaves and the
    share of the float64 rule."""
    label = "probe_mixtral14"
    mesh = make_mesh((1, 4), ("data", "model"), device=dev_kind)
    base = mixtral_base(spec).replace(router_aux_coef=0.0)
    base = base.replace(capacity_factor=gate_capacity(
        base, mesh.shape["model"]))
    accum, out = spec["accum"], {}
    for dt, layers in (("float64", 1), ("float32", spec["layers"])):
        cut = base.replace(compute_dtype=dt, n_layers=layers)
        whole, mine = train_batch(cut, *spec["gate"], mesh, 7)
        with plain_attention(dt == "float64"):
            got = gate_step(cut, mesh, mine, accum) if dt == "float64" \
                else None
            free(mesh.device)
            if dist.get_rank() == 0:
                one = single_device_mesh(device=str(mesh.device))
                want = gate_step(cut, one, whole, accum)
                free(mesh.device)
                pushed = gate_step(cut, one, whole, accum, push=1e-7)
        if dist.get_rank() == 0:
            res = {"push": gate_faults(pushed, want)}
            pairs = [("push", pushed)]
            if got is not None:
                res["mesh"] = gate_faults(got, want, pushed, res["push"])
                pairs.append(("mesh", got))
            for name, (m, _, _) in pairs:
                res[name].update(
                    loss_off=abs(m["loss"] - want[0]["loss"]),
                    grad_norm_off=abs(m["grad_norm"] - want[0]["grad_norm"]),
                    grad_norm_alone=want[0]["grad_norm"])
                log(f"[{label}] {dt}, {layers} layers, {name} vs rank 0 "
                    f"alone: " + str({k: res[name][k] for k in (
                        "loss_off", "grad_norm_off", "grad_norm_alone",
                        "metrics", "leaves", "noise_share", "grad_rel",
                        "ok")}))
            out[dt] = res
            del want, pushed
        del got
        free(mesh.device)
        dist.barrier()
    return {label: out}


def prefill_qwen_phase(spec, dev_kind):
    """qwen1_5_110b whole (80 layers) on (1, 4), bf16 weights placed as
    the ``qwen`` decode phase places them, one prompt of ``seq`` tokens
    through ``make_prefill_step``: two timed calls and one profiled.
    Gates: finite last-position logits, the same on every rank."""
    from repro_torch.launch.steps import make_prefill_step
    mesh = make_mesh((1, 4), ("data", "model"), device=dev_kind)
    dev = mesh.device
    cfg = get_config(spec["arch"], smoke=spec["smoke"])
    params = init_sharded_params(mdl.model_defs(cfg), shd.ShardingPlan(mesh),
                                 mesh, seed=0, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (1, spec["seq"]), generator=gen,
                         device=dev)
    step = make_prefill_step(cfg, mesh=mesh)
    sync(dev)
    resident = torch.cuda.memory_allocated(dev) / 1e9 \
        if dev.type == "cuda" else 0.0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launches()
    ms = []
    for _ in range(2):
        sync(dev)
        t0 = time.perf_counter()
        logits = step(params, {"tokens": toks})
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 \
        if dev.type == "cuda" else 0.0
    launches = dict(fa.LAUNCHES)
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        t0 = time.perf_counter()
        step(params, {"tokens": toks})
        sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
    summary = profile_summary(prof, wall, 1, TRAIN_RANGES)
    finite = bool(torch.isfinite(logits).all())
    same = same_on_every_rank(logits)
    peaks = torch.tensor([peak], device=DEV[0])
    dist.all_reduce(peaks, op=dist.ReduceOp.MAX)
    row = {"arch": cfg.name, "n_layers": cfg.n_layers, "mesh": [1, 4],
           "prompt": spec["seq"], "ms": ms,
           "prompt_tokens_per_s": spec["seq"] / (ms[-1] / 1e3),
           "resident_gb_rank0": resident, "peak_gb_max": float(peaks.item()),
           "finite": finite, "same_on_every_rank": same,
           "logits_shape": list(logits.shape), "launches": launches,
           "profile": summary}
    log(f"[prefill_qwen] {cfg.name} ({cfg.n_layers} layers) on (1, 4), "
        f"1 x {spec['seq']}: {ms} ms (the second "
        f"{row['prompt_tokens_per_s']:.1f} prompt tok/s), resident "
        f"{resident:.2f} GB, peak {row['peak_gb_max']:.2f} GB a rank, "
        f"finite {finite}, identical on every rank {same}, launches a rank "
        f"{launches}; profiled call: "
        f"{profile_line(summary, TRAIN_RANGES)}")
    for key, t, n in summary["top_device_ms"]:
        log(f"[prefill_qwen]   device {t:10.3f} ms  {n:6d}x  {key[:90]}")
    del params, logits
    free(dev)
    want = 2 * cfg.n_layers if dev.type == "cuda" else 0
    if not agree(finite and same
                 and launches["flash_attention_wgmma"] == want):
        fail("prefill_qwen: logits not finite, not the same on every rank, "
             "or the attention kernel not launched once a layer")
    return {"prefill_qwen": row}


def prefill_pieces_phase(spec, dev_kind):
    """qwen1.5's layer 0 at full width on (1, 4), the prefill's attention
    sublayer (the rank's heads, kv heads split, ``wo``'s partial sums
    all-reduced) and MLP against the same sublayer of the whole layer on
    every rank, on the same input: bf16 at 1 x ``seq16``, float32 at 1 x
    ``seq32``, each within the band of the output's largest magnitude
    (``within_scale``, as ``pieces``)."""
    base = get_config(spec["arch"], smoke=spec["smoke"]).replace(n_layers=1)
    mesh = make_mesh((1, 4), ("data", "model"), device=dev_kind)
    dev = mesh.device
    rows = []
    for dt, seq in (("bfloat16", spec["seq16"]), ("float32", spec["seq32"])):
        cdt = getattr(torch, dt)
        cfg = base.replace(compute_dtype=dt)
        defs = mdl.model_defs(cfg)
        blocks = init_sharded_params(defs, shd.ShardingPlan(mesh), mesh,
                                     seed=0, dtype=cdt)["blocks"]["sub0"]
        specs = mdl.train_specs(cfg, mesh)["blocks"]["sub0"]
        lsp = {part: tree_map(lambda sp: sp[1:], specs[part])
               for part in ("mixer", "ffn")}
        mine = {part: tree_map(lambda a: a[0], blocks[part]) for part in lsp}
        whole = {part: tree_map(lambda a, sp: shd.gather(a, sp, mesh),
                                mine[part], lsp[part]) for part in lsp}
        gen = torch.Generator(device=dev).manual_seed(5)
        x = torch.randn(1, seq, cfg.d_model, device=dev,
                        generator=gen).to(cdt)
        pos = torch.arange(seq, device=dev)[None]
        with torch.no_grad():
            got = mdl.attn_apply(mine["mixer"], x, cfg, pos,
                                 window=cfg.window, sp=lsp["mixer"],
                                 mesh=mesh)
            want = mdl.attn_apply(whole["mixer"], x, cfg, pos,
                                  window=cfg.window)
            rows.append({"sublayer": "attention", "dtype": dt, "seq": seq,
                         "max_abs_diff": float((got - want).abs().max()),
                         "max_abs": float(want.abs().max()),
                         "ok": within_scale(got.float(), want.float())})
            del got, want
            got, _ = mdl.ffn_apply(mine["ffn"], x, "mlp", cfg,
                                   sp=lsp["ffn"], mesh=mesh)
            want, _ = mdl.ffn_apply(whole["ffn"], x, "mlp", cfg)
            rows.append({"sublayer": "mlp", "dtype": dt, "seq": seq,
                         "max_abs_diff": float((got - want).abs().max()),
                         "max_abs": float(want.abs().max()),
                         "ok": within_scale(got.float(), want.float())})
        del blocks, mine, whole, got, want, x
        free(dev)
    for r in rows:
        log(f"[prefill_pieces] qwen1.5 layer 0 {r['sublayer']} {r['dtype']} "
            f"1 x {r['seq']}: max |diff| {r['max_abs_diff']!r} at max |y| "
            f"{r['max_abs']!r}, within band {r['ok']}")
    if not agree(all(r["ok"] for r in rows)):
        fail("prefill_pieces: a sublayer on 4 ranks left the band of the "
             "whole")
    return {"prefill_pieces": rows}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rehearse", action="store_true",
                    help="gloo ranks on the CPU, smoke configs")
    ap.add_argument("--phases",
                    default="pieces,qwen,granite22,collectives,pipeline,"
                            "moe_pieces,mixtral,jamba,prefill_pieces,"
                            "prefill_qwen,train_granite22,train_qwen22,"
                            "train_mixtral14")
    ap.add_argument("--d-model", type=int, default=None,
                    help="with --rehearse: the mixtral phases at full "
                         "vocabulary, head counts and gate batch, at this "
                         "width (head_dim d / 32, moe_d_ff 2 d)")
    ap.add_argument("--out", default=None,
                    help="the result's file name under chiprun_out/")
    args = ap.parse_args()
    sizes = SMALL if args.rehearse else FULL
    if args.rehearse and args.d_model:
        sizes = dict(sizes, train_mixtral14=dict(
            FULL["train_mixtral14"], width=args.d_model, batch=4, seq=64,
            steps=2))
    if args.rehearse:
        dev_kind = "cpu"
        dist.init_process_group("gloo")
    else:
        if not torch.cuda.is_available():
            print("chip_mesh: no CUDA device", file=sys.stderr)
            return 2
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local)
        # rank 0 alone runs a gate's reference steps and compares whole
        # float32 trees on the host while the others wait in a collective:
        # at mixtral's width that outlasted NCCL's default 10 minutes
        dist.init_process_group("nccl", timeout=datetime.timedelta(hours=1),
                                device_id=torch.device("cuda", local))
        dev_kind = "cuda"
        DEV[0] = torch.device("cuda", local)
        torch.backends.cuda.matmul.allow_tf32 = False
        if dist.get_rank() == 0:
            from repro_torch.kernels import build
            t0 = time.perf_counter()
            build.build(["flash_decode", "flash_attention"])
            log(f"[build] flash_decode, flash_attention in "
                f"{time.perf_counter() - t0:.1f} s")
        dist.barrier()
    if dist.get_world_size() != 4:
        raise SystemExit("chip_mesh runs on 4 ranks")
    t_start = time.perf_counter()
    card = None
    if dev_kind == "cuda" and dist.get_rank() == 0:
        import subprocess
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        log(f"[chip_mesh] cards: {card!r}, torch {torch.__version__}, "
            f"nccl {torch.cuda.nccl.version()}")
    phases = args.phases.split(",")
    out = {}
    for name in phases:
        t0 = time.perf_counter()
        try:
            if name == "pieces":
                out.update(pieces_phase(sizes["qwen"], dev_kind))
            elif name == "qwen":
                out.update(qwen_phase(sizes["qwen"], dev_kind))
            elif name == "granite22":
                out.update(granite_phase(sizes["granite"], dev_kind))
            elif name == "moe_pieces":
                out.update(moe_pieces_phase(sizes["moe_pieces"], dev_kind,
                                            args.rehearse))
            elif name in ("mixtral", "jamba"):
                out.update(family_phase(name, sizes[name], dev_kind))
            elif name == "collectives":
                out.update(collectives_phase(sizes["sizes"], dev_kind))
            elif name == "pipeline":
                out.update(pipeline_phase(dev_kind))
            elif name == "train_granite22":
                out.update(train_granite_phase(sizes[name], dev_kind))
            elif name == "train_qwen22":
                out.update(train_qwen_phase(sizes[name], dev_kind))
            elif name == "train_mixtral14":
                out.update(train_mixtral_phase(sizes[name], dev_kind))
            elif name == "probe_mixtral14":
                out.update(probe_mixtral_phase(sizes["train_mixtral14"],
                                               dev_kind))
            elif name == "prefill_qwen":
                out.update(prefill_qwen_phase(sizes[name], dev_kind))
            elif name == "prefill_pieces":
                out.update(prefill_pieces_phase(sizes[name], dev_kind))
            else:
                raise ValueError(name)
        except Exception as exc:          # report, and stop every rank
            fail(f"{name}: {type(exc).__name__}: {exc}")
            raise
        log(f"[chip_mesh] {name} {time.perf_counter() - t0:.1f} s")
    ok = agree(not FAILURES)
    if dist.get_rank() == 0:
        os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
        name = args.out or ("chip_mesh_rehearsal.json" if args.rehearse
                            else "chip_mesh.json")
        with open(os.path.join(REPO, "chiprun_out", name), "w") as fh:
            json.dump({"card": card, "torch": torch.__version__,
                       "phases": out, "failures": FAILURES,
                       "seconds": time.perf_counter() - t_start}, fh,
                      indent=1, default=str)
        print(json.dumps({"ok": ok, "failures": FAILURES,
                          "seconds": time.perf_counter() - t_start}))
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
