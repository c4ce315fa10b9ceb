"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the Hopper kernels of ``src/repro_torch/kernels/csrc/`` from the
checkout (one ``nvcc`` per source, all at once), drives the port's main
paths at full width, and holds every kernel against its plain PyTorch
version on the card:

1. **build**   ``nvcc`` for ``sm_90a`` (``-Xptxas -v`` printed), the
   card's name and power limit;
2. **paths**   each with every launch count set to 0 just before it and
   read just after:
   - fig14: HPL gleam vs ring/long on the 1024-host fat tree (scales 8,
     16, 32) and on the 16,384-host fat tree (scales 64, 128);
   - fig15: 4096-member bcasts on the 4096-host fat tree, gleam and
     multiunicast, loss 0 and 1e-3;
   - matrix: churn x loss x link-flap grid, 8 groups x 32 members on the
     4096-host fat tree (dynamic segments, float64 lanes);
   every JCT is held against the port's numpy solver (``flow-np``) at
   rtol 1e-3, and against the JAX package's recorded values where
   ``BENCH_flowsim.json`` has them; segment rates against the numpy
   ``LinkMap.segment_rates_many`` at 1e-6;
   - serve: granite_3_2b at full width (40 layers, d 2048, float32
     weights from seed 0, bf16 compute and caches) behind
     ``launch/serve.py``'s ``serve``: 16 requests, pool 8, 4096-slot
     caches, 32 new tokens each; every request must complete with 32
     tokens, the step count must be the scheduler's, the logits finite
     and ``flash_decode`` launched steps x 40 times, every one of them
     the tensor-core variant; steps 700-709 are traced with
     ``torch.profiler`` (device busy time and idle share, each kernel's
     device time a step, top device and host ops);
   - cross: the granite smoke config in float32 (TF32 off) served on the
     card and on the CPU with the same weights: identical greedy tokens,
     per-step logits within 1e-3;
   - prefill: ``launch/steps.make_prefill_step`` at full width on seed-0
     weights, bf16 compute, prompts from ``default_rng(0)``: granite_3_2b
     4 x 4096 (40 ``flash_attention`` launches, every one of them the
     wgmma variant), h2o_danube_3_4b 1 x 8192 (window 4096; 24),
     mamba2_370m 8 x 4096 (48 ``ssd_scan``, chunk 256, every one the
     chunk-parallel tensor-core variant); finite (B, 1, V)
     logits; one more granite prefill traced with ``torch.profiler``;
     then the three smoke configs in float32 (TF32 off, so the SIMT
     attention variant) on card and CPU, last-position logits within
     1e-3;
   - train: ``runtime/train.Trainer`` at full width, seed-0 float32
     parameters and moments drawn on the card, bf16 compute, synthetic
     data, no checkpoint, 3 steps: granite_3_2b 4 x 4096 in 2
     microbatches, mamba2_370m 8 x 4096 (``flash_attention`` /
     ``ssd_scan`` launched twice a layer and microbatch, forward and
     remat recompute, every launch the tensor-core variant); finite
     losses, ms a step, tokens/s, model FLOP utilisation, peak memory
     and one more step traced with ``torch.profiler``; then the granite
     and mamba2 smoke configs in float32 (TF32 off) for 8 steps on card
     and CPU from one step-0 checkpoint (per-step losses within 1e-4),
     and a crash at step 6 resumed from the step-4 checkpoint by a fresh
     ``Trainer`` (final loss within rtol 1e-6 of the uninterrupted run);
   - the packet-vs-flow gates: the packet engine on the host (its wall,
     events/s and the host CPU logged) and the flow engine on the card,
     each flow side one phase:
     packet_frozen: ``benchmarks/ref_faults_zero.json``'s three scenarios
     (seed 7, 256 KiB), the packet records exactly the file's, the flow
     records within rtol 1e-3 of its flow-np ones;
     packet_fig15: fig15's single gleam points (1 MiB, 8 chunks, window
     512, seed 11) at 512 hosts, loss 1e-4, and 64 hosts, loss 1e-3: JCT,
     events and drops exactly ``BENCH_packetsim.json``'s ``single`` rows,
     the flow JCT and the divergence logged;
     packet_vs_flow: ``tests/test_engines.py``'s JCT points (testbed, the
     two-pod fat tree, the four transports within 10%, allreduce 20%) and
     ``tools/check_faults.py``'s recovery latency per fault class (15%),
     no QP error; one ``run_many(workers=4)`` batch forked after CUDA is
     up, its records and ``last_run_stats`` equal to the serial batch's;
     fleet: ``tools/check_fleet.py``'s spec and fabric: tenant p99 within
     10%, monotone quantiles, the QP census and MFT occupancy equal, a
     staging hit rate above 0, the flow report on the packet engine's
     fabric equal to a fresh fabric's;
     apps: ``tools/check_apps.py``'s archs and mesh: train-step time per
     transport and the serving generator's achieved QPS within 10%,
     ``param_count == count_params(model_defs)``;
3. **kernels** every kernel input the paths produced: the max-min
   kernels in float32 and float64, plus random many-round problems (the
   kernel against its plain version: freeze set and rates per round for
   the first 256 rounds, then the whole filling, rtol 1e-6 in float32
   and 1e-12 in float64; loss factors within 1e-6 and exactly 1 on
   all-zero rows); ``flash_decode`` at layers 0 and 39 of the serve
   path's first, middle and last step, the cross path's last step,
   ``tests/test_kernels.py``'s decode cases in float32 and bf16 and the
   one-launch kernel's edge cases in every dtype pair (``out``, ``m``,
   ``l`` within rtol = atol = 2e-5 for a float32 q, 2e-2 for bf16; a
   second call bit-identical to the first; one device kernel a call),
   with ``scaled_dot_product_attention`` timed beside it as a yardstick;
   ``flash_attention`` at the first and last layer of
   each attention prefill, ``tests/test_kernels.py``'s ATTN_CASES and the
   wgmma variant's WGMMA_CASES, in float32 (SIMT variant) and bf16
   (wgmma variant) (2e-5 / 2e-2; SDPA timed beside it; each row with its
   variant, useful TFLOP/s and share of the bound); ``ssd_scan`` at
   the first and last layer of the mamba prefill at chunks 64, 128 and
   256, SSD_CASES in float32 and bf16 and the chunk-parallel variant's
   edge cases in f32, bf16 and bf16 x with f32 y (y 1e-4 / 3e-2, state
   1e-3); the two autograd Functions' backwards (plain PyTorch) against
   torch.autograd of the plain versions at captured bf16 layer inputs:
   granite's layer at 1 x 4096, danube's windowed layer at 1 x 8192,
   mamba's at 2 x 4096 (each gradient within the forward's tolerance
   times its max abs; SDPA's backward timed beside the attention's).
   Times through the wrapper from CUDA events; for
   ``flash_decode`` and ``ssd_scan`` also the device time a call and the
   device kernels a call, from torch.profiler, with the share of the
   bound taken on the device time.  The plain versions take the query
   axis in blocks (``ref.mha_reference``), so no full-width input is
   split.

It prints one ``{"kernels": [...]}`` line, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``; any failed phase exits
non-zero without that line.  Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s; FLOP/s by the dtype
#: of the inputs (float32/64 outside the tensor cores, bf16 dense on them)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12,
              torch.bfloat16: 989e12}

#: kernel -> (the TPU kernel it replaces, its source in the port)
KERNELS = {
    "maxmin_fill": ("src/repro/kernels/maxmin.py:69",
                    "src/repro_torch/kernels/csrc/maxmin.cu"),
    "loss_factors": ("src/repro/kernels/maxmin.py:232",
                     "src/repro_torch/kernels/csrc/maxmin.cu"),
    "flash_decode": ("src/repro/kernels/flash_decode.py:27",
                     "src/repro_torch/kernels/csrc/flash_decode.cu"),
    "flash_attention": ("src/repro/kernels/flash_attention.py:31",
                        "src/repro_torch/kernels/csrc/flash_attention.cu"),
    "ssd_scan": ("src/repro/kernels/ssd_scan.py:27",
                 "src/repro_torch/kernels/csrc/ssd_scan.cu"),
}

HPL_VOLUME = 8 << 20
HPL_CHUNKS = 8
FIG15_NBYTES = 1 << 20
MATRIX_NBYTES = 1 << 20

#: the fabrics of the path phases: (label, fat_tree kwargs, HPL scales)
FIG14 = (("fig14_1024", dict(n_pods=8, leaves_per_pod=8, hosts_per_leaf=16,
                             aggs_per_pod=8), (8, 16, 32)),
         ("fig14_16384", dict(n_pods=32, leaves_per_pod=16,
                              hosts_per_leaf=32, aggs_per_pod=16), (64, 128)))
FIG15 = dict(n_pods=16, leaves_per_pod=16, hosts_per_leaf=16, aggs_per_pod=16)
#: fat_tree kwargs, groups, members per group
MATRIX = (dict(n_pods=16, leaves_per_pod=16, hosts_per_leaf=16,
               aggs_per_pod=4), 8, 32)
#: the packet-vs-flow gates.  packet_frozen: ``tools/freeze_fault_refs.py``'s
#: zero-fault scenarios and their frozen records
FROZEN_REFS = "benchmarks/ref_faults_zero.json"
FROZEN_NBYTES, FROZEN_SEED = 1 << 18, 7
#: packet_fig15: the (group, loss) points of BENCH_packetsim.json's
#: ``single`` rows (gleam, 1 MiB, 8 chunks, window 512, seed 11)
FIG15_PACKET = ((512, 1e-4), (64, 1e-3))
#: tolerances of the gates: tests/test_engines.py (JCT, allreduce),
#: tools/check_faults.py (recovery), tools/check_fleet.py (tenant p99),
#: tools/check_apps.py (step time, achieved QPS)
GATE_TOL = {"jct": 0.10, "allreduce": 0.20, "recovery": 0.15,
            "fleet": 0.10, "apps": 0.10}
#: check_faults.py's fault instant and message
FAULT_AT, FAULT_NBYTES = 3e-6, 1 << 17
#: where the gates' flow side runs; a CPU rehearsal sets it to "cpu"
FLOW_DEVICE = "cuda"
#: the forked run_many batch (after CUDA is up) held to the serial one
FORK_WORKERS, FORK_SCENARIOS = 4, 8
#: check_fleet.py's spec and fabric (100 Gb/s)
FLEET_SPEC = dict(n_tenants=4, groups_per_tenant=2, group_size=6,
                  nbytes=2 << 20, bg_unicasts=8, bg_incasts=2, bg_fan_in=4,
                  bg_nbytes=1 << 20, seed=0)
FLEET_FABRIC = dict(n_pods=2, leaves_per_pod=4, hosts_per_leaf=4,
                    aggs_per_pod=4)
#: check_apps.py's archs (smoke), mesh, transports and serving point
APPS_ARCHS = ("llama3_2_3b", "mixtral_8x7b")
APPS_MESH = dict(data=2, model=2)
APPS_TRANSPORTS = ("gleam", "multiunicast")
APPS_SERVE = dict(n_replicas=4, tp=2, prompt_len=64, decode_len=16,
                  kv_replicas=2)
APPS_ARRIVALS = dict(rate=2e4, n=24, seed=0)
#: rounds held one by one against the plain round (the whole filling is
#: compared however many rounds it takes)
ROUNDS_CHECKED = 256
#: the serve path: granite_3_2b at full width, as launch/serve.py runs
#: it; steps 700-709 (mid-run, every slot busy) traced with torch.profiler
SERVE = dict(arch="granite_3_2b", smoke=False, requests=16, pool=8,
             max_new=32, max_seq=4096, profile=(700, 10))
#: the cross-device check: the smoke config in float32 on card and CPU
CROSS = dict(arch="granite_3_2b", smoke=True, requests=6, pool=4,
             max_new=8, max_seq=64)
#: the serve paths of the other families at full width, depth cut where
#: the float32 weights would not fit 80 GB: (phase, arch, layers (0: the
#: config's), requests, pool, max_new, max_seq); pool 4 recycles slots;
#: steps 10-14 (every slot busy) traced with torch.profiler
SERVE_FAMILIES = (
    ("serve_danube", "h2o_danube_3_4b", 0, 8, 8, 16, 1024),
    ("serve_mamba", "mamba2_370m", 0, 8, 4, 16, 1024),
    ("serve_mixtral", "mixtral_8x7b", 8, 8, 8, 16, 1024),
    ("serve_jamba", "jamba_v0_1_52b", 8, 8, 4, 16, 1024))
SERVE_FAMILY_PROFILE = (10, 5)
#: their card-vs-CPU check at the smoke configs, float32 with float32
#: caches, TF32 off: (arch, requests, pool, max_new, max_seq); danube's and
#: mixtral's positions run to 46, past their window of 32 (a 32-slot
#: rolling buffer), mamba2's and jamba's slots recycle, whisper serves a
#: pool (per-row positions)
SERVE_CROSS = (("h2o_danube_3_4b", 4, 4, 16, 128),
               ("mixtral_8x7b", 4, 4, 16, 128),
               ("mamba2_370m", 6, 2, 8, 64),
               ("qwen3_moe_235b_a22b", 6, 4, 8, 64),
               ("jamba_v0_1_52b", 6, 2, 8, 64),
               ("whisper_medium", 6, 4, 8, 64),
               ("internvl2_26b", 6, 4, 8, 64))
#: tests/test_kernels.py's flash-decode cases: (B, S, H, KVH, D, kv_lens)
DECODE_CASES = ((1, 512, 4, 4, 64, (512,)), (2, 1024, 8, 2, 64, (1000, 37)),
                (2, 512, 4, 1, 32, (1, 512)), (1, 768, 2, 2, 128, (600,)))
#: the cases the one-launch decode kernel makes risky, also
#: tests/test_torch_kernels.py's DECODE_EDGE_CASES: kv_len 0 and kv_len > S,
#: rows of very unequal length at granite's heads, splits that get no tile
#: (8 splits, 2 tiles), rep 1 / 8 / 32 (two head groups of 16), D 120
#: (zero columns up to 128), D 128 and 256; each in every dtype pair
DECODE_EDGE_CASES = ((2, 256, 8, 2, 64, (0, 300)),
                     (4, 4096, 32, 8, 64, (1, 4096, 65, 2000)),
                     (1, 4096, 4, 1, 64, (70,)),
                     (2, 512, 8, 8, 64, (300, 512)),
                     (2, 512, 16, 2, 64, (129, 7)),
                     (1, 256, 32, 1, 64, (200,)),
                     (1, 300, 8, 2, 120, (250,)),
                     (1, 600, 8, 2, 128, (600,)),
                     (2, 300, 8, 1, 256, (257, 33)))
#: danube's full rolling buffer: pool 8, 32/8 heads x 120, every one of
#: the window's 4096 slots valid (a serve past the window)
DECODE_ROLLING = ((8, 4096, 32, 8, 120, (4096,) * 8),)
#: (q dtype, cache dtype) pairs of the edge cases
DECODE_PAIRS = ((torch.float32, torch.float32),
                (torch.bfloat16, torch.bfloat16),
                (torch.float32, torch.bfloat16),
                (torch.bfloat16, torch.float32))
#: kernel-vs-plain tolerance (rtol = atol) by the dtype of q and out,
#: tests/test_kernels.py's
DECODE_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: the prefill paths at full width: (phase, arch, layers (0: the
#: config's; cut where the float32 weights would not fit 80 GB), batch,
#: prompt tokens); internvl2 adds its 256 vision positions, whisper's
#: encoder takes 4096 / 4 = 1024 frames
PREFILL = (("prefill_granite", "granite_3_2b", 0, 4, 4096),
           ("prefill_danube", "h2o_danube_3_4b", 0, 1, 8192),
           ("prefill_mamba", "mamba2_370m", 0, 8, 4096),
           ("prefill_mixtral", "mixtral_8x7b", 8, 1, 8192),
           ("prefill_jamba", "jamba_v0_1_52b", 8, 2, 4096),
           ("prefill_whisper", "whisper_medium", 0, 4, 4096),
           ("prefill_internvl2", "internvl2_26b", 24, 2, 4096))
#: the prefill phase traced with torch.profiler (one more call)
PREFILL_PROFILE = "prefill_granite"
#: the card-vs-CPU prefill check at the smoke configs, float32, TF32 off:
#: (arch, batch, prompt length); danube where the reference applies its
#: window of 32
PREFILL_CROSS = (("granite_3_2b", 2, 64), ("h2o_danube_3_4b", 2, 64),
                 ("h2o_danube_3_4b", 2, 96), ("mamba2_370m", 2, 64),
                 ("mixtral_8x7b", 2, 64), ("qwen3_moe_235b_a22b", 2, 64),
                 ("jamba_v0_1_52b", 2, 64), ("whisper_medium", 2, 64),
                 ("internvl2_26b", 2, 64))
#: the train paths at full width, through ``runtime/train.Trainer``:
#: (phase, arch, batch, sequence, microbatches, the kernel every mixer
#: layer launches twice a microbatch: forward and remat recompute)
TRAIN = (("train_granite", "granite_3_2b", 4, 4096, 2, "flash_attention"),
         ("train_mamba", "mamba2_370m", 8, 4096, 1, "ssd_scan"))
#: steps of each train phase; one more is traced with torch.profiler
TRAIN_STEPS = 3
#: the card-vs-CPU and restart check of the trainer: smoke configs in
#: float32 (TF32 off), steps, checkpoint period, the injected crash
TRAIN_CROSS = dict(archs=("granite_3_2b", "mamba2_370m"), steps=8,
                   ckpt_every=4, fail_at=6, batch=4, seq=64)
#: per-step losses, card against CPU; final loss after a restart against
#: the uninterrupted run (tests/test_runtime.py's rtol)
TRAIN_CROSS_TOL = 1e-4
RESTART_RTOL = 1e-6
#: the backward rows: the autograd Functions' backwards against autograd
#: of the plain versions at the train paths' layers, from captured
#: prefill inputs: (name, captured phase, layer, rows kept)
TRAIN_BACKWARD = (("granite layer 0", "prefill_granite", 0, 1),
                  ("danube layer 0", "prefill_danube", 0, 1),
                  ("mamba layer 0", "prefill_mamba", 0, 2))
#: tests/test_kernels.py's ATTN_CASES: (B, Sq, Skv, H, KVH, D, causal,
#: window), and SSD_CASES: (B, S, H, P, N, chunk)
ATTN_CASES = ((1, 128, 128, 4, 4, 64, True, 0),
              (2, 256, 256, 8, 2, 64, True, 0),
              (1, 128, 128, 4, 2, 32, False, 0),
              (2, 256, 256, 4, 4, 64, True, 128),
              (1, 384, 384, 4, 2, 64, True, 96),
              (1, 192, 192, 2, 1, 16, True, 0),
              (1, 100, 100, 2, 2, 64, True, 0))
#: the edges of the wgmma variant's tiling, tests/test_torch_kernels.py's
#: WGMMA_CASES: rep 3 with D 128 (llama3_2_3b's heads), D 120 with a
#: window under a tile, a ragged q tile, Sq != Skv, B > 1 with the causal
#: diagonal across a key tile's edge
WGMMA_CASES = ((1, 100, 100, 24, 8, 128, True, 0),
               (1, 300, 300, 32, 8, 120, True, 40),
               (1, 77, 77, 8, 2, 64, True, 0),
               (1, 150, 260, 8, 4, 32, True, 0),
               (2, 96, 200, 8, 2, 64, False, 0),
               (2, 200, 200, 10, 2, 64, True, 0))
SSD_CASES = ((1, 256, 2, 64, 64, 128), (2, 128, 4, 32, 64, 64),
             (1, 384, 2, 64, 128, 128), (1, 100, 2, 16, 32, 64))
#: the cases the chunk-parallel scan makes risky, also
#: tests/test_torch_kernels.py's SSD_EDGE_CASES: ragged last chunks, S <
#: chunk, a single chunk, chunks 64 / 128 / 256 with N 32 / 128 and P 16 /
#: 64, and N 40, P 24 (zero columns up to 48 and 32); each in f32 and in
#: bf16 x with y in bf16 and in f32
SSD_EDGE_CASES = ((1, 300, 2, 64, 128, 256), (2, 200, 3, 32, 64, 64),
                  (1, 100, 2, 64, 128, 256), (2, 256, 2, 64, 128, 256),
                  (1, 512, 2, 16, 32, 64), (1, 512, 4, 64, 128, 128),
                  (1, 640, 2, 16, 128, 256), (2, 384, 2, 64, 32, 128),
                  (1, 200, 2, 24, 40, 64))
#: (x dtype, y dtype) pairs of the SSD edge cases
SSD_PAIRS = ((torch.float32, torch.float32),
             (torch.bfloat16, torch.bfloat16),
             (torch.bfloat16, torch.float32))
#: kernel-vs-plain tolerances (rtol = atol) by the input dtype,
#: tests/test_kernels.py's: attention output; SSD y and final state
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
SSD_STATE_TOL = 1e-3
#: at captured full-width inputs in float32 the kernel is held to a float64
#: evaluation of the plain version: its max error may be at most this
#: many times the float32 plain version's own (plus the tolerance).  The
#: path's activations are large (|q|, |k| up to ~120 from the seed-0
#: weights, so logits of hundreds), and any float32 order of summation,
#: the plain version's included, lands ~1e-3 from the exact result there,
#: beyond the element-wise 2e-5 / 1e-4 set for unit-scale inputs.  A bf16
#: row is decided by the element-wise 2e-2 band from the plain version at
#: every input; at captured inputs its distance from float64 beyond each
#: output's own bf16 rounding is recorded beside it.
ORACLE_FACTOR = 2.0
#: the chunks every captured SSD input is held at (the path's is 256)
SSD_CHUNKS = (64, 128, 256)
#: profiler ranges whose device time (every kernel launched inside) a
#: profile summary reports: the train step's forward and AdamW, and the
#: two Functions' backwards (the rest of the step is the backward)
RANGES = ("train_step.forward", "train_step.adamw",
          "FlashAttentionBackward", "SSDScanBackward")
#: what the name of the fill kernel that opens a timing trace contains
PAD_KERNEL = "FillFunctor"
FAILURES: list = []


def log(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str) -> None:
    FAILURES.append(msg)
    log(f"FAIL {msg}")


def close(got: float, want: float, rtol: float, atol: float = 0.0) -> bool:
    return abs(got - want) <= rtol * abs(want) + atol


# ------------------------------------------------------------- workloads

def hpl_workloads(Workload, hosts, n):
    """fig14: N PB groups (rows) + N RS groups (columns) as gleam
    bcasts; the baseline is ring PB plus the `long` unicast exchange."""
    wg = Workload(f"fig14/gleam_{n}x{n}")
    for row in range(n):
        wg.bcast(hosts[row * n:(row + 1) * n], HPL_VOLUME, key=row)
    for col in range(n):
        wg.bcast([hosts[row * n + col] for row in range(n)], HPL_VOLUME,
                 key=n + col)
    wb = Workload(f"fig14/ring_long_{n}x{n}")
    for row in range(n):
        wb.bcast(hosts[row * n:(row + 1) * n], HPL_VOLUME, transport="ring",
                 chunks=HPL_CHUNKS, key=row)
    for col in range(n):
        members = [hosts[row * n + col] for row in range(n)]
        for i in range(n - 1):
            wb.unicast(members[i], members[i + 1],
                       HPL_VOLUME * (n - 1) // n, key=n + col)
    return wg, wb


def hpl_values(n, g_recs, b_recs):
    jg = max(r.jct(n - 1) for r in g_recs)
    pb = max(r.jct(n - 1) for r in b_recs[:n])
    long_jct = max(r.jct(1) for r in b_recs[n:])
    return jg, max(pb, long_jct)


def matrix_ops(wl, hosts, n_groups, group, churn, n_flaps):
    """One churn x flaps cell: contending bcasts over disjoint host
    blocks, each with leave/join events and plane-0 uplink flaps."""
    spares = n_events = 4
    stride = group + spares
    ops = []
    for g in range(n_groups):
        block = hosts[g * stride:(g + 1) * stride]
        members, spare = block[:group], block[group:]
        events = []
        if churn > 0:
            dt = 1.0 / churn
            for i in range(n_events):
                kind, who = (("leave", members[-1 - i // 2]) if i % 2 == 0
                             else ("join", spare[i // 2]))
                events.append(wl.MemberEvent(kind, who, (i + 1) * dt))
        racks = []
        for m in members[1:]:
            pod, leaf, _ = m[1:].split(".")
            la = (f"L{pod}.{leaf}", f"A{pod}.0")
            if la not in racks:
                racks.append(la)
        faults = tuple(
            wl.FaultEvent("link_flap", 3e-6 + i * 5e-6,
                          node=racks[i % len(racks)][0],
                          peer=racks[i % len(racks)][1], duration=20e-6)
            for i in range(n_flaps))
        ops.append(wl.GroupOp("bcast", members, MATRIX_NBYTES,
                              events=tuple(events), faults=faults))
    return ops


# -------------------------------------------------------------- recording

def launch_counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import maxmin as mm
    from repro_torch.kernels import ssd_scan as ssd
    return mm.LAUNCHES, fd.LAUNCHES, fa.LAUNCHES, ssd.LAUNCHES


def reset_counts() -> None:
    for counter in launch_counters():
        for name in counter:
            counter[name] = 0


def counts() -> dict:
    out = {}
    for counter in launch_counters():
        out.update(counter)
    return out


class Recorder:
    """Wraps the kernel wrappers the solver calls to keep one copy of
    each distinct input (by shape, dtype and solve options) per phase."""

    def __init__(self, mm):
        self.mm = mm
        self.phase = None
        self.inputs: dict = {}
        self._fill, self._loss = mm.maxmin_rates, mm.loss_factors

        def rates(fl, cap, active, **kw):
            key = ("maxmin_fill", self.phase, tuple(fl.shape),
                   tuple(cap.shape), str(cap.dtype), kw.get("tol", 1e-6),
                   kw.get("max_rounds"))
            if self.phase and key not in self.inputs:
                self.inputs[key] = (fl.clone(), cap.clone(),
                                    active.clone(), dict(kw))
            return self._fill(fl, cap, active, **kw)

        def loss(fl, rates_, active, cap, q, wsq, wnd, ecn, **kw):
            key = ("loss_factors", self.phase, tuple(fl.shape),
                   tuple(cap.shape), str(cap.dtype),
                   bool(self.phase and (q != 0).any()))
            if self.phase and key not in self.inputs:
                self.inputs[key] = tuple(t.clone() for t in (
                    fl, rates_, active, cap, q, wsq, wnd, ecn)) + (dict(kw),)
            return self._loss(fl, rates_, active, cap, q, wsq, wnd, ecn, **kw)

        mm.maxmin_rates, mm.loss_factors = rates, loss


class Phase:
    """One main-path phase: launch counts zeroed before, read after."""

    def __init__(self, name, rec, fts, lossy):
        self.name, self.rec, self.fts, self.lossy = name, rec, fts, lossy

    def __enter__(self):
        torch.cuda.synchronize()
        self.fts.reset_solve_stats()
        self.rec.phase = self.name
        reset_counts()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.wall = time.perf_counter() - self.t0
        self.launches = counts()
        self.rec.phase = None
        st = self.fts.SOLVE_STATS
        self.stats = {"wall_s": self.wall, "solve_s": st["solve_s"],
                      "solve_calls": st["calls"], "host_syncs": st["syncs"],
                      "shapes": [list(s) for s in st["shapes"]],
                      "launches": self.launches}
        log(f"[paths] {self.name}: wall {self.wall:.3f} s, solve "
            f"{st['solve_s']:.3f} s in {st['calls']} calls, "
            f"{st['syncs']} host syncs, shapes {st['shapes']}, "
            f"launches {self.launches}")
        if exc[0] is None:
            if self.launches["maxmin_fill"] == 0:
                fail(f"{self.name}: maxmin_fill was never launched")
            if self.lossy and self.launches["loss_factors"] == 0:
                fail(f"{self.name}: loss_factors was never launched")
        return False


def recorded_values():
    """The JAX package's recorded flow JCTs (ms), read as data."""
    try:
        with open(os.path.join(REPO, "BENCH_flowsim.json")) as fh:
            bench = json.load(fh)
    except (OSError, ValueError):
        return {}
    rows = dict(bench.get("after_warm", {}).get("pass1", {}).get("rows", []))
    rows.update(dict(bench.get("loss_sweep", {}).get("rows", [])))
    return rows


def check_jct(label, got_ms, want_ms, recorded):
    ok = close(got_ms, want_ms, 1e-3)
    ref = recorded.get(label)
    note = ""
    if ref is not None:
        # recorded to 4 decimals: allow half a unit of the last digit
        rec_ok = close(got_ms, ref, 1e-3, 5e-5)
        ok = ok and rec_ok
        note = f", JAX package recorded {ref}"
    log(f"[paths]   {label}: {got_ms!r} ms (flow-np {want_ms!r}{note})"
        f"{'' if ok else '  MISMATCH'}")
    if not ok:
        fail(f"{label}: {got_ms} ms vs flow-np {want_ms} ms{note}")
    return {"label": label, "ms": got_ms, "flow_np_ms": want_ms,
            "recorded_ms": ref}


def run_paths(rec, fig14=FIG14, fig15=FIG15, matrix=MATRIX):
    from repro_torch.core import fattree, flowsim_torch as fts
    from repro_torch.core import workload as wl
    from repro_torch.core.engine import make_engine
    from repro_torch.core.flowsim import LinkMap
    from repro_torch.kernels import maxmin as mm
    recorded = recorded_values()
    out = {}

    # fig14: HPL at 1024 and 16,384 hosts
    for label, fabric, scales in fig14:
        t0 = time.perf_counter()
        topo = fattree.fat_tree(bw=200 * fattree.GBPS, **fabric)
        wls = []
        for n in scales:
            wls.extend(hpl_workloads(wl.Workload, topo.hosts, n))
        log(f"[paths] {label}: {len(topo.hosts)} hosts, "
            f"{sum(len(p) for p in topo.ports.values())} directed links, "
            f"built in {time.perf_counter() - t0:.1f} s")
        with Phase(label, rec, fts, lossy=False) as ph:
            recss = make_engine("flow", topo).run_workloads(wls)
        t0 = time.perf_counter()
        want = make_engine("flow-np", topo).run_workloads(wls)
        log(f"[paths]   flow-np oracle in {time.perf_counter() - t0:.1f} s")
        rows = []
        for i, n in enumerate(scales):
            got = hpl_values(n, recss[2 * i], recss[2 * i + 1])
            ref = hpl_values(n, want[2 * i], want[2 * i + 1])
            for name, g, w in (("gleam", got[0], ref[0]),
                               ("ring_long", got[1], ref[1])):
                rows.append(check_jct(f"fig14/hpl_{n}x{n}/{name}_ms",
                                      g * 1e3, w * 1e3, recorded))
        out[label] = dict(ph.stats, rows=rows)

    # fig15: the loss grid's 4096-member points on the 4096-host tree
    topo = fattree.fat_tree(bw=200 * fattree.GBPS, **fig15)
    n_hosts = len(topo.hosts)
    for loss in (0.0, 1e-3):
        label = f"fig15_loss{loss:g}"
        kw = dict(loss_rate=loss, seed=11, group_kw={"window": 512},
                  relay_kw={"window": 512})
        rows = []
        with Phase(label, rec, fts, lossy=loss > 0) as ph:
            got = {}
            for transport in ("gleam", "multiunicast"):
                eng = make_engine("flow", topo, **kw)
                r = eng.stage(wl.GroupOp("bcast", topo.hosts, FIG15_NBYTES,
                                         transport=transport, chunks=8))
                eng.run()
                got[transport] = r.jct(len(topo.hosts) - 1)
        for transport in ("gleam", "multiunicast"):
            eng = make_engine("flow-np", topo, **kw)
            r = eng.stage(wl.GroupOp("bcast", topo.hosts, FIG15_NBYTES,
                                     transport=transport, chunks=8))
            eng.run()
            tag = f"{loss:.0e}" if loss else "0"
            rows.append(check_jct(
                f"fig15/scale_g{n_hosts}_loss{tag}/{transport}_ms",
                got[transport] * 1e3, r.jct(len(topo.hosts) - 1) * 1e3,
                recorded))
        out[label] = dict(ph.stats, rows=rows)

    # matrix: churn x loss x flaps, dynamic segments on float64 lanes
    fabric, n_groups, group = matrix
    topo = fattree.fat_tree(**fabric)
    cells = [(c, f) for c in (0.0, 5e4) for f in (0, 2)]
    label = "matrix"
    rows, seg_err = [], 0.0
    problems = []
    with Phase(label, rec, fts, lossy=True) as ph:
        got = {}
        for loss in (0.0, 1e-3):
            eng = make_engine("flow", topo,
                              **({"loss_rate": loss} if loss else {}))
            inner = eng._sim.segment_rates_many

            def seg(probs, inner=inner):
                vals = inner(probs)
                problems.append((probs, vals))
                return vals
            eng._sim.segment_rates_many = seg
            got[loss] = sweep_cells(eng, wl, topo, cells, n_groups, group)
    want = {}
    for loss in (0.0, 1e-3):
        eng = make_engine("flow-np", topo,
                          **({"loss_rate": loss} if loss else {}))
        want[loss] = sweep_cells(eng, wl, topo, cells, n_groups, group)
    for loss in (0.0, 1e-3):
        for cell, g, w in zip(cells, got[loss], want[loss]):
            rows.append(check_jct(f"matrix c{cell[0]:g} l{loss:g} "
                                  f"f{cell[1]}", g * 1e3, w * 1e3, {}))
    sim = LinkMap(topo)
    n_probs = 0
    for probs, vals in problems:
        oracle = LinkMap.segment_rates_many(sim, probs)
        n_probs += len(probs)
        for g, w in zip(vals, oracle):
            seg_err = max(seg_err, abs(g - w) / abs(w))
    log(f"[paths]   {n_probs} segment problems: max rel err {seg_err:.3g} "
        f"vs numpy LinkMap.segment_rates_many (limit 1e-6)")
    if not n_probs or seg_err > 1e-6:
        fail(f"matrix: segment rates {n_probs} problems, err {seg_err}")
    out[label] = dict(ph.stats, rows=rows, segment_problems=n_probs,
                      segment_max_rel_err=seg_err)
    return out


def sweep_cells(eng, wl, topo, cells, n_groups, group):
    """Mean group JCT of every (churn, flaps) cell, one run_many."""
    all_ops = [matrix_ops(wl, topo.hosts, n_groups, group, c, f)
               for c, f in cells]
    recss = []

    def scenario(ops):
        return lambda e: recss.append([e.stage(op) for op in ops])

    eng.run_many([scenario(ops) for ops in all_ops])
    return [sum(r.jct(len(op.surviving_receivers()))
                for op, r in zip(ops, recs)) / len(ops)
            for ops, recs in zip(all_ops, recss)]


# ------------------------------------------------------------------ serve

class DecodeRecorder:
    """Wraps ``kernels/ops.flash_decode`` (the attention layers look it up
    at call time) to keep the kernel inputs of the first and last call of
    a step at chosen steps of a serve phase, and at its last step.  Each
    step calls it ``n_layers`` times (once per attention sublayer, twice
    with a cross-attention), in layer order."""

    def __init__(self, ops):
        self.ops, self._call = ops, ops.flash_decode
        self.phase, self.inputs = None, {}
        ops.flash_decode = self.wrapped

    def arm(self, phase, n_layers, steps):
        if n_layers == 0:           # no attention: nothing to keep
            return
        self.phase, self.n_layers, self.steps = phase, n_layers, set(steps)
        self.calls, self.last = 0, {}

    def disarm(self):
        """Keep the last step's inputs: its k/v are views of the caches,
        which no later step has changed."""
        for layer, (step, q, k, v, kv_len) in self.last.items():
            self.inputs.setdefault((self.phase, step, layer),
                                   (q, k.clone(), v.clone(), kv_len))
        self.phase, self.last = None, {}

    def wrapped(self, q, k, v, kv_len):
        if self.phase:
            step, layer = divmod(self.calls, self.n_layers)
            self.calls += 1
            if layer in (0, self.n_layers - 1):
                if step in self.steps:
                    self.inputs[(self.phase, step, layer)] = tuple(
                        t.clone() for t in (q, k, v, kv_len))
                self.last[layer] = (step, q.clone(), k, v, kv_len.clone())
        return self._call(q, k, v, kv_len)


def path_launches(cfg, decode):
    """Kernel launches the path makes: a decode step one ``flash_decode``
    per attention sublayer (two with a cross-attention); a prefill one
    ``flash_attention`` per attention sublayer of the decoder (two with a
    cross-attention) and of the encoder, one ``ssd_scan`` per Mamba-2
    sublayer."""
    kinds = [m for m, _ in cfg.pattern] * cfg.n_blocks
    n_attn, n_mamba = kinds.count("attn"), kinds.count("mamba")
    per_attn = 2 if cfg.enc_layers else 1
    if decode:
        return {"flash_decode": n_attn * per_attn}
    return {"flash_attention": n_attn * per_attn + cfg.enc_layers,
            "ssd_scan": n_mamba}


def scheduled_steps(prompt_lens, max_new, pool):
    """Pool steps the server takes: a request holds its slot for its
    prompt plus max_new - 1 steps (the last prompt token's step yields
    the first new token), and a freed slot takes the next queued request
    at the following step."""
    free = [0] * pool
    for n in prompt_lens:
        start = min(free)
        free[free.index(start)] = start + n + max_new - 1
    return max(free)


class FiniteSampler:
    """Greedy sampling that also folds, on the device, whether every
    logit of every step was finite, keeps each step's logits when asked
    to, and traces ``profile = (first step, steps)`` with
    ``torch.profiler``."""

    def __init__(self, keep=False, profile=None):
        self.finite, self.keep, self.logits = None, keep, []
        self.profile, self.calls = profile, 0
        self.prof = self.trace = None

    def __call__(self, logits):
        ok = torch.isfinite(logits).all()
        self.finite = ok if self.finite is None else self.finite & ok
        if self.keep:
            self.logits.append(logits.detach().cpu())
        if self.profile:
            self._profile_step()
        self.calls += 1
        return torch.argmax(logits, -1)

    def _profile_step(self):
        first, n = self.profile
        if self.calls == first:
            torch.cuda.synchronize()
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        elif self.calls == first + n and self.prof is not None:
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - self.t0) * 1e3
            self.prof.__exit__(None, None, None)
            self.trace = profile_summary(self.prof, wall_ms, n)
            self.prof = None


def profile_summary(prof, wall_ms, steps):
    """Device busy time (the sum of the device's own events: kernels,
    copies and fills; the CPU ops that launched them would count them a
    second time), the idle share of the window, the top device events
    and the top CPU ops by self time."""
    from torch.autograd import DeviceType
    avgs = prof.key_averages()
    # a named range also leaves a device-side span, which would count its
    # kernels a second time
    dev = sorted(((a.key, a.self_device_time_total / 1e3, a.count)
                  for a in avgs if a.device_type != DeviceType.CPU
                  and a.key not in RANGES),
                 key=lambda r: -r[1])
    host = sorted(((a.key, a.self_cpu_time_total / 1e3, a.count)
                   for a in avgs if a.device_type == DeviceType.CPU),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in dev)
    per_step = {name: sum(ms for key, ms, _ in dev if name in key) / steps
                for name in KERNELS}
    ranges = {a.key: a.device_time_total / 1e3 / steps for a in avgs
              if a.device_type == DeviceType.CPU and a.key in RANGES}
    return {"steps": steps, "wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall_ms if busy else None,
            "kernel_device_ms_per_step": per_step,
            "range_device_ms_per_step": ranges,
            "top_device_ms": dev[:12], "top_host_ms": host[:12]}


def serve_phase(label, spec, rec, device="cuda", cfg=None, model=None,
                record=True):
    """Serve ``spec`` through ``launch/serve.py``'s ``serve`` (on the
    seed-0 model drawn on the device unless ``model`` is given), keeping
    flash-decode inputs when ``record``; returns the phase record and the
    sampler."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve as launch_serve
    if cfg is None:
        cfg = get_config(spec["arch"], smoke=spec["smoke"])
        if spec.get("layers"):
            cfg = cfg.replace(n_layers=spec["layers"])
    lens = [len(p) for p in launch_serve.make_prompts(
        spec["requests"], cfg.vocab_size, spec["max_seq"])]
    want_steps = scheduled_steps(lens, spec["max_new"], spec["pool"])
    sampler = FiniteSampler(keep=spec["smoke"],
                            profile=spec.get("profile"))
    per_step = path_launches(cfg, decode=True)["flash_decode"]
    if record:
        rec.arm(label, per_step, (0, want_steps // 2))
    reset_counts()
    out = launch_serve.serve(cfg, requests=spec["requests"],
                             pool=spec["pool"], max_new=spec["max_new"],
                             max_seq=spec["max_seq"], device=device,
                             sampler=sampler, model=model)
    launches = counts()
    if record:
        rec.disarm()
    stats, wall = out["stats"], out["seconds"]
    tokens = [r.out_tokens for r in out["requests"]]
    row = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "compute_dtype": cfg.compute_dtype,
           "device": device, **{k: spec[k] for k in
                                ("requests", "pool", "max_new", "max_seq")},
           "prompt_lens": lens, "completed": stats.completed,
           "tokens_generated": stats.tokens_generated, "steps": stats.steps,
           "scheduled_steps": want_steps, "wall_s": wall,
           "ms_per_step": wall / max(stats.steps, 1) * 1e3,
           "tokens_per_s": stats.tokens_generated / wall,
           "logits_finite": bool(sampler.finite), "launches": launches,
           "profile": sampler.trace}
    log(f"[paths] {label}: {stats.completed}/{spec['requests']} completed, "
        f"{stats.tokens_generated} tokens, {stats.steps} pool steps "
        f"(scheduled {want_steps}), wall {wall:.3f} s, "
        f"{row['ms_per_step']:.3f} ms/step, {row['tokens_per_s']:.1f} "
        f"tok/s, launches {launches}")
    if device == "cuda":
        row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if sampler.trace:
        tr = sampler.trace
        log(f"[paths] {label} profile of {tr['steps']} steps: wall "
            f"{tr['wall_ms']:.3f} ms, device busy {tr['device_busy_ms']:.3f}"
            f" ms, idle share {tr['device_idle_share']}, flash_decode "
            f"{tr['kernel_device_ms_per_step']['flash_decode']!r} ms of "
            f"device time a step")
        for key, ms, n in tr["top_device_ms"]:
            log(f"[paths]   device {ms:10.3f} ms  {n:6d}x  {key[:90]}")
        for key, ms, n in tr["top_host_ms"]:
            log(f"[paths]   host   {ms:10.3f} ms  {n:6d}x  {key[:90]}")
    why = []
    if stats.completed != spec["requests"] or any(
            len(t) != spec["max_new"] for t in tokens):
        why.append("not every request completed with max_new tokens")
    if stats.steps != want_steps:
        why.append(f"{stats.steps} steps, the scheduler gives {want_steps}")
    if not row["logits_finite"] or not all(
            0 <= t < cfg.vocab_size for ts in tokens for t in ts):
        why.append("non-finite logits or tokens outside the vocabulary")
    want_launches = stats.steps * per_step if device == "cuda" else 0
    if launches["flash_decode"] != want_launches:
        why.append(f"flash_decode launched {launches['flash_decode']} "
                   f"times, not {want_launches}")
    kind = "flash_decode_mma" if cfg.compute_dtype == "bfloat16" \
        else "flash_decode_simt"
    if launches[kind] != want_launches:
        why.append(f"{kind} launched {launches[kind]} times, not "
                   f"{want_launches}")
    for msg in why:
        fail(f"{label}: {msg}")
    return dict(row, tokens=tokens), sampler


def run_serve(rec, serve=SERVE, cross=CROSS, families=SERVE_FAMILIES,
              family_cross=SERVE_CROSS, device="cuda"):
    """The serve path at full width, then the cross-device check; then the
    other families at full width, each model freed before the next is
    drawn, and their cross-device checks."""
    out = {}
    row, _ = serve_phase("serve", serve, rec, device)
    out["serve"] = {k: v for k, v in row.items() if k != "tokens"}
    for label, arch, layers, requests, pool, max_new, max_seq in families:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        row, _ = serve_phase(label, dict(
            arch=arch, smoke=False, layers=layers, requests=requests,
            pool=pool, max_new=max_new, max_seq=max_seq,
            profile=SERVE_FAMILY_PROFILE), rec, device)
        out[label] = {k: v for k, v in row.items() if k != "tokens"}
    torch.cuda.empty_cache()

    prev_tf32 = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model
    cfg = get_config(cross["arch"], smoke=cross["smoke"]).replace(
        compute_dtype="float32")
    cpu_model = Model(cfg, seed=0, device="cpu")
    card_model = Model(cfg, seed=0, device=device)
    card_model.load_state_dict(cpu_model.state_dict())
    try:
        card, card_s = serve_phase("cross", cross, rec, device, cfg,
                                   card_model)
        cpu, cpu_s = serve_phase("cross_cpu", cross, rec, "cpu", cfg,
                                 cpu_model, record=False)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev_tf32
    same = card["tokens"] == cpu["tokens"]
    err = max(float((a - b).abs().max())
              for a, b in zip(card_s.logits, cpu_s.logits)) \
        if len(card_s.logits) == len(cpu_s.logits) else float("inf")
    log(f"[paths] cross: tokens identical on card and CPU: {same}; "
        f"per-step logits max abs diff {err!r} (limit 1e-3) over "
        f"{len(card_s.logits)} steps")
    if not same or not err <= 1e-3:
        fail(f"cross: tokens identical {same}, logits diff {err}")
    out["cross"] = dict({k: v for k, v in card.items() if k != "tokens"},
                        tokens_identical=same, logits_max_abs_diff=err,
                        cpu_wall_s=cpu["wall_s"])
    points = [serve_cross(arch, dict(arch=arch, smoke=True, requests=r,
                                     pool=p, max_new=n, max_seq=m), rec,
                          device)
              for arch, r, p, n, m in family_cross]
    out["serve_cross"] = {"points": points, "launches": {
        name: sum(r["launches"][name] for r in points) for name in counts()}}
    return out


def serve_cross(arch, spec, rec, device="cuda"):
    """One smoke config served in float32 (TF32 off) on the card and on
    the CPU with the same weights: identical greedy tokens, per-step
    logits within 1e-3; for a windowed model, positions past the window.
    The caches are float32 too: a bf16 cache element that rounds the
    other way on one device persists in the SSM state and can tip a MoE
    router near a tie (the float32 card and CPU runs of qwen3 smoke with
    bf16 caches kept their tokens but one step's logits moved 0.049), so
    with bf16 caches the comparison would measure the caches' rounding,
    not the card.  The bf16 caches are the full-width phases' own; the
    ``Server`` takes float32 ones here from ``init_caches(dtype=)``,
    which it looks up at call time."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as mdl
    cfg = get_config(arch, smoke=True).replace(compute_dtype="float32")
    cpu_model = mdl.Model(cfg, seed=0, device="cpu")
    card_model = mdl.Model(cfg, seed=0, device=device)
    card_model.load_state_dict(cpu_model.state_dict())
    prev = torch.backends.cuda.matmul.allow_tf32
    init_caches = mdl.init_caches
    torch.backends.cuda.matmul.allow_tf32 = False
    mdl.init_caches = functools.partial(init_caches, dtype=torch.float32)
    try:
        card, card_s = serve_phase(f"serve_cross {arch}", spec, rec, device,
                                   cfg, card_model, record=False)
        cpu, cpu_s = serve_phase(f"serve_cross {arch} cpu", spec, rec,
                                 "cpu", cfg, cpu_model, record=False)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
        mdl.init_caches = init_caches
    same = card["tokens"] == cpu["tokens"]
    err = max(float((a - b).abs().max())
              for a, b in zip(card_s.logits, cpu_s.logits)) \
        if len(card_s.logits) == len(cpu_s.logits) else float("inf")
    last_pos = max(card["prompt_lens"]) + spec["max_new"] - 1
    past = bool(cfg.window) and last_pos >= cfg.window
    log(f"[paths] serve_cross {arch}: tokens identical on card and CPU: "
        f"{same}; per-step logits max abs diff {err!r} (limit 1e-3) over "
        f"{len(card_s.logits)} steps; last position {last_pos}"
        + (f", past the window {cfg.window}" if past else ""))
    if not same or not err <= 1e-3:
        fail(f"serve_cross {arch}: tokens identical {same}, logits diff "
             f"{err}")
    if cfg.window and not past:
        fail(f"serve_cross {arch}: positions end at {last_pos}, inside the "
             f"window {cfg.window}")
    return {"arch": arch, "steps": card["steps"], "launches":
            card["launches"], "tokens_identical": same,
            "logits_max_abs_diff": err, "last_position": last_pos}


# ---------------------------------------------------------------- prefill

class PrefillRecorder:
    """Wraps ``kernels/ops.flash_attention`` and ``ops.ssd_scan`` (the
    model's layers look them up at call time) to keep the inputs of the
    first and the last call of each kernel in an armed prefill, keyed by
    (phase, kernel, call index): ``calls`` says how many times the
    prefill calls each (``path_launches``)."""

    def __init__(self, ops):
        self.ops, self.inputs, self.phase = ops, {}, None
        self._attn, self._ssd = ops.flash_attention, ops.ssd_scan
        ops.flash_attention = self.attention
        ops.ssd_scan = self.scan

    def arm(self, phase, calls):
        self.phase, self.n_calls = phase, calls
        self.calls = dict.fromkeys(calls, 0)

    def _keep(self, kernel, tensors, kw):
        if self.phase:
            i = self.calls[kernel]
            if i in (0, self.n_calls[kernel] - 1):
                self.inputs[(self.phase, kernel, i)] = (
                    tuple(t.clone() for t in tensors), dict(kw))
            self.calls[kernel] += 1

    def attention(self, q, k, v, **kw):
        self._keep("flash_attention", (q, k, v), kw)
        return self._attn(q, k, v, **kw)

    def scan(self, x, dt, a, B_, C_, **kw):
        self._keep("ssd_scan", (x, dt, a, B_, C_), kw)
        return self._ssd(x, dt, a, B_, C_, **kw)


def prefill_batch(cfg, batch, seq, device):
    """``batch`` prompts of ``seq`` tokens from ``default_rng(0)``, with
    the VLM's vision prefix (``vision_prefix`` patch embeddings) and the
    encoder-decoder's frames (``max(seq // audio_stride, 8)``), bf16 unit
    normals, as the reference's ``batch_structs`` shapes them."""
    rng = np.random.default_rng(0)
    out = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size,
                                               (batch, seq)), device=device)}
    gen = torch.Generator(device=device).manual_seed(0)

    def embed(n):
        return torch.randn((batch, n, cfg.d_model), generator=gen,
                           device=device).bfloat16()
    if cfg.vision_prefix:
        out["vision_embed"] = embed(cfg.vision_prefix)
    if cfg.enc_layers:
        out["frames"] = embed(max(seq // max(cfg.audio_stride, 1), 8))
    return out


def prefill_phase(label, cfg, batch, seq, rec, profile=False,
                  device="cuda"):
    """Prefill ``batch`` prompts of ``seq`` tokens (``prefill_batch``)
    through ``launch/steps.make_prefill_step`` on the seed-0 model of
    ``cfg`` drawn on the device, with the launch counts zeroed just
    before and read just after; a second call under ``torch.profiler``
    when ``profile``.  Returns the phase record."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.model import Model
    model = Model(cfg, seed=0, device=device)
    step = make_prefill_step(cfg, device=device)
    inputs = prefill_batch(cfg, batch, seq, device)
    want_launches = path_launches(cfg, decode=False)
    rec.arm(label, want_launches)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logits = step(model.params, inputs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    rec.phase = None
    finite = bool(torch.isfinite(logits).all())
    row = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "enc_layers": cfg.enc_layers, "d_model": cfg.d_model,
           "compute_dtype": cfg.compute_dtype, "batch": batch,
           "prompt_len": seq, "vision_prefix": cfg.vision_prefix,
           "wall_s": wall, "prompt_tokens_per_s": batch * seq / wall,
           "logits_shape": list(logits.shape), "logits_finite": finite,
           "launches": launches,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if profile:
        torch.cuda.synchronize()
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        with prof:
            t0 = time.perf_counter()
            step(model.params, inputs)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
        row["profile"] = profile_summary(prof, prof_ms, 1)
    log(f"[paths] {label}: {cfg.name} {batch} x {seq} prompt tokens, wall "
        f"{wall:.3f} s, {row['prompt_tokens_per_s']:.1f} prompt tok/s, "
        f"logits {row['logits_shape']} finite {finite}, launches "
        f"{launches}, peak {row['peak_gb']:.1f} GB")
    if row.get("profile"):
        tr = row["profile"]
        log(f"[paths] {label} profile of one prefill: wall "
            f"{tr['wall_ms']:.3f} ms, device busy {tr['device_busy_ms']:.3f}"
            f" ms, idle share {tr['device_idle_share']}")
        for key, ms, n in tr["top_device_ms"]:
            log(f"[paths]   device {ms:10.3f} ms  {n:6d}x  {key[:90]}")
        for key, ms, n in tr["top_host_ms"]:
            log(f"[paths]   host   {ms:10.3f} ms  {n:6d}x  {key[:90]}")
    if not finite or list(logits.shape) != [batch, 1, cfg.vocab_size]:
        fail(f"{label}: logits {list(logits.shape)}, finite {finite}")
    kinds = {"flash_attention": "flash_attention_wgmma",
             "ssd_scan": "ssd_scan_mma"}
    for kernel, n in want_launches.items():
        want = n if device == "cuda" else 0
        names = [kernel] + ([kinds[kernel]]
                            if cfg.compute_dtype == "bfloat16" else [])
        for name in names:
            if launches[name] != want:
                fail(f"{label}: {name} launched {launches[name]} times, "
                     f"not {want}")
    return row


def prefill_cross(points=PREFILL_CROSS):
    """The smoke configs' prefill in float32 (TF32 off) on the card and on
    the CPU with the same weights: last-position logits within 1e-3."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.model import Model
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    try:
        for arch, batch, seq in points:
            cfg = get_config(arch, smoke=True).replace(
                compute_dtype="float32")
            cpu = Model(cfg, seed=0, device="cpu")
            card = Model(cfg, seed=0, device="cuda")
            card.load_state_dict(cpu.state_dict())
            inputs = prefill_batch(cfg, batch, seq, "cpu")
            reset_counts()
            got = make_prefill_step(cfg, device="cuda")(
                card.params, {k: v.cuda() for k, v in inputs.items()})
            torch.cuda.synchronize()
            launches = counts()
            want = make_prefill_step(cfg, device="cpu")(cpu.params, inputs)
            err = float((got.cpu() - want).abs().max())
            # float32: the SIMT / FMA variants
            want_launches = {f"{k}_simt": n for k, n in
                             path_launches(cfg, decode=False).items()}
            ok = err <= 1e-3 and all(launches[k] == n
                                     for k, n in want_launches.items())
            log(f"[paths] prefill_cross {arch} {batch} x {seq}: logits max "
                f"abs diff card vs CPU {err!r} (limit 1e-3), launches "
                f"{launches} (want {want_launches})")
            if not ok:
                fail(f"prefill_cross {arch} s={seq}: diff {err}, launches "
                     f"{launches}")
            rows.append({"arch": arch, "batch": batch, "prompt_len": seq,
                         "max_abs_diff": err, "launches": launches})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return rows


def run_prefill(rec, phases=PREFILL):
    """Every prefill phase at full width (depth cut where given), each
    model freed before the next is drawn; then the smoke-config cross
    check."""
    from repro_torch.configs.base import get_config
    out = {}
    for label, arch, layers, batch, seq in phases:
        cfg = get_config(arch)
        if layers:
            cfg = cfg.replace(n_layers=layers)
        torch.cuda.reset_peak_memory_stats()
        out[label] = prefill_phase(label, cfg, batch, seq, rec,
                                   profile=label == PREFILL_PROFILE)
        torch.cuda.empty_cache()
    points = prefill_cross()
    out["prefill_cross"] = {"points": points, "launches": {
        name: sum(r["launches"][name] for r in points) for name in counts()}}
    return out


# ---------------------------------------------------------------- train

def ssd_ops(b, s, h, p, n, chunk):
    """Operations of the SSD scan's products (see ``ssd_bound``)."""
    lens = [min(chunk, s - c0) for c0 in range(0, s, chunk)]
    return sum(b * ln * (ln + 1) * n + b * h * (ln * (ln + 1) * p
                                               + 4 * ln * n * p)
               for ln in lens)


def model_flops(cfg, batch, seq):
    """Model FLOPs of one train step: 6 x the parameters outside the
    input embedding x tokens, plus, forward and backward (3 x the
    forward), the attention products the mask keeps (q Kᵀ and P V: 4 D a
    kept (query, key) pair and head) or the SSD scan's products."""
    from repro_torch.models.blocks import count_params
    from repro_torch.models.model import model_defs
    from repro_torch.models.ssm import ssm_dims
    n = count_params(model_defs(cfg)) - cfg.vocab_size * cfg.d_model
    flops = 6 * n * batch * seq
    for mixer, _ in cfg.pattern:
        if mixer == "attn":
            flops += 3 * cfg.n_blocks * 4 * cfg.hd * cfg.n_heads * batch \
                * attn_pairs(seq, seq, True, cfg.window)
        else:
            _, h, p, n_state, _ = ssm_dims(cfg)
            flops += 3 * cfg.n_blocks * ssd_ops(batch, seq, h, p, n_state,
                                                min(256, seq))
    return flops


def train_phase(label, cfg, batch, seq, accum, kernel, device="cuda"):
    """``TRAIN_STEPS`` steps of ``runtime/train.Trainer`` on ``cfg`` at
    full width (seed-0 parameters drawn on the card, synthetic data, no
    checkpoint), the launch counts zeroed just before and read just
    after; then one more step under torch.profiler.  Returns the phase
    record."""
    import tempfile
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.blocks import tree_leaves
    from repro_torch.runtime.train import Trainer, TrainerConfig
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(cfg, DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=seq, global_batch=batch),
                          TrainerConfig(total_steps=TRAIN_STEPS, ckpt_every=0,
                                        accum_steps=accum, log_every=1,
                                        ckpt_dir=tmp),
                          log=lines.append, device=device)
        trainer.init_state()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = trainer.run(resume=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts()
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        with prof:
            t0 = time.perf_counter()
            trainer.step_fn(trainer.params, trainer.opt_state, trainer.err,
                            trainer.pipeline.batch_at(TRAIN_STEPS))
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
        n_params = sum(t.numel() for _, t in tree_leaves(trainer.params))
        del trainer
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    losses = [h["loss"] for h in out["history"]]
    dts = [h["dt"] for h in out["history"]]
    step_s = sum(dts[1:]) / len(dts[1:])
    flops = model_flops(cfg, batch, seq)
    row = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "compute_dtype": cfg.compute_dtype,
           "remat": cfg.remat, "batch": batch, "seq": seq,
           "accum_steps": accum, "steps": TRAIN_STEPS, "n_params": n_params,
           "losses": losses, "step_s": dts, "wall_s": wall,
           "ms_per_step": step_s * 1e3,
           "tokens_per_s": batch * seq / step_s,
           "model_flops_per_step": flops,
           "mfu": flops / step_s / PEAK_FLOPS[torch.bfloat16],
           "peak_gb": peak, "launches": launches,
           "profile": profile_summary(prof, prof_ms, 1), "log": lines}
    tr = row["profile"]
    by_range = tr["range_device_ms_per_step"]
    tr["backward_device_ms"] = tr["device_busy_ms"] - by_range.get(
        "train_step.forward", 0.0) - by_range.get("train_step.adamw", 0.0)
    log(f"[paths] {label}: {cfg.name} {batch} x {seq} tokens a step in "
        f"{accum} microbatches, {TRAIN_STEPS} steps, losses {losses}, step "
        f"s {dts}, {row['ms_per_step']:.1f} ms a step after the first, "
        f"{row['tokens_per_s']:.1f} tok/s, mfu {row['mfu']:.4f} "
        f"({flops / 1e12:.1f} model TFLOP a step at 989 TFLOP/s bf16), "
        f"peak {peak:.1f} GB, launches {launches}; profiled step: wall "
        f"{tr['wall_ms']:.1f} ms, device busy {tr['device_busy_ms']:.1f} "
        f"ms, idle share {tr['device_idle_share']}, device ms by range "
        f"{by_range} (backward, the rest: {tr['backward_device_ms']:.1f}), "
        f"by kernel {tr['kernel_device_ms_per_step']}")
    for key, ms, n in tr["top_device_ms"]:
        log(f"[paths]   device {ms:10.3f} ms  {n:6d}x  {key[:90]}")
    for key, ms, n in tr["top_host_ms"]:
        log(f"[paths]   host   {ms:10.3f} ms  {n:6d}x  {key[:90]}")
    if not all(np.isfinite(losses)) or len(losses) != TRAIN_STEPS:
        fail(f"{label}: losses {losses}")
    want = 2 * cfg.n_layers * accum * TRAIN_STEPS if device == "cuda" else 0
    kind = {"flash_attention": "flash_attention_wgmma",
            "ssd_scan": "ssd_scan_mma"}[kernel]
    for name in (kernel, kind):
        if launches[name] != want:
            fail(f"{label}: {name} launched {launches[name]} times, not "
                 f"{want} (2 a layer and microbatch)")
    return row


def train_cross(spec=TRAIN_CROSS):
    """The smoke configs' ``Trainer`` in float32 (TF32 off) on the card
    and on the CPU from one step-0 checkpoint: per-step losses within
    ``TRAIN_CROSS_TOL``; then on the card a crash at ``fail_at`` and a
    fresh ``Trainer`` resuming from the last checkpoint, whose final
    loss must equal the uninterrupted card run's (``RESTART_RTOL``)."""
    import shutil
    import tempfile
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.runtime.train import (SimulatedFailure, Trainer,
                                           TrainerConfig)
    prev = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    try:
        for arch in spec["archs"]:
            cfg = get_config(arch, smoke=True).replace(
                compute_dtype="float32")
            dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=spec["seq"],
                            global_batch=spec["batch"])
            with tempfile.TemporaryDirectory() as tmp:
                def trainer(name, device, **kw):
                    return Trainer(cfg, dc, TrainerConfig(
                        total_steps=spec["steps"],
                        ckpt_every=spec["ckpt_every"], keep=3,
                        ckpt_dir=os.path.join(tmp, name), **kw),
                        log=lambda *_: None, device=device)
                start = trainer("start", "cpu")
                start.init_state()
                start.ckpt.save(0, start._state_tree(), meta={"loss": None})
                start.ckpt.wait()
                for name in ("cpu", "card", "ft"):
                    shutil.copytree(os.path.join(tmp, "start"),
                                    os.path.join(tmp, name))
                cpu = trainer("cpu", "cpu").run()
                torch.cuda.synchronize()
                reset_counts()
                card = trainer("card", "cuda").run()
                torch.cuda.synchronize()
                launches = counts()
                crashed = False
                try:
                    trainer("ft", "cuda", fail_at_steps=(spec["fail_at"],)
                            ).run()
                except SimulatedFailure:
                    crashed = True
                resumed = trainer("ft", "cuda").run()
            got = [h["loss"] for h in card["history"]]
            want = [h["loss"] for h in cpu["history"]]
            diff = max(abs(a - b) for a, b in zip(got, want))
            restart = abs(resumed["final_loss"] - card["final_loss"])
            kernel = "ssd_scan_simt" if cfg.family == "ssm" \
                else "flash_attention_simt"      # float32: the FMA variants
            n_launch = 2 * cfg.n_layers * spec["steps"]
            ok = (diff <= TRAIN_CROSS_TOL and crashed
                  and restart <= RESTART_RTOL * abs(card["final_loss"])
                  and [h["step"] for h in resumed["history"]]
                  == list(range(spec["ckpt_every"], spec["steps"]))
                  and launches[kernel] == n_launch)
            log(f"[paths] train_cross {arch}: {spec['steps']} steps of "
                f"{spec['batch']} x {spec['seq']}, losses on the card "
                f"{got}, max abs diff from the CPU {diff!r} (limit "
                f"{TRAIN_CROSS_TOL}); crash at step {spec['fail_at']} "
                f"{crashed}, resumed steps "
                f"{[h['step'] for h in resumed['history']]}, final loss "
                f"{resumed['final_loss']!r} vs uninterrupted "
                f"{card['final_loss']!r} (abs diff {restart!r}, rtol "
                f"{RESTART_RTOL}); {kernel} launched {launches[kernel]} "
                f"(want {n_launch})")
            if not ok:
                fail(f"train_cross {arch}: loss diff {diff}, crashed "
                     f"{crashed}, restart diff {restart}, launches "
                     f"{launches}")
            rows.append({"arch": arch, "card_losses": got,
                         "cpu_losses": want, "max_abs_diff": diff,
                         "restart_final_loss": resumed["final_loss"],
                         "final_loss": card["final_loss"],
                         "restart_abs_diff": restart, "launches": launches})
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    return rows


def run_train(phases=TRAIN):
    """Every train phase at full width, each state freed before the next
    is drawn; then the smoke-config cross and restart check."""
    from repro_torch.configs.base import get_config
    out = {}
    for label, arch, batch, seq, accum, kernel in phases:
        out[label] = train_phase(label, get_config(arch), batch, seq, accum,
                                 kernel)
    points = train_cross()
    out["train_cross"] = {"points": points, "launches": {
        name: sum(r["launches"][name] for r in points) for name in counts()}}
    return out


# ------------------------------------------------------ packet-vs-flow gates

def gate(label, got, want, tol, what="JCT"):
    """One packet-vs-flow comparison: the flow side (card) within ``tol``
    of the packet engine (host)."""
    div = abs(got - want) / abs(want)
    ok = div <= tol
    log(f"[packet]   {label}: packet {want!r} flow {got!r} div "
        f"{100 * div:.2f}% (limit {100 * tol:g}%)"
        f"{'' if ok else '  MISMATCH'}")
    if not ok:
        fail(f"{label}: flow {what} {got} vs packet {want}, "
             f"div {div:.4f} > {tol}")
    return {"label": label, "packet": want, "flow": got, "div": div,
            "tol": tol}


def frozen_scenarios(wl):
    """``tools/freeze_fault_refs.py``'s three zero-fault scenarios."""
    members = [f"h{i}" for i in range(8)]
    return [("static-g8", wl.GroupOp("bcast", members, FROZEN_NBYTES)),
            ("churn-g6", wl.GroupOp(
                "bcast", members[:6], FROZEN_NBYTES,
                events=(wl.MemberEvent("join", "h7", 4e-5),
                        wl.MemberEvent("leave", "h3", 8e-5)))),
            ("ring-g6", wl.GroupOp("bcast", members[:6], FROZEN_NBYTES,
                                   transport="ring"))]


def frozen_rows(eng, wl):
    """Records of the scenarios, one run_many, in the frozen file's form
    (every float as its repr)."""
    scen = frozen_scenarios(wl)
    recs = []
    eng.run_many([lambda e, op=op: recs.append(e.stage(op))
                  for _, op in scen], timeout=60.0)
    return {name: {"t_submit": repr(float(r.t_submit)),
                   "t_sender_cqe": repr(float(r.t_sender_cqe)),
                   "t_deliver": [[m, repr(float(t))]
                                 for m, t in sorted(r.t_deliver.items())],
                   "jct": repr(float(r.jct(len(op.surviving_receivers()))))}
            for (name, op), r in zip(scen, recs)}


def packet_frozen(rec, fts, mods):
    fattree, wl, make_engine = mods
    with open(os.path.join(REPO, FROZEN_REFS)) as fh:
        ref = json.load(fh)
    if (ref["nbytes"], ref["seed"]) != (FROZEN_NBYTES, FROZEN_SEED):
        fail(f"packet_frozen: {FROZEN_REFS} holds nbytes {ref['nbytes']} "
             f"seed {ref['seed']}")
    t0 = time.perf_counter()
    got = frozen_rows(make_engine("packet", fattree.testbed(n_hosts=10),
                                  seed=FROZEN_SEED), wl)
    packet_wall = time.perf_counter() - t0
    for name, want in ref["engines"]["packet"].items():
        ok = got.get(name) == want
        log(f"[packet]   {name}: packet records "
            f"{'equal' if ok else 'DIFFER from'} {FROZEN_REFS}")
        if not ok:
            fail(f"packet_frozen {name}: {got.get(name)} != {want}")
    with Phase("packet_frozen", rec, fts, lossy=False) as ph:
        flow = frozen_rows(make_engine("flow", fattree.testbed(n_hosts=10),
                                       device=FLOW_DEVICE), wl)
    err = 0.0
    for name, want in ref["engines"]["flow-np"].items():
        g = flow[name]
        pairs = [(g[k], want[k]) for k in ("t_submit", "t_sender_cqe",
                                           "jct")]
        if [m for m, _ in g["t_deliver"]] != [m for m, _ in
                                               want["t_deliver"]]:
            fail(f"packet_frozen {name}: flow receivers "
                 f"{g['t_deliver']} vs {want['t_deliver']}")
        pairs += [(a[1], b[1]) for a, b in zip(g["t_deliver"],
                                              want["t_deliver"])]
        for a, b in pairs:
            a, b = float(a), float(b)
            err = max(err, abs(a - b) / abs(b) if b else abs(a))
            if not close(a, b, 1e-3):
                fail(f"packet_frozen {name}: flow {a} vs flow-np {b}")
    log(f"[packet] packet_frozen: packet {packet_wall:.3f} s, flow records "
        f"max rel err {err:.3g} vs the frozen flow-np (limit 1e-3)")
    return dict(ph.stats, packet_wall_s=packet_wall, flow_max_rel_err=err)


def fig15_point(mods, engine, group, loss, **kw):
    """fig15's single point: gleam on the ``group``-host testbed."""
    fattree, wl, make_engine = mods
    topo = fattree.testbed(n_hosts=group, bw=200 * fattree.GBPS)
    eng = make_engine(engine, topo, loss_rate=loss, seed=11,
                      group_kw={"window": 512}, relay_kw={"window": 512},
                      **kw)
    r = eng.stage(wl.GroupOp("bcast", [f"h{i}" for i in range(group)],
                             FIG15_NBYTES, transport="gleam", chunks=8))
    return eng, r


def packet_fig15(rec, fts, mods):
    with open(os.path.join(REPO, "BENCH_packetsim.json")) as fh:
        single = [p["passes"][0] for p in json.load(fh)["single"]]
    rows = []
    for group, loss in FIG15_PACKET:
        want = [p for p in single if (p["group"], p["loss"]) == (group,
                                                                 loss)]
        eng, r = fig15_point(mods, "packet", group, loss)
        t0 = time.perf_counter()
        eng.run(timeout=240.0)
        wall = time.perf_counter() - t0
        sim = eng.net.sim
        got = {"jct_ms": r.jct(group - 1) * 1e3, "events": sim.events,
               "dropped": sim.dropped}
        ok = bool(want) and all(got[k] == want[0][k] for k in got)
        log(f"[packet]   fig15 g{group} loss {loss:g}: packet {got} in "
            f"{wall:.3f} s ({sim.events / wall:.0f} events/s); "
            f"BENCH_packetsim.json {want[0] if want else None}"
            f"{'' if ok else '  MISMATCH'}")
        if not ok:
            fail(f"packet_fig15 g{group} loss {loss}: {got} vs {want}")
        rows.append(dict(got, group=group, loss=loss, packet_wall_s=wall,
                         events_per_s=sim.events / wall))
    with Phase("packet_fig15", rec, fts, lossy=True) as ph:
        for row in rows:
            eng, r = fig15_point(mods, "flow", row["group"], row["loss"],
                                 device=FLOW_DEVICE)
            eng.run()
            row["flow_jct_ms"] = r.jct(row["group"] - 1) * 1e3
    for row in rows:
        row["div"] = abs(row["flow_jct_ms"] - row["jct_ms"]) / row["jct_ms"]
        log(f"[packet]   fig15 g{row['group']} loss {row['loss']:g}: flow "
            f"{row['flow_jct_ms']!r} ms, packet-vs-flow divergence "
            f"{100 * row['div']:.2f}% (logged, not gated)")
    return dict(ph.stats, rows=rows,
                packet_wall_s=sum(r["packet_wall_s"] for r in rows))


def leaf_uplink(topo, host):
    """First non-host peer of the host's leaf switch."""
    leaf = topo.ports[host][0][0]
    for p in sorted(topo.ports[leaf]):
        peer = topo.ports[leaf][p][0]
        if not peer.startswith("h"):
            return leaf, peer
    raise RuntimeError(f"no uplink above {host}")


def gate_values(mods, engine, kw):
    """``tests/test_engines.py``'s JCT points and
    ``tools/check_faults.py``'s recovery latencies on one engine:
    label -> (value, tolerance).  Every op must complete without a QP
    error."""
    fattree, wl, make_engine = mods
    out = {}

    def run(label, topo, op, n, timeout=120.0, **extra):
        eng = make_engine(engine, topo, **kw, **extra)
        r = eng.stage(op)
        eng.run(timeout=timeout)
        if r.error or r.t_sender_cqe < 0 or len(r.t_deliver) < n:
            fail(f"{label}/{engine}: incomplete (error {r.error!r}, cqe "
                 f"{r.t_sender_cqe}, {len(r.t_deliver)}/{n} delivered)")
        return r

    members = ["h0", "h1", "h2", "h3"]
    two_pod = dict(n_pods=2, leaves_per_pod=2, hosts_per_leaf=2,
                   aggs_per_pod=2, bw=100 * fattree.GBPS)
    for nbytes in (64 << 10, 1 << 20, 8 << 20):
        r = run("testbed", fattree.testbed(),
                wl.GroupOp("bcast", members, nbytes), 3)
        out[f"testbed_bcast_{nbytes}"] = (r.jct(3), GATE_TOL["jct"])
    for nbytes in (256 << 10, 4 << 20):
        topo = fattree.fat_tree(**two_pod)
        r = run("two_pod", topo, wl.GroupOp("bcast", topo.hosts, nbytes), 7)
        out[f"two_pod_bcast_{nbytes}"] = (r.jct(7), GATE_TOL["jct"])
    for transport in wl.TRANSPORT_CHOICES:
        for nbytes in (256 << 10, 1 << 20):
            r = run("transport", fattree.testbed(n_hosts=4),
                    wl.GroupOp("bcast", members, nbytes,
                               transport=transport), 3)
            out[f"{transport}_bcast_{nbytes}"] = (r.jct(3), GATE_TOL["jct"])
        r = run("allreduce", fattree.testbed(),
                wl.GroupOp("allreduce", members, 1 << 20,
                           transport=transport), 4)
        out[f"{transport}_allreduce"] = (r.jct(4), GATE_TOL["allreduce"])
    topo = fattree.fig4()
    leaf, spine = leaf_uplink(topo, "h2")
    seed = {"seed": 7} if engine == "packet" else {}
    cases = (("link_down", wl.FaultEvent("link_down", FAULT_AT, node=leaf,
                                         peer=spine)),
             ("link_flap", wl.FaultEvent("link_flap", FAULT_AT, node=leaf,
                                         peer=spine, duration=50e-6)),
             ("switch_fail", wl.FaultEvent("switch_fail", FAULT_AT,
                                           node=spine)),
             ("host_gone_dark", wl.FaultEvent("host_gone_dark", FAULT_AT,
                                              node="h3")),
             ("master_crash", wl.FaultEvent("master_crash", FAULT_AT)))
    base = run("fault_base", fattree.fig4(),
               wl.GroupOp("bcast", members, FAULT_NBYTES), 3, 1.0, **seed)
    for name, fault in cases:
        op = wl.GroupOp("bcast", members, FAULT_NBYTES, faults=(fault,))
        r = run(name, fattree.fig4(), op, len(op.surviving_receivers()),
                1.0, **seed)
        out[f"recovery_{name}"] = (r.t_sender_cqe - base.t_sender_cqe,
                                   GATE_TOL["recovery"])
    return out


def fork_batch(mods, workers):
    """Eight scenarios of a lossy 16-member gleam bcast on packet
    ``run_many`` (each scenario its own RNG stream).  The scenarios share
    one group, whose message ids count on in each process, so a forked
    run's ids restart per worker: the records are compared without
    them."""
    fattree, wl, make_engine = mods
    eng = make_engine("packet", fattree.testbed(n_hosts=16,
                                                bw=200 * fattree.GBPS),
                      loss_rate=1e-3, seed=11, group_kw={"window": 512})
    recs = []
    op = wl.GroupOp("bcast", [f"h{i}" for i in range(16)], FIG15_NBYTES)
    t0 = time.perf_counter()
    ends = eng.run_many([lambda e: recs.append(e.stage(op))] * FORK_SCENARIOS,
                        timeout=240.0, workers=workers)
    wall = time.perf_counter() - t0
    return (ends, [(r.t_submit, r.t_sender_cqe,
                    sorted(r.t_deliver.items()), r.error) for r in recs],
            eng.last_run_stats, eng.last_run_errors), wall


def packet_vs_flow(rec, fts, mods):
    t0 = time.perf_counter()
    want = gate_values(mods, "packet", {})
    packet_wall = time.perf_counter() - t0
    with Phase("packet_vs_flow", rec, fts, lossy=False) as ph:
        got = gate_values(mods, "flow", {"device": FLOW_DEVICE})
    rows = [gate(label, got[label][0], value, tol)
            for label, (value, tol) in want.items()]
    serial, serial_wall = fork_batch(mods, None)
    forked, forked_wall = fork_batch(mods, FORK_WORKERS)
    same = forked[:3] == serial[:3] and not forked[3]
    log(f"[packet]   run_many: {FORK_SCENARIOS} scenarios serial "
        f"{serial_wall:.3f} s, workers={FORK_WORKERS} {forked_wall:.3f} s "
        f"(forked after CUDA init), records and last_run_stats "
        f"{'equal' if same else 'DIFFER'}; worker errors {forked[3]}")
    if not same:
        fail(f"packet_vs_flow: run_many(workers={FORK_WORKERS}) differs "
             f"from serial: {forked[3]}")
    return dict(ph.stats, rows=rows, packet_wall_s=packet_wall,
                fork={"workers": FORK_WORKERS, "scenarios": FORK_SCENARIOS,
                      "serial_s": serial_wall, "forked_s": forked_wall,
                      "equal": same})


def fleet_phase(rec, fts, mods):
    from repro_torch.apps.fleet import FleetSpec, run_fleet
    fattree = mods[0]
    spec = FleetSpec(**FLEET_SPEC)

    def fabric():
        return fattree.fat_tree(bw=100 * fattree.GBPS, **FLEET_FABRIC)

    shared = fabric()
    t0 = time.perf_counter()
    rp = run_fleet("packet", shared, spec, seed=1)
    packet_wall = time.perf_counter() - t0
    with Phase("fleet", rec, fts, lossy=False) as ph:
        rf = run_fleet("flow", shared, spec, device=FLOW_DEVICE)
        fresh = run_fleet("flow", fabric(), spec, device=FLOW_DEVICE)
    rows = []
    for rep in (rp, rf):
        if rep["errors"]:
            fail(f"fleet {rep['engine']}: {rep['errors']} errored ops")
    for phase, qf in sorted(rf["tenants"].items()):
        qp = rp["tenants"][phase]
        if phase.startswith("tenant-"):
            rows.append(gate(f"fleet {phase} p99", qf["p99"], qp["p99"],
                             GATE_TOL["fleet"], "p99"))
        for q in (qf, qp):
            if not q["p50"] <= q["p99"] <= q["p999"] <= q["latency"]:
                fail(f"fleet {phase}: non-monotone quantiles {q}")
    cp, cf = rp["census"], rf["census"]
    census_ok = cf["qp_per_host"] == cp["qp_per_host"] and \
        cf["mft_groups_total"] == cp["mft_groups_total"]
    shared_ok = fresh["tenants"] == rf["tenants"] and \
        fresh["census"] == rf["census"]
    hit_rate = rf["staging"]["hit_rate"]
    log(f"[packet]   fleet: census qp_total {cp['qp_total']} (flow "
        f"{cf['qp_total']}), mft groups {cp['mft_groups_total']} (flow "
        f"{cf['mft_groups_total']}){'' if census_ok else '  MISMATCH'}; "
        f"staging hit rate {hit_rate:.3f}; flow on the packet engine's "
        f"fabric {'equals' if shared_ok else 'DIFFERS from'} a fresh one")
    if not census_ok:
        fail(f"fleet census: flow {cf} vs packet {cp}")
    if not hit_rate > 0:
        fail("fleet: the staging cache saw no hits")
    if not shared_ok:
        fail("fleet: flow on the shared fabric differs from a fresh one")
    return dict(ph.stats, rows=rows, packet_wall_s=packet_wall,
                census_equal=census_ok, staging_hit_rate=hit_rate,
                shared_fabric_equal=shared_ok)


def apps_phase(rec, fts, mods):
    from repro_torch.apps.collectives_lowering import (MeshShape,
                                                       param_count,
                                                       train_step_workload)
    from repro_torch.apps.metrics import run_phased, step_time
    from repro_torch.apps.traffic import ArrivalSpec, ServingGenerator
    from repro_torch.configs.base import get_config
    from repro_torch.models.blocks import count_params
    from repro_torch.models.model import model_defs
    fattree, _, make_engine = mods
    mesh = MeshShape(**APPS_MESH)
    cfgs = {arch: get_config(arch, smoke=True) for arch in APPS_ARCHS}
    for arch, cfg in cfgs.items():
        if param_count(cfg) != count_params(model_defs(cfg)):
            fail(f"apps {arch}: param_count {param_count(cfg)} != "
                 f"count_params(model_defs) {count_params(model_defs(cfg))}")
    gen = ServingGenerator(cfgs["llama3_2_3b"], **APPS_SERVE)
    spec = ArrivalSpec(**APPS_ARRIVALS)

    def run(engine, kw):
        steps = {}
        for arch, cfg in cfgs.items():
            for transport in APPS_TRANSPORTS:
                eng = make_engine(engine, fattree.testbed(
                    n_hosts=mesh.n_chips), **kw)
                wl = train_step_workload(cfg, mesh, seq=64, batch=8,
                                         transport=transport)
                steps[(arch, transport)] = step_time(
                    *run_phased(eng, wl, timeout=60.0))
        rep = gen.run(make_engine(engine, fattree.testbed(n_hosts=8), **kw),
                      spec, timeout=60.0)
        return steps, rep

    t0 = time.perf_counter()
    want, want_rep = run("packet", {})
    packet_wall = time.perf_counter() - t0
    with Phase("apps", rec, fts, lossy=False) as ph:
        got, got_rep = run("flow", {"device": FLOW_DEVICE})
    rows = [gate(f"apps {arch} train/{transport} step", got[(arch, transport)],
                 want[(arch, transport)], GATE_TOL["apps"], "step time")
            for arch, transport in want]
    for arch in cfgs:
        if want[(arch, "gleam")] > want[(arch, "multiunicast")]:
            fail(f"apps {arch}: gleam step slower than multiunicast")
    for engine, r in (("packet", want_rep), ("flow", got_rep)):
        q = r.quantiles
        log(f"[packet]   apps serve/{engine}: achieved "
            f"{r.achieved_qps!r}/{spec.rate:g} qps, p50 {q['p50']!r} p99 "
            f"{q['p99']!r} p999 {q['p999']!r} s")
        if r.n_requests != spec.n or not 0 < r.achieved_qps \
                <= spec.rate * 1.05 \
                or not q["p50"] <= q["p99"] <= q["p999"] <= q["max"]:
            fail(f"apps serve/{engine}: {r.n_requests} requests, achieved "
                 f"{r.achieved_qps}, quantiles {q}")
    rows.append(gate("apps serve achieved qps", got_rep.achieved_qps,
                     want_rep.achieved_qps, GATE_TOL["apps"], "QPS"))
    return dict(ph.stats, rows=rows, packet_wall_s=packet_wall)


def host_cpu() -> str:
    """The host CPU's model name (``unknown`` where ``/proc/cpuinfo``
    gives none), architecture and cores: the packet engine's times are
    taken on it."""
    import platform
    name = "unknown"
    try:
        with open("/proc/cpuinfo") as fh:
            name = next((line.split(":", 1)[1].strip() for line in fh
                         if line.startswith("model name")), name)
    except OSError:
        pass
    return f"{name} ({platform.machine()}, {os.cpu_count()} cores)"


def run_packet(rec):
    """The packet engine (host) beside the flow engine (card) at every
    packet-vs-flow gate of the reference; each flow side one path phase."""
    from repro_torch.core import fattree, flowsim_torch as fts
    from repro_torch.core import workload as wl
    from repro_torch.core.engine import make_engine
    mods = (fattree, wl, make_engine)
    cpu = host_cpu()
    log(f"[packet] host CPU: {cpu}")
    out = {}
    for label, fn in (("packet_frozen", packet_frozen),
                      ("packet_fig15", packet_fig15),
                      ("packet_vs_flow", packet_vs_flow),
                      ("fleet", fleet_phase), ("apps", apps_phase)):
        t0 = time.perf_counter()
        out[label] = fn(rec, fts, mods)
        out[label]["phase_wall_s"] = time.perf_counter() - t0
        log(f"[packet] {label}: {out[label]['phase_wall_s']:.3f} s "
            f"(packet side {out[label].get('packet_wall_s', 0.0):.3f} s), "
            f"flow launches {out[label]['launches']}")
        out[label]["host_cpu"] = cpu
    return out


# ---------------------------------------------------------------- kernels

def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_kernels(fn, reps, attempts=4):
    """``(events, traces)``: torch.profiler's device events (kernels,
    copies, fills) of ``reps`` calls of ``fn``, after ``reps`` calls
    untraced, and the traces taken; events None when no trace of
    ``attempts`` was whole.  Late in a long process the tracer drops the
    first device events of each trace (a few, then tens), so a trace
    first launches a run of one-element fills (64, four times more on
    each retry), whose events are left out: a trace counts when some of
    the fills' events are there and every kernel of ``fn`` ran a whole
    multiple of ``reps`` times."""
    from torch.autograd import DeviceType
    pad = torch.zeros(1, device="cuda")
    for traces in range(1, attempts + 1):
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(64 * 4 ** (traces - 1)):
                pad.fill_(0.0)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [a for a in prof.key_averages()
               if a.device_type != DeviceType.CPU]
        mine = [a for a in dev if PAD_KERNEL not in a.key]
        if len(mine) < len(dev) and mine \
                and all(a.count % reps == 0 for a in mine):
            return mine, traces
    return None, attempts


def device_time(fn, reps):
    """``(device ms per call, device kernels per call, traces)`` of
    ``fn``: every kernel (copy or fill) that one call launches, summed;
    the first two None, not measured, when the tracer gave no whole
    trace."""
    dev, traces = device_kernels(fn, reps)
    if dev is None:
        return None, None, traces
    return (sum(a.self_device_time_total for a in dev) / 1e3 / reps,
            sum(a.count for a in dev) // reps, traces)


def kernels_per_call(count, fn, reps):
    """Device kernels one call of ``fn`` launches, by its library's own
    count (``count()``, one added beside each launch) over ``reps``
    calls: no tracer, so nothing is lost."""
    before = count()
    for _ in range(reps):
        fn()
    return (count() - before) / reps


def bound(n_bytes, ops, dtype):
    """The least time for the work: (bound ms, bound by, byte bound ms)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, ops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", t_bytes * 1e3)


def fill_bound(fl, cap, rounds, dtype):
    """Each input read once (link ids, capacities, active mask), the
    rates written once; per round a scatter, a gather-min and a scatter
    over the link ids plus three passes over the links."""
    b, f, _ = fl.shape
    es = torch.finfo(dtype).bits // 8
    n_bytes = fl.numel() * 4 + cap.numel() * es + 2 * b * f * es
    ops = rounds * (3 * fl.numel() + 3 * b * cap.shape[-1] + b * f)
    return bound(n_bytes, ops, dtype)


def loss_bound(fl, cap, dtype):
    """Link ids, capacities and six per-flow vectors read once, the
    factors written once; two scatters, a hot test per link id and ~20
    operations per flow."""
    b, f, _ = fl.shape
    es = torch.finfo(dtype).bits // 8
    n_bytes = fl.numel() * 4 + cap.numel() * es + 7 * b * f * es
    ops = 5 * fl.numel() + 20 * b * f
    return bound(n_bytes, ops, dtype)


def check_fill(name, fl, cap, active, kw, dtype, mm, ref, launches=0):
    """Kernel vs plain filling: per round, then whole; times."""
    cap = cap.to(dtype)
    active = active.to(dtype)
    tol = kw.get("tol", 1e-6)
    rtol = 1e-6 if dtype == torch.float32 else 1e-12
    b = fl.shape[0]
    frozen = 1.0 - active
    rates = torch.zeros_like(active)
    cap_rem = cap.expand(b, -1).contiguous() if cap.dim() == 1 else cap
    rounds, round_err, freeze_ok = 0, 0.0, True
    bound = fl.shape[1] if kw.get("max_rounds") is None \
        else kw["max_rounds"] - 1
    while rounds <= bound:
        live = (frozen < 0.5).any(-1)
        if not bool(live.any()):
            break
        pr, pf, pc = ref.maxmin_round_reference(fl, frozen, rates, cap_rem,
                                                tol=tol)
        if rounds < ROUNDS_CHECKED:
            kr, kf, kc = mm.maxmin_round(fl, frozen, rates, cap_rem, tol=tol)
            freeze_ok &= bool((kf == pf)[live].all())
            round_err = max(round_err, rel_err(kr[live], pr[live]),
                            rel_err(kc[live], pc[live]))
        keep = live[:, None]
        rates = torch.where(keep, pr, rates)
        frozen = torch.where(keep, pf, frozen)
        cap_rem = torch.where(keep, pc, cap_rem)
        rounds += 1
    got = mm.maxmin_rates(fl, cap, active, **kw)
    want = ref.maxmin_rates_reference(fl, cap, active, **kw)
    err_abs = float((got - want).abs().max())
    err_rel = rel_err(got, want)
    ok = freeze_ok and round_err <= rtol and err_rel <= rtol
    ms = cuda_ms(lambda: mm.maxmin_rates(fl, cap, active, **kw), 20)
    plain_ms = cuda_ms(lambda: ref.maxmin_rates_reference(fl, cap, active,
                                                          **kw), 3)
    bound_ms, bound_by, bytes_ms = fill_bound(fl, cap, max(rounds, 1), dtype)
    row = {"kernel": "maxmin_fill", "phase": name, "shape": list(fl.shape),
           "caps": cap.shape[-1], "dtype": str(dtype).split(".")[-1],
           "rounds": rounds, "freeze_sets_equal": freeze_ok,
           "round_max_rel_err": round_err, "max_abs_err": err_abs,
           "max_rel_err": err_rel, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes_bound_ms": bytes_ms, "phase_launches": launches, "ok": ok}
    log(f"[kernels] {json.dumps(row)}")
    if not ok:
        fail(f"maxmin_fill {name} {list(fl.shape)} {dtype}: freeze "
             f"{freeze_ok}, round err {round_err}, rates err {err_rel}")
    return row


def rel_err(got, want):
    if got.numel() == 0:
        return 0.0
    den = want.abs().clamp(min=1e-30)
    diff = (got - want).abs()
    diff = torch.where(torch.isinf(want) & (got == want),
                       torch.zeros_like(diff), diff)
    return float((diff / den).max())


def check_loss(name, args, kw, dtype, mm, ref, launches=0):
    fl, rates, active, cap, q, wsq, wnd, ecn = (
        a.to(dtype) if a.is_floating_point() else a for a in args)
    got = mm.loss_factors(fl, rates, active, cap, q, wsq, wnd, ecn, **kw)
    want = ref.loss_factors_reference(fl, rates, active, cap, q, wsq, wnd,
                                      ecn, **kw)
    err = float((got - want).abs().max())
    zero = (q == 0) & (wsq == 0) & (wnd == 0) & (ecn == 0)
    ones_ok = bool((got[zero] == 1.0).all())
    ok = err <= 1e-6 and ones_ok
    ms = cuda_ms(lambda: mm.loss_factors(fl, rates, active, cap, q, wsq,
                                         wnd, ecn, **kw), 20)
    plain_ms = cuda_ms(lambda: ref.loss_factors_reference(
        fl, rates, active, cap, q, wsq, wnd, ecn, **kw), 5)
    bound_ms, bound_by, bytes_ms = loss_bound(fl, cap, dtype)
    row = {"kernel": "loss_factors", "phase": name, "shape": list(fl.shape),
           "caps": cap.shape[-1], "dtype": str(dtype).split(".")[-1],
           "zero_rows": int(zero.sum()), "zero_rows_exactly_one": ones_ok,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes_bound_ms": bytes_ms, "phase_launches": launches, "ok": ok}
    log(f"[kernels] {json.dumps(row)}")
    if not ok:
        fail(f"loss_factors {name} {list(fl.shape)} {dtype}: err {err}, "
             f"all-zero rows exactly 1: {ones_ok}")
    return row


def random_fill_problem(rng, b, f, h, n_links, per_lane, device):
    """Random flows with ragged rows over ``n_links`` links: many rounds."""
    fl = rng.integers(0, n_links, (b, f, h)).astype(np.int32)
    lens = rng.integers(1, h + 1, (b, f))
    fl[np.arange(h)[None, None, :] >= lens[..., None]] = n_links
    cap = np.append(rng.uniform(1e9, 2.5e10, n_links), np.inf)
    if per_lane:
        cap = np.stack([cap] * b)
    active = (rng.random((b, f)) < 0.9).astype(np.float64)
    return (torch.tensor(fl, device=device), torch.tensor(cap, device=device),
            torch.tensor(active, device=device))


def run_kernels(rec, paths):
    from repro_torch.kernels import maxmin as mm
    from repro_torch.kernels import ref
    rows = []
    for key, val in rec.inputs.items():
        kernel, phase = key[0], key[1]
        for dtype in (torch.float32, torch.float64):
            launches = paths[phase]["launches"][kernel]
            if kernel == "maxmin_fill":
                fl, cap, active, kw = val
                row = check_fill(phase, fl, cap, active, kw, dtype, mm, ref,
                                 launches)
            else:
                row = check_loss(phase, val[:8], val[8], dtype, mm, ref,
                                 launches)
            row["path_dtype"] = str(dtype) == key[4]
            rows.append(row)
    # many-round problems: one lane over a 16k-host fabric's link count
    # (the cross-CTA variant) and 80 float64 segment-shaped lanes
    rng = np.random.default_rng(0)
    for shape, n_links, per_lane, kw in (
            ((1, 8192, 8), 50176, False, {}),
            ((80, 16, 64), 300, True, {"tol": 1e-12, "max_rounds": 64})):
        fl, cap, active = random_fill_problem(rng, *shape, n_links,
                                              per_lane, "cuda")
        for dtype in (torch.float32, torch.float64):
            rows.append(check_fill("random", fl, cap, active, kw, dtype,
                                   mm, ref))
    return rows


def decode_bound(q, k, kv_len):
    """The valid cache prefix's keys and values read once, q read and
    out, m, l written once; ~4 f32 operations per (key, q head, dim)."""
    b, h, d = q.shape
    n_keys = int(kv_len.clamp(0, k.shape[1]).sum())
    n_bytes = (n_keys * k.shape[2] * d * 2 * k.element_size()
               + 2 * q.numel() * q.element_size() + 2 * b * h * 4)
    return bound(n_bytes, 4 * n_keys * h * d, torch.float32), n_keys


def sdpa_ms(q, k, v, kv_len):
    """One PyTorch call computing the same attention, as a yardstick
    (the port never calls it); None where q and the cache differ in
    dtype, which it does not take."""
    if q.dtype != k.dtype:
        return None
    mask = (torch.arange(k.shape[1], device=q.device)[None, :]
            < kv_len[:, None])[:, None, None, :]
    qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    return cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), 200)


def check_decode(name, q, k, v, kv_len, fd, ref, launches=0, timed=True):
    """Kernel vs plain flash decode: out, m and l within the tolerance, a
    second call bit-identical, one device kernel a call (the library's
    count; the tracer's, where it gave a whole trace, must agree); then,
    when ``timed``, times."""
    tol = DECODE_TOL[q.dtype]

    def call():
        return fd.flash_decode(q, k, v, kv_len)
    got = call()
    again = call()
    same = all(torch.equal(g, a) for g, a in zip(got, again))
    want = ref.decode_reference(q, k, v, kv_len)
    errs = [float((g.float() - w.float()).abs().max())
            for g, w in zip(got, want)]
    within = all(torch.allclose(g.float(), w.float(), rtol=tol, atol=tol)
                 for g, w in zip(got, want))
    per_call = kernels_per_call(fd.kernels_launched, call, 10)
    dev_ms, traced, traces = device_time(call, 50) if timed \
        else (None, None, 0)
    ok = within and same and per_call == 1 and traced in (None, per_call)
    (bound_ms, bound_by, bytes_ms), n_keys = decode_bound(q, k, kv_len)
    row = {"kernel": "flash_decode", "phase": name,
           "variant": fd.variant(q, k),
           "shape": [*q.shape, k.shape[1], k.shape[2]],
           "q_dtype": str(q.dtype).split(".")[-1],
           "kv_dtype": str(k.dtype).split(".")[-1],
           "kv_len": kv_len.tolist(), "kv_keys": n_keys,
           "max_abs_err": errs[0], "m_max_abs_err": errs[1],
           "l_max_abs_err": errs[2], "tol": tol,
           "within_tol_of_plain": within, "repeat_identical": same,
           "kernels_per_call": per_call, "traced_kernels_per_call": traced,
           "traces": traces,
           "phase_launches": launches, "ok": ok}
    if timed:
        row.update({
            "ms": cuda_ms(call, 200), "device_ms": dev_ms,
            "bound_share": bound_ms / dev_ms if dev_ms else None,
            "plain_ms": cuda_ms(lambda: ref.decode_reference(q, k, v,
                                                             kv_len), 10),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes_bound_ms": bytes_ms,
            "library_ms": sdpa_ms(q, k, v, kv_len)})
    log(f"[kernels] {json.dumps(row)}")
    if not ok:
        fail(f"flash_decode {name} {row['shape']} {row['q_dtype']}/"
             f"{row['kv_dtype']}: out/m/l errors {errs}, tol {tol}, second "
             f"call identical {same}, device kernels a call {per_call} "
             f"(traced {traced})")
    return row


def decode_case_inputs(rng):
    """``(name, q, k, v, kv_len)`` on the card: tests/test_kernels.py's
    decode cases in float32 and bf16, then the edge cases in every dtype
    pair, then danube's full rolling buffer in bf16, drawn from
    ``rng``."""
    for name, cases, pairs in (
            ("decode_cases", DECODE_CASES, DECODE_PAIRS[:2]),
            ("decode_edges", DECODE_EDGE_CASES, DECODE_PAIRS),
            ("danube_rolling", DECODE_ROLLING, DECODE_PAIRS[1:2])):
        for b, s, h, kvh, d, kv_lens in cases:
            arrays = [rng.standard_normal(shape).astype(np.float32)
                      for shape in ((b, h, d), (b, s, kvh, d), (b, s, kvh, d))]
            kv_len = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
            for q_dt, kv_dt in pairs:
                q, k, v = (torch.tensor(a, device="cuda").to(dt) for a, dt in
                           zip(arrays, (q_dt, kv_dt, kv_dt)))
                yield name, q, k, v, kv_len


def run_decode_kernels(rec, paths):
    """Every captured flash-decode input of the serve paths, then
    tests/test_kernels.py's decode cases in float32 and bf16, the edge
    cases in every dtype pair and danube's full rolling buffer."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    rows = []
    for (phase, step, layer), (q, k, v, kv_len) in sorted(
            rec.inputs.items()):
        rows.append(check_decode(f"{phase} step {step} layer {layer}", q, k,
                                 v, kv_len, fd, ref,
                                 paths[phase]["launches"]["flash_decode"]))
    for name, q, k, v, kv_len in decode_case_inputs(
            np.random.default_rng(0)):
        rows.append(check_decode(name, q, k, v, kv_len, fd, ref))
    return rows


def attn_pairs(sq, skv, causal, window):
    """(query, key) pairs inside the mask: what the kernel must compute."""
    qpos = torch.arange(sq)
    hi = torch.clamp(qpos + 1, max=skv) if causal \
        else torch.full_like(qpos, skv)
    lo = torch.clamp(qpos - window + 1, min=0) if window \
        else torch.zeros_like(qpos)
    return int(torch.clamp(hi - lo, min=0).sum())


def attn_bound(q, k, causal, window):
    """q, k, v read once and out written once; 4 D operations per head and
    (query, key) pair inside the causal band or window (the two
    products), at the peak of the inputs' dtype (bf16 on the tensor
    cores)."""
    b, sq, h, d = q.shape
    n_bytes = 2 * q.numel() * q.element_size() \
        + 2 * k.numel() * k.element_size()
    ops = 4 * d * b * h * attn_pairs(sq, k.shape[1], causal, window)
    return bound(n_bytes, ops, q.dtype), ops


def sdpa_prefill_ms(q, k, v, causal, window, reps):
    """One PyTorch call computing the same attention, as a yardstick (the
    port never calls it): ``is_causal`` with GQA for a causal band, an
    explicit band mask (kv heads repeated) for a window."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if not window:
        return cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=causal,
                                    enable_gqa=True), reps)
    rep = q.shape[2] // k.shape[2]
    kt, vt = kt.repeat_interleave(rep, 1), vt.repeat_interleave(rep, 1)
    qpos = torch.arange(q.shape[1], device=q.device)[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = kpos > qpos - window
    if causal:
        mask &= kpos <= qpos
    return cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask), reps)


def oracle_errors(got, want, exact):
    """(kernel, plain) max abs distance from the float64 result."""
    return (float((got.double() - exact).abs().max()),
            float((want.double() - exact).abs().max()))


def beyond_rounding(got, want, exact):
    """(kernel, plain) max distance from the float64 result beyond the
    bf16 rounding of each output (2^-8 of its exact value)."""
    half_ulp = 2.0 ** -8 * exact.abs()
    return tuple(float(((x.double() - exact).abs() - half_ulp).max())
                 for x in (got, want))


def check_attention(name, q, k, v, causal, window, fa, ref, launches=0,
                    oracle=False):
    """Kernel vs plain flash attention; times.  With ``oracle`` (the
    captured full-width inputs) both are also measured against the plain
    version in float64, which decides a float32 row (ORACLE_FACTOR); a
    bf16 row is decided by the element-wise 2e-2 check, with each
    output's distance from float64 beyond its bf16 rounding recorded."""
    tol = ATTN_TOL[q.dtype]
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.mha_reference(q, k, v, causal=causal, window=window)
    err = float((got.float() - want.float()).abs().max())
    within = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    ok, errs, beyond = within, None, None
    if oracle:
        exact = ref.mha_reference(q.double(), k.double(), v.double(),
                                  causal=causal, window=window)
        errs = oracle_errors(got, want, exact)
        if q.dtype == torch.float32:
            ok = errs[0] <= ORACLE_FACTOR * errs[1] + tol
        else:
            beyond = beyond_rounding(got, want, exact)
        del exact
    del got, want
    big = q.numel() > 1 << 22
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                            window=window), 5 if big else 20)
    plain_ms = cuda_ms(lambda: ref.mha_reference(q, k, v, causal=causal,
                                                 window=window),
                       2 if big else 5)
    (bound_ms, bound_by, bytes_ms), ops = attn_bound(q, k, causal, window)
    lib = sdpa_prefill_ms(q, k, v, causal, window, 5 if big else 20)
    row = {"kernel": "flash_attention", "phase": name,
           "variant": fa.variant(q, k),
           "shape": [*q.shape, k.shape[1], k.shape[2]],
           "dtype": str(q.dtype).split(".")[-1], "causal": causal,
           "window": window, "flops": ops, "tflops": ops / ms / 1e9,
           "bound_share": bound_ms / ms, "max_abs_err": err, "tol": tol,
           "within_tol_of_plain": within, "f64_err_kernel_plain": errs,
           "f64_err_beyond_rounding": beyond,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bytes_bound_ms": bytes_ms,
           "library_ms": lib, "phase_launches": launches, "ok": ok}
    log(f"[kernels] {json.dumps(row)}")
    if not ok:
        fail(f"flash_attention {name} {row['shape']} {row['dtype']}: err "
             f"{err}, tol {tol}, float64 errors (kernel, plain) {errs}, "
             f"beyond bf16 rounding {beyond}")
    return row


def ssd_bound(x, B_, chunk, y_dtype):
    """x, dt, a, B_, C_ read once, y and the final state written once;
    per (row, chunk of L) C B^T over the causal half, L(L+1) N operations
    (shared by the heads), and per (row, head, chunk) its product with
    x, L(L+1) P, plus C S_prev and B^T x, 2 L N P each."""
    b, s, h, p = x.shape
    n = B_.shape[-1]
    es = torch.finfo(y_dtype).bits // 8
    n_bytes = (x.numel() * x.element_size() + 2 * B_.numel()
               * B_.element_size() + 2 * b * s * h * 4 + x.numel() * es
               + b * h * n * p * 4)
    ops = ssd_ops(b, s, h, p, n, chunk)
    return bound(n_bytes, ops, x.dtype), ops


def timed_once(fn):
    """``(fn(), its milliseconds by CUDA events)`` for one call: for the
    plain SSD recurrence, whose one call at full width takes seconds."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def check_ssd(name, args, chunk, y_dtype, ssd, ref, launches=0, plain=None,
              exact=None, timed=True):
    """Kernel vs plain SSD scan: y and the final state (and, given
    ``exact``, the float64 plain result, both against it), and device
    kernels a call by the library's count (the tracer's, where it gave a
    whole trace, must agree); then, when ``timed``, times.  ``plain`` is
    ``(plain result, plain ms)`` when the caller has them already (they
    do not depend on the chunk); returned with the row."""
    x = args[0]
    tol = SSD_TOL[x.dtype]

    def call():
        return ssd.ssd_scan(*args, chunk=chunk, y_dtype=y_dtype)
    y, state = call()
    if plain is None:
        plain = timed_once(lambda: ref.ssd_reference(*args))
    want, plain_ms = plain
    y_err = float((y.float() - want[0]).abs().max())
    s_err = float((state - want[1]).abs().max())
    within = torch.allclose(y.float(), want[0], rtol=tol, atol=tol) and \
        torch.allclose(state, want[1], rtol=SSD_STATE_TOL,
                       atol=SSD_STATE_TOL)
    ok, errs = within, None
    if exact is not None:
        errs = oracle_errors(y, want[0], exact[0]) \
            + oracle_errors(state, want[1], exact[1])
        ok = errs[0] <= ORACLE_FACTOR * errs[1] + tol and \
            errs[2] <= ORACLE_FACTOR * errs[3] + SSD_STATE_TOL
    del y, state
    reps = 5 if x.numel() > 1 << 22 else 20
    per_call = kernels_per_call(ssd.kernels_launched, call, 2)
    dev_ms, traced, traces = device_time(call, reps) if timed \
        else (None, None, 0)
    ok = ok and traced in (None, per_call)
    (bound_ms, bound_by, bytes_ms), ops = ssd_bound(x, args[3], chunk,
                                                    y_dtype)
    row = {"kernel": "ssd_scan", "phase": name, "variant": ssd.variant(x),
           "shape": list(x.shape),
           "state": args[3].shape[-1], "chunk": chunk,
           "dtype": str(x.dtype).split(".")[-1],
           "y_dtype": str(y_dtype).split(".")[-1], "flops": ops,
           "max_abs_err": y_err, "state_max_abs_err": s_err, "tol": tol,
           "within_tol_of_plain": within, "f64_err_kernel_plain": errs,
           "kernels_per_call": per_call, "traced_kernels_per_call": traced,
           "traces": traces,
           "plain_ms": plain_ms, "phase_launches": launches, "ok": ok}
    if timed:
        row.update({
            "ms": cuda_ms(call, reps), "device_ms": dev_ms,
            "bound_share": bound_ms / dev_ms if dev_ms else None,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes_bound_ms": bytes_ms, "library_ms": None})
    log(f"[kernels] {json.dumps(row)}")
    if not ok:
        fail(f"ssd_scan {name} {row['shape']} {row['dtype']} chunk {chunk}:"
             f" y err {y_err}, state err {s_err}, float64 errors (kernel y, "
             f"plain y, kernel state, plain state) {errs}, device kernels a "
             f"call {per_call} (traced {traced})")
    return row, plain


def ssd_case_inputs(rng, device="cuda"):
    """``(name, args, chunk, y dtype)``: tests/test_kernels.py's SSD cases
    in float32 and bf16, then the edge cases in every (x, y) dtype pair,
    drawn from ``rng``."""
    for name, cases, pairs in (
            ("ssd_cases", SSD_CASES, ((torch.float32, torch.float32),
                                      (torch.bfloat16, torch.bfloat16))),
            ("ssd_edges", SSD_EDGE_CASES, SSD_PAIRS)):
        for b, s, h, p, n, chunk in cases:
            x = rng.standard_normal((b, s, h, p)).astype(np.float32)
            dt = np.logaddexp(rng.standard_normal((b, s, h)), 0)
            a = -np.abs(rng.standard_normal((b, s, h))) * 0.1
            B_, C_ = (rng.standard_normal((b, s, n)) for _ in range(2))
            for dtype, y_dtype in pairs:
                args = (torch.tensor(x, device=device).to(dtype),
                        torch.tensor(dt, device=device, dtype=torch.float32),
                        torch.tensor(a, device=device, dtype=torch.float32),
                        torch.tensor(B_, device=device).to(dtype),
                        torch.tensor(C_, device=device).to(dtype))
                yield name, args, chunk, y_dtype


def run_prefill_kernels(rec, paths, device="cuda"):
    """Every captured prefill input in bf16 and float32 (SSD inputs at
    chunks 64, 128 and 256; float32 also against the float64 oracle),
    then tests/test_kernels.py's attention and SSD cases."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd
    rows = []
    for (phase, kernel, layer), (tensors, kw) in sorted(
            rec.inputs.items()):
        name = f"{phase} layer {layer}"
        launches = paths[phase]["launches"][kernel]
        for dtype in (torch.bfloat16, torch.float32):
            oracle = dtype == torch.float32
            if kernel == "flash_attention":
                q, k, v = (t.to(dtype) for t in tensors)
                rows.append(check_attention(name, q, k, v, kw["causal"],
                                            kw["window"], fa, ref, launches,
                                            oracle=True))
                continue
            x, dt, a, B_, C_ = tensors
            args = (x.to(dtype), dt, a, B_.to(dtype), C_.to(dtype))
            exact = ref.ssd_reference(*(t.double() for t in args)) \
                if oracle else None
            plain = None
            for chunk in SSD_CHUNKS:
                row, plain = check_ssd(name, args, chunk, kw["y_dtype"], ssd,
                                       ref, launches, plain, exact)
                row["path_chunk"] = chunk == kw["chunk"]
                rows.append(row)
            del plain, exact
        torch.cuda.empty_cache()
    rng = np.random.default_rng(0)
    for b, sq, skv, h, kvh, d, causal, window in ATTN_CASES + WGMMA_CASES:
        arrays = [rng.standard_normal(shape).astype(np.float32) for shape in
                  ((b, sq, h, d), (b, skv, kvh, d), (b, skv, kvh, d))]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.tensor(a, device=device).to(dtype)
                       for a in arrays)
            rows.append(check_attention("attn_cases", q, k, v, causal,
                                        window, fa, ref))
    for name, args, chunk, y_dtype in ssd_case_inputs(rng, device):
        rows.append(check_ssd(name, args, chunk, y_dtype, ssd, ref)[0])
    return rows


def grads_of(fn, ins, dout):
    """``(gradients of fn(*ins)[0] for dout, backward ms)``: the graph is
    built once, its backward timed over repeated calls (retain_graph)."""
    ins = [t.detach().clone().requires_grad_() for t in ins]
    out = fn(*ins)
    out = out[0] if isinstance(out, tuple) else out
    grads = torch.autograd.grad(out, ins, dout, retain_graph=True)
    big = out.numel() > 1 << 22

    def backward():
        return torch.autograd.grad(out, ins, dout, retain_graph=True)
    return grads, backward, big


def check_backward(name, kernel, ins, grad_names, fn, plain, dout, tol,
                   work, library=None):
    """The autograd Function's gradients (``fn``: forward through the
    wrapper, backward plain PyTorch) against torch.autograd of the plain
    version (``plain``), each within ``tol`` times its max abs; the
    Function's backward timed, and the plain version's, and ``library``'s
    where given.  ``work = (bytes, operations, dtype)`` of the backward."""
    got, backward, big = grads_of(fn, ins, dout)
    want, plain_backward, _ = grads_of(plain, ins, dout)
    errs = {g: float((a.float() - b.float()).abs().max())
            for g, a, b in zip(grad_names, got, want)}
    limits = {g: tol * float(b.float().abs().max())
              for g, b in zip(grad_names, want)}
    ok = all(errs[g] <= limits[g] for g in grad_names)
    del got, want
    ms = cuda_ms(backward, 3 if big else 10)
    plain_ms = timed_once(plain_backward)[1] if kernel == "ssd_scan" \
        else cuda_ms(plain_backward, 3 if big else 10)
    del backward, plain_backward
    bound_ms, bound_by, bytes_ms = bound(*work)
    row = {"kernel": f"{kernel}_backward", "phase": name,
           "shape": [list(t.shape) for t in ins],
           "dtype": str(ins[0].dtype).split(".")[-1], "flops": work[1],
           "tflops": work[1] / ms / 1e9, "bound_share": bound_ms / ms,
           "max_abs_err": max(errs.values()), "grad_max_abs_err": errs,
           "grad_limits": limits, "tol": f"{tol} x each gradient's max abs",
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bytes_bound_ms": bytes_ms,
           "library_ms": library() if library else None, "ok": ok}
    torch.cuda.empty_cache()
    log(f"[kernels] {json.dumps(row)}")
    if not ok:
        fail(f"{kernel} backward {name}: errors {errs}, limits {limits}")
    return row


def attention_backward_row(name, q, k, v, causal, window):
    """``ops.flash_attention``'s backward (``ref.mha_backward``) against
    autograd of ``ref.mha_reference`` at a captured layer, dO from a
    seed; SDPA's backward beside it."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=q.device).manual_seed(0)
    dout = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    b, sq, h, d = q.shape
    pairs = attn_pairs(sq, k.shape[1], causal, window)
    # q, k, v, out, dO read once, dq, dk, dv written once; the five
    # products (q Kᵀ again, dV, dP, dQ, dK) over the kept pairs
    work = (4 * q.numel() * q.element_size()
            + 4 * k.numel() * k.element_size(), 10 * d * b * h * pairs,
            q.dtype)

    def library():
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                      for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        if window:
            rep = h // k.shape[2]
            qpos = torch.arange(sq, device=q.device)[:, None]
            kpos = torch.arange(k.shape[1], device=q.device)[None, :]
            mask = (kpos > qpos - window) & (kpos <= qpos)
            out = sdpa(qt, kt.repeat_interleave(rep, 1),
                       vt.repeat_interleave(rep, 1), attn_mask=mask)
        else:
            out = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
        dt = dout.transpose(1, 2)
        return cuda_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dt, retain_graph=True), 3)

    return check_backward(
        name, "flash_attention", (q, k, v), ("dq", "dk", "dv"),
        lambda *t: ops.flash_attention(*t, causal=causal, window=window),
        lambda *t: ref.mha_reference(*t, causal=causal, window=window),
        dout, ATTN_TOL[q.dtype], work, library)


def ssd_backward_row(name, args, chunk, y_dtype):
    """``ops.ssd_scan``'s backward (``ref.ssd_backward``: the chunked
    plain scan recomputed and differentiated) against autograd of the
    exact recurrence ``ref.ssd_reference`` at a captured layer, dy from a
    seed."""
    from repro_torch.kernels import ops, ref
    x, B_ = args[0], args[3]
    gen = torch.Generator(device=x.device).manual_seed(0)
    dy = torch.randn(x.shape, generator=gen, device=x.device).to(y_dtype)
    b, s, h, p = x.shape
    n = B_.shape[-1]
    es = torch.finfo(y_dtype).bits // 8
    # inputs and dy read once, the five gradients written once; the
    # forward's products again and two more for each (3 x the forward)
    n_bytes = 2 * (x.numel() * x.element_size() + 2 * B_.numel()
                   * B_.element_size() + 2 * b * s * h * 4) \
        + x.numel() * es
    work = (n_bytes, 3 * ssd_ops(b, s, h, p, n, chunk), x.dtype)
    return check_backward(
        name, "ssd_scan", args, ("dx", "ddt", "da", "dB", "dC"),
        lambda *t: ops.ssd_scan(*t, chunk=chunk, y_dtype=y_dtype),
        lambda *t: ref.ssd_reference(*t), dy, SSD_TOL[x.dtype], work)


def run_train_kernels(prefill_rec, specs=TRAIN_BACKWARD):
    """The backward rows: each Function's backward at a train path's
    layer, from the prefill phases' captured layer inputs in bf16 (the
    dtype the train phases run), the batch cut to ``rows``."""
    rows = []
    for name, phase, layer, keep in specs:
        for (ph, kernel, lay), (tensors, kw) in prefill_rec.inputs.items():
            if (ph, lay) != (phase, layer):
                continue
            tensors = [t[:keep] for t in tensors]
            if kernel == "flash_attention":
                rows.append(attention_backward_row(
                    name, *tensors, kw["causal"], kw["window"]))
            else:
                rows.append(ssd_backward_row(name, tensors, kw["chunk"],
                                             kw["y_dtype"]))
    return rows


def kernels_line(rows, paths):
    """One entry per kernel: launches summed over the path phases, the
    worst error of any comparison, and the times of its largest
    main-path input in the dtype the path used."""
    out = []
    for name, (replaces, source) in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        launches = sum(p["launches"][name] for p in paths.values())
        if name == "flash_decode":
            rep = max([r for r in mine if r["phase"].startswith("serve ")]
                      or mine, key=lambda r: r["kv_keys"])
            dtype = f"{rep['q_dtype']}/{rep['kv_dtype']}"
        elif name in ("flash_attention", "ssd_scan"):
            rep = max([r for r in mine if r["phase"].startswith("prefill_")
                       and r["dtype"] == "bfloat16"
                       and r.get("path_chunk", True)] or mine,
                      key=lambda r: r["flops"])
            dtype = rep["dtype"] + (f" ({rep['variant']})"
                                    if "variant" in rep else "")
        else:
            rep = max([r for r in mine if r.get("path_dtype")] or mine,
                      key=lambda r: np.prod(r["shape"]) * r["caps"])
            dtype = rep["dtype"]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches,
                    "max_abs_err": max(r["max_abs_err"] for r in mine),
                    "ms": rep["ms"], "plain_ms": rep["plain_ms"],
                    "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
                    "library_ms": rep.get("library_ms"),
                    **{k: rep[k] for k in ("device_ms", "kernels_per_call")
                       if k in rep},
                    "phase": rep["phase"], "shape": rep["shape"],
                    "dtype": dtype})
    return {"kernels": out}


def gpu_name_power() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    return proc.stdout.strip().splitlines()[0] if proc.stdout.strip() \
        else "unknown"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import maxmin as mm
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    built = build.build()
    log(f"[build] {', '.join(p.name for p in built.values())} in "
        f"{time.perf_counter() - t0:.2f} s (one nvcc per source, in "
        f"parallel)")
    for name, lines in build.BUILD_LOG.items():
        for line in lines:
            if "registers" in line or "spill" in line \
                    or "entry function" in line:
                log(f"[build]   {name}: {line.strip()}")
    card = gpu_name_power()
    log(f"[build] card: {card}")

    rec = Recorder(mm)
    decode_rec = DecodeRecorder(ops)
    prefill_rec = PrefillRecorder(ops)
    paths = run_paths(rec)
    paths.update(run_serve(decode_rec))
    paths.update(run_prefill(prefill_rec))
    paths.update(run_train())
    paths.update(run_packet(rec))
    rows = run_kernels(rec, paths) + run_decode_kernels(decode_rec, paths) \
        + run_prefill_kernels(prefill_rec, paths) \
        + run_train_kernels(prefill_rec)
    line = kernels_line(rows, paths)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"),
              "w") as fh:
        json.dump({"card": card, "paths": paths, "kernel_rows": rows,
                   "kernels": line["kernels"], "failures": FAILURES,
                   "seconds": time.perf_counter() - t_start}, fh, indent=1)
    if FAILURES:
        for msg in FAILURES:
            print(f"chip_smoke: {msg}", file=sys.stderr)
        return 1
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
