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
   - mesh: ``launch/steps.make_serve_step`` on ``single_device_mesh``
     with the serve phases' weights (granite, and mixtral_8x7b and
     jamba_v0_1_52b at 8 layers) against ``decode_forward`` without a
     mesh, 16 steps: bit-identical logits and caches, ``flash_decode``
     once per attention layer and step; mixtral's layer 0 MoE run as 4
     ranks' expert blocks on the one card, their sum within the band of
     the whole layer (bf16 and float32); the split-KV merge emulated on
     the card (``mesh split`` rows);
   - prefill: ``launch/steps.make_prefill_step`` at full width on seed-0
     weights, bf16 compute, prompts from ``default_rng(0)``: granite_3_2b
     4 x 4096 (40 ``flash_attention`` launches, every one of them the
     wgmma variant), h2o_danube_3_4b 1 x 8192 (window 4096; 24),
     mamba2_370m 8 x 4096 (48 ``ssd_scan``, chunk 256, every one the
     chunk-parallel tensor-core variant); finite (B, 1, V)
     logits; one more granite prefill traced with ``torch.profiler``;
     then the smoke configs (granite, llama3.2, qwen1.5, danube and the
     other families) in float32 (TF32 off, so the SIMT attention
     variant) on card and CPU, last-position logits within 1e-3;
   - train: full width, seed-0 float32 parameters and moments drawn
     on the card, bf16 compute, no checkpoint, 3 steps, through
     ``runtime/train.Trainer`` on synthetic tokens: granite_3_2b 4 x
     4096 in 2 microbatches, mamba2_370m 8 x 4096, mixtral_8x7b (2 of 32
     layers: the router, the capacity drops, the aux loss) 2 x 4096 in
     2; through ``launch/steps.make_train_step`` on ``batch_structs``
     batches from a seeded generator: whisper_medium (24 + 24 layers) 4
     x 4096 tokens and 1024 frames in 2, internvl2_26b (4 of 48 layers)
     2 x (256 vision + 3840 text); every attention sublayer, cross-
     attention, encoder layer and Mamba-2 sublayer launches its kernel
     twice a microbatch, forward and remat recompute, every launch the
     tensor-core variant; finite losses, peak under 80 GB, ms a step,
     tokens/s, model FLOP utilisation and one more step traced with
     ``torch.profiler``; then the granite, mamba2, mixtral, qwen3_moe and
     jamba smoke configs in float32 (TF32 off) for 8 steps on card and
     CPU from one step-0 checkpoint (per-step losses within 1e-4), and a
     crash at step 6 resumed from the step-4 checkpoint by a fresh
     ``Trainer`` (final loss within rtol 1e-6 of the uninterrupted run),
     and the whisper and internvl2 smoke configs for 8 steps of
     ``make_train_step`` on card and CPU (losses within 1e-4);
   - mesh_prefill, mesh_train (granite_3_2b at 8 layers) and
     mesh_prefill_<family>,
     mesh_train_<family> (mamba2_370m whole, mixtral_8x7b at 2 layers,
     jamba_v0_1_52b cut to the attention, Mamba-2 and MoE sublayers of its
     pattern's positions 2 and 3, whisper_medium 24 + 24, internvl2_26b
     at 4 layers; ``MESH_STEPS``): the prefill and train steps on
     ``single_device_mesh`` (the mesh code with every collective on an
     axis of one rank: the MoE's dispatch, the Mamba-2 heads, the
     encoder and the vision prefix) against the steps without a mesh at
     full width: prefill 4 x 4096 (internvl2 2 x (256 + 3840), whisper's
     1024 frames), bit-identical logits; one train step at 2 x 4096 in 2
     microbatches from the same seed-0 state, bit-identical loss,
     ``grad_norm``, the gradient handed to AdamW and every updated
     parameter and moment (at whisper's 48 layers the float32
     ``grad_norm`` overflows, so the clip zeroes the update's gradient
     and the moments: the recorded gradient is what holds the backward);
     each mesh step's ``flash_attention`` and ``ssd_scan`` launches
     counted alone, every one the tensor-core variant;
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
   - dryrun: the dry run's predictions (``launch/steps.lower_cell`` on a
     (1, 1) mesh of fake tensors, traced on the host) for the steps of
     train_granite, prefill_granite, the granite serve step of ``mesh``
     and train_mixtral, held to the card: kernel calls a step equal to
     the phase's launches and to ``train_launches`` / ``path_launches``,
     argument bytes equal to the real tensors' sum (both exact), the
     predicted peak of live bytes within 10% of the step's measured
     peak; the counted FLOPs beside the model FLOPs and the measured
     step time, and ``roofline_fraction`` at that time, printed;
3. **kernels** every kernel input the paths produced: the max-min
   kernels in float32 and float64, plus random many-round problems and
   the +inf-bottleneck lane (the kernel against its plain version:
   freeze set, rates and remaining capacity per round for the first 256
   rounds, then the whole filling, rtol 1e-6 in float32 and 1e-12 in
   float64, a NaN on one side only an error; loss factors within 1e-6
   and exactly 1 on all-zero rows; one kernel a call and nothing else);
   ``flash_decode`` at layers 0 and 39 of the serve
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
   variant, useful TFLOP/s and share of the bound), and with
   ``q_offset`` (``Q_OFFSET_ATTN``: llama3.2's and danube's layers at
   8192 positions and granite's heads at 6000, each cut into 4 blocks of
   query rows at their offsets against the whole K/V, every block held
   to the plain version, the blocks together to one whole call);
   ``ssd_scan`` at
   the first and last layer of the mamba prefill at chunks 64, 128 and
   256, SSD_CASES in float32 and bf16 and the chunk-parallel variant's
   edge cases in f32, bf16 and bf16 x with f32 y (y 1e-4 / 3e-2, state
   1e-3); the two autograd Functions' backwards (plain PyTorch) against
   torch.autograd of the plain versions at captured bf16 layer inputs:
   granite's layer at 1 x 4096, danube's windowed layer at 1 x 8192,
   mamba's at 2 x 4096, whisper's encoder layer (2 x 1024,
   bidirectional) and its first cross-attention (1 x 4096 over 1024),
   mixtral's windowed D 128 layer at 1 x 8192, jamba's first Mamba-2
   layer (N 16) at 1 x 4096 (each gradient within the forward's
   tolerance times its max abs; SDPA's backward timed beside the
   attention's).
   Times through the wrapper from CUDA events; for the max-min
   kernels, ``flash_decode`` and ``ssd_scan`` also the device time a
   call and the device kernels a call, from torch.profiler, with the
   share of the bound taken on the device time.  The plain versions
   take the query axis in blocks (``ref.mha_reference``), so no
   full-width input is split.

It prints one ``{"kernels": [...]}`` line, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``; any failed phase exits
non-zero without that line.  Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import functools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

# the card's yardsticks, defined once in the package: H100 SXM datasheet
# peaks (HBM bytes/s; FLOP/s by the dtype of the inputs), each kernel's
# operations and bytes, the model FLOPs of a train step, and the kernel
# calls a path makes
from repro_torch.kernels import flash_attention as fa_cost  # noqa: E402
from repro_torch.kernels import flash_decode as fd_cost  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_cost  # noqa: E402
from repro_torch.kernels.flash_attention import attn_pairs  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_ops  # noqa: E402
from repro_torch.launch.roofline import (  # noqa: E402
    HBM_BW as PEAK_BYTES, PEAK_FLOPS, path_launches, train_launches,
    train_step_flops as model_flops)

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
#: where the card side of the packet-vs-flow gates, the train phases and
#: train_cross runs; a CPU rehearsal sets it to "cpu"
CARD = "cuda"
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
#: the +inf-bottleneck lane: flow rows (the last link id is the +inf
#: sentinel) and capacities; its second round's b is +inf
B_INF = ([[2, 2], [0, 2]], [0.0, 20.0, math.inf])
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
#: the mesh phase: ``make_serve_step`` on ``single_device_mesh`` with the
#: serve phase's granite weights, 4 rows, a 32,768-slot bf16 cache filled
#: from the seed below ``start``, 16 steps from it
MESH = dict(batch=4, seq=32768, start=8184, steps=16)
#: the serve phases whose 8-layer weights the mesh phase also runs
#: (mixtral's 4,096-slot rolling buffer past its window, jamba's Mamba-2
#: conv windows and states beside its one attention layer), and the
#: emulated expert-parallel check: mixtral's layer 0 MoE sublayer at
#: decode_32k's batch, each of 4 ranks' 2 experts run on the one card
MESH_FAMILIES = ("serve_mixtral", "serve_jamba")
EXPERT_PARALLEL = dict(batch=128, ranks=4)
#: the split-KV check: (name, B, S, H, KVH, D) of granite's and qwen1.5's
#: decode layers, each row's valid prefix (inside block 0, on a block
#: boundary, at the last slot, inside a middle block), block counts
SPLIT_KV = (("granite", 4, 32768, 32, 8, 64), ("qwen1_5", 4, 32768, 64, 8,
                                               128))
SPLIT_KV_LENS = (100, 8192, 32768, 12000)
SPLIT_KV_BLOCKS = (4, 8)
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
PREFILL_CROSS = (("granite_3_2b", 2, 64), ("llama3_2_3b", 2, 64),
                 ("qwen1_5_110b", 2, 64), ("h2o_danube_3_4b", 2, 64),
                 ("h2o_danube_3_4b", 2, 96), ("mamba2_370m", 2, 64),
                 ("mixtral_8x7b", 2, 64), ("qwen3_moe_235b_a22b", 2, 64),
                 ("jamba_v0_1_52b", 2, 64), ("whisper_medium", 2, 64),
                 ("internvl2_26b", 2, 64))
#: the train and prefill steps on ``single_device_mesh`` against the steps
#: without a mesh, at full width: (label suffix, arch, layers (0: the
#: config's), the prefill's (batch, prompt tokens), the train step's
#: (batch, positions, microbatches)).  granite is cut to 8 of its 40
#: layers (whole, its two rows took 51 s of the run) to make room for the
#: other families in the script's time.  jamba is cut to the two sublayers
#: of its pattern that hold an attention, a Mamba-2 and a MoE sublayer
#: (positions 2 and 3; any whole period of 8 holds four MoE sublayers of
#: 16 experts, whose float32 train state does not fit 80 GB);
#: internvl2's prompt is 256 vision positions and 3840 tokens
MESH_STEPS = (("", "granite_3_2b", 8, (4, 4096), (2, 4096, 2)),
              ("_mamba", "mamba2_370m", 0, (4, 4096), (2, 4096, 2)),
              ("_mixtral", "mixtral_8x7b", 2, (4, 4096), (2, 4096, 2)),
              ("_jamba", "jamba_v0_1_52b", 2, (4, 4096), (2, 4096, 2)),
              ("_whisper", "whisper_medium", 0, (4, 4096), (2, 4096, 2)),
              ("_internvl2", "internvl2_26b", 4, (2, 3840), (2, 4096, 2)))
#: jamba's cut of its pattern in ``MESH_STEPS``
JAMBA_CUT = slice(2, 4)
#: ``flash_attention`` with ``q_offset``, the sequence-parallel attention
#: of a mesh's ``model`` ranks: (name, seq, H, KVH, D, window, blocks):
#: each block's rows at offset i seq / blocks against the whole K/V,
#: causal, batch 1 (llama3_2_3b's layer at 8192 split 4 ways, danube's
#: with its window, and granite's heads at 6000 positions in 4 blocks
#: whose offsets 1500, 3000 and 4500 are not multiples of 128)
Q_OFFSET_ATTN = (("llama3_2_3b", 8192, 24, 8, 128, 0, 4),
                 ("h2o_danube_3_4b", 8192, 32, 8, 120, 4096, 4),
                 ("granite_3_2b", 6000, 32, 8, 64, 0, 4))
#: the train paths at full width: (phase, arch, layers (0: the config's;
#: cut where the float32 train state, 16 bytes a parameter: parameters,
#: gradients and two moments, would not fit 80 GB), batch, decoder
#: positions (the vision prefix's included), microbatches, route):
#: "trainer" runs ``runtime/train.Trainer`` on its synthetic token
#: pipeline; "step" runs ``launch/steps.make_train_step`` on
#: ``batch_structs`` batches from a seeded ``torch.Generator`` (the
#: Trainer's pipeline carries no ``frames`` or ``vision_embed``, nor does
#: the reference's).  Every attention and Mamba-2 layer launches its
#: kernel twice a microbatch: forward and remat recompute.
TRAIN = (("train_granite", "granite_3_2b", 0, 4, 4096, 2, "trainer"),
         ("train_mamba", "mamba2_370m", 0, 8, 4096, 1, "trainer"),
         ("train_mixtral", "mixtral_8x7b", 2, 2, 4096, 2, "trainer"),
         ("train_whisper", "whisper_medium", 0, 4, 4096, 2, "step"),
         ("train_internvl2", "internvl2_26b", 4, 2, 4096, 1, "step"))
#: steps of each train phase; one more is traced with torch.profiler
TRAIN_STEPS = 3
#: the dry run's predictions held to the card: (phase whose step is
#: traced, its kind); each phase's config, batch, sequence and
#: microbatches are its own entry's (``TRAIN``, ``PREFILL``; the granite
#: serve step of ``mesh``: ``MESH``, float32 weights as the serve phase
#: draws them)
DRYRUN = (("train_granite", "train"), ("prefill_granite", "prefill"),
          ("mesh", "decode"), ("train_mixtral", "train"))
#: the predicted peak of live bytes against the step's measured peak
DRYRUN_PEAK_TOL = 0.10
#: the card-vs-CPU check of training: smoke configs in float32 (TF32
#: off), steps, batch, sequence; through the ``Trainer`` (with the
#: checkpoint period and the injected crash of the restart check) and
#: through ``make_train_step`` (the encoder-decoder and the VLM)
TRAIN_CROSS = dict(trainer=("granite_3_2b", "mamba2_370m", "mixtral_8x7b",
                            "qwen3_moe_235b_a22b", "jamba_v0_1_52b"),
                   step=("whisper_medium", "internvl2_26b"), steps=8,
                   ckpt_every=4, fail_at=6, batch=4, seq=64)
#: per-step losses, card against CPU; final loss after a restart against
#: the uninterrupted run (tests/test_runtime.py's rtol)
TRAIN_CROSS_TOL = 1e-4
RESTART_RTOL = 1e-6
#: the backward rows: the autograd Functions' backwards against autograd
#: of the plain versions at the train paths' layers, from captured
#: prefill inputs: (name, captured phase, kernel, call, rows kept).
#: Whisper's calls: its 24 encoder layers first, then each decoder
#: layer's self- and cross-attention, so call 25 is the cross-attention
#: of decoder layer 0.
TRAIN_BACKWARD = (
    ("granite layer 0", "prefill_granite", "flash_attention", 0, 1),
    ("danube layer 0", "prefill_danube", "flash_attention", 0, 1),
    ("mamba layer 0", "prefill_mamba", "ssd_scan", 0, 2),
    ("whisper encoder layer 0", "prefill_whisper", "flash_attention", 0, 2),
    ("whisper cross layer 0", "prefill_whisper", "flash_attention", 25, 1),
    ("mixtral layer 0", "prefill_mixtral", "flash_attention", 0, 1),
    ("jamba ssd layer 0", "prefill_jamba", "ssd_scan", 0, 1))
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
            if not self.phase:
                return self._fill(fl, cap, active, **kw)
            key = ("maxmin_fill", self.phase, tuple(fl.shape),
                   tuple(cap.shape), str(cap.dtype), kw.get("tol", 1e-6),
                   kw.get("max_rounds"))
            if key not in self.inputs:
                self.inputs[key] = (fl.clone(), cap.clone(),
                                    active.clone(), dict(kw))
            return self._fill(fl, cap, active, **kw)

        def loss(fl, rates_, active, cap, q, wsq, wnd, ecn, **kw):
            if not self.phase:
                return self._loss(fl, rates_, active, cap, q, wsq, wnd, ecn,
                                  **kw)
            key = ("loss_factors", self.phase, tuple(fl.shape),
                   tuple(cap.shape), str(cap.dtype), bool((q != 0).any()))
            if key not in self.inputs:
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


def tree_bytes(*trees, card_only=False) -> int:
    """``numel x element_size`` summed over the tensors (and the host
    arrays, unless ``card_only``) of nested dicts, lists and tuples."""
    n = 0
    for t in trees:
        if isinstance(t, torch.Tensor):
            n += t.numel() * t.element_size() \
                if t.is_cuda or not card_only else 0
        elif isinstance(t, np.ndarray):
            n += 0 if card_only else t.nbytes
        elif isinstance(t, dict):
            n += tree_bytes(*t.values(), card_only=card_only)
        elif isinstance(t, (list, tuple)):
            n += tree_bytes(*t, card_only=card_only)
    return n


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
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model
    out = {}
    model = Model(get_config(serve["arch"], smoke=serve["smoke"]), seed=0,
                  device=device)
    row, _ = serve_phase("serve", serve, rec, device, model=model)
    out["serve"] = {k: v for k, v in row.items() if k != "tokens"}
    out["mesh"] = mesh_phase(model, device)
    del model
    for label, arch, layers, requests, pool, max_new, max_seq in families:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = None
        if label in MESH_FAMILIES:
            model = Model(get_config(arch).replace(n_layers=layers), seed=0,
                          device=device)
        row, _ = serve_phase(label, dict(
            arch=arch, smoke=False, layers=layers, requests=requests,
            pool=pool, max_new=max_new, max_seq=max_seq,
            profile=SERVE_FAMILY_PROFILE), rec, device, model=model)
        out[label] = {k: v for k, v in row.items() if k != "tokens"}
        if model is not None:
            mesh = mesh_phase(model, device, label=f"mesh_{arch}")
            if model.cfg.pattern[0][1] == "moe":
                mesh["expert_parallel"] = expert_parallel(model, device)
            out[f"mesh_{arch}"] = mesh
            del model
    torch.cuda.empty_cache()

    prev_tf32 = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


def mesh_phase(model, device="cuda", spec=MESH, label="mesh"):
    """``launch/steps.make_serve_step`` on ``single_device_mesh`` with a
    serve phase's weights against ``decode_forward`` without a mesh, the
    same caches (every k and v filled from the seed below ``start``, or
    all of a rolling buffer, every Mamba-2 conv window and state) and
    tokens: bit-identical logits and caches; the step's launches counted
    alone.  The mesh step runs the mesh code of every sublayer (the
    plan's specs, the FSDP gathers, the heads' gather, the embedding's
    and the projections' branches, the MoE's and the Mamba-2 step's),
    each collective on an axis of one rank."""
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import model as mdl
    from repro_torch.models.blocks import tree_leaves
    cfg, b = model.cfg, spec["batch"]
    step = make_serve_step(cfg, single_device_mesh(device), False)
    caches = [mdl.init_caches(cfg, b, spec["seq"], device=device)
              for _ in range(2)]
    gen = torch.Generator(device=device).manual_seed(0)
    for name, c in tree_leaves(caches[0]):
        if name.endswith((".k", ".v")):
            n = min(spec["start"], c.shape[2])
            c[:, :, :n] = torch.randn(c[:, :, :n].shape, generator=gen,
                                      device=device)
        else:
            c.copy_(torch.randn(c.shape, generator=gen, device=device))
    for (_, a), (_, c) in zip(tree_leaves(caches[0]),
                              tree_leaves(caches[1])):
        c.copy_(a)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (spec["steps"], b, 1))).to(device, torch.int32)
    got, want = [], []
    # the step's arguments (the position an int32, as the reference takes
    # it), and the first step's peak above what else the card holds
    args = (model.params, caches[0], toks[0])
    arg_bytes = tree_bytes(*args) + 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    for i in range(spec["steps"]):
        got.append(step(model.params, caches[0], toks[i],
                        spec["start"] + i)[0])
        if i == 0:
            step_peak = torch.cuda.max_memory_allocated() - base \
                + tree_bytes(*args, card_only=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    for i in range(spec["steps"]):
        want.append(mdl.decode_forward(model.params, caches[1], toks[i],
                                       spec["start"] + i, cfg,
                                       device=device)[0])
    same = all(torch.equal(a, w) for a, w in zip(got, want)) and all(
        torch.equal(a, c) for (_, a), (_, c) in zip(
            tree_leaves(caches[0]), tree_leaves(caches[1])))
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    per_step = path_launches(cfg, decode=True)["flash_decode"]
    row = {"arch": cfg.name, "n_layers": cfg.n_layers, "batch": b,
           "seq": spec["seq"], "start": spec["start"],
           "steps": spec["steps"],
           "plan": "inference" if not step.cfg.fsdp_weights else "default",
           "ms_per_step": wall / spec["steps"] * 1e3,
           "identical_to_decode_forward": same, "logits_finite": finite,
           "launches": launches, "argument_bytes": arg_bytes,
           "step_peak_bytes": step_peak}
    log(f"[paths] {label}: make_serve_step on single_device_mesh, "
        f"{cfg.name} ({cfg.n_layers} layers) {b} x {spec['seq']} slots, "
        f"{spec['steps']} steps from {spec['start']}: "
        f"{row['ms_per_step']:.3f} ms/step, identical to decode_forward "
        f"{same}, finite {finite}, launches {launches}")
    want_launches = spec["steps"] * per_step
    if not same or not finite:
        fail(f"{label}: identical {same}, finite {finite}")
    if launches["flash_decode_mma"] != want_launches \
            or launches["flash_decode"] != want_launches:
        fail(f"{label}: flash_decode launched {launches['flash_decode']} "
             f"times ({launches['flash_decode_mma']} mma), not "
             f"{want_launches}")
    del caches
    torch.cuda.empty_cache()
    return row


def expert_parallel(model, device="cuda", spec=EXPERT_PARALLEL):
    """The mesh path's expert-parallel MoE decode emulated on one card:
    layer 0's MoE sublayer of ``model`` (mixtral at full width) on
    ``batch`` rows, each of ``ranks`` ranks' experts run through
    ``models/moe.expert_block`` (the ``"ep"`` body with the rank's index:
    ids shifted to its experts, foreign ones to the sentinel, its own
    capacity) and the ranks' outputs added in float32 and rounded once,
    as the mesh path's combine adds them; held to ``moe_decode`` on the
    whole layer, bf16 within the 2e-2 band and float32 within its
    tolerance (``DECODE_TOL``)."""
    from repro_torch.models import moe
    base, n = model.cfg, spec["ranks"]
    p = {k: v[0] for k, v in model.params["blocks"]["sub0"]["ffn"].items()
         if k != "norm"}
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(spec["batch"], 1, base.d_model, generator=gen,
                    device=device)
    e_local = base.n_experts // n
    rows = []
    for dt in ("bfloat16", "float32"):
        cfg = base.replace(compute_dtype=dt)
        xd = x.to(getattr(torch, dt))
        want, _ = moe.moe_decode(p, xd, cfg)
        x2 = xd.reshape(-1, cfg.d_model)
        gates, ids, _ = moe._router(x2, p["router"], cfg.top_k)
        parts = [moe.expert_block(
            {k: p[k][r * e_local:(r + 1) * e_local]
             for k in ("we_i", "we_g", "we_o")}, x2, gates, ids, cfg,
            rank=r, n_ranks=n) for r in range(n)]
        got = sum(t.float() for t in parts).to(xd.dtype).reshape(want.shape)
        tol = DECODE_TOL[xd.dtype]
        err = float((got.float() - want.float()).abs().max())
        ok = bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                 atol=tol) and torch.isfinite(got).all())
        rows.append({"dtype": dt, "batch": spec["batch"], "ranks": n,
                     "experts_per_rank": e_local, "max_abs_diff": err,
                     "max_abs": float(want.float().abs().max()), "tol": tol,
                     "ok": ok})
        log(f"[paths] expert_parallel: {base.name} layer 0 MoE, "
            f"{spec['batch']} rows, {n} ranks x {e_local} experts emulated "
            f"on one card, {dt}: max |sum of ranks - whole| {err!r} "
            f"(tol {tol}), ok {ok}")
        if not ok:
            fail(f"expert_parallel {dt}: {err} (tol {tol})")
    return rows


def butterfly_merge(parts, merge):
    """The partials of ``len(parts)`` ranks merged in
    ``butterfly_allreduce``'s pairing: round j, rank i combines its own
    with rank i ^ 2^j's.  Every rank's result, rank order."""
    n = len(parts)
    j = 1
    while j < n:
        parts = [merge(parts[i], parts[i ^ j]) for i in range(n)]
        j *= 2
    return parts


def psum_merge(parts):
    """The ``xla`` schedule's order: the max of m over the ranks, then
    the rescaled l and acc summed in rank order."""
    m = torch.stack([p[0] for p in parts]).amax(0)
    l = sum(p[1] * torch.exp(p[0] - m) for p in parts)
    acc = sum(p[2] * torch.exp(p[0] - m)[..., None] for p in parts)
    return m, l, acc


def run_split_kv(specs=SPLIT_KV, lens=SPLIT_KV_LENS, blocks=SPLIT_KV_BLOCKS,
                 device="cuda"):
    """The mesh path's split-KV attention at granite's and qwen1.5's decode
    layer shapes, emulated on one card: ``flash_decode`` on each of 4 and
    of 8 sequence blocks of the cache (each call held to the plain version,
    the ``kv_len = 0`` blocks to out 0, m -1e30, l 0 without a NaN), the
    partials merged by ``core/collectives._softmax_merge`` in the
    butterfly's pairing and in the pmax / psum order, each merge held to
    the plain version over the whole cache.  bf16 q on the bf16 cache
    with a float32 out (the mesh path's: the tensor-core variant leaves
    the last rounding to the merge) and with a bf16 out (the one-device
    path's), and float32 q on it (the FMA variant); one block of each
    timed.  A float32 out, per block and merged, is held to the float32
    tolerance against the plain version's float32 out: the bf16 band is
    as wide as a long row's values."""
    from repro_torch.core.collectives import _softmax_merge
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    rows, rng = [], np.random.default_rng(3)
    for name, b, s, h, kvh, d in specs:
        kv_len = torch.tensor(lens, dtype=torch.int32, device=device)
        q0, k, v = (torch.tensor(rng.standard_normal(shape).astype(
            np.float32), device=device) for shape in
            ((b, h, d), (b, s, kvh, d), (b, s, kvh, d)))
        k, v = k.bfloat16(), v.bfloat16()
        for q, out_dtype in ((q0.bfloat16(), torch.float32),
                             (q0.bfloat16(), None),
                             (q0.bfloat16().float(), None)):
            tol = DECODE_TOL[out_dtype or q.dtype]
            whole = ref.decode_reference(q, k, v, kv_len, out_dtype)
            for n in blocks:
                sl = s // n
                parts, empty_ok = [], True
                for i in range(n):
                    kb = k[:, i * sl:(i + 1) * sl].contiguous()
                    vb = v[:, i * sl:(i + 1) * sl].contiguous()
                    lb = torch.clamp(kv_len - i * sl, 0, sl).to(torch.int32)
                    row = check_decode(
                        f"mesh split {name} {n} x {sl} block {i}", q, kb,
                        vb, lb, fd, ref, timed=i == 0, out_dtype=out_dtype)
                    rows.append(row)
                    out, m, l = fd.flash_decode(q, kb, vb, lb, out_dtype)
                    empty = lb == 0
                    empty_ok &= bool(torch.isfinite(out).all()
                                     and torch.isfinite(m).all()
                                     and torch.isfinite(l).all()
                                     and (out[empty] == 0).all()
                                     and (m[empty] == -1e30).all()
                                     and (l[empty] == 0).all())
                    parts.append((m, l, out.float() * l[..., None]))
                merged = {"butterfly": butterfly_merge(parts,
                                                       _softmax_merge)[0],
                          "psum": psum_merge(parts)}
                for order, (m, l, acc) in merged.items():
                    out = acc / torch.clamp(l, min=1e-30)[..., None]
                    err = float((out - whole[0].float()).abs().max())
                    ok = bool(torch.allclose(out, whole[0].float(),
                                             rtol=tol, atol=tol)
                              and torch.allclose(m, whole[1], rtol=tol,
                                                 atol=tol)
                              and torch.allclose(l, whole[2], rtol=tol,
                                                 atol=tol)) and empty_ok
                    log(f"[kernels] mesh split {name} {str(q.dtype)[6:]} q, "
                        f"{str(out_dtype or q.dtype)[6:]} out, "
                        f"{n} blocks of {sl}, {order} merge: out max |diff| "
                        f"from the whole cache's plain version {err!r} "
                        f"(tol {tol}), empty blocks clean {empty_ok}")
                    if not ok:
                        fail(f"mesh split {name} {q.dtype} {n} blocks "
                             f"{order}: {err} (tol {tol}), empty blocks "
                             f"clean {empty_ok}")
    return rows


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
    first and the last call of each kernel in an armed prefill, and of the
    calls the ``backward`` rows name (``run_train_kernels`` runs the same
    rows), keyed by (phase, kernel, call index): ``calls`` says how many
    times the prefill calls each (``path_launches``)."""

    def __init__(self, ops, backward=TRAIN_BACKWARD):
        self.ops, self.inputs, self.phase = ops, {}, None
        self.backward = backward
        self._attn, self._ssd = ops.flash_attention, ops.ssd_scan
        ops.flash_attention = self.attention
        ops.ssd_scan = self.scan

    def arm(self, phase, calls):
        self.phase, self.n_calls = phase, calls
        self.calls = dict.fromkeys(calls, 0)
        self.keep = {k: {0, n - 1} | {call for _, ph, kernel, call, _
                                      in self.backward
                                      if (ph, kernel) == (phase, k)}
                     for k, n in calls.items()}

    def _keep(self, kernel, tensors, kw):
        if self.phase:
            i = self.calls[kernel]
            if i in self.keep[kernel]:
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
                                               (batch, seq)),
                                  dtype=torch.int32, device=device)}
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
    arg_bytes = tree_bytes(model.params, inputs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    logits = step(model.params, inputs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    # the step's peak above what else the card holds (the recorder's
    # captured kernel inputs count in it)
    step_peak = torch.cuda.max_memory_allocated() - base + arg_bytes
    rec.phase = None
    finite = bool(torch.isfinite(logits).all())
    row = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "enc_layers": cfg.enc_layers, "d_model": cfg.d_model,
           "compute_dtype": cfg.compute_dtype, "batch": batch,
           "prompt_len": seq, "vision_prefix": cfg.vision_prefix,
           "wall_s": wall, "prompt_tokens_per_s": batch * seq / wall,
           "logits_shape": list(logits.shape), "logits_finite": finite,
           "launches": launches,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "argument_bytes": arg_bytes, "step_peak_bytes": step_peak}
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

def train_batches(cfg, batch, seq, steps, device):
    """``steps`` train batches shaped by ``launch/steps.batch_structs``,
    drawn from ``torch.Generator(device).manual_seed(0)``: tokens and
    targets (the tokens shifted by one), a loss mask of ones, and unit
    normal ``vision_embed`` / ``frames`` in bf16."""
    from repro_torch.launch.steps import batch_structs
    gen = torch.Generator(device=device).manual_seed(0)
    out = []
    for _ in range(steps):
        b = {}
        for name, spec in batch_structs(cfg, seq, batch, train=True).items():
            if name == "tokens":
                rows = torch.randint(0, cfg.vocab_size, (batch,
                                                          spec.shape[1] + 1),
                                     generator=gen, device=device)
                b["tokens"] = rows[:, :-1].to(spec.dtype)
                b["targets"] = rows[:, 1:].to(spec.dtype)
            elif name == "loss_mask":
                b[name] = torch.ones(spec.shape, dtype=spec.dtype,
                                     device=device)
            elif name != "targets":
                b[name] = torch.randn(spec.shape, generator=gen,
                                      device=device).to(spec.dtype)
        out.append(b)
    return out


class StepRunner:
    """``make_train_step`` over a list of batches, the ``Trainer``'s loop
    without its data pipeline: seed-0 parameters (``Model``, as the
    ``Trainer`` draws them) or ``params``, fresh moments, each step timed
    to the float of its loss."""

    def __init__(self, cfg, accum, device, params=None):
        from repro_torch.launch.steps import make_train_step
        from repro_torch.models.model import Model
        from repro_torch.optim import adamw
        self.params = Model(cfg, seed=0, device=device).params \
            if params is None else params
        self.opt_state = adamw.init(self.params)
        self.step = make_train_step(cfg, accum_steps=accum, device=device)

    def run(self, batches):
        history = []
        for i, batch in enumerate(batches):
            t0 = time.perf_counter()
            self.params, self.opt_state, m = self.step(
                self.params, self.opt_state, batch)
            loss = float(m["loss"])
            history.append({"step": i, "loss": loss,
                            "dt": time.perf_counter() - t0})
        return {"history": history, "final_loss": history[-1]["loss"]}


def train_phase(label, cfg, batch, seq, accum, route):
    """``TRAIN_STEPS`` steps on ``cfg`` at full width (seed-0 parameters
    drawn on the card, no checkpoint) through the ``Trainer`` (``route``
    "trainer", synthetic tokens) or ``make_train_step`` ("step",
    ``train_batches``), the launch counts zeroed just before and read
    just after; then one more step under torch.profiler.  Returns the
    phase record."""
    import tempfile
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.blocks import tree_leaves
    from repro_torch.runtime.train import Trainer, TrainerConfig
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        if route == "trainer":
            runner = Trainer(cfg, DataConfig(vocab_size=cfg.vocab_size,
                                             seq_len=seq, global_batch=batch),
                             TrainerConfig(total_steps=TRAIN_STEPS,
                                           ckpt_every=0, accum_steps=accum,
                                           log_every=1, ckpt_dir=tmp),
                             log=lines.append, device=CARD)
            runner.init_state()

            def run():
                return runner.run(resume=False)

            def one_more():
                runner.step_fn(runner.params, runner.opt_state, runner.err,
                               runner.pipeline.batch_at(TRAIN_STEPS))
        else:
            batches = train_batches(cfg, batch, seq, TRAIN_STEPS + 1, CARD)
            runner = StepRunner(cfg, accum, CARD)

            def run():
                return runner.run(batches[:TRAIN_STEPS])

            def one_more():
                runner.step(runner.params, runner.opt_state,
                            batches[TRAIN_STEPS])
        # the step's arguments (a Trainer's batch is a host array, copied
        # to the card inside the step), and the steps' peak above what
        # else the card holds
        args = (runner.params, runner.opt_state,
                runner.pipeline.batch_at(0) if route == "trainer"
                else batches[0])
        arg_bytes = tree_bytes(*args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts()
        step_peak = torch.cuda.max_memory_allocated() - base \
            + tree_bytes(*args, card_only=True)
        del args
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        with prof:
            t0 = time.perf_counter()
            one_more()
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
        n_params = sum(t.numel() for _, t in tree_leaves(runner.params))
        del runner, run, one_more
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    losses = [h["loss"] for h in out["history"]]
    dts = [h["dt"] for h in out["history"]]
    step_s = sum(dts[1:]) / len(dts[1:])
    flops = model_flops(cfg, batch, seq)
    row = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "enc_layers": cfg.enc_layers, "d_model": cfg.d_model,
           "compute_dtype": cfg.compute_dtype, "remat": cfg.remat,
           "route": route, "batch": batch, "seq": seq,
           "vision_prefix": cfg.vision_prefix, "accum_steps": accum,
           "steps": TRAIN_STEPS, "n_params": n_params,
           "state_gb": 16 * n_params / 1e9,
           "losses": losses, "step_s": dts, "wall_s": wall,
           "ms_per_step": step_s * 1e3,
           "tokens_per_s": batch * seq / step_s,
           "model_flops_per_step": flops,
           "mfu": flops / step_s / PEAK_FLOPS[torch.bfloat16],
           "peak_gb": peak, "launches": launches,
           "argument_bytes": arg_bytes, "step_peak_bytes": step_peak,
           "profile": profile_summary(prof, prof_ms, 1), "log": lines}
    tr = row["profile"]
    by_range = tr["range_device_ms_per_step"]
    tr["backward_device_ms"] = tr["device_busy_ms"] - by_range.get(
        "train_step.forward", 0.0) - by_range.get("train_step.adamw", 0.0)
    log(f"[paths] {label}: {cfg.name} ({n_params / 1e9:.3f} B parameters, "
        f"{row['state_gb']:.1f} GB of float32 state) {batch} x {seq} "
        f"positions a step in {accum} microbatches through the {route}, "
        f"{TRAIN_STEPS} steps, losses {losses}, step s {dts}, "
        f"{row['ms_per_step']:.1f} ms a step after the first, "
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
    if peak >= 80:
        fail(f"{label}: peak {peak:.1f} GB")
    kinds = {"flash_attention": "flash_attention_wgmma",
             "ssd_scan": "ssd_scan_mma"}
    for kernel, n in train_launches(cfg, accum * TRAIN_STEPS).items():
        want = n if CARD == "cuda" else 0
        for name in (kernel, kinds[kernel]):
            if launches[name] != want:
                fail(f"{label}: {name} launched {launches[name]} times, "
                     f"not {want} (each layer's, twice a microbatch where "
                     f"rematerialised)")
    return row


def train_cross_arch(arch, route, spec):
    """One smoke config's card-vs-CPU check (``train_cross``): the
    losses of both runs, the card run's launches, and for the ``Trainer``
    the crash-and-restart outcome."""
    import shutil
    import tempfile
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.blocks import tree_map
    from repro_torch.models.model import Model
    from repro_torch.runtime.train import (SimulatedFailure, Trainer,
                                           TrainerConfig)
    cfg = get_config(arch, smoke=True).replace(compute_dtype="float32")
    out = {}
    if route == "step":
        batches = train_batches(cfg, spec["batch"], spec["seq"],
                                spec["steps"], "cpu")
        params = Model(cfg, seed=0, device="cpu").params
        cpu = StepRunner(cfg, 1, "cpu", tree_map(torch.clone, params)).run(
            batches)
        card_runner = StepRunner(cfg, 1, CARD, tree_map(
            lambda t: t.to(CARD), params))
        torch.cuda.synchronize()
        reset_counts()
        card = card_runner.run([{k: v.to(CARD) for k, v in b.items()}
                                for b in batches])
        torch.cuda.synchronize()
        launches = counts()
        return cfg, cpu, card, launches, out
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=spec["seq"],
                    global_batch=spec["batch"])
    with tempfile.TemporaryDirectory() as tmp:
        def trainer(name, device, **kw):
            return Trainer(cfg, dc, TrainerConfig(
                total_steps=spec["steps"], ckpt_every=spec["ckpt_every"],
                keep=3, ckpt_dir=os.path.join(tmp, name), **kw),
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
        card = trainer("card", CARD).run()
        torch.cuda.synchronize()
        launches = counts()
        out["crashed"] = False
        crashing = trainer("ft", CARD, fail_at_steps=(spec["fail_at"],))
        try:
            crashing.run()
        except SimulatedFailure:
            out["crashed"] = True
        # the step-4 checkpoint's write runs on the crashed Trainer's
        # writer thread, which outlives the exception: let it commit, or
        # the restart may read step 0 (a card step takes milliseconds)
        crashing.ckpt.wait()
        out["resumed"] = trainer("ft", CARD).run()
    return cfg, cpu, card, launches, out


def train_cross(spec=TRAIN_CROSS):
    """The smoke configs trained in float32 (TF32 off) on the card and on
    the CPU from the same step-0 state: per-step losses within
    ``TRAIN_CROSS_TOL``, and each attention and Mamba-2 layer's float32
    (SIMT) kernel launched twice a step.  Through the ``Trainer`` both
    start from one step-0 checkpoint, and on the card a crash at
    ``fail_at`` is resumed by a fresh ``Trainer`` from the last
    checkpoint, whose final loss must equal the uninterrupted card run's
    (``RESTART_RTOL``); the encoder-decoder and the VLM go through
    ``make_train_step`` (``StepRunner``) on ``train_batches``."""
    prev = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    try:
        for route in ("trainer", "step"):
            for arch in spec[route]:
                cfg, cpu, card, launches, ft = train_cross_arch(arch, route,
                                                                spec)
                rows.append(train_cross_row(arch, route, spec, cfg, cpu,
                                            card, launches, ft))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    return rows


def train_cross_row(arch, route, spec, cfg, cpu, card, launches, ft):
    """Decide and log one ``train_cross`` point."""
    got = [h["loss"] for h in card["history"]]
    want = [h["loss"] for h in cpu["history"]]
    diff = max(abs(a - b) for a, b in zip(got, want))
    # float32: the SIMT / FMA variants
    want_launches = {f"{k}_simt": n for k, n in
                     train_launches(cfg, spec["steps"]).items()}
    ok = diff <= TRAIN_CROSS_TOL and len(got) == spec["steps"] and all(
        launches[k] == n for k, n in want_launches.items())
    row = {"arch": arch, "route": route, "card_losses": got,
           "cpu_losses": want, "max_abs_diff": diff, "launches": launches,
           "want_launches": want_launches}
    text = (f"[paths] train_cross {arch} through the {route}: "
            f"{spec['steps']} steps of {spec['batch']} x {spec['seq']}, "
            f"losses on the card {got}, max abs diff from the CPU {diff!r} "
            f"(limit {TRAIN_CROSS_TOL}); launches {launches} (want "
            f"{want_launches})")
    if route == "trainer":
        resumed = ft["resumed"]
        restart = abs(resumed["final_loss"] - card["final_loss"])
        steps = [h["step"] for h in resumed["history"]]
        ok = ok and ft["crashed"] and steps == list(
            range(spec["ckpt_every"], spec["steps"])) \
            and restart <= RESTART_RTOL * abs(card["final_loss"])
        row.update(restart_final_loss=resumed["final_loss"],
                   final_loss=card["final_loss"], restart_abs_diff=restart)
        text += (f"; crash at step {spec['fail_at']} {ft['crashed']}, "
                 f"resumed steps {steps}, final loss "
                 f"{resumed['final_loss']!r} vs uninterrupted "
                 f"{card['final_loss']!r} (abs diff {restart!r}, rtol "
                 f"{RESTART_RTOL})")
    log(text)
    if not ok:
        fail(f"train_cross {arch}: {text}")
    return row


def run_train(phases=TRAIN):
    """Every train phase at full width (depth cut where given), each state
    freed before the next is drawn; then the smoke-config cross and
    restart check."""
    from repro_torch.configs.base import get_config
    out = {}
    for label, arch, layers, batch, seq, accum, route in phases:
        cfg = get_config(arch)
        if layers:
            cfg = cfg.replace(n_layers=layers)
        out[label] = train_phase(label, cfg, batch, seq, accum, route)
    points = train_cross()
    out["train_cross"] = {"points": points, "launches": {
        name: sum(r["launches"][name] for r in points) for name in counts()}}
    return out


# ---------------------------------------------------------- mesh steps

def mesh_cfg(arch, layers):
    """``arch``'s published config cut to ``layers`` (``MESH_STEPS``;
    jamba's pattern cut to ``JAMBA_CUT``)."""
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    if arch == "jamba_v0_1_52b":
        return cfg.replace(pattern=cfg.pattern[JAMBA_CUT], n_layers=layers)
    return cfg.replace(n_layers=layers) if layers else cfg


def check_launches(label, launches, want):
    """Fail unless every kernel of ``want`` launched as many times, each
    launch its tensor-core variant."""
    if CARD != "cuda":
        want = {k: 0 for k in want}
    variant = {"flash_attention": "flash_attention_wgmma",
               "ssd_scan": "ssd_scan_mma"}
    for name, n in want.items():
        for key in (name, variant[name]):
            if launches[key] != n:
                fail(f"{label}: {key} launched {launches[key]} times, not "
                     f"{n}")


def mesh_prefill_phase(cfg, batch, seq, label="mesh_prefill"):
    """``cfg`` at full width (seed-0 weights, bf16 compute):
    ``make_prefill_step`` on ``single_device_mesh`` against the step
    without a mesh on the same prompts (``prefill_batch``: ``seq`` tokens
    after a VLM's prefix, an encoder-decoder's frames): bit-identical
    logits, one ``flash_attention`` (wgmma) an attention sublayer,
    cross-attention and encoder layer and one ``ssd_scan`` (mma) a
    Mamba-2 sublayer, counted for the mesh step alone."""
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.model import Model
    model = Model(cfg, seed=0, device=CARD)
    inputs = prefill_batch(cfg, batch, seq, CARD)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    got = make_prefill_step(cfg, mesh=single_device_mesh(CARD))(
        model.params, inputs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    want = make_prefill_step(cfg, device=CARD)(model.params, inputs)
    same = torch.equal(got, want)
    finite = bool(torch.isfinite(got).all())
    row = {"arch": cfg.name, "n_layers": cfg.n_layers, "batch": batch,
           "seq": seq, "wall_s": wall, "identical_to_no_mesh": same,
           "logits_finite": finite, "launches": launches}
    log(f"[paths] {label}: make_prefill_step on single_device_mesh, "
        f"{cfg.name} ({cfg.n_layers} layers) {batch} x {seq}: {wall:.3f} s "
        f"(the first call), identical to the step without a mesh {same}, "
        f"finite {finite}, launches {launches}")
    if not same or not finite:
        fail(f"{label}: identical {same}, finite {finite}")
    check_launches(label, launches, {
        k: n for k, n in path_launches(cfg, decode=False).items() if n})
    del model, got, want
    torch.cuda.empty_cache()
    return row


def mesh_train_phase(cfg, spec, label="mesh_train"):
    """``cfg`` at full width (seed-0 float32 parameters and fresh moments
    drawn on the card, bf16 compute): one ``make_train_step`` step on
    ``single_device_mesh`` and one without a mesh from the same state and
    batch (``train_batches``' first, ``spec`` its batch, positions and
    microbatches): bit-identical loss, ``grad_norm``, the gradient handed
    to AdamW and every updated parameter and moment (the mesh run's
    copied to the host, and each brought back to the card to be compared
    with the other's leaf there).  The gradient must be finite and
    nonzero: where its float32 norm overflows to inf (whisper's 48
    layers; granite's whole 40) the clip factor is 0 and the moments
    stay zero, so it is the gradient that shows the backward.  The mesh
    step's launches are counted alone (``train_launches``: each kernel
    twice a microbatch where the blocks are rematerialised, forward and
    recompute), every one the tensor-core variant."""
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.blocks import tree_leaves
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    batch = train_batches(cfg, spec["batch"], spec["seq"], 1, CARD)[0]
    kept, metrics, diff, walls = {}, {}, [], {}
    grads, gdiff, gsum = {}, [], {}
    apply = adamw.apply

    def recorded(opt_cfg, p, state, g, **kw):
        # the gradient handed to AdamW, before its clip scales it in place
        # (at 40 layers the float32 norm overflows, the clip factor is 0
        # and the moments stay zero: this is where the backward shows)
        kind = "mesh" if kw.get("mesh") is not None else "none"
        sq, big, nz = 0.0, 0.0, 0
        for name, t in tree_leaves(g):
            sq += float(torch.sum(torch.square(t.double())))
            big = max(big, float(t.abs().max()))
            nz += int(torch.count_nonzero(t))
            if kind == "mesh":
                grads[name] = t.to("cpu", copy=True)
            elif not torch.equal(t, grads[name].to(t.device)):
                gdiff.append(name)
        gsum[kind] = {"norm_f64": sq ** 0.5, "max_abs": big,
                      "nonzero": nz}
        return apply(opt_cfg, p, state, g, **kw)
    adamw.apply = recorded
    torch.cuda.reset_peak_memory_stats()
    for kind in ("mesh", "none"):
        params = Model(cfg, seed=0, device=CARD).params
        state = adamw.init(params)
        kw = ({"mesh": single_device_mesh(CARD)} if kind == "mesh"
              else {"device": CARD})
        step = make_train_step(cfg, adamw.AdamWConfig(), spec["accum"],
                               **kw)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        walls[kind] = time.perf_counter() - t0
        if kind == "mesh":
            launches = counts()
        metrics[kind] = {k: v.detach().cpu() for k, v in m.items()}
        leaves = tree_leaves({"params": params, "m": state["m"],
                              "v": state["v"]})
        for name, t in leaves:
            if kind == "mesh":
                kept[name] = t.cpu()
            elif not torch.equal(t, kept[name].to(t.device)):
                diff.append(name)
        del params, state, step, m, leaves
        torch.cuda.empty_cache()
    adamw.apply = apply
    peak = torch.cuda.max_memory_allocated() / 1e9
    same_metrics = all(torch.equal(metrics["mesh"][k], metrics["none"][k])
                       for k in metrics["none"])
    loss = float(metrics["mesh"]["loss"])
    row = {"arch": cfg.name, "n_layers": cfg.n_layers, **spec,
           "loss": loss, "grad_norm": float(metrics["mesh"]["grad_norm"]),
           "step_s": walls, "peak_gb": peak, "leaves": len(kept),
           "leaves_differing": diff, "metrics_identical": same_metrics,
           "grad_leaves": len(grads), "grad_leaves_differing": gdiff,
           "grad": gsum["mesh"], "launches": launches}
    log(f"[paths] {label}: make_train_step on single_device_mesh vs no "
        f"mesh, {cfg.name} ({cfg.n_layers} layers) {spec['batch']} x "
        f"{spec['seq']} in {spec['accum']} microbatches: loss {loss!r}, "
        f"grad_norm {row['grad_norm']!r}, metrics identical "
        f"{same_metrics}, {len(kept) - len(diff)} of {len(kept)} leaves "
        f"(parameters, m, v) identical, {len(grads) - len(gdiff)} of "
        f"{len(grads)} gradient leaves handed to AdamW identical (mesh "
        f"run's gradient: {gsum['mesh']}), step s {walls} (the first "
        f"steps), peak {peak:.1f} GB, launches {launches}")
    if diff or gdiff or not same_metrics or not np.isfinite(loss):
        fail(f"{label}: leaves differing {diff[:5]}, gradient leaves "
             f"differing {gdiff[:5]}, metrics identical {same_metrics}, "
             f"loss {loss}")
    if not gsum["mesh"]["nonzero"] or not np.isfinite(
            gsum["mesh"]["max_abs"]):
        fail(f"{label}: the gradient is zero or not finite {gsum['mesh']}")
    check_launches(label, launches, train_launches(cfg, spec["accum"]))
    del kept, grads
    torch.cuda.empty_cache()
    return row


def run_mesh_steps(steps=MESH_STEPS):
    """The prefill and train steps on ``single_device_mesh`` against the
    steps without a mesh (the one-card case of the mesh code), every
    family of ``steps``."""
    t0 = time.perf_counter()
    out = {}
    for suffix, arch, layers, (pb, ps), (tb, ts, accum) in steps:
        cfg = mesh_cfg(arch, layers)
        out[f"mesh_prefill{suffix}"] = mesh_prefill_phase(
            cfg, pb, ps, f"mesh_prefill{suffix}")
        out[f"mesh_train{suffix}"] = mesh_train_phase(
            cfg, dict(batch=tb, seq=ts, accum=accum), f"mesh_train{suffix}")
    log(f"[paths] mesh steps: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------- dry run

def dryrun_cell(label, kind):
    """``(cfg, cell, steps)`` of a ``DRYRUN`` phase: its config, a
    ``launch/steps.SHAPE_TABLE``-style cell of its batch, sequence and
    microbatches, and the steps the phase counted launches over."""
    from repro_torch.configs.base import get_config
    if kind == "decode":
        cfg = get_config(SERVE["arch"])
        return cfg, dict(seq=MESH["seq"], batch=MESH["batch"], kind=kind,
                         param_dtype=torch.float32), MESH["steps"]
    table = TRAIN if kind == "train" else PREFILL
    entry = next(e for e in table if e[0] == label)
    arch, layers, batch, seq = entry[1:5]
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    cell = dict(seq=seq, batch=batch, kind=kind)
    if kind == "train":
        cell["accum"] = entry[5]
    return cfg, cell, TRAIN_STEPS if kind == "train" else 1


def run_dryrun(paths, phases=DRYRUN):
    """The dry run's predictions (``launch/steps.lower_cell`` on a (1, 1)
    mesh of fake tensors, on the host) for steps the phases ran, held to
    what the card measured: each kernel's calls a step equal to the
    launches the phase counted a step and to ``train_launches`` /
    ``path_launches`` (exact); the argument bytes equal to the sum of the
    phase's real parameters, moments, batch or caches (exact); the
    predicted peak of live bytes within ``DRYRUN_PEAK_TOL`` of the step's
    measured peak (``max_memory_allocated`` above what else the card
    held, plus the arguments).  Printed, not gated: the counted FLOPs
    beside the model FLOPs and the measured step time, and
    ``roofline_fraction`` at the measured time."""
    from repro_torch.launch import roofline, steps
    from repro_torch.launch.mesh import single_device_mesh
    mesh = single_device_mesh("cpu")
    out = {}
    for label, kind in phases:
        row = paths[label]
        cfg, cell, n_steps = dryrun_cell(label, kind)
        t0 = time.perf_counter()
        counts, spec = steps.lower_cell(cfg, label, mesh,
                                        table={label: cell})
        t_trace = time.perf_counter() - t0
        if kind == "decode":
            want = roofline.path_launches(cfg, decode=True)
            step_s = row["ms_per_step"] / 1e3
        elif kind == "prefill":
            want = roofline.path_launches(cfg, decode=False)
            step_s = row["wall_s"]
        else:
            want = roofline.train_launches(cfg, spec.accum)
            step_s = row["ms_per_step"] / 1e3
        want = {k: n for k, n in want.items() if n}
        traced = {k: v["calls"] for k, v in counts["kernels"].items()}
        card = {k: row["launches"][k] / n_steps for k in want}
        flops = roofline.train_step_flops(cfg, cell["batch"], cell["seq"]) \
            if kind == "train" else roofline.model_flops(
                cfg, cell, spec.n_params, 1)
        t_star = flops / roofline.PEAK_FLOPS[getattr(torch,
                                                      cfg.compute_dtype)]
        pred, meas = counts["peak_bytes"], row["step_peak_bytes"]
        rec = {"phase": label, "arch": cfg.name, "n_layers": cfg.n_layers,
               **cell, "param_dtype": str(cell.get("param_dtype", "")),
               "accum": spec.accum, "trace_s": t_trace,
               "kernel_calls_traced": traced, "kernel_calls_card": card,
               "kernel_calls_formula": want,
               "argument_bytes_traced": counts["argument_bytes"],
               "argument_bytes_card": row["argument_bytes"],
               "peak_bytes_traced": pred, "peak_bytes_card": meas,
               "peak_ratio": pred / meas,
               "flops_traced": counts["flops"], "model_flops": flops,
               "bytes_traced": counts["bytes"], "step_s_card": step_s,
               "roofline_fraction_at_card_time": t_star / step_s}
        log(f"[dryrun] {json.dumps(rec)}")
        if not traced == card == want:
            fail(f"dryrun {label}: kernel calls a step traced {traced}, "
                 f"on the card {card}, by formula {want}")
        if counts["argument_bytes"] != row["argument_bytes"]:
            fail(f"dryrun {label}: argument bytes traced "
                 f"{counts['argument_bytes']}, on the card "
                 f"{row['argument_bytes']}")
        if not abs(pred - meas) <= DRYRUN_PEAK_TOL * meas:
            fail(f"dryrun {label}: predicted peak {pred} bytes, measured "
                 f"{meas} (ratio {pred / meas:.4f}, band "
                 f"{DRYRUN_PEAK_TOL})")
        out[label] = rec
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
                                       device=CARD), wl)
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
                                 device=CARD)
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
        got = gate_values(mods, "flow", {"device": CARD})
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
        rf = run_fleet("flow", shared, spec, device=CARD)
        fresh = run_fleet("flow", fabric(), spec, device=CARD)
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
        got, got_rep = run("flow", {"device": CARD})
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
    def call():
        return mm.maxmin_rates(fl, cap, active, **kw)
    got = call()
    want = ref.maxmin_rates_reference(fl, cap, active, **kw)
    err_abs = abs_err(got, want)
    err_rel = rel_err(got, want)
    ms = cuda_ms(call, 20)
    plain_ms = cuda_ms(lambda: ref.maxmin_rates_reference(fl, cap, active,
                                                          **kw), 3)
    bound_ms, bound_by, bytes_ms = fill_bound(fl, cap, max(rounds, 1), dtype)
    calls = call_counts(mm, call, ms, bound_ms)
    ok = freeze_ok and round_err <= rtol and err_rel <= rtol \
        and calls["one_kernel"]
    row = {"kernel": "maxmin_fill", "phase": name, "shape": list(fl.shape),
           "caps": cap.shape[-1], "dtype": str(dtype).split(".")[-1],
           "rounds": rounds, "freeze_sets_equal": freeze_ok,
           "round_max_rel_err": round_err, "max_abs_err": err_abs,
           "max_rel_err": err_rel, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes_bound_ms": bytes_ms, **calls, "phase_launches": launches,
           "ok": ok}
    log(f"[kernels] {json.dumps(row)}")
    if not ok:
        fail(f"maxmin_fill {name} {list(fl.shape)} {dtype}: freeze "
             f"{freeze_ok}, round err {round_err}, rates err {err_rel}, "
             f"kernels a call {calls['kernels_per_call']} (traced "
             f"{calls['traced_kernels_per_call']})")
    return row


def call_counts(mm, call, ms, bound_ms):
    """Device ms (torch.profiler), kernels a call by the library's own
    count and by the tracer (memsets and copies included), the share of
    the bound on the device time, and whether a call ran one kernel and
    nothing else (the tracer's count, where it gave a whole trace, must
    agree)."""
    reps = max(2, min(50, int(20.0 / max(ms, 1e-3))))
    per_call = kernels_per_call(mm.kernels_launched, call, min(10, reps))
    dev_ms, traced, traces = device_time(call, reps)
    return {"device_ms": dev_ms, "kernels_per_call": per_call,
            "traced_kernels_per_call": traced, "traces": traces,
            "bound_share": bound_ms / dev_ms if dev_ms else None,
            "one_kernel": per_call == 1 and traced in (None, 1)}


def rel_err(got, want):
    """Largest relative distance; equal values (infinities, and a NaN
    where the plain value is NaN) count 0, a NaN on one side only +inf."""
    if got.numel() == 0:
        return 0.0
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    err = torch.where(same, torch.zeros_like(got),
                      (got - want).abs() / want.abs().clamp(min=1e-30))
    return float(torch.nan_to_num(err, nan=math.inf).max())


def abs_err(got, want):
    """Largest absolute distance, equal values (NaN with NaN) counting 0."""
    if got.numel() == 0:
        return 0.0
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    err = torch.where(same, torch.zeros_like(got), (got - want).abs())
    return float(torch.nan_to_num(err, nan=math.inf).max())


def check_loss(name, args, kw, dtype, mm, ref, launches=0):
    fl, rates, active, cap, q, wsq, wnd, ecn = (
        a.to(dtype) if a.is_floating_point() else a for a in args)
    def call():
        return mm.loss_factors(fl, rates, active, cap, q, wsq, wnd, ecn, **kw)
    got = call()
    want = ref.loss_factors_reference(fl, rates, active, cap, q, wsq, wnd,
                                      ecn, **kw)
    err = abs_err(got, want)
    zero = (q == 0) & (wsq == 0) & (wnd == 0) & (ecn == 0)
    ones_ok = bool((got[zero] == 1.0).all())
    ms = cuda_ms(call, 20)
    plain_ms = cuda_ms(lambda: ref.loss_factors_reference(
        fl, rates, active, cap, q, wsq, wnd, ecn, **kw), 5)
    bound_ms, bound_by, bytes_ms = loss_bound(fl, cap, dtype)
    calls = call_counts(mm, call, ms, bound_ms)
    ok = err <= 1e-6 and ones_ok and calls["one_kernel"]
    row = {"kernel": "loss_factors", "phase": name, "shape": list(fl.shape),
           "caps": cap.shape[-1], "dtype": str(dtype).split(".")[-1],
           "zero_rows": int(zero.sum()), "zero_rows_exactly_one": ones_ok,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes_bound_ms": bytes_ms, **calls, "phase_launches": launches,
           "ok": ok}
    log(f"[kernels] {json.dumps(row)}")
    if not ok:
        fail(f"loss_factors {name} {list(fl.shape)} {dtype}: err {err}, "
             f"all-zero rows exactly 1: {ones_ok}, kernels a call "
             f"{calls['kernels_per_call']} (traced "
             f"{calls['traced_kernels_per_call']})")
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
    # a live row over the sentinel alone: its round's bottleneck is +inf,
    # and the plain round leaves NaN on every link a row crosses
    links, caps = B_INF
    fl = torch.tensor([links], dtype=torch.int32, device="cuda")
    cap = torch.tensor(caps, dtype=torch.float64, device="cuda")
    for dtype in (torch.float32, torch.float64):
        rows.append(check_fill("b_inf", fl, cap, torch.ones(
            fl.shape[:2], dtype=dtype, device="cuda"), {}, dtype, mm, ref))
    return rows


def decode_bound(q, k, kv_len):
    """The valid cache prefix's keys and values read once, q read and
    out, m, l written once; ~4 f32 operations per (key, q head, dim)
    (``kernels/flash_decode.cost``)."""
    n_keys = int(kv_len.clamp(0, k.shape[1]).sum())
    ops, n_bytes = fd_cost.cost(q, k, n_keys)
    return bound(n_bytes, ops, torch.float32), n_keys


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


def check_decode(name, q, k, v, kv_len, fd, ref, launches=0, timed=True,
                 out_dtype=None):
    """Kernel vs plain flash decode: out, m and l within the tolerance, a
    second call bit-identical, one device kernel a call (the library's
    count; the tracer's, where it gave a whole trace, must agree); then,
    when ``timed``, times.  ``out_dtype``: a float32 out of bf16 q, held
    to the float32 tolerance (the kernel rounds nothing to bf16 there)."""
    tol = DECODE_TOL[out_dtype or q.dtype]

    def call():
        return fd.flash_decode(q, k, v, kv_len, out_dtype)
    got = call()
    again = call()
    same = all(torch.equal(g, a) for g, a in zip(got, again))
    want = ref.decode_reference(q, k, v, kv_len, out_dtype)
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
           "out_dtype": str(got[0].dtype).split(".")[-1],
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
            "plain_ms": cuda_ms(lambda: ref.decode_reference(
                q, k, v, kv_len, out_dtype), 10),
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


def attn_bound(q, k, causal, window, q_offset=0):
    """q, k, v read once and out written once; 4 D operations per head and
    (query, key) pair inside the causal band or window (the two
    products), at the peak of the inputs' dtype (bf16 on the tensor
    cores) (``kernels/flash_attention.cost``)."""
    ops, n_bytes = fa_cost.cost(q, k, causal, window, q_offset)
    return bound(n_bytes, ops, q.dtype), ops


def sdpa_prefill_ms(q, k, v, causal, window, reps, q_offset=0):
    """One PyTorch call computing the same attention, as a yardstick (the
    port never calls it): ``is_causal`` with GQA for a causal band, an
    explicit band mask (kv heads repeated) for a window or query rows at
    an offset."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if not window and not q_offset:
        return cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=causal,
                                    enable_gqa=True), reps)
    rep = q.shape[2] // k.shape[2]
    kt, vt = kt.repeat_interleave(rep, 1), vt.repeat_interleave(rep, 1)
    qpos = torch.arange(q.shape[1], device=q.device)[:, None] + q_offset
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = kpos > qpos - window if window else torch.ones_like(kpos > qpos)
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
                    oracle=False, q_offset=0, reps=None):
    """Kernel vs plain flash attention; times.  With ``oracle`` (the
    captured full-width inputs) both are also measured against the plain
    version in float64, which decides a float32 row (ORACLE_FACTOR); a
    bf16 row is decided by the element-wise 2e-2 check, with each
    output's distance from float64 beyond its bf16 rounding recorded.
    ``q_offset`` puts query row s at position ``q_offset + s``; ``reps``
    (kernel, plain, SDPA) overrides the timing repetitions."""
    tol = ATTN_TOL[q.dtype]
    got = fa.flash_attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    want = ref.mha_reference(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
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
    reps = reps or ((5, 2, 5) if big else (20, 5, 20))
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                            window=window,
                                            q_offset=q_offset), reps[0])
    plain_ms = cuda_ms(lambda: ref.mha_reference(q, k, v, causal=causal,
                                                 window=window,
                                                 q_offset=q_offset),
                       reps[1])
    (bound_ms, bound_by, bytes_ms), ops = attn_bound(q, k, causal, window,
                                                     q_offset)
    lib = sdpa_prefill_ms(q, k, v, causal, window, reps[2], q_offset)
    row = {"kernel": "flash_attention", "phase": name,
           "variant": fa.variant(q, k),
           "shape": [*q.shape, k.shape[1], k.shape[2]],
           "dtype": str(q.dtype).split(".")[-1], "causal": causal,
           "window": window, "q_offset": q_offset, "flops": ops, "tflops": ops / ms / 1e9,
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
    ``ssd_ops`` operations (``kernels/ssd_scan.cost``)."""
    ops, n_bytes = ssd_cost.cost(x, B_, chunk, y_dtype)
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


def run_train_kernels(prefill_rec):
    """The backward rows (``prefill_rec.backward``): each Function's
    backward at a train path's layer, from the prefill phases' captured
    layer inputs in bf16 (the dtype the train phases run), the batch cut
    to ``rows``."""
    rows = []
    for name, phase, kernel, call, keep in prefill_rec.backward:
        if (phase, kernel, call) not in prefill_rec.inputs:
            fail(f"{name}: no captured input of {phase}'s {kernel} call "
                 f"{call}")
            continue
        tensors, kw = prefill_rec.inputs[(phase, kernel, call)]
        tensors = [t[:keep] for t in tensors]
        if kernel == "flash_attention":
            rows.append(attention_backward_row(
                name, *tensors, kw["causal"], kw["window"]))
        else:
            rows.append(ssd_backward_row(name, tensors, kw["chunk"],
                                         kw["y_dtype"]))
    return rows


def run_q_offset_kernels(cases=Q_OFFSET_ATTN):
    """``flash_attention`` with ``q_offset`` (the sequence-parallel
    attention of a mesh's ``model`` ranks) in bf16 (wgmma) and float32
    (SIMT): each block of query rows at its offset against the whole
    K/V, causal, held to the plain version at the same bands as every
    row (``check_attention``); the blocks concatenated held to one
    whole-sequence call of the kernel at the same band, and whether they
    are its bits recorded.  Inputs are unit normals from a seeded
    generator."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    gen = torch.Generator(device=CARD).manual_seed(0)
    rows = []
    t0 = time.perf_counter()
    for name, seq, h, kvh, d, window, blocks in cases:
        shapes = ((1, seq, h, d), (1, seq, kvh, d), (1, seq, kvh, d))
        base = [torch.randn(sh, generator=gen, device=CARD) for sh in shapes]
        n = seq // blocks
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (t.to(dtype) for t in base)
            parts = []
            for i in range(blocks):
                qb = q[:, i * n:(i + 1) * n].contiguous()
                rows.append(check_attention(
                    f"q_offset {name} block {i}/{blocks}", qb, k, v, True,
                    window, fa, ref, q_offset=i * n, reps=(3, 1, 3)))
                parts.append(fa.flash_attention(qb, k, v, causal=True,
                                                window=window,
                                                q_offset=i * n))
            whole = fa.flash_attention(q, k, v, causal=True, window=window)
            cat = torch.cat(parts, 1)
            tol = ATTN_TOL[dtype]
            err = float((cat.float() - whole.float()).abs().max())
            within = torch.allclose(cat.float(), whole.float(), rtol=tol,
                                    atol=tol)
            same = torch.equal(cat, whole)
            rows[-1].update(blocks_vs_whole_err=err,
                            blocks_identical_to_whole=same)
            log(f"[kernels] q_offset {name} {str(dtype).split('.')[-1]}: "
                f"{blocks} blocks of {n} rows concatenated vs one call over "
                f"{seq}: max abs {err!r} (tol {tol}), bit-identical {same}")
            if not within:
                fail(f"q_offset {name} {dtype}: blocks vs whole err {err}")
            del q, k, v, parts, whole, cat
        del base
        torch.cuda.empty_cache()
    log(f"[kernels] q_offset rows: {time.perf_counter() - t0:.1f} s")
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
    paths.update(run_mesh_steps())
    paths.update(run_packet(rec))
    dryrun = run_dryrun(paths)
    rows = run_kernels(rec, paths) + run_decode_kernels(decode_rec, paths) \
        + run_split_kv() + run_prefill_kernels(prefill_rec, paths) \
        + run_train_kernels(prefill_rec) + run_q_offset_kernels()
    line = kernels_line(rows, paths)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"),
              "w") as fh:
        json.dump({"card": card, "paths": paths, "dryrun": dryrun,
                   "kernel_rows": rows,
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
