"""Cases and inputs of the mesh tests, shared by the test modules, the
reference's subprocess and the port's rank processes (numpy only)."""
from __future__ import annotations

import itertools

import numpy as np

# ------------------------------------------------------------ collectives

#: ranks of the collective worlds
WORLDS = (2, 4, 8)
COMBINES = ("add", "min", "softmax")
SOFTMAX_SCHEDULES = ("xla", "gleam_tree")
SUM_SCHEDULES = ("xla", "gleam_tree", "ring", "unicast")


def collective_cases(n):
    """``(key, function, root, arg)`` of every collective case at ``n``
    ranks: each root of the broadcasts, the tree reduce and allreduce;
    ``chunks`` 1 and 2 of the ring; each combine; each schedule."""
    out = []
    for root in range(n):
        out += [(f"tree_broadcast/root{root}", "tree_broadcast", root, None),
                (f"unicast_broadcast/root{root}", "unicast_broadcast", root,
                 None)]
        out += [(f"ring_broadcast/root{root}/chunks{c}", "ring_broadcast",
                 root, c) for c in (1, 2)]
        out += [(f"{fn}/root{root}/{comb}", fn, root, comb)
                for fn in ("tree_reduce", "tree_allreduce")
                for comb in COMBINES]
    out += [(f"butterfly_allreduce/{comb}", "butterfly_allreduce", 0, comb)
            for comb in COMBINES]
    out += [(f"allreduce_sum/{s}", "allreduce_sum", 0, s)
            for s in SUM_SCHEDULES]
    out += [(f"softmax_combine/{s}", "softmax_combine", 0, s)
            for s in SOFTMAX_SCHEDULES]
    return out


def collective_inputs(n, seed=0):
    """Whole inputs whose rank-r block is rank r's value: ``v`` (4n, 5)
    (4 rows a rank), ``w`` (2n, 3) for the two-leaf allreduce, and split-KV
    partials ``m`` (2n, 3), ``l`` (2n, 3) > 0, ``acc`` (2n, 3, 4)."""
    rng = np.random.default_rng(seed + n)
    f32 = np.float32
    return {"v": rng.standard_normal((4 * n, 5)).astype(f32),
            "w": rng.standard_normal((2 * n, 3)).astype(f32),
            "m": (3 * rng.standard_normal((2 * n, 3))).astype(f32),
            "l": rng.uniform(0.5, 2.0, (2 * n, 3)).astype(f32),
            "acc": rng.standard_normal((2 * n, 3, 4)).astype(f32)}


# ------------------------------------------------------------ pipeline

PIPE = dict(stages=8, layers=16, d=32, n_micro=4, mb=2)


def pipeline_inputs(seed=0):
    rng = np.random.default_rng(seed)
    p = PIPE
    f32 = np.float32
    return {"w": (rng.standard_normal((p["layers"], p["d"], p["d"]))
                  * 0.3).astype(f32),
            "b": (rng.standard_normal((p["layers"], p["d"])) * 0.1)
            .astype(f32),
            "xs": rng.standard_normal((p["n_micro"], p["mb"], p["d"]))
            .astype(f32)}


# ------------------------------------------------------------ serve step

SERVE_ARCHES = ("granite_3_2b", "llama3_2_3b", "qwen1_5_110b",
                "h2o_danube_3_4b")
#: (mesh shape, batch_shardable): the batch of 8 divides every data axis
SERVE_MESHES = (((1, 4), False), ((2, 2), True), ((2, 2), False),
                ((2, 4), True), ((2, 4), False))
SERVE_BATCH, SERVE_SEQ, SERVE_STEPS = 8, 64, 3
#: first position of each arch's three steps: the dense caches hold 21
#: valid slots before it (the valid prefix ends inside a block, then on a
#: block boundary at 24 of 8-slot blocks); danube's 32-slot rolling
#: buffer is past its window
SERVE_START = {"granite_3_2b": 21, "llama3_2_3b": 21, "qwen1_5_110b": 21,
               "h2o_danube_3_4b": 45}
DTYPES = ("float32", "bfloat16")


def serve_cases():
    """``(key, arch, shape, batch_shardable, schedule, dtype, plan,
    embed_impl)``: every arch, mesh, schedule and dtype through
    ``make_serve_step`` (its plan); the default (FSDP) plan where the
    batch shards, in float32 and bf16 under ``xla``; and qwen1.5's
    ``psum`` embedding on the batch-sharded meshes."""
    out = []
    for arch, (shape, bs), sched, dt in itertools.product(
            SERVE_ARCHES, SERVE_MESHES, SOFTMAX_SCHEDULES, DTYPES):
        out.append((arch, shape, bs, sched, dt, "serve", "gather"))
        if bs and sched == "xla":
            out.append((arch, shape, bs, sched, dt, "default", "gather"))
    for shape in ((2, 2), (2, 4)):
        out.append(("qwen1_5_110b", shape, True, "xla", "float32", "serve",
                    "psum"))
    return [(case_key(c),) + c for c in out]


def case_key(case):
    arch, shape, bs, sched, dt, plan, embed = case
    return (f"{arch}/{shape[0]}x{shape[1]}/{'bs' if bs else 'seq'}/{sched}/"
            f"{dt}/{plan}/{embed}")


def ref_key(case):
    """The reference's run a case is held to (the plan is the port's)."""
    arch, shape, bs, sched, dt, _, embed = case
    return f"{arch}/{shape[0]}x{shape[1]}/{int(bs)}/{sched}/{dt}/{embed}"


def drawn_params(leaves, seed=0):
    """Whole parameters ``{dotted name: float32 array}`` of a ``ParamDef``
    list ``[(name, def)]`` (pytree order): a leaf the init sets to a
    constant c is c + 0.1 N(0, 1) (so the q/k/v biases are not 0), every
    other leaf N(0, 1) times its init's scale."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, d in leaves:
        x = rng.standard_normal(d.shape).astype(np.float32)
        if d.init in ("zeros", "ones"):
            out[name] = (float(d.init == "ones") + 0.1 * x).astype(np.float32)
            continue
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale if d.scale is not None else 1.0 / np.sqrt(fan_in)
        out[name] = (x * np.float32(std)).astype(np.float32)
    return out


def serve_inputs(arch, cfg, seed=0):
    """Caches (k, v: (layers, B, slots, KVH, hd) float32 values, filled
    below the start position, or all of a rolling buffer) and the tokens
    of the three steps (steps, B, 1)."""
    rng = np.random.default_rng(seed + 1)
    slots = min(SERVE_SEQ, cfg.window) if cfg.window else SERVE_SEQ
    shape = (cfg.n_blocks, SERVE_BATCH, slots, cfg.n_kv_heads, cfg.hd)
    fill = min(SERVE_START[arch], slots)
    k = np.zeros(shape, np.float32)
    v = np.zeros(shape, np.float32)
    k[:, :, :fill] = rng.standard_normal(k[:, :, :fill].shape)
    v[:, :, :fill] = rng.standard_normal(v[:, :, :fill].shape)
    tokens = rng.integers(0, cfg.vocab_size,
                          (SERVE_STEPS, SERVE_BATCH, 1)).astype(np.int32)
    return {"k": k, "v": v, "tokens": tokens}


#: (arch, cell, mesh) whose ``input_specs`` blocks are held to the
#: reference's: every step kind, the SSM and encoder-decoder caches, and
#: both decode plans (where the two budgets choose alike)
INPUT_SPEC_CELLS = (
    ("granite_3_2b", "train_4k", (2, 4)),
    ("granite_3_2b", "prefill_32k", (2, 4)),
    ("granite_3_2b", "decode_32k", (2, 4)),
    ("llama3_2_3b", "train_4k", (2, 2)),
    ("h2o_danube_3_4b", "long_500k", (2, 4)),
    ("qwen1_5_110b", "decode_32k", (1, 4)),
    ("mixtral_8x7b", "decode_32k", (2, 2)),
    ("mamba2_370m", "decode_32k", (2, 4)),
    ("whisper_medium", "decode_32k", (2, 2)),
    ("internvl2_26b", "prefill_32k", (1, 4)),
)
