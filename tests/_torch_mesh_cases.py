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


#: (split dim, concat dim) of the all_to_all cases, on a (2n, 3, 2n)
#: block a rank
ALL_TO_ALL_DIMS = ((0, 0), (0, 2), (2, 0), (2, 1))


def all_to_all_inputs(n, seed=0):
    """Each rank's block ``x`` (n, 2n, 3, 2n) of the all_to_all cases and
    the weights ``w`` of its output's loss, one a case (indexed by the
    case's position in ``ALL_TO_ALL_DIMS``): rank r's are ``x[r]``,
    ``w[case][r]``."""
    rng = np.random.default_rng(seed + 10 * n)
    x = rng.standard_normal((n, 2 * n, 3, 2 * n)).astype(np.float32)
    w = [rng.standard_normal((n,) + all_to_all_shape(x.shape[1:], n, s, c))
         .astype(np.float32) for s, c in ALL_TO_ALL_DIMS]
    return {"x": x, "w": w}


def all_to_all_shape(shape, n, split, concat):
    """The shape all_to_all gives a block of ``shape`` on n ranks."""
    out = list(shape)
    out[split] //= n
    out[concat] *= n
    return tuple(out)


def all_to_all_want(x, split, concat):
    """Every rank's all_to_all output from the ranks' blocks ``x`` (n,
    ...): rank i's is block i (along ``split``) of each rank's, those
    concatenated along ``concat`` in rank order."""
    n = len(x)
    return np.stack([np.concatenate(
        [np.split(x[r], n, axis=split)[i] for r in range(n)], axis=concat)
        for i in range(n)])


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
#: reference's: every step kind, the SSM and encoder-decoder caches, every
#: family's decode cell, and both decode plans (where the two budgets
#: choose alike: on (1, 4) no batch axis splits a weight under either)
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
    ("mixtral_8x7b", "decode_32k", (1, 4)),
    ("qwen3_moe_235b_a22b", "decode_32k", (2, 4)),
    ("jamba_v0_1_52b", "decode_32k", (1, 4)),
    ("internvl2_26b", "decode_32k", (1, 4)),
)


# ------------------------------------------------------------ families

#: the families of ``tests/test_torch_mesh_families.py``
FAMILY_ARCHES = ("mixtral_8x7b", "qwen3_moe_235b_a22b", "mamba2_370m",
                 "jamba_v0_1_52b", "whisper_medium", "internvl2_26b")
#: first position of the three steps: mixtral's 32-slot rolling buffer is
#: past its window; every other cache holds 21 valid slots before it
FAMILY_START = {"mixtral_8x7b": 45, "qwen3_moe_235b_a22b": 21,
                "mamba2_370m": 21, "jamba_v0_1_52b": 21,
                "whisper_medium": 21, "internvl2_26b": 21}


def family_cases():
    """``(key, arch, shape, batch_shardable, schedule, dtype)``: every
    family on (1, 4) (the sequence over ``model``) and (2, 2) (the batch
    over ``data``) in float32 and bf16 under ``xla``; (1, 4) under
    ``gleam_tree`` in float32; (2, 2) with whole rows (the MoE takes its
    batch block) for mixtral and jamba; and mixtral and jamba on (1, 8),
    where 4 experts on 8 ranks run in ``"etp"`` mode."""
    out = []
    for arch in FAMILY_ARCHES:
        for (shape, bs), dt in itertools.product(
                (((1, 4), False), ((2, 2), True)), DTYPES):
            out.append((arch, shape, bs, "xla", dt))
        out.append((arch, (1, 4), False, "gleam_tree", "float32"))
    for arch in ("mixtral_8x7b", "jamba_v0_1_52b"):
        out.append((arch, (2, 2), False, "xla", "float32"))
        out += [(arch, (1, 8), False, "xla", dt) for dt in DTYPES]
    return [(family_key(c),) + c for c in out]


def family_key(case):
    arch, shape, bs, sched, dt = case
    return (f"{arch}/{shape[0]}x{shape[1]}/{'bs' if bs else 'seq'}/{sched}/"
            f"{dt}")


def family_inputs(cfg, structs, start, seed=0):
    """Whole caches ``{"c:<dotted leaf>": float32 array}`` for the cache
    tree ``structs`` (``{dotted leaf: shape}``): every attention
    sublayer's k and v N(0, 1) below ``start`` (all of a rolling buffer),
    each Mamba-2 conv window and state N(0, 1), the encoder memory N(0,
    1); and the tokens of the three steps (steps, B, 1)."""
    rng = np.random.default_rng(seed + 2)
    out = {}
    for name, shape in sorted(structs.items()):
        a = rng.standard_normal(shape).astype(np.float32)
        if name.endswith((".k", ".v")):
            fill = min(start, shape[2])
            a[:, :, fill:] = 0
        out[f"c:{name}"] = a
    out["tokens"] = rng.integers(0, cfg.vocab_size,
                                 (SERVE_STEPS, SERVE_BATCH, 1)).astype(
                                     np.int32)
    return out


#: (mesh shape, batch_shardable) of the sublayer pieces; mixtral and
#: jamba also run on (1, 8) ("etp")
PIECE_MESHES = (((1, 4), False), ((2, 2), True))


def piece_parts(pattern):
    """``(sublayer index, "mixer" or "ffn", kind)`` of the first sublayer
    of each kind in a block's pattern."""
    seen, out = set(), []
    for j, (mixer, ffn) in enumerate(pattern):
        for part, kind in (("mixer", mixer), ("ffn", ffn)):
            if kind and kind not in seen:
                seen.add(kind)
                out.append((j, part, kind))
    return out


def piece_cases(patterns):
    """``(key, arch, shape, batch_shardable, j, part, kind)`` of every
    family's sublayer kinds on ``PIECE_MESHES`` (and (1, 8) for mixtral
    and jamba); ``patterns`` maps an arch to its smoke pattern."""
    out = []
    for arch in FAMILY_ARCHES:
        meshes = PIECE_MESHES + ((((1, 8), False),) if arch in (
            "mixtral_8x7b", "jamba_v0_1_52b") else ())
        for (shape, bs) in meshes:
            for j, part, kind in piece_parts(patterns[arch]):
                key = (f"{arch}/{shape[0]}x{shape[1]}/{'bs' if bs else 'seq'}"
                       f"/sub{j}/{kind}")
                out.append((key, arch, shape, bs, j, part, kind))
    return out


#: the families whose float32 reassociation over ranks is held apart from
#: the arithmetic: their serve step in float64 on ``PIECE_MESHES``
FLOAT64_ARCHES = ("jamba_v0_1_52b", "whisper_medium")


def float64_cases():
    """``(key, arch, shape, batch_shardable)`` of the float64 serve runs."""
    return [(family_key((arch, shape, bs, "xla", "float64")), arch, shape, bs)
            for arch in FLOAT64_ARCHES for shape, bs in PIECE_MESHES]


#: wrong versions of the split Mamba-2 step a test must tell apart from
#: it: the gated norm over the rank's channels alone, and the conv
#: window's new column written from the rank's channels alone
SSM_MUTANTS = ("per_rank_norm", "rank_channels_conv")


def mutant_cases():
    """``(piece key, mutant)`` of the first Mamba-2 sublayer of mamba2
    and jamba on ``PIECE_MESHES``."""
    return [(f"{arch}/{shape[0]}x{shape[1]}/{'bs' if bs else 'seq'}"
             f"/sub0/mamba", mutant)
            for arch in ("mamba2_370m", "jamba_v0_1_52b")
            for shape, bs in PIECE_MESHES for mutant in SSM_MUTANTS]


# ------------------------------------------------------------ train step

#: the dense and sliding-window families of prefill and training on a mesh
TRAIN_ARCHES = ("granite_3_2b", "llama3_2_3b", "qwen1_5_110b",
                "h2o_danube_3_4b")
#: the 4-rank world's meshes, then the 8-rank world's
TRAIN_MESHES = ((1, 4), (2, 2), (2, 4), (4, 2))
#: the embedding of each arch: the masked lookup psummed over ``model``
#: (llama, qwen1.5: their vocabulary of 256 splits) or the gather
TRAIN_EMBED = {"granite_3_2b": "gather", "llama3_2_3b": "psum",
               "qwen1_5_110b": "psum", "h2o_danube_3_4b": "gather"}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM = 8, 64, 2
#: bf16 prefill: 96 positions take the reference's chunked branch
#: (granite; danube's banded one, 96 a multiple of its window), where its
#: bf16 P is not rounded (ROADMAP queue 3)
BF16_ARCHES, BF16_SEQ = ("granite_3_2b", "h2o_danube_3_4b"), 96


def train_key(arch, shape):
    return f"{arch}/{shape[0]}x{shape[1]}"


def train_cases():
    """``(key, arch, shape, embed_impl)`` of every arch on every mesh."""
    return [(train_key(a, s), a, s, TRAIN_EMBED[a])
            for a in TRAIN_ARCHES for s in TRAIN_MESHES]


def bf16_cases():
    """``(key, arch, shape)`` of the bf16 prefill runs."""
    return [(train_key(a, s), a, s) for a in BF16_ARCHES
            for s in TRAIN_MESHES]


#: wrong versions of the mesh train step the checks must reject: the
#: gradient without the psum over ``model`` of a replicated activation's
#: gradient, the loss over each rank's own mask sum, and microbatches cut
#: from each rank's own rows; each on the cases where it changes a number
TRAIN_MUTANTS = (("no_model_psum", "granite_3_2b/1x4"),
                 ("no_model_psum", "llama3_2_3b/2x2"),
                 ("no_model_psum", "qwen1_5_110b/2x2"),
                 ("own_mask_sum", "granite_3_2b/2x2"),
                 ("own_mask_sum", "qwen1_5_110b/4x2"),
                 ("own_rows_microbatches", "h2o_danube_3_4b/2x2"),
                 ("own_rows_microbatches", "llama3_2_3b/4x2"))


def train_inputs(cfg, seed=0):
    """A train batch (``tokens``, ``targets``, ``loss_mask``) of
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` whose mask is not uniform across rows
    (row r's first 4 r positions and a fifth of the rest masked, so every
    rank's rows weigh differently), and the bf16 prefill's tokens."""
    rng = np.random.default_rng(seed + 3)
    b, s = TRAIN_BATCH, TRAIN_SEQ
    rows = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    mask = (rng.random((b, s)) > 0.2).astype(np.float32)
    for r in range(b):
        mask[r, :4 * r] = 0.0
    return {"tokens": rows[:, :-1], "targets": rows[:, 1:],
            "loss_mask": mask,
            "prefill16": rng.integers(0, cfg.vocab_size,
                                      (b, BF16_SEQ)).astype(np.int32)}


# ------------------------------------------------------------ train step,
# the other families

#: the families of ``tests/test_torch_mesh_train_families.py``
TRAIN_FAMILY_ARCHES = FAMILY_ARCHES
#: the 4-rank world's meshes for every family; the 8-rank world's:
#: mixtral on (1, 8) (its 4 experts in ``"etp"`` mode) and jamba on (2, 4)
TRAIN_FAMILY_MESHES = ((1, 4), (2, 2))
TRAIN_FAMILY_WIDE = (("mixtral_8x7b", (1, 8)), ("jamba_v0_1_52b", (2, 4)))
#: a MoE case whose sequence the model axis does not divide: its MoE
#: sublayers take ``moe_decode``'s body, as the reference's ``moe_apply``
#: chooses
ODD_SEQ_CASE = ("qwen3_moe_235b_a22b", (1, 4), 62)
#: bf16 prefill of one MoE and one SSM configuration, the port on each of
#: ``TRAIN_FAMILY_MESHES`` against the port on one device
BF16_FAMILY_ARCHES = ("mixtral_8x7b", "mamba2_370m")
#: the whole frames' length and the VLM's text length at ``TRAIN_SEQ``
FRAMES = 16


def family_train_key(arch, shape, seq=TRAIN_SEQ):
    return train_key(arch, shape) + ("" if seq == TRAIN_SEQ else f"/s{seq}")


def family_train_cases():
    """``(key, arch, shape, seq)`` of every family on every mesh of its
    world (``TRAIN_SEQ`` positions), and ``ODD_SEQ_CASE``."""
    out = [(a, s, TRAIN_SEQ) for a in TRAIN_FAMILY_ARCHES
           for s in TRAIN_FAMILY_MESHES]
    out += [(a, s, TRAIN_SEQ) for a, s in TRAIN_FAMILY_WIDE]
    out.append(ODD_SEQ_CASE)
    return [(family_train_key(*c),) + c for c in out]


def bf16_family_cases():
    """``(key, arch, shape)`` of the bf16 prefill runs."""
    return [(train_key(a, s), a, s) for a in BF16_FAMILY_ARCHES
            for s in TRAIN_FAMILY_MESHES]


#: wrong versions of the MoE dispatch the checks must reject: the
#: all_to_all return skipped (each rank keeps its own experts' outputs of
#: the rows it received, in its own slots), and ``"ep"`` without the
#: psum over ``model`` of its input's gradient
MOE_MUTANTS = (("no_return", "mixtral_8x7b/1x4"),
               ("no_input_psum", "mixtral_8x7b/1x4"))


class MoEMutant:
    """The collectives module ``coll`` as ``models/moe.py`` sees it under
    the mutant ``name`` of ``MOE_MUTANTS`` (patched in as ``moe.coll``):
    ``no_return`` skips every third ``all_to_all`` (a layer's return,
    after its rows and expert ids), ``no_input_psum`` takes the input
    without ``grad_psum`` (the router's weight, 2-D, keeps it).  Shared
    by the gloo worlds and ``tools/chip_mesh.py``'s four-card gate."""

    def __init__(self, name, coll):
        self.name, self.coll, self.calls = name, coll, 0

    def __getattr__(self, name):
        return getattr(self.coll, name)

    def all_to_all(self, x, *args):
        self.calls += 1
        if self.name == "no_return" and self.calls % 3 == 0:
            return x
        return self.coll.all_to_all(x, *args)

    def grad_psum(self, x, mesh, axes):
        if self.name == "no_input_psum" and getattr(x, "dim", int)() == 3:
            return x
        return self.coll.grad_psum(x, mesh, axes)


def family_train_inputs(cfg, seq=TRAIN_SEQ, seed=0, batch=TRAIN_BATCH):
    """``train_inputs`` of ``batch`` rows at ``seq`` positions of text
    (``seq - vision_prefix`` for a VLM, whose prefix fills the rest),
    with the encoder-decoder's ``frames`` (B, ``FRAMES``, D) and the
    VLM's ``vision_embed`` (B, prefix, D), N(0, 1) float32."""
    rng = np.random.default_rng(seed + 4)
    b, s = batch, seq - cfg.vision_prefix
    rows = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    mask = (rng.random((b, s)) > 0.2).astype(np.float32)
    for r in range(b):
        mask[r, :4 * r] = 0.0
    out = {"tokens": rows[:, :-1], "targets": rows[:, 1:], "loss_mask": mask,
           "prefill16": rng.integers(0, cfg.vocab_size,
                                     (b, BF16_SEQ)).astype(np.int32)}
    if cfg.enc_layers:
        out["frames"] = rng.standard_normal(
            (b, FRAMES, cfg.d_model)).astype(np.float32)
    if cfg.vision_prefix:
        out["vision_embed"] = rng.standard_normal(
            (b, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
    return out


#: a batch's modality inputs beside the tokens
MODALITIES = ("frames", "vision_embed")
