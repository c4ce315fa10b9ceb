"""Step functions of the port: train and prefill.

The port of the reference package's ``launch/steps.py``.

- ``make_train_step(cfg, opt_cfg, accum_steps, mesh=)`` returns
  ``train_step(params, opt_state, batch)``: the gradient of
  ``models.model.loss_fn`` summed in float32 over ``accum_steps``
  microbatches and divided by their number, then one AdamW step
  (``optim/adamw.apply``), as the reference's.  Every attention layer
  runs the flash-attention kernel forward and every Mamba-2 layer the
  SSD-scan kernel (twice where the block is rematerialised), their
  backwards plain PyTorch (``kernels/ref.py``).
- ``batch_structs(cfg, seq, batch, train=)`` gives the shape and dtype
  of every entry of a batch, as the reference's does: tokens (and
  targets and loss mask) of ``seq - vision_prefix`` positions, the VLM's
  ``vision_embed`` and the encoder-decoder's ``frames``.
- ``make_prefill_step(cfg, mesh=)`` returns ``prefill_step(params, batch)``,
  which runs ``forward_hidden`` over the whole prompt under
  ``torch.no_grad()`` and gives only the last position's logits, which
  is what serving needs to start decoding (a (B, S, V) logits buffer
  would be pointless).
- On a ``mesh`` of ranks both run SPMD, each rank on its blocks of the
  parameters (and moments) and its rows of the batch, as the reference's
  GSPMD steps place them (``train_accum``, ``microbatches``,
  ``sync_grads``); a (1, 1) mesh is the one-device step bit for bit.

- ``make_serve_step(cfg, mesh, batch_shardable)`` returns
  ``serve_step(params, caches, tokens, step)``: one ``decode_forward``
  on ``mesh`` (``launch/mesh.Mesh``), every tensor this rank's block,
  for every configuration.  ``serve_plan`` is the reference's decode
  plan choice: pure tensor parallelism (``INFERENCE_RULES``) when the
  bf16 parameters (all the experts of a MoE) over the model axis fit
  the memory budget, else ``DEFAULT_RULES`` (FSDP gathers a step); the
  step carries it (``serve_step.plan``) so that callers shard the
  parameters as it reads them.
- ``input_specs(cfg, shape_name, mesh)`` gives the shape and dtype of
  this rank's block of every input of a cell's step, without
  allocating anything.

Every configuration trains and prefills on a mesh: the batch's
``frames`` (an encoder-decoder's) and ``vision_embed`` (a VLM's) are
split over the batch axes like the tokens and cut into microbatches with
them (``microbatches``), and ``sync_grads`` sums the gradients of the
encoder's, the vision projection's, the experts' and the Mamba-2
layers' leaves like any other.

The dry run's lowering: ``lowering_spec(cfg, shape_name, mesh)`` gives
a cell's step on ``mesh`` (rank 0 of a fake world,
``launch/mesh.fake_world``) and its arguments as fake tensors of this
rank's blocks (``input_specs``); ``lower_cell`` runs that step once
under ``FakeTensorMode`` and counts what it would do on the card: the
products' FLOPs, the bytes every op and kernel moves, the collectives'
bytes by kind and link, the kernel calls, and the peak of live bytes
(``trace``).  Where the reference lowers and compiles through XLA, the
port traces eagerly: every layer and microbatch runs, so the counts are
those of the whole step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import trace
from repro_torch.configs.base import ArchConfig
from repro_torch.core import collectives as coll
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.launch.roofline import link
from repro_torch.models import model as mdl
from repro_torch.models.blocks import (count_params, param_specs,
                                       tree_leaves, tree_map)
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import (DEFAULT_RULES, INFERENCE_RULES,
                                           ShardingPlan, block_shape)

#: the reference's (arch x shape) cells, as data: sequence, batch and
#: step kind of each
SHAPE_TABLE = {
    "train_4k": dict(seq=4096, batch=256, kind="train", accum=8),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}


class TensorSpec(NamedTuple):
    """The shape and dtype of a batch entry (the reference's
    ``ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def batch_structs(cfg: ArchConfig, seq: int, batch: int, *,
                  train: bool) -> dict:
    """``{name: TensorSpec}`` of a batch of ``batch`` sequences of ``seq``
    positions: ``tokens`` (int32) of ``seq - vision_prefix`` positions,
    with ``targets`` (int32) and ``loss_mask`` (float32) of the same shape
    when ``train``; ``vision_embed`` (batch, vision_prefix, d_model) bf16
    for a VLM and ``frames`` (batch, max(seq // audio_stride, 8),
    d_model) bf16 for an encoder-decoder.  The reference's
    ``batch_structs``, as shapes and dtypes."""
    s_text = seq - cfg.vision_prefix if cfg.vision_prefix else seq
    out = {"tokens": TensorSpec((batch, s_text), torch.int32)}
    if train:
        out["targets"] = TensorSpec((batch, s_text), torch.int32)
        out["loss_mask"] = TensorSpec((batch, s_text), torch.float32)
    if cfg.vision_prefix:
        out["vision_embed"] = TensorSpec(
            (batch, cfg.vision_prefix, cfg.d_model), torch.bfloat16)
    if cfg.enc_layers > 0:
        enc_len = max(seq // max(cfg.audio_stride, 1), 8)
        out["frames"] = TensorSpec((batch, enc_len, cfg.d_model),
                                   torch.bfloat16)
    return out


def make_prefill_step(cfg: ArchConfig, *, mesh=None, device="cuda"):
    """``prefill_step(params, batch) -> (B, 1, V) f32`` logits of the
    last prompt position.  ``params`` is ``Model.params`` on ``device``
    (``cuda`` by default, which needs a card); ``batch["tokens"]`` is a
    (B, S) integer array or tensor, with ``vision_embed`` (B,
    vision_prefix, D) for a VLM and ``frames`` (B, F, D) for an
    encoder-decoder (``models/model.forward_hidden``).

    On a ``mesh`` the step runs on the rank's device: ``params`` are this
    rank's blocks under ``models/model.train_specs`` (the reference's
    prefill plan, ``DEFAULT_RULES``), the batch and the logits the rank's
    rows (split over the batch axes), the logits whole over the
    vocabulary (all-gathered over ``model`` where ``lm_head`` splits).  A
    (1, 1) mesh is the one-device step."""
    dev = mdl._forward_device(mesh, device)
    specs = mdl.train_specs(cfg, mesh)

    @torch.no_grad()
    def prefill_step(params, batch):
        x, _ = mdl.forward_hidden(params, batch, cfg, mesh=mesh, device=dev)
        cd = getattr(torch, cfg.compute_dtype)
        last = x[:, -1:]
        logits = torch.einsum("bsd,dv->bsv", last.to(cd), mdl._weight(
            params, "lm_head", cd, specs, mesh))
        logits = coll.all_gather(logits, mesh,
                                 mdl._axes(specs, "lm_head", 1), 2)
        return logits.float()

    return prefill_step


def _leaf(p, g):
    t = p.detach().requires_grad_()
    t.grad = g
    return t


#: the stacked parameter trees: each becomes a list of per-layer trees
STACKED = ("blocks", "enc_blocks")


def grad_leaves(params, grads):
    """A tree like ``params`` whose tensors are autograd leaves sharing
    the parameters' storage, each with its ``.grad`` set to the matching
    slice of ``grads``, so that a ``backward()`` ADDS the gradient there.
    The stacked ``blocks`` (and an encoder's ``enc_blocks``) become lists
    of per-layer trees whose leaves are the layers' slices (a form
    ``models/model.block_layers`` takes): autograd through ``a[i]`` of a
    stacked parameter would give every layer a full-size (n_layers, ...)
    zero tensor to add."""
    tree = {k: tree_map(_leaf, v, grads[k]) for k, v in params.items()
            if k not in STACKED}
    for key in STACKED:
        if key in params:
            n = len(next(tree_leaves(params[key]))[1])
            tree[key] = [tree_map(lambda p, g: _leaf(p[i], g[i]),
                                  params[key], grads[key])
                         for i in range(n)]
    return tree


def accumulate_grads(params, batch, cfg, grads, *, mesh=None,
                     device="cuda"):
    """``loss_fn(params, batch)``'s metrics, its gradient added into
    ``grads`` (float32 tensors shaped like ``params``; on a ``mesh`` the
    rank's blocks, each holding the part of this rank's rows, summed over
    the ranks whose FSDP gather it went through).  The forward is
    the profiler range ``train_step.forward``; the backward (remat
    recompute included) runs on autograd's device thread, outside any
    range opened here."""
    with torch.profiler.record_function("train_step.forward"):
        total, metrics = mdl.loss_fn(grad_leaves(params, grads), batch,
                                     cfg, mesh=mesh, device=device)
    total.backward()
    return metrics


def train_accum(accum: int, batch: int, mesh) -> int:
    """``accum`` for a global batch of ``batch`` rows, as the reference
    takes it: a batch it does not divide raises (its ``make_train_step``
    reshapes the batch to (accum, B / accum)), and it is clamped, as its
    ``lowering_spec`` clamps it, to at most the rows a rank of the batch
    axes holds, so that every microbatch still splits over those axes
    (``mesh`` None: one rank).  A clamped ``accum`` divides ``batch``."""
    if batch % accum:
        raise ValueError(f"batch {batch} is not a multiple of accum_steps "
                         f"{accum}")
    ways = math.prod(mesh.shape[a] for a in mdl._batch_axes(mesh))
    max_accum = max(batch // ways, 1) if batch % ways == 0 else batch
    return min(accum, max_accum)


def microbatches(batch, accum: int, mesh):
    """This rank's rows of each of ``accum`` microbatches, the
    reference's: its ``make_train_step`` reshapes the GLOBAL batch to
    (accum, B / accum), so microbatch i is global rows ``[i B / accum,
    (i + 1) B / accum)``, split over the batch axes.  ``batch`` holds
    this rank's block of the global rows (``input_specs``); with more
    than one microbatch and batch axes of more than one rank, the blocks
    are all-gathered over them (integers and the mask, a few hundred KB)
    and each microbatch's block of this rank cut from the whole.  With no
    such axes (``mesh`` None or a (1, 1) mesh) the rows are the batch's
    own, sliced as given."""
    axes = mdl._batch_axes(mesh)
    if accum <= 1:
        return [batch]
    whole = {k: coll.all_gather(torch.as_tensor(v).to(mesh.device), mesh,
                                axes, 0) for k, v in batch.items()} \
        if axes else batch
    rows = len(whole["tokens"])
    index, count = shd.block(mesh, axes)
    mb = rows // accum
    if mb % count:
        raise ValueError(f"a microbatch of {mb} rows does not split over "
                         f"the {count} ranks of the batch axes")
    n = mb // count
    return [{k: v[i * mb + index * n:i * mb + (index + 1) * n]
             for k, v in whole.items()} for i in range(accum)]


def sync_grads(grads, specs, mesh) -> None:
    """All-reduce IN PLACE, over every batch axis of more than one rank
    that does not split it, the gradient of each leaf: one a rank's rows
    gave (the norm scales, and every leaf the plan does not split over
    those axes).  A leaf split over a batch axis got its sum over that
    axis from its FSDP gather's reduce-scatter; a leaf's ``model`` blocks
    keep their own gradients.  With no such axes (``mesh`` None or a
    (1, 1) mesh) nothing is reduced."""
    rows = mdl._batch_axes(mesh)
    if not rows:
        return
    for (_, g), (_, sp) in zip(tree_leaves(grads), tree_leaves(specs)):
        split = {a for d in range(g.dim()) for a in shd.entry_axes(sp, d)}
        coll.psum_(g, mesh, tuple(a for a in rows if a not in split))


def make_train_step(cfg: ArchConfig, opt_cfg=None, accum_steps: int = 1, *,
                    mesh=None, device="cuda"):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``params`` is ``Model.params`` (or any tree of float32
    tensors in its layout) on ``device`` (``cuda`` by default, which
    needs a card), ``opt_state`` ``adamw.init(params)``; ``batch`` holds
    ``tokens``, ``targets`` and ``loss_mask`` (B, S) arrays or tensors,
    with ``vision_embed`` or ``frames`` where the model takes them
    (``batch_structs``), B a multiple of ``accum_steps``, which is
    clamped to the rows a rank holds (``train_accum``).  Microbatch i
    takes rows ``i * B / accum`` onward of every entry, as the
    reference's reshape does (``microbatches``).
    Parameters and moments are updated in place and returned (at
    granite_3_2b's width each is 10.5 GB); metrics are ``loss``,
    ``aux_loss``, ``perplexity`` (over the microbatches' mean loss),
    ``grad_norm`` and ``lr``.

    On a ``mesh`` of more than one rank the step runs SPMD on the rank's
    device (``mesh.device``), each rank on its own blocks: ``params`` and
    both moments under ``models/model.train_specs`` (``DEFAULT_RULES``,
    the reference's train plan; ``blocks.shard_params``), ``batch`` the
    rank's block of the global rows (``input_specs``), and B above the
    global batch.  Each rank differentiates the loss of the whole batch
    through its rows; the FSDP gathers' reduce-scatters and
    ``sync_grads`` sum the parts, ``adamw.apply`` takes the norm of the
    blocks over the mesh and updates each rank's blocks.  The metrics are
    the same on every rank.  ``mesh`` None and a (1, 1) mesh run the same
    code, every collective on an axis of one rank a no-op."""
    dev = mdl._forward_device(mesh, device)
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    specs = mdl.train_specs(cfg, mesh)
    ways = math.prod(mesh.shape[a] for a in mdl._batch_axes(mesh))

    def train_step(params, opt_state, batch):
        rows = len(batch["tokens"]) * ways
        parts = microbatches(batch, train_accum(accum_steps, rows, mesh),
                             mesh)
        # float32 gradients (float64 for float64 parameters: the tests'
        # exact evaluation)
        grads = tree_map(lambda p: torch.zeros_like(
            p, dtype=torch.promote_types(p.dtype, torch.float32)), params)
        if len(parts) == 1:
            metrics = accumulate_grads(params, parts[0], cfg, grads,
                                       mesh=mesh, device=dev)
        else:
            lsum = asum = torch.zeros((), dtype=torch.float32, device=dev)
            for part in parts:
                m = accumulate_grads(params, part, cfg, grads, mesh=mesh,
                                     device=dev)
                lsum, asum = lsum + m["loss"], asum + m["aux_loss"]
            tree_map(lambda g: g.div_(len(parts)), grads)
            loss = lsum / len(parts)
            metrics = {"loss": loss, "aux_loss": asum / len(parts),
                       "perplexity": torch.exp(torch.clamp(loss, max=20.0))}
        with torch.profiler.record_function("train_step.grad_sync"):
            sync_grads(grads, specs, mesh)
        with torch.profiler.record_function("train_step.adamw"):
            params, opt_state, opt_metrics = adamw.apply(
                opt_cfg, params, opt_state, grads, mesh=mesh, specs=specs)
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step


# ---------------------------------------------------------------- serve

#: The share of one card's memory the bf16 parameters of one model-axis
#: shard may take before the decode plan falls back to FSDP sharding: the
#: reference allows 8e9 bytes of a 16 GB accelerator, a half.
DECODE_WEIGHT_SHARE = 0.5
#: The memory of the card the port is built for, which sizes the budget
#: where the mesh is abstract or on the CPU (the dry run's fake world):
#: what ``torch.cuda.get_device_properties(0).total_memory`` reports on
#: an NVIDIA H100 80GB HBM3.
CARD_BYTES = 85_017_493_504


def decode_budget(mesh) -> float:
    """Bytes of bf16 parameters one model-axis shard may hold under the
    pure tensor-parallel plan: ``DECODE_WEIGHT_SHARE`` of the memory
    ``torch.cuda.get_device_properties`` reports for the mesh's card, of
    ``CARD_BYTES`` off the card, so that a dry run picks the plan a run
    on the card would."""
    dev = getattr(mesh, "device", None)
    total = (torch.cuda.get_device_properties(dev).total_memory
             if dev is not None and dev.type == "cuda" else CARD_BYTES)
    return DECODE_WEIGHT_SHARE * total


def serve_plan(cfg: ArchConfig, mesh):
    """``(cfg, plan)`` of the decode step, the reference's choice: when
    the bf16 parameters over the model-axis size fit ``decode_budget``,
    the inference plan (weights replicated over the batch axes, no
    per-step gathers) and ``fsdp_weights`` off; else the default plan
    (FSDP over the batch axes, its weights gathered every step)."""
    n_params = count_params(mdl.model_defs(cfg))
    if n_params * 2 / mesh.shape["model"] <= decode_budget(mesh):
        return (cfg.replace(fsdp_weights=False),
                ShardingPlan(mesh, rules=INFERENCE_RULES))
    return cfg, ShardingPlan(mesh, rules=DEFAULT_RULES)


def make_serve_step(cfg: ArchConfig, mesh, batch_shardable: bool):
    """``serve_step(params, caches, tokens, step) -> (logits, caches)``:
    one decode step on ``mesh``'s rank (its device), through
    ``models/model.decode_forward``.  The parameters are this rank's
    blocks under ``serve_step.plan`` (``blocks.shard_params`` /
    ``init_sharded_params``), bf16 as the reference's decode lowering
    takes them; the caches from ``init_caches(mesh=, batch_shardable=)``.
    Every configuration decodes on any mesh: dense, sliding-window, MoE
    (experts over ``model``, ``models/moe.expert_mode``), Mamba-2 and the
    hybrid (heads over ``model``), the encoder-decoder (its memory a
    cache leaf) and the VLM (a dense decoder once its prefix is
    cached)."""
    cfg, plan = serve_plan(cfg, mesh)

    def serve_step(params, caches, tokens, step):
        return mdl.decode_forward(params, caches, tokens, step, cfg,
                                  mesh=mesh, batch_shardable=batch_shardable,
                                  plan=plan, device=mesh.device)

    serve_step.cfg, serve_step.plan = cfg, plan
    return serve_step


def batch_shardable(mesh, batch: int) -> bool:
    """Whether ``batch`` rows split over the mesh's batch axes (of more
    than one rank in all)."""
    n = 1
    for a in mdl.BATCH_AXES:
        if a in mesh.axis_names:
            n *= mesh.shape[a]
    return batch % n == 0 and n > 1


def _blocks(structs, specs, mesh):
    return tree_map(lambda ts, sp: TensorSpec(
        block_shape(ts.shape, sp, mesh), ts.dtype), structs, specs)


def input_specs(cfg: ArchConfig, shape_name: str, mesh=None, *,
                table=None) -> tuple:
    """The shape and dtype of this rank's block of every input of the
    cell's step (``TensorSpec`` trees), the reference's ``input_specs``
    with the reference's shardings applied, nothing allocated: ``(params,
    opt_state, batch)`` for a train cell (float32 parameters and AdamW
    moments), ``(params, batch)`` for prefill, ``(params, caches, tokens,
    step)`` for decode (bf16 parameters under ``serve_plan``, or the
    cell's ``param_dtype``; bf16 caches under
    ``models/model.cache_specs``).  ``mesh`` (an abstract one will do)
    defaults to (1, 1); ``table`` (``SHAPE_TABLE`` by default) holds the
    cell."""
    mesh = mesh or abstract_mesh((1, 1), ("data", "model"))
    info = (SHAPE_TABLE if table is None else table)[shape_name]
    seq, batch, kind = info["seq"], info["batch"], info["kind"]
    defs = mdl.model_defs(cfg)
    bspec = mdl._bspec(mesh)

    def params(dtype, plan):
        return _blocks(tree_map(lambda d: TensorSpec(d.shape, dtype), defs),
                       param_specs(defs, plan), mesh)

    def batch_blocks(structs):
        return {k: TensorSpec(block_shape(
            v.shape, (bspec,) + (None,) * (len(v.shape) - 1), mesh), v.dtype)
            for k, v in structs.items()}
    if kind == "train":
        p = params(torch.float32, ShardingPlan(mesh))
        opt = {"m": p, "v": p, "step": TensorSpec((), torch.int32)}
        return p, opt, batch_blocks(batch_structs(cfg, seq, batch,
                                                  train=True))
    if kind == "prefill":
        return (params(torch.float32, ShardingPlan(mesh)),
                batch_blocks(batch_structs(cfg, seq, batch, train=False)))
    cfg, plan = serve_plan(cfg, mesh)
    shardable = batch_shardable(mesh, batch)
    caches = mdl._map_structs(
        lambda sd, sp: TensorSpec(block_shape(sd[0], sp, mesh), sd[1]),
        mdl.cache_structs(cfg, batch, seq),
        mdl.cache_specs(cfg, batch, seq, mesh, shardable))
    tokens = TensorSpec(block_shape(
        (batch, 1), (bspec if shardable else None, None), mesh), torch.int32)
    return (params(info.get("param_dtype", torch.bfloat16), plan), caches,
            tokens, TensorSpec((), torch.int32))


# ---------------------------------------------------------------- dry run

@dataclasses.dataclass
class LoweringSpec:
    """Everything the dry run's trace needs for one (arch x shape x mesh)
    cell: the step, its arguments (fake tensors of this rank's blocks,
    made in ``mode``; a decode step's position a host integer), the
    parameter count, the step's kind, its microbatches, and the bytes of
    its arguments (``input_specs``' sum, the decode position an int32)."""
    fn: Any
    args: tuple
    mode: FakeTensorMode
    n_params: int
    kind: str
    accum: int
    argument_bytes: int


def shape_runnable(cfg: ArchConfig, shape_name: str) -> tuple[bool, str]:
    """long_500k needs sub-quadratic attention (the reference's rule)."""
    if shape_name == "long_500k" and not cfg.is_subquadratic:
        return False, ("pure full-attention arch: long_500k skipped "
                       "(DESIGN.md §3)")
    return True, ""


def cell_accum(cfg: ArchConfig, info: dict, mesh) -> int:
    """A train cell's microbatches, the reference's clamp: ``accum_steps``
    of the config, else the cell's (``info``, a ``SHAPE_TABLE`` entry),
    at most the rows a rank of the batch axes holds (so that every
    microbatch still splits over them), lowered until it divides the
    batch."""
    batch = info["batch"]
    accum = cfg.accum_steps or info.get("accum", 1)
    ways = math.prod(mesh.shape[a] for a in mdl.BATCH_AXES
                     if a in mesh.axis_names)
    max_accum = max(batch // ways, 1) if batch % ways == 0 else batch
    accum = min(accum, max_accum, batch)
    while batch % accum:
        accum -= 1
    return accum


def spec_bytes(tree) -> int:
    """The bytes of a tree of ``TensorSpec``s."""
    if isinstance(tree, TensorSpec):
        return math.prod(tree.shape) * tree.dtype.itemsize
    return sum(spec_bytes(v) for v in tree.values())


def fake_tensors(tree, device):
    """Empty tensors shaped by a tree of ``TensorSpec``s on ``device``:
    fake ones under a ``FakeTensorMode``."""
    if isinstance(tree, TensorSpec):
        return torch.empty(tree.shape, dtype=tree.dtype, device=device)
    return {k: fake_tensors(v, device) for k, v in tree.items()}


def lowering_spec(cfg: ArchConfig, shape_name: str, mesh, *,
                  table=None) -> LoweringSpec:
    """The cell's step on ``mesh`` (this rank's: ``make_train_step`` with
    the clamped ``accum`` (``cell_accum``), ``make_prefill_step`` or
    ``make_serve_step``) and its arguments as fake tensors on the mesh's
    device, shaped by ``input_specs``.  A decode step decodes at the
    cache's last position (``seq - 1``), one new token against a full
    cache, as the reference's cell does.  ``table`` (``SHAPE_TABLE`` by
    default) holds the cell."""
    info = (SHAPE_TABLE if table is None else table)[shape_name]
    seq, batch, kind = info["seq"], info["batch"], info["kind"]
    n_params = count_params(mdl.model_defs(cfg))
    specs = input_specs(cfg, shape_name, mesh, table=table)
    mode = FakeTensorMode()
    accum = 1
    with mode:
        if kind == "train":
            accum = cell_accum(cfg, info, mesh)
            fn = make_train_step(cfg, accum_steps=accum, mesh=mesh)
            args = tuple(fake_tensors(t, mesh.device) for t in specs)
        elif kind == "prefill":
            fn = make_prefill_step(cfg, mesh=mesh)
            args = tuple(fake_tensors(t, mesh.device) for t in specs)
        else:
            fn = make_serve_step(cfg, mesh, batch_shardable(mesh, batch))
            args = tuple(fake_tensors(t, mesh.device)
                         for t in specs[:3]) + (seq - 1,)
    return LoweringSpec(fn=fn, args=args, mode=mode, n_params=n_params,
                        kind=kind, accum=accum,
                        argument_bytes=sum(spec_bytes(t) for t in specs))


def lower_cell(cfg: ArchConfig, shape_name: str, mesh, *, table=None):
    """``(counts, spec)``: the cell's step (``lowering_spec``) run once on
    its fake arguments, and what it did on this rank:

    - ``flops``: the products' FLOPs (``aten_flops``, by
      ``FlopCounterMode``'s registry) plus the kernels' operations;
    - ``bytes``: what every aten op and kernel reads and writes
      (``trace.Tally``, ``kernels/*.cost``);
    - ``collectives``: one entry per (kind, group): its ranks, ``link``
      (``roofline.link``), calls and bytes;
    - ``kernels``: ``{name: {"calls", "ops", "bytes"}}``;
    - ``argument_bytes`` and ``peak_bytes`` (the most fake storage alive
      at once, the arguments included).

    A trace allocates nothing and launches nothing, so it needs no card.
    """
    spec = lowering_spec(cfg, shape_name, mesh, table=table)
    with spec.mode, trace.counting() as counts, \
            trace.Tally(spec.args) as tally:
        spec.fn(*spec.args)
    kernels = {name: {"calls": c, "ops": o, "bytes": b}
               for name, (c, o, b) in sorted(counts.kernels.items())}
    return {
        "flops": tally.flops + sum(k["ops"] for k in kernels.values()),
        "aten_flops": tally.flops,
        "bytes": tally.bytes + sum(k["bytes"] for k in kernels.values()),
        "collectives": [
            {"kind": kind, "ranks": list(ranks), "link": link(ranks),
             "calls": c, "bytes": b}
            for (kind, ranks), (c, b) in sorted(counts.collectives.items())],
        "kernels": kernels,
        "argument_bytes": spec.argument_bytes,
        "peak_bytes": tally.peak,
    }, spec
