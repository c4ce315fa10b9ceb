"""Lower LM training/serving steps to the Workload IR.

Everything here is *analytic* config math — no tensors, no kernels:
collective sizes are derived from the ``ArchConfig`` tensor shapes
(the same shapes ``models.model.model_defs`` declares; the parameter
count is cross-checked against ``blocks.count_params`` in
``tests/test_apps.py``) and a ``MeshShape``.  The sizing rules, per
phase (bf16 activations = 2 B/elem, f32 grads = 4 B/elem):

- **tp-allreduce** — every mixer (attn / mamba) and every dense FFN
  sublayer ends in a row-parallel projection whose partial sums are
  all-reduced over the ``model`` axis: one ``(batch, seq, d_model)``
  activation per sublayer unit, doubled for the backward pass in
  training.  MoE FFN sublayers count here only in *etp* mode (experts
  not divisible by the model axis — ``models.moe.expert_mode``);
- **moe-alltoall** — in *ep* mode each MoE sublayer dispatches
  ``top_k`` routed copies of every token and combines them back: an
  all-to-all, lowered as a **unicast fan-mesh** (one GroupOp per
  ordered rank pair — all pairs contend concurrently, which is what an
  a2a does to the fabric).  Per pair per a2a:
  ``tokens/ep * top_k * d_model * 2 / ep`` bytes;
- **pp-boundary** — each microbatch crosses a pipeline cut twice
  (activations fwd, activation-grads bwd): ``micro * seq * d_model *
  2`` bytes per crossing, sharded over the model axis;
- **dp-gradsync** — the optimizer all-reduces f32 gradients of this
  rank's parameter shard across the ``data`` axis:
  ``4 * n_params / (model * pipe)`` bytes;
- **weights** — replica scale-out broadcasts each rank's bf16
  parameter shard: ``2 * n_params / model`` bytes (a *bcast*, Gleam's
  native op);
- **kv-replicate / ckpt-write** — storage-style ``write`` ops sized by
  ``kv_cache_bytes`` / the f32 parameter shard.

Chip placement is linear: chip ``(pipe p, data d, model m)`` maps to
``hosts[(p*data + d)*model + m]`` — model-axis neighbours are adjacent
hosts (the bandwidth-hungriest axis gets the topologically closest
peers, the standard TPU/GPU placement).

The port's own copy of the reference ``apps/collectives_lowering.py``:
the port imports nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.configs.base import ArchConfig
from repro_torch.core.workload import GroupOp, Workload

__all__ = [
    "MeshShape", "default_hosts", "param_count", "kv_cache_bytes",
    "tp_allreduce_bytes", "moe_a2a_pair_bytes", "pp_boundary_bytes",
    "moe_uses_ep", "train_step_workload", "weight_bcast_workload",
    "prefill_comm_bytes", "decode_comm_bytes",
]

BF16 = 2                     # activation / weight bytes per element
F32 = 4                      # gradient / optimizer bytes per element


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Logical chip grid: ``pipe`` stages x ``data`` replicas x
    ``model`` (tensor-parallel) ranks.  Plain data — serializes into
    ``Workload.meta`` so a staged app workload is replayable."""

    data: int = 1
    model: int = 1
    pipe: int = 1

    def __post_init__(self):
        if min(self.data, self.model, self.pipe) < 1:
            raise ValueError(f"mesh axes must be >= 1, got {self}")

    @property
    def n_chips(self) -> int:
        return self.data * self.model * self.pipe

    def host(self, hosts: Sequence[str], p: int, d: int, m: int) -> str:
        return hosts[(p * self.data + d) * self.model + m]

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "MeshShape":
        return cls(**d)


def default_hosts(n: int) -> List[str]:
    """The flat ``h0..h{n-1}`` naming of ``fattree.testbed``."""
    return [f"h{i}" for i in range(n)]


# ------------------------------------------------------ parameter math

def _attn_params(cfg: ArchConfig) -> int:
    """Mirror of ``model._attn_defs`` (+ the sublayer norm)."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    n = d + d * h * hd + 2 * d * kv * hd + h * hd * d
    if cfg.qkv_bias:
        n += h * hd + 2 * kv * hd
    return n


def _ssm_params(cfg: ArchConfig) -> int:
    """Mirror of ``ssm.ssm_defs`` (+ the sublayer norm)."""
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    h = d_in // cfg.ssm_headdim
    n, k = cfg.ssm_state, cfg.ssm_conv
    return (d                               # norm
            + 2 * d * d_in                  # wz, wx
            + 2 * d * n                     # wB, wC
            + d * h + 3 * h                 # wdt, dt_bias, A_log, D
            + k * d_in + 2 * k * n          # conv_x, conv_B, conv_C
            + d_in + d_in * d)              # gnorm, wo


def _ffn_params(cfg: ArchConfig, kind: Optional[str]) -> int:
    """Mirror of ``model._ffn_defs`` / ``moe.moe_defs``."""
    d = cfg.d_model
    if kind is None:
        return 0
    if kind == "mlp":
        return d + 3 * d * cfg.d_ff
    if kind == "moe":
        e, f = cfg.n_experts, cfg.moe_d_ff
        return d + d * e + 3 * e * d * f
    raise ValueError(kind)


def param_count(cfg: ArchConfig) -> int:
    """Total parameters, matching ``count_params(model_defs(cfg))``
    exactly for decoder-only archs (the traffic plane's scope)."""
    if cfg.enc_layers > 0 or cfg.vision_prefix > 0:
        raise ValueError(
            f"{cfg.name}: encoder/vision frontends are outside the "
            "traffic-plane lowering (decoder-only archs only)")
    per_block = 0
    for mixer, ffn in cfg.pattern:
        if mixer == "attn":
            per_block += _attn_params(cfg)
        elif mixer == "mamba":
            per_block += _ssm_params(cfg)
        else:
            raise ValueError(mixer)
        per_block += _ffn_params(cfg, ffn)
    d, v = cfg.d_model, cfg.vocab_size
    return v * d + per_block * cfg.n_blocks + d + d * v


def kv_cache_bytes(cfg: ArchConfig, seq: int) -> int:
    """Decode-state bytes of ONE sequence: bf16 K+V per attention
    sublayer, f32 SSD recurrent state + conv tail per mamba sublayer
    (sequence-length-free — the hybrid archs' point)."""
    attn = mamba = 0
    for mixer, _ in cfg.pattern:
        if mixer == "attn":
            attn += 1
        elif mixer == "mamba":
            mamba += 1
    d_in = cfg.ssm_expand * cfg.d_model
    h = d_in // max(cfg.ssm_headdim, 1)
    per_attn = 2 * seq * cfg.n_kv_heads * cfg.hd * BF16
    per_mamba = (h * cfg.ssm_headdim * cfg.ssm_state
                 + (cfg.ssm_conv - 1) * d_in) * F32
    return (attn * per_attn + mamba * per_mamba) * cfg.n_blocks


# ------------------------------------------------------ collective math

def moe_uses_ep(cfg: ArchConfig, tp: int) -> bool:
    """Expert-parallel iff experts divide the model axis — the planner
    rule (the reference's ``models.moe.expert_mode``, reimplemented
    here)."""
    return bool(cfg.n_experts) and tp > 1 and cfg.n_experts % tp == 0


def _sublayer_units(cfg: ArchConfig, tp: int) -> int:
    """Row-parallel reductions per block: one per mixer, one per dense
    FFN; MoE FFNs reduce via the a2a combine in ep mode."""
    ep = moe_uses_ep(cfg, tp)
    units = 0
    for _, ffn in cfg.pattern:
        units += 1                                  # the mixer
        if ffn is not None and not (ffn == "moe" and ep):
            units += 1
    return units


def _moe_sublayers(cfg: ArchConfig) -> int:
    return sum(1 for _, f in cfg.pattern if f == "moe")


def tp_allreduce_bytes(cfg: ArchConfig, seq: int, batch: int, tp: int,
                       kind: str = "train") -> int:
    """Total activation all-reduce bytes per TP group per step (the
    whole model; divide by ``pipe`` for a stage's share)."""
    act = batch * seq * cfg.d_model * BF16
    passes = 2 if kind == "train" else 1            # bwd grad allreduce
    return _sublayer_units(cfg, tp) * cfg.n_blocks * act * passes


def moe_a2a_pair_bytes(cfg: ArchConfig, seq: int, batch: int, ep: int,
                       kind: str = "train") -> int:
    """Total bytes one ordered rank pair carries per step across every
    MoE sublayer's dispatch+combine (x2 again for the backward)."""
    tokens = batch * seq
    per_a2a = tokens * cfg.top_k * cfg.d_model * BF16 // (ep * ep)
    n_a2a = _moe_sublayers(cfg) * cfg.n_blocks * 2  # dispatch + combine
    if kind == "train":
        n_a2a *= 2
    return per_a2a * n_a2a


def pp_boundary_bytes(cfg: ArchConfig, seq: int, micro_batch: int) -> int:
    """One microbatch's activation tensor at one pipeline cut (one
    direction, full hidden — divide by ``model`` for a rank's shard)."""
    return micro_batch * seq * cfg.d_model * BF16


def prefill_comm_bytes(cfg: ArchConfig, prompt_len: int, tp: int) -> int:
    """TP all-reduce bytes to prefill one request's prompt."""
    return tp_allreduce_bytes(cfg, prompt_len, 1, tp, kind="prefill")


def decode_comm_bytes(cfg: ArchConfig, n_tokens: int, tp: int) -> int:
    """TP all-reduce bytes to decode ``n_tokens`` (one token = one
    seq-1 activation; aggregated so a request is one GroupOp)."""
    return tp_allreduce_bytes(cfg, 1, n_tokens, tp, kind="decode")


# ----------------------------------------------------------- workloads

def train_step_workload(cfg: ArchConfig, mesh: MeshShape,
                        hosts: Optional[Sequence[str]] = None, *,
                        seq: int, batch: int, accum: int = 1,
                        transport: str = "gleam", chunks: int = 8,
                        include_ckpt: bool = False) -> Workload:
    """One training step as a phased ``Workload``.

    Phase order (each phase is barrier-separated in the application;
    ``apps.metrics.step_time`` sums phase maxima): tp-allreduce,
    moe-alltoall, pp-boundary, dp-gradsync[, ckpt-write].
    """
    if hosts is None:
        hosts = default_hosts(mesh.n_chips)
    if len(hosts) < mesh.n_chips:
        raise ValueError(f"need {mesh.n_chips} hosts, got {len(hosts)}")
    if batch % (mesh.data * max(accum, 1)) != 0:
        raise ValueError(
            f"batch {batch} not divisible by data {mesh.data} x "
            f"accum {accum}")
    if mesh.pipe > 1 and cfg.n_blocks % mesh.pipe != 0:
        raise ValueError(
            f"{cfg.name}: n_blocks {cfg.n_blocks} not divisible by "
            f"pipe {mesh.pipe}")
    b_shard = batch // mesh.data
    micro = b_shard // max(accum, 1)
    tp, dp, pp = mesh.model, mesh.data, mesh.pipe
    n_params = param_count(cfg)
    wl = Workload(
        f"{cfg.name}/train/{transport}",
        meta={"model": cfg.name, "mesh": mesh.to_dict(), "seq": seq,
              "batch": batch, "accum": accum, "kind": "train",
              "transport": transport})
    kw = dict(transport=transport, chunks=chunks)

    if tp > 1:
        nb = tp_allreduce_bytes(cfg, seq, b_shard, tp) // pp
        for p in range(pp):
            for d in range(dp):
                group = [mesh.host(hosts, p, d, m) for m in range(tp)]
                wl.allreduce(group, nb, phase="tp-allreduce", **kw)

    if moe_uses_ep(cfg, tp):
        nb = moe_a2a_pair_bytes(cfg, seq, b_shard, tp) // pp
        for p in range(pp):
            for d in range(dp):
                group = [mesh.host(hosts, p, d, m) for m in range(tp)]
                for src in group:
                    for dst in group:
                        if src != dst:
                            wl.unicast(src, dst, nb,
                                       phase="moe-alltoall")

    if pp > 1:
        # accum microbatches cross each cut fwd + bwd, per TP shard
        nb = pp_boundary_bytes(cfg, seq, micro) * accum * 2 // tp
        for p in range(pp - 1):
            for d in range(dp):
                for m in range(tp):
                    wl.unicast(mesh.host(hosts, p, d, m),
                               mesh.host(hosts, p + 1, d, m), nb,
                               phase="pp-boundary")

    if dp > 1:
        nb = F32 * n_params // (tp * pp)
        for p in range(pp):
            for m in range(tp):
                group = [mesh.host(hosts, p, d, m) for d in range(dp)]
                wl.allreduce(group, nb, phase="dp-gradsync", **kw)

    if include_ckpt and dp > 1:
        # rank (0, 0, m) snapshots its f32 shard to its data peers
        nb = F32 * n_params // (tp * pp)
        for m in range(tp):
            group = [mesh.host(hosts, 0, d, m) for d in range(dp)]
            wl.write(group, nb, phase="ckpt-write", **kw)

    if not wl.ops:
        raise ValueError(
            f"mesh {mesh} has a single chip: no fabric traffic to lower")
    return wl


def weight_bcast_workload(cfg: ArchConfig, n_replicas: int, tp: int,
                          hosts: Optional[Sequence[str]] = None, *,
                          transport: str = "gleam",
                          chunks: int = 8) -> Workload:
    """Replica scale-out: each TP rank's bf16 weight shard broadcasts
    from replica 0 to every other replica (Gleam's native one-to-many;
    serving layout ``hosts[replica * tp + rank]``)."""
    if n_replicas < 2:
        raise ValueError("weight broadcast needs >= 2 replicas")
    if hosts is None:
        hosts = default_hosts(n_replicas * tp)
    nb = BF16 * param_count(cfg) // tp
    wl = Workload(
        f"{cfg.name}/weights/{transport}",
        meta={"model": cfg.name, "replicas": n_replicas, "tp": tp,
              "kind": "weights", "transport": transport})
    for m in range(tp):
        members = [hosts[r * tp + m] for r in range(n_replicas)]
        wl.bcast(members, nb, phase="weights", transport=transport,
                 chunks=chunks)
    return wl
