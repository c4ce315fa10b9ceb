"""Roofline terms of a dry run's trace, at the H100's peaks.

The port of the reference package's ``launch/roofline.py``.  Three
terms per (arch x shape x mesh) cell, each in seconds a step on one
rank:

    compute    = FLOPs a rank / PEAK_FLOPS[compute dtype]  (989e12 bf16)
    memory     = bytes a rank / HBM_BW                     (3.35e12 B/s)
    collective = each collective's bytes / its link's rate

The peaks are the NVIDIA H100 SXM datasheet's, stated as such, not
measured: bf16 dense on the tensor cores, float32 and float64 outside
them; HBM3; NVLink 4 within a node of ``NODE_CARDS`` cards; one 400 Gb/s
NDR InfiniBand port a card across nodes.

The counts come from the trace of the rank's step
(``launch/steps.lower_cell``), not from XLA's cost analysis: FLOPs are
the products aten runs (``torch.utils.flop_counter``) plus each
kernel's operations (``kernels/*.cost``); bytes are what every aten op
and kernel reads and writes; collective bytes are the results of
``core/collectives``' calls by kind, as the reference's HLO parse
counts result-shape bytes.  No HLO is parsed, so the reference's
``collective_bytes(hlo_text)`` has no counterpart here:
``trace.collective`` takes its place.

The reference's one ``LINK_BW`` becomes a rate a collective
(``link``): a group whose ranks all lie in one node (global rank // 8,
ranks in row-major mesh order) moves at ``NVLINK_BW``, any other at
``IB_BW``.  On the 16 x 16 pod a ``model`` line is 16 consecutive
ranks, so it spans two nodes and its collectives are charged at
InfiniBand; a ``data`` line (stride 16) spans 16 nodes.

``model_flops`` is the reference's 6 N D for training
(2 N D prefill, 2 N a token decode), N the active parameters of a MoE,
over the chips.  ``train_step_flops`` is the count ``chip_smoke.py``'s
and ``tools/chip_mesh.py``'s ``mfu`` divide by: the weights each
position passes and the attention pairs or SSD products it computes.
``path_launches`` and ``train_launches`` are the kernel calls a step
makes.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.flash_attention import attn_pairs
from repro_torch.kernels.ssd_scan import ssd_ops
from repro_torch.models import moe as moe_mod
from repro_torch.models.blocks import count_params
from repro_torch.models.model import model_defs
from repro_torch.models.ssm import ssm_dims

#: FLOP/s by the dtype of a product's inputs (H100 SXM datasheet):
#: bf16 dense on the tensor cores, float32 and float64 outside them
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.float64: 34e12}
#: HBM3 bytes/s a card (datasheet)
HBM_BW = 3.35e12
#: NVLink 4 bytes/s a direction a card, between the cards of a node
NVLINK_BW = 450e9
#: InfiniBand bytes/s a card across nodes (one 400 Gb/s NDR port)
IB_BW = 50e9
#: cards a node (an HGX H100 board), whose ranks NVLink joins
NODE_CARDS = 8


def link(ranks) -> str:
    """``"nvlink"`` for a group of global ranks within one node, else
    ``"ib"``."""
    return "nvlink" if len({r // NODE_CARDS for r in ranks}) == 1 else "ib"


LINK_BW = {"nvlink": NVLINK_BW, "ib": IB_BW}


@dataclasses.dataclass
class Roofline:
    """The reference's fields and properties; ``coll_detail`` also holds
    the bytes by link (``by_link``), which ``t_collective`` charges, and
    ``compute_dtype`` names the peak ``t_compute`` takes."""
    arch: str
    shape: str
    mesh: str
    n_chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_detail: dict
    model_flops_per_device: float
    memory_stats: dict
    compute_dtype: str = "bfloat16"

    @property
    def peak_flops(self) -> float:
        return PEAK_FLOPS[getattr(torch, self.compute_dtype)]

    @property
    def t_compute(self):
        return self.flops_per_device / self.peak_flops

    @property
    def t_memory(self):
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self):
        return sum(n / LINK_BW[k]
                   for k, n in self.coll_detail.get("by_link", {}).items())

    @property
    def bottleneck(self):
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self):
        if self.flops_per_device == 0:
            return 0.0
        return self.model_flops_per_device / self.flops_per_device

    @property
    def roofline_fraction(self):
        """Useful-compute time over the dominant term: how close the step
        is to the compute roofline if the bottleneck were removed."""
        t_star = self.model_flops_per_device / self.peak_flops
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        return t_star / t_bound if t_bound > 0 else 0.0

    def to_dict(self):
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "n_chips": self.n_chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "coll_detail": self.coll_detail,
            "model_flops_per_device": self.model_flops_per_device,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "memory_stats": self.memory_stats,
            "compute_dtype": self.compute_dtype,
        }


def model_flops(cfg, shape_info, n_params_total: int, n_chips: int) -> float:
    """6*N*D for train, 2*N*D for prefill, 2*N*1 token for decode —
    active-params for MoE (the reference's formula, term for term)."""
    n = n_params_total
    if cfg.n_experts and cfg.top_k:
        # experts contribute top_k/n_experts of their params per token
        e_params = count_params(moe_mod.moe_defs(cfg)) - (
            cfg.d_model * cfg.n_experts)  # router excluded
        e_total = e_params * cfg.n_blocks * sum(
            1 for _, f in cfg.pattern if f == "moe")
        n = n - e_total + e_total * cfg.top_k / cfg.n_experts
    seq, batch, kind = (shape_info["seq"], shape_info["batch"],
                        shape_info["kind"])
    if kind == "train":
        d = seq * batch
        f = 6.0 * n * d
    elif kind == "prefill":
        d = seq * batch
        f = 2.0 * n * d
    else:  # decode: one token per sequence
        f = 2.0 * n * batch
    return f / n_chips


def summarize(counts, cfg, shape_name, shape_info, mesh_name, n_chips,
              n_params) -> Roofline:
    """The cell's ``Roofline`` from ``launch/steps.lower_cell``'s counts
    (``flops``, ``bytes``, ``collectives``, ``argument_bytes``,
    ``peak_bytes``), where the reference's takes the compiled module."""
    kinds, calls, by_link = {}, {}, {"nvlink": 0, "ib": 0}
    for c in counts["collectives"]:
        kinds[c["kind"]] = kinds.get(c["kind"], 0) + c["bytes"]
        calls[c["kind"]] = calls.get(c["kind"], 0) + c["calls"]
        by_link[c["link"]] += c["bytes"]
    total = sum(kinds.values())
    return Roofline(
        arch=cfg.name, shape=shape_name, mesh=mesh_name, n_chips=n_chips,
        flops_per_device=float(counts["flops"]),
        bytes_per_device=float(counts["bytes"]),
        coll_bytes_per_device=float(total),
        coll_detail={"bytes": kinds, "counts": calls, "total_bytes": total,
                     "by_link": by_link},
        model_flops_per_device=model_flops(cfg, shape_info, n_params,
                                           n_chips),
        memory_stats={"argument_bytes": counts["argument_bytes"],
                      "peak_bytes": counts["peak_bytes"]},
        compute_dtype=cfg.compute_dtype)


def path_launches(cfg, decode: bool) -> dict:
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


def train_launches(cfg, passes: int) -> dict:
    """Kernel launches of ``passes`` forward-and-backward passes: the
    prefill path's launches (``path_launches``) each pass, twice where
    the config rematerialises its blocks (the recompute in the
    backward)."""
    per = 2 if cfg.remat != "none" else 1
    return {k: n * per * passes
            for k, n in path_launches(cfg, decode=False).items() if n}


def train_step_flops(cfg, batch, seq) -> float:
    """Model FLOPs of one train step of ``batch`` sequences of ``seq``
    decoder positions, forward and backward (3 x the forward): 2 x the
    weights each position passes (a decoder position the blocks' weights,
    of an MoE ffn only its ``top_k`` of ``n_experts`` experts, a text
    position also the LM head, a vision position ``vis_proj``, an encoder
    frame ``enc_in``, the encoder's blocks and every decoder layer's
    cross-attention k and v), plus the attention products the mask keeps
    (q Kᵀ and P V: 4 D a kept (query, key) pair and head: causal or
    windowed self-attention, the encoder's bidirectional attention, the
    cross-attention of every decoder position over every frame) or the
    SSD scan's products."""
    defs = model_defs(cfg)
    d = cfg.d_model
    frames = max(seq // max(cfg.audio_stride, 1), 8) if cfg.enc_layers else 0
    text = seq - cfg.vision_prefix
    blocks = count_params(defs["blocks"])
    per_frame = 0
    for j, (mixer, ffn) in enumerate(cfg.pattern):
        sub = defs["blocks"][f"sub{j}"]
        if ffn == "moe":
            experts = sum(count_params(sub["ffn"][k])
                          for k in ("we_i", "we_g", "we_o"))
            blocks -= experts * (1 - cfg.top_k / cfg.n_experts)
        if cfg.enc_layers and mixer == "attn":
            cross_kv = count_params(sub["mixer"]["xwk"]) \
                + count_params(sub["mixer"]["xwv"])
            blocks -= cross_kv
            per_frame += cross_kv
    fwd = 2 * batch * (seq * blocks + text * d * cfg.vocab_size
                       + cfg.vision_prefix * d * d)
    hd_heads = 4 * cfg.hd * cfg.n_heads * batch
    for mixer, _ in cfg.pattern:
        if mixer == "attn":
            fwd += cfg.n_blocks * hd_heads * (
                attn_pairs(seq, seq, True, cfg.window)
                + (attn_pairs(seq, frames, False, 0) if frames else 0))
        else:
            _, h, p, n_state, _ = ssm_dims(cfg)
            fwd += cfg.n_blocks * ssd_ops(batch, seq, h, p, n_state,
                                          min(256, seq))
    if frames:
        per_frame += count_params(defs["enc_blocks"]) + d * d
        fwd += 2 * batch * frames * per_frame + cfg.enc_layers * hd_heads \
            * attn_pairs(frames, frames, False, 0)
    return 3 * fwd
