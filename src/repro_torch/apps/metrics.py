"""Per-phase / per-request JCT aggregation over ``MsgRecord``s.

The app lowerings (``apps.collectives_lowering``, ``apps.traffic``)
tag every ``GroupOp`` with a ``phase`` label; the engines stage a
phase's ops concurrently (they contend for the fabric) while distinct
phases of a step are barrier-separated in the application (an optimizer
cannot sync gradients it has not computed).  So:

- a phase's **latency** is the MAX op JCT inside it (the barrier waits
  for the slowest collective);
- a step's **time** is the SUM of its phase latencies, in first-
  appearance order;
- request/tail statistics use **nearest-rank** quantiles (p50 / p99 /
  p999) — deterministic, no interpolation, exact on small samples.

The port's own copy of the reference ``apps/metrics.py``: the port imports
nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

from repro_torch.core.metrics import MsgRecord
from repro_torch.core.workload import GroupOp

__all__ = ["jct", "quantile", "request_quantiles", "PhaseStats",
           "phase_stats", "step_time", "split_phases", "run_phased"]


def jct(rec: MsgRecord) -> float:
    """Job completion time of one op: last delivery (falling back to
    the sender CQE for ops with no receivers' deliveries recorded)."""
    if rec.t_deliver:
        return max(rec.t_deliver.values()) - rec.t_submit
    return rec.t_sender_cqe - rec.t_submit


def quantile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank quantile (q in [0, 1]); 0.0 on an empty sample."""
    if not xs:
        return 0.0
    s = sorted(xs)
    rank = max(1, math.ceil(q * len(s)))
    return s[min(rank, len(s)) - 1]


def request_quantiles(latencies: Sequence[float]) -> Dict[str, float]:
    """The serving-tail dict every report carries: p50/p99/p999/max."""
    return {
        "p50": quantile(latencies, 0.50),
        "p99": quantile(latencies, 0.99),
        "p999": quantile(latencies, 0.999),
        "max": max(latencies) if latencies else 0.0,
    }


@dataclasses.dataclass
class PhaseStats:
    """Aggregate of one phase's op JCTs within a scenario."""

    phase: str
    n_ops: int
    total_bytes: int
    latency: float              # max JCT: what the barrier waits for
    sum_jct: float
    p50: float
    p99: float
    p999: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def phase_stats(ops: Sequence[GroupOp], recs: Sequence[MsgRecord]
                ) -> Dict[str, PhaseStats]:
    """Group op records by their ``phase`` tag (first-appearance order;
    untagged ops fall under ``""``)."""
    groups: Dict[str, List[int]] = {}
    for i, op in enumerate(ops):
        groups.setdefault(op.phase, []).append(i)
    out: Dict[str, PhaseStats] = {}
    for phase, idxs in groups.items():
        js = [jct(recs[i]) for i in idxs]
        out[phase] = PhaseStats(
            phase=phase, n_ops=len(idxs),
            total_bytes=sum(ops[i].nbytes for i in idxs),
            latency=max(js), sum_jct=sum(js),
            p50=quantile(js, 0.50), p99=quantile(js, 0.99),
            p999=quantile(js, 0.999))
    return out


def step_time(ops: Sequence[GroupOp], recs: Sequence[MsgRecord],
              compute_floor: Optional[Dict[str, float]] = None) -> float:
    """Step time = sum over phases of max(phase latency, optional
    per-phase compute floor).  ``compute_floor`` maps phase -> seconds
    of overlappable compute (e.g. a roofline term); a phase present
    only in the floor dict still contributes (pure-compute phase)."""
    stats = phase_stats(ops, recs)
    floor = dict(compute_floor or {})
    total = 0.0
    for phase, st in stats.items():
        total += max(st.latency, floor.pop(phase, 0.0))
    return total + sum(floor.values())


def split_phases(wl) -> List["object"]:
    """One sub-``Workload`` per phase (first-appearance order), sharing
    the parent's meta and op objects.

    This is how a phased step SHOULD be executed: the engines stage one
    scenario's ops concurrently, so staging a whole step as one
    scenario makes the tp-allreduce contend with the dp-gradsync it is
    barrier-separated from — only stage them together when full-step
    contention is the thing under study."""
    from repro_torch.core.workload import Workload
    groups: Dict[str, List[GroupOp]] = {}
    for op in wl.ops:
        groups.setdefault(op.phase, []).append(op)
    return [Workload(f"{wl.name}#{phase or 'untagged'}", ops,
                     meta=dict(wl.meta))
            for phase, ops in groups.items()]


def run_phased(eng, wl, *, timeout: float = 120.0,
               workers: Optional[int] = None):
    """Run ``wl`` phase by phase (each phase one independent scenario,
    all phases one ``run_many`` batch) and return ``(ops, recs)``
    aligned — feed them to ``step_time`` / ``phase_stats``."""
    phases = split_phases(wl)
    results = eng.run_workloads(phases, timeout=timeout, workers=workers)
    ops = [op for p in phases for op in p.ops]
    recs = [r for rs in results for r in rs]
    return ops, recs
