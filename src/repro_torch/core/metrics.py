"""Shared result records and metric accounting for every simulation engine.

The paper's §5 evaluation reports three quantities, and both simulation
backends (``packetsim`` and the flow-level engines behind
``core/engine.py``) produce them through the same ``MsgRecord``:

- **JCT** (job completion time): submission of a group message until the
  LAST receiver has delivered it — ``max(t_deliver) - t_submit``.  This is
  what Figs. 9-11 and 14-15 plot.
- **IO latency**: submission until the SENDER's completion event
  (the CQE raised when the cumulative aggregated ACK covers the last PSN;
  "hardware reliability") — ``t_sender_cqe - t_submit``.  Fig. 13.
- **IOPS**: completed IOs divided by the wall-clock span of the batch
  (``iops()`` below).  Fig. 12.

Keeping the records engine-agnostic is what makes the engines swappable:
a benchmark asks its engine for records and computes metrics identically,
whether the record was filled in by a per-packet event loop or by a
vectorized max-min fair-share solve.

``schedule_cost`` (the analytic alpha-beta broadcast model used by the
adapted-layer benchmarks) lives here too: it is JCT accounting with the
network abstracted away entirely, the zeroth engine in the fidelity
ladder analytic -> flow -> packet.

The port's own copy of the reference ``core/metrics.py``: the port imports
nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Sequence


@dataclasses.dataclass(slots=True)
class MsgRecord:
    """Completion bookkeeping for one submitted group message.

    ``t_sender_cqe`` is -1 until the sender-side completion is observed;
    ``t_deliver`` maps member name -> delivery time and fills in as
    receivers finish (flow-level engines fill all of it at once).
    ``error`` is the bounded-retry verdict: empty for a clean completion,
    else an attributable reason (e.g. ``"retry_exceeded"``) meaning the
    op terminated explicitly instead of completing — never a hang.
    """

    msg_id: int
    nbytes: int
    t_submit: float
    t_sender_cqe: float = -1.0
    t_deliver: Dict[str, float] = dataclasses.field(default_factory=dict)
    error: str = ""

    @property
    def errored(self) -> bool:
        return bool(self.error)

    def jct(self, n_receivers: int) -> float:
        """Submission -> last receiver delivery (inf while incomplete)."""
        if len(self.t_deliver) < n_receivers:
            return float("inf")
        return max(self.t_deliver.values()) - self.t_submit

    @property
    def io_latency(self) -> float:
        """Submission -> sender CQE (§5.2.2's single-IO latency)."""
        return self.t_sender_cqe - self.t_submit

    @property
    def complete(self) -> bool:
        return self.t_sender_cqe >= 0.0


# ------------------------------------------------------------- aggregates

def iops(records: Sequence[MsgRecord], t0: float) -> float:
    """Completed IOs per second over the batch span starting at ``t0``.

    Matches Fig. 12's measurement: the denominator is the time the LAST
    sender CQE lands, so pipelining across outstanding IOs is credited.
    """
    if not records:
        return 0.0
    t_end = max(r.t_sender_cqe for r in records)
    span = t_end - t0
    return len(records) / span if span > 0 else float("inf")


def mean_io_latency(records: Iterable[MsgRecord]) -> float:
    """Arithmetic mean of per-IO submit->CQE latency (Fig. 13)."""
    recs = list(records)
    return sum(r.io_latency for r in recs) / max(len(recs), 1)


def max_jct(records: Iterable[MsgRecord], n_receivers: int) -> float:
    """Batch JCT: the slowest message's JCT (epoch completion time)."""
    return max(r.jct(n_receivers) for r in records)


# ------------------------------------------------- schedule cost model

def schedule_cost(schedule: str, n: int, bytes_: int, *, chunks: int = 1,
                  link_bw: float = 50e9, hop_latency: float = 1e-6):
    """Analytic alpha-beta cost of broadcasting ``bytes_`` to n-1 receivers.

    Used by benchmarks/collective_schedules.py to compare against the
    paper's Fig. 9 structure (sender-bottleneck vs tree vs overlay):

    - ``unicast``:   n-1 serialized sends through the sender's link;
    - ``ring``:      pipelined store-and-forward, (n-1 + chunks-1) rounds;
    - ``tree``:      binomial tree, ceil(log2 n) rounds;
    - ``infabric``:  ideal switch multicast — one hop, one serialization
      (Gleam's data plane in the limit of free replication).
    """
    beta = bytes_ / link_bw
    if n == 1:
        return 0.0
    if schedule == "unicast":
        return (n - 1) * (hop_latency + beta)     # serialized at sender
    if schedule == "ring":
        c = max(chunks, 1)
        return (n - 1 + c - 1) * (hop_latency + beta / c)
    if schedule in ("gleam_tree", "tree"):
        return math.ceil(math.log2(n)) * (hop_latency + beta)
    if schedule == "infabric":                    # ideal switch multicast
        return hop_latency + beta
    raise ValueError(schedule)
