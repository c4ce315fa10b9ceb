"""Open-loop serving traffic: arrivals -> fabric ops -> tail latency.

MLPerf-offline style: requests arrive on a clock the server does NOT
control (seeded Poisson or a deterministic trace), each request costs
prefill + decode TP collectives on its replica plus a KV-replication
write, and the report compares **offered load vs achieved QPS** with
p50/p99/p999 request latency.

The engines stage a scenario's ops concurrently from t=0, so open-loop
time is modeled with an **arrival-window round schedule**: arrivals are
bucketed into windows of ``window_s`` seconds, each window's requests
form one contended scenario (its round time = the slowest op's JCT,
with every other request in the window contending for the fabric), and
rounds execute back to back:

    start_w = max(end of window w, finish of round w-1)
    finish_w = start_w + round_time_w
    latency(request in w) = finish_w - t_arrive

Past the saturation rate rounds outlast their windows, the backlog
term compounds, and the p999 hockey-stick appears — the queueing
behaviour an open-loop harness exists to expose.  Because a round's
time does not depend on its start, ALL windows run as one
``run_many`` batch (serial == ``workers=N`` bit-identical on the
packet engine) and the chaining is applied analytically afterwards.

The port's own copy of the reference ``apps/traffic.py``: the port imports
nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.apps import metrics as appm
from repro_torch.apps.collectives_lowering import (decode_comm_bytes,
                                                   default_hosts,
                                                   kv_cache_bytes,
                                                   prefill_comm_bytes)
from repro_torch.configs.base import ArchConfig
from repro_torch.core.metrics import MsgRecord
from repro_torch.core.workload import Workload

__all__ = ["ArrivalSpec", "ServeReport", "ServingGenerator"]


@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """Request arrival process — plain data, serialized into
    ``Workload.meta`` so a staged serving sweep is replayable.

    ``poisson``: ``n`` arrivals with Exp(rate) gaps from
    ``random.Random(seed)`` (deterministic across platforms — Python's
    Mersenne Twister is part of the language spec).  ``trace``: the
    given arrival times verbatim (rate is then only the offered-load
    label)."""

    kind: str = "poisson"               # poisson | trace
    rate: float = 1e4                   # offered requests / second
    n: int = 64
    seed: int = 0
    trace: Tuple[float, ...] = ()

    def __post_init__(self):
        if self.kind not in ("poisson", "trace"):
            raise ValueError(f"unknown arrival kind {self.kind!r}")
        if self.kind == "poisson" and (self.rate <= 0 or self.n < 1):
            raise ValueError("poisson arrivals need rate > 0 and n >= 1")
        if self.kind == "trace" and not self.trace:
            raise ValueError("trace arrivals need a non-empty trace")
        object.__setattr__(self, "trace", tuple(self.trace))

    def arrivals(self) -> List[float]:
        if self.kind == "trace":
            return sorted(self.trace)
        rng = random.Random(self.seed)
        t, out = 0.0, []
        for _ in range(self.n):
            t += rng.expovariate(self.rate)
            out.append(t)
        return out

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ArrivalSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown ArrivalSpec fields: "
                             f"{sorted(unknown)}")
        d = dict(d)
        if "trace" in d:
            d["trace"] = tuple(d["trace"])
        return cls(**d)


@dataclasses.dataclass
class ServeReport:
    """Offered vs achieved throughput + request-latency tail."""

    transport: str
    offered_qps: float
    achieved_qps: float
    n_requests: int
    latencies: List[float]
    quantiles: Dict[str, float]
    phase_latency: Dict[str, float]     # phase -> max JCT observed

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class ServingGenerator:
    """Map request arrivals to fabric ops across ``n_replicas`` TP
    groups (serving layout ``hosts[replica * tp + rank]``).

    Per request, on its round-robin replica: one ``prefill`` TP
    all-reduce (prompt_len tokens), one aggregated ``decode`` TP
    all-reduce (decode_len tokens), and one ``kv-replicate`` write of
    the finished KV cache from the replica's rank-0 host to the next
    ``kv_replicas`` replicas' rank-0 hosts (prefix-cache / failover
    sharing — a one-to-many storage write, so the transport choice
    shows).  With ``tp == 1`` the collectives vanish and only
    replication traffic remains.
    """

    def __init__(self, cfg: ArchConfig, n_replicas: int, tp: int,
                 hosts: Optional[Sequence[str]] = None, *,
                 prompt_len: int = 512, decode_len: int = 64,
                 kv_replicas: int = 1,
                 transport: str = "gleam", chunks: int = 8,
                 window_s: Optional[float] = None):
        if n_replicas < 2:
            raise ValueError("serving traffic needs >= 2 replicas "
                             "(KV replication has nowhere to go)")
        if not 1 <= kv_replicas < n_replicas:
            raise ValueError(
                f"kv_replicas must be in [1, {n_replicas - 1}], got "
                f"{kv_replicas}")
        self.cfg = cfg
        self.n_replicas = n_replicas
        self.tp = tp
        self.hosts = list(hosts) if hosts is not None else \
            default_hosts(n_replicas * tp)
        if len(self.hosts) < n_replicas * tp:
            raise ValueError(f"need {n_replicas * tp} hosts, got "
                             f"{len(self.hosts)}")
        self.prompt_len = prompt_len
        self.decode_len = decode_len
        self.kv_replicas = kv_replicas
        self.transport = transport
        self.chunks = chunks
        self.window_s = window_s

    def _replica_hosts(self, r: int) -> List[str]:
        return [self.hosts[r * self.tp + m] for m in range(self.tp)]

    def _request_ops(self, wl: Workload, idx: int) -> None:
        r = idx % self.n_replicas
        group = self._replica_hosts(r)
        kw = dict(transport=self.transport, chunks=self.chunks)
        if self.tp > 1:
            wl.allreduce(group, prefill_comm_bytes(
                self.cfg, self.prompt_len, self.tp),
                phase="prefill", **kw)
            wl.allreduce(group, decode_comm_bytes(
                self.cfg, self.decode_len, self.tp),
                phase="decode", **kw)
        kv = kv_cache_bytes(self.cfg, self.prompt_len + self.decode_len)
        dsts = [self._replica_hosts((r + 1 + i) % self.n_replicas)[0]
                for i in range(self.kv_replicas)]
        wl.write([group[0]] + dsts, kv, phase="kv-replicate", **kw)

    def workloads(self, spec: ArrivalSpec) -> List[Workload]:
        """One phased ``Workload`` per arrival window (meta carries the
        spec, the window bounds, and the member request indices)."""
        arrivals = spec.arrivals()
        w = self.window_s
        if w is None:
            # ~8 requests per window at the offered rate: enough
            # contention per round to matter, enough rounds for a tail
            span = arrivals[-1] if arrivals[-1] > 0 else 1.0
            w = max(span / max(len(arrivals) // 8, 1), 1e-9)
        windows: Dict[int, List[int]] = {}
        for i, t in enumerate(arrivals):
            windows.setdefault(int(t / w), []).append(i)
        out = []
        for k in sorted(windows):
            wl = Workload(
                f"{self.cfg.name}/serve/{self.transport}/w{k}",
                meta={"model": self.cfg.name, "kind": "serve",
                      "transport": self.transport, "window": k,
                      "window_s": w, "requests": windows[k],
                      "arrivals": [arrivals[i] for i in windows[k]],
                      "spec": spec.to_dict()})
            for i in windows[k]:
                self._request_ops(wl, i)
            out.append(wl)
        return out

    def report(self, spec: ArrivalSpec, workloads: Sequence[Workload],
               results: Sequence[Sequence[MsgRecord]]) -> ServeReport:
        """Chain the window rounds and fold per-request latencies.
        ``results[w]`` must align with ``workloads[w].ops``; a window's
        round time is its ``step_time`` (prefill, decode, and
        replication are barrier-separated batch phases)."""
        latencies: List[float] = []
        phase_lat: Dict[str, float] = {}
        finish = 0.0
        for wl, recs in zip(workloads, results):
            w = wl.meta["window_s"]
            round_t = appm.step_time(wl.ops, recs)
            for phase, st in appm.phase_stats(wl.ops, recs).items():
                phase_lat[phase] = max(phase_lat.get(phase, 0.0),
                                       st.latency)
            start = max((wl.meta["window"] + 1) * w, finish)
            finish = start + round_t
            latencies.extend(finish - t for t in wl.meta["arrivals"])
        n = len(latencies)
        achieved = n / finish if finish > 0 else 0.0
        return ServeReport(
            transport=self.transport, offered_qps=spec.rate,
            achieved_qps=achieved, n_requests=n, latencies=latencies,
            quantiles=appm.request_quantiles(latencies),
            phase_latency=phase_lat)

    def run(self, eng, spec: ArrivalSpec, *, timeout: float = 120.0,
            workers: Optional[int] = None) -> ServeReport:
        """Run every window phase by phase — one flat ``run_many``
        batch (each window's prefill / decode / kv-replicate phase is
        an independent scenario; requests inside a phase contend) —
        then fold the report."""
        wls = self.workloads(spec)
        parts = [appm.split_phases(wl) for wl in wls]
        flat = [p for ps in parts for p in ps]
        flat_res = iter(eng.run_workloads(flat, timeout=timeout,
                                          workers=workers))
        results = []
        for wl, ps in zip(wls, parts):
            by_op = {}
            for p in ps:
                for op, r in zip(p.ops, next(flat_res)):
                    by_op[id(op)] = r
            results.append([by_op[id(op)] for op in wl.ops])
        return self.report(spec, wls, results)
