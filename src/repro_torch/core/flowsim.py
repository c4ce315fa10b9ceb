"""Fluid (flow-level) simulator — the scalable companion to packetsim
for the §5.3 large-scale experiments (the paper parallelized ns-3; the
standard scalable substitute is max-min fair fluid flows).

Model:
- directed links with capacity (bytes/s), taken from the Topology;
- a **UnicastFlow** occupies the links of its path;
- a **MulticastFlow** (Gleam) occupies the union of its distribution-tree
  links but is ONE flow: every tree link must sustain the same rate (the
  switch replicates; the sender transmits once) — rate = min fair share
  over tree links.  Feedback aggregation keeps ACK load negligible, so
  only the data plane is modeled;
- progressive-filling (water-filling) max-min allocation, vectorized with
  numpy over the link-flow incidence;
- event loop advances to the next flow completion and re-allocates.

Under HPL's symmetric workloads flows complete in large simultaneous
waves, so even 16384-host topologies run in seconds.

``LinkMap`` (topology -> dense directed-link ids, unicast paths, multicast
tree link sets) is shared with the vectorized JAX backend
(``flowsim_jax``) so both flow engines route identically; only the
max-min solver differs.  The overlay *transports* of the Workload IR
(multiunicast / ring / binary-tree — ``core/workload.py``) route
through the same ``unicast_links`` per relay edge, so a baseline and
its Gleam counterpart contend on identical fabric paths.

The port's own copy of the reference ``core/flowsim.py``: the port imports
nothing of the reference package. It is the port's CPU solver
(engine name ``flow-np``) and the oracle the torch solver is held to.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.fattree import Topology

INF = float("inf")

# --------------------------------------------------------------------------
# Expected-value loss model — calibration constants.
#
# The flow engines replace the packet engine's per-packet drop/NACK/RTO
# machinery with a per-flow rate multiplier plus an additive completion
# tail (docs/ARCHITECTURE.md "Loss & congestion model").  The three CAL_*
# constants below were fitted against fixed-seed packet-engine ground
# truth (32-seed means, testbed topology, 1 MiB flows, window=512,
# gleam + multiunicast x group 4/8 x loss 1e-3/1e-2) and hold every
# fitted point within ~11%:
#
# - GBN_REPLAY_CAL: a drop costs ``W = CAL * sqrt(bdp_flow * bdp_link)``
#   replayed packets (geometric mean of flow- and link-BDP — the NACK
#   turnaround sees the *link* RTT while replay drains at the *flow*
#   rate), giving goodput fraction ``(1-q) / (1-q + q W)``.
# - GBN_MERGE_CAL: multicast NACK aggregation merges rollbacks when
#   independent drops on L > 1 lossy hops land in one window; damps W
#   by ``1 + CAL * q * bdp_link * (1 - 1/L)``.
# - GBN_RTO_CAL: tail-drop recoveries that need a timeout instead of a
#   NACK add an expected stall ``rto * (CAL * n_pkts * q * p + q)``
#   applied to the completion time, not the rate (the bandwidth is
#   free during the stall for OTHER flows, which the packet engine
#   confirms: post-RTO flows catch up at full rate).
GBN_REPLAY_CAL = 0.84
GBN_MERGE_CAL = 0.25
GBN_RTO_CAL = 0.6

# DCQCN equilibrium (endpoint.py:RateState defaults: +5 Gbit/s per 55 us
# recovery period, receiver CNPs paced at 50 us, 1 Gbit/s floor).  At
# the sawtooth fixed point rate-cut == recovery between CNPs, so
# ``alpha_eq = DCQCN_RATE_NUM / rate`` and the mean undershoot below
# the fair share is ``alpha_eq / 4``.
DCQCN_RATE_NUM = 2.0 * (5e9 / 8.0) * 50e-6 / 55e-6      # bytes/s
DCQCN_MIN_RATE = 1e9 / 8.0                              # bytes/s
# a link is ECN-"hot" when >= 2 active flows hold it at capacity
ECN_UTIL_EPS = 1e-3


class LinkMap:
    """Dense directed-link indexing over a Topology, plus routing helpers.

    Link ``i`` is the directed (node, port) egress; ``cap[i]`` is its
    bandwidth in bytes/s and ``delay[i]`` its propagation delay.
    """

    def __init__(self, topo: Topology, shared_cache: bool = True):
        from repro_torch.core.staging import StagingCache
        self.topo = topo
        # routed-path artifacts live in the topology's shared staging
        # cache so sweeps across engine instances derive each path once.
        # ``shared_cache=False`` keeps a private cache — the reference
        # mode for the cache-on/off bit-identity tests.  The link-id
        # assignment below is a pure function of the topology's links
        # dict (insertion-ordered), so cached id tuples are valid across
        # LinkMap instances; any ``connect`` bumps the fingerprint and
        # drops them.
        self.cache = StagingCache.of(topo) if shared_cache \
            else StagingCache(topo)
        arrays = self.cache.sync().misc.get("linkmap")
        if arrays is None:
            link_id: Dict[Tuple[str, int], int] = {}
            caps: List[float] = []
            delays: List[float] = []
            lossy: List[float] = []
            switches = set(topo.switches)
            for (node, port), link in topo.links.items():
                link_id[(node, port)] = len(caps)
                caps.append(link.bw)
                delays.append(link.delay)
                # the packet engine drops only on switch egress (packetsim
                # drops DATA iff from_switch), so host uplinks are lossless
                lossy.append(1.0 if node in switches else 0.0)
            arrays = (link_id, np.asarray(caps, float),
                      np.asarray(delays, float), np.asarray(lossy, float))
            self.cache.misc["linkmap"] = arrays
        self.link_id, self.cap, self.delay, self.lossy = arrays

    def add_many(self, rows) -> List["Flow"]:
        """Bulk ``add``: one Flow per (links, volume, loss) row, in
        order.  Staged layouts already carry immutable link tuples, so
        the per-call defensive ``tuple()`` copy is skipped for them —
        the fleet sweep stages thousands of flows per epoch and the
        per-flow call overhead is measurable."""
        flows = [Flow(links if type(links) is tuple else tuple(links),
                      float(volume), loss=loss)
                 for links, volume, loss in rows]
        self.flows.extend(flows)
        return flows

    def unicast_links(self, src: str, dst: str, key: int = 0):
        """Directed link ids along the ECMP unicast path src -> dst.

        Memoized in the shared staging cache: large-scale staging
        (fig14 meshes both tree links AND per-receiver latency paths)
        asks for the same pair repeatedly, and `run_many` sweeps ask
        again per scenario.
        """
        cache = self.cache.sync()
        memo = cache.paths.get((src, dst, key))
        if memo is None:
            cache.misses += 1
            memo = cache.paths[(src, dst, key)] = tuple(
                self.link_id[hop]
                for hop in self.topo.path_links(src, dst, key))
        else:
            cache.hits += 1
        return memo

    def multicast_tree_links(self, src: str, members: Sequence[str],
                             key: int = 0):
        """Union of unicast paths source -> members; reusing a port = the
        forwarded-entry reuse of Algorithm 4 (one copy per tree link).
        `key` seeds the ECMP choice — distinct groups spread over distinct
        spine planes (Algorithm 4's group-level load balancing).
        Memoized on (source, member frozenset, key)."""
        cache = self.cache.sync()
        mk = (src, frozenset(members), key)
        memo = cache.trees.get(mk)
        if memo is None:
            cache.misses += 1
            links = set()
            for m in members:
                if m != src:
                    links.update(self.unicast_links(src, m, key))
            memo = cache.trees[mk] = tuple(sorted(links))
        else:
            cache.hits += 1
        return memo

    def warm_paths(self, requests: Sequence[Tuple[str, str, int]]) -> None:
        """Batch-derive many unicast paths into the staging cache.

        Deduplicates against cached entries and hands the misses to
        ``Topology.paths_many`` — one shared frontier sweep per
        destination chunk instead of one Python BFS walk per pair.
        Bit-identical to per-pair ``unicast_links`` by construction.
        """
        cache = self.cache.sync()
        missing = sorted({r for r in requests if r not in cache.paths})
        if not missing:
            return
        cache.misses += len(missing)
        hop_lists = self.topo.paths_many(missing)
        link_id = self.link_id
        for req, hops in zip(missing, hop_lists):
            cache.paths[req] = tuple(link_id[h] for h in hops)
        cache.bound()

    def warm_latencies(self, requests) -> None:
        """Batch-fill the latency cache for (src, dst, seg_wire, key)
        requests whose paths are already cached (see ``warm_paths``).

        The per-segment reductions run in the same left-to-right order
        as the scalar ``FlowEngine._path_latency`` sums, so warmed
        entries are bit-identical to lazily computed ones.
        """
        cache = self.cache.sync()
        missing = [r for r in requests if r not in cache.lat]
        if not missing:
            return
        ids_list = [cache.paths.get((s, d, k)) for (s, d, _, k) in missing]
        lazy = [i for i, ids in enumerate(ids_list) if ids is None]
        if lazy:
            self.warm_paths([(missing[i][0], missing[i][1], missing[i][3])
                             for i in lazy])
            for i in lazy:
                s, d, _, k = missing[i]
                ids_list[i] = cache.paths[(s, d, k)]
        lens = np.fromiter((len(x) for x in ids_list), np.int64,
                           len(ids_list))
        total = int(lens.sum())
        if not total:
            for req in missing:
                cache.lat[req] = (0.0, 0.0)
            return
        flat = np.fromiter((i for x in ids_list for i in x), np.int64,
                           total)
        starts = np.cumsum(lens) - lens
        segs = np.fromiter((r[2] for r in missing), float, len(missing))
        delays = self.delay[flat]
        # store-and-forward terms seg/cap per hop, first hop zeroed (its
        # serialization is part of the message wire time)
        sf_terms = np.repeat(segs, lens) / self.cap[flat]
        sf_terms[starts[lens > 0]] = 0.0
        nz = lens > 0
        prop = np.zeros(len(missing))
        sf = np.zeros(len(missing))
        prop[nz] = np.add.reduceat(delays, starts[nz])
        sf[nz] = np.add.reduceat(sf_terms, starts[nz])
        for req, p, s in zip(missing, prop, sf):
            cache.lat[req] = (float(p + s), float(p))
        cache.bound()

    def segment_rates_many(self, problems) -> List[float]:
        """Solve a batch of dynamic-segment fairness snapshots.

        Each problem is ``(link_sets, loss)``: a tuple of link-id
        tuples (the OWN flow last, exactly the layout
        ``engine._stage_dynamic``'s per-segment ``fair()`` closure
        passes to ``static_maxmin``) plus the own flow's ``LossParams``
        (or None).  Returns the own flow's solved rate per problem,
        loss-factor-adjusted when loss params are given.

        This numpy fallback is the ORACLE the JAX override
        (``flowsim_jax.JaxFlowSim.segment_rates_many``) is tested
        against (<= 1e-6 relative) — per-problem it is bit-identical
        to the legacy per-segment path.
        """
        out = []
        for link_sets, lp in problems:
            rates = static_maxmin(self.cap, link_sets)
            r = float(rates[-1])
            if lp is not None:
                r *= segment_loss_factor(self.cap, link_sets, rates, lp)
            out.append(r)
        return out


@dataclasses.dataclass(frozen=True)
class LossParams:
    """Pre-folded per-flow loss-model inputs (see module constants).

    ``q`` is the per-packet probability that at least one tree copy is
    dropped; ``wsq`` folds the calibrated replay window and NACK-merge
    damping so the replay cost in packets is ``sqrt(rate * wsq)``
    (capped at ``wnd``, the go-back-N window); ``tail`` is the expected
    additive RTO stall added to the completion time; ``ecn`` turns on
    the DCQCN correction for shared saturated links.
    """

    q: float
    wsq: float
    wnd: float
    tail: float
    ecn: bool = False

    @classmethod
    def build(cls, *, loss_rate: float, lossy_hops: float, rtt: float,
              pkt_wire: float, cap_min: float, window: float,
              n_pkts: float, rto: float, ecn: bool = False,
              parallel: float = 1.0) -> Optional["LossParams"]:
        """Fold raw scenario parameters into solver inputs.

        ``parallel`` is the number of sibling lossy flows racing to the
        same op completion (a multiunicast/overlay fan-out finishes at
        the MAX over its K independent flows; the RTO stall is
        exponential-tailed, so the expected max exceeds the per-flow
        expectation by ~``ln K`` stall scales — Gumbel's correction).
        Returns None when the flow is unaffected (zero effective loss
        and no ECN marking) so callers can keep the exact lossless
        code path — the zero-loss flow results stay bit-identical.
        """
        hops = max(float(lossy_hops), 0.0)
        p = float(loss_rate)
        q = 1.0 - (1.0 - p) ** hops if p > 0.0 and hops > 0.0 else 0.0
        if q <= 0.0 and not ecn:
            return None
        bdp_link = cap_min * rtt / pkt_wire         # link BDP, packets
        merge = 1.0 + GBN_MERGE_CAL * q * bdp_link * (1.0 - 1.0 / hops) \
            if hops > 1.0 else 1.0
        wsq = (GBN_REPLAY_CAL / merge) ** 2 * (rtt / pkt_wire) * bdp_link
        tail = rto * (GBN_RTO_CAL * n_pkts * q * p + q) \
            * (1.0 + math.log(max(float(parallel), 1.0)))
        return cls(q=q, wsq=wsq, wnd=float(window), tail=tail,
                   ecn=bool(ecn))


@dataclasses.dataclass(slots=True)
class Flow:
    """One staged flow.  ``volume`` is the STAGED byte count and is
    never mutated by the solvers — metrics and re-run inspection rely
    on it; ``remaining`` is the solver's working countdown."""

    links: Tuple[int, ...]          # directed link ids
    volume: float                   # bytes staged (immutable after add)
    remaining: float = -1.0         # bytes left to serve (solver state)
    done_t: float = -1.0
    rate: float = 0.0
    tag: object = None
    loss: Optional[LossParams] = None

    def __post_init__(self):
        if self.remaining < 0.0:
            self.remaining = self.volume


def static_maxmin_loops(cap: np.ndarray,
                        link_sets: Sequence[Sequence[int]]):
    """Per-flow-loop progressive filling — the original implementation.

    Kept verbatim as the bit-identity oracle for the vectorized
    ``static_maxmin`` (the regression tests assert exact equality) and
    as the honest "before" leg of the ``dyn_segments`` benchmark.
    """
    flow_links = [np.asarray(ls, int) for ls in link_sets]
    n = len(flow_links)
    rates = np.zeros(n)
    frozen = np.zeros(n, bool)
    cap = np.asarray(cap, float).copy()
    for _ in range(64):                     # bottleneck rounds
        cnt = np.zeros(len(cap))
        for i, ls in enumerate(flow_links):
            if not frozen[i]:
                cnt[ls] += 1.0
        hot = cnt > 0
        if not hot.any():
            break
        share = np.full(len(cap), INF)
        share[hot] = cap[hot] / cnt[hot]
        # each unfrozen flow is limited by its tightest link
        limit = np.array([share[ls].min() if not frozen[i] else INF
                          for i, ls in enumerate(flow_links)])
        b = limit.min()
        # freeze flows crossing a bottleneck link (share == b)
        newly = (~frozen) & (limit <= b * (1 + 1e-12))
        if not newly.any():
            break
        for i in np.where(newly)[0]:
            rates[i] = b
            cap[flow_links[i]] -= b
            frozen[i] = True
        cap = np.maximum(cap, 0.0)
        if frozen.all():
            break
    return np.maximum(rates, 1e-9)


def static_maxmin(cap: np.ndarray, link_sets: Sequence[Sequence[int]]):
    """Max-min fair rates for a static flow set by progressive filling.

    ``cap`` is the dense capacity vector (bytes/s, NOT mutated);
    ``link_sets`` one link-id sequence per flow (link ids unique within
    a flow — trees and simple paths never repeat a link).  Returns (F,)
    rates.  Shared by the solver hot path (``FlowSim._allocate``) and
    the engine's piecewise-membership fairness snapshots
    (``engine.FlowEngine._stage_dynamic``).

    CSR-vectorized: one ``np.add.at`` scatter for per-link demand and
    one ``np.minimum.reduceat`` gather for per-flow limits replace the
    per-flow Python loop of ``static_maxmin_loops``; the element-wise
    operation sequences are identical (ordered scatters, exact min
    reductions), so the results are bit-identical.
    """
    n = len(link_sets)
    if n == 0:
        return np.maximum(np.zeros(0), 1e-9)
    lens = np.fromiter((len(ls) for ls in link_sets), np.int64, n)
    if not lens.all():           # empty set: no constraint — rare, and
        return static_maxmin_loops(cap, link_sets)    # not vectorizable
    total = int(lens.sum())
    flat = np.fromiter((i for ls in link_sets for i in ls), np.int64,
                       total)
    starts = np.cumsum(lens) - lens
    row = np.repeat(np.arange(n), lens)
    rates = np.zeros(n)
    frozen = np.zeros(n, bool)
    cap = np.asarray(cap, float).copy()
    live = np.ones(total, bool)             # per-entry ~frozen[row]
    for _ in range(64):                     # bottleneck rounds
        cnt = np.zeros(len(cap))
        np.add.at(cnt, flat[live], 1.0)
        hot = cnt > 0
        if not hot.any():
            break
        share = np.full(len(cap), INF)
        share[hot] = cap[hot] / cnt[hot]
        # each unfrozen flow is limited by its tightest link
        limit = np.minimum.reduceat(share[flat], starts)
        limit[frozen] = INF
        b = limit.min()
        # freeze flows crossing a bottleneck link (share == b)
        newly = (~frozen) & (limit <= b * (1 + 1e-12))
        if not newly.any():
            break
        rates[newly] = b
        # unbuffered ordered scatter == the loop's sequential per-flow
        # ``cap[links] -= b`` (row-major order, one op per element)
        np.subtract.at(cap, flat[newly[row]], b)
        frozen |= newly
        live = ~frozen[row]
        cap = np.maximum(cap, 0.0)
        if frozen.all():
            break
    return np.maximum(rates, 1e-9)


def segment_loss_factor(cap: np.ndarray, link_sets, rates, lp) -> float:
    """Expected-value loss/DCQCN rate factor for the LAST flow of a
    solved segment problem — the scalar numpy twin of
    ``kernels/ref.py:loss_factors_reference`` (same math as
    ``FlowSim._apply_loss``, evaluated for one flow against the whole
    segment's solved rates).  Used by the batched dynamic-segment
    solver so churn-under-loss fairness snapshots are loss-native."""
    util = np.zeros(len(cap))
    cnt = np.zeros(len(cap))
    for ls, r in zip(link_sets, rates):
        ids = np.asarray(ls, int)
        util[ids] += r
        cnt[ids] += 1.0
    hot = (cnt >= 2.0) & (util >= cap * (1.0 - ECN_UTIL_EPS))
    r = float(rates[-1])
    w = min(math.sqrt(max(r * lp.wsq, 0.0)), lp.wnd)
    gbn = (1.0 - lp.q) / max(1.0 - lp.q + lp.q * w, 1e-30)
    dc = 1.0
    if lp.ecn and hot[np.asarray(link_sets[-1], int)].any():
        alpha = min(DCQCN_RATE_NUM / max(r, 1e-30), 1.0)
        dc = max(1.0 - 0.25 * alpha,
                 min(DCQCN_MIN_RATE / max(r, 1e-30), 1.0))
    return min(max(gbn * dc, 1e-9), 1.0)


class FlowSim(LinkMap):
    def __init__(self, topo: Topology, shared_cache: bool = True):
        super().__init__(topo, shared_cache)
        self.flows: List[Flow] = []
        self.now = 0.0

    # ------------------------------------------------------------ engine

    def add(self, links, volume, tag=None, loss=None) -> Flow:
        f = Flow(tuple(links), float(volume), tag=tag, loss=loss)
        self.flows.append(f)
        return f

    def _allocate(self, active: List[Flow]):
        """Max-min fair rates by progressive filling (vectorized)."""
        if not active:
            return
        rates = static_maxmin(self.cap, [f.links for f in active])
        for f, r in zip(active, rates):
            f.rate = r

    def _apply_loss(self, active: List[Flow]):
        """Scale solved rates by the expected-value loss/DCQCN factors.

        The numpy twin of ``kernels/ref.py:loss_factors_reference``:
        identical math, applied to ``Flow.rate`` in place.
        """
        util = np.zeros(len(self.cap))
        cnt = np.zeros(len(self.cap))
        for f in active:
            ls = np.asarray(f.links, int)
            util[ls] += f.rate
            cnt[ls] += 1.0
        hot = (cnt >= 2.0) & (util >= self.cap * (1.0 - ECN_UTIL_EPS))
        for f in active:
            lp = f.loss
            if lp is None:
                continue
            w = min(math.sqrt(max(f.rate * lp.wsq, 0.0)), lp.wnd)
            gbn = (1.0 - lp.q) / max(1.0 - lp.q + lp.q * w, 1e-30)
            dc = 1.0
            if lp.ecn and hot[np.asarray(f.links, int)].any():
                alpha = min(DCQCN_RATE_NUM / max(f.rate, 1e-30), 1.0)
                dc = max(1.0 - 0.25 * alpha,
                         min(DCQCN_MIN_RATE / max(f.rate, 1e-30), 1.0))
            f.rate *= min(max(gbn * dc, 1e-9), 1.0)

    def run(self) -> float:
        """Run until every flow completes; returns the final time."""
        active = [f for f in self.flows if f.done_t < 0]
        lossy = any(f.loss is not None for f in active)
        while active:
            self._allocate(active)
            if lossy:
                self._apply_loss(active)
            dt = min(f.remaining / f.rate for f in active)
            self.now += dt
            still = []
            for f in active:
                f.remaining -= f.rate * dt
                if f.remaining <= 1e-6 * max(f.rate, 1.0):
                    # RTO stalls delay completion but free the fabric:
                    # the tail is added to done_t, not simulated time
                    f.done_t = self.now + (f.loss.tail if f.loss else 0.0)
                    f.remaining = 0.0
                else:
                    still.append(f)
            active = still
        if self.flows:
            return max(self.now, max(f.done_t for f in self.flows))
        return self.now
