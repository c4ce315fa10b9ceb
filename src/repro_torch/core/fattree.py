"""Datacenter topologies for the faithful Gleam layer.

``Topology`` is a port-numbered multigraph with per-directed-link bandwidth
and propagation delay, plus shortest-path routing helpers:

- ``next_hop_ports(node, dst, flow_key)`` — the deterministic ECMP choice
  used by unicast forwarding;
- ``candidate_ports(node, dst)`` — the full equal-cost port set ("the set
  of accessible ports", Algorithm 4 line 14) used by the registration
  protocol's group-level load balancing.

Builders:
- ``testbed()``       — the paper's prototype (Fig. 8): one switch, four
  100Gbps hosts (the FPGA board is folded into the switch model: the
  Gleam logic runs "in" the switch, exactly the deployment the ACL
  redirect emulates).
- ``fig4()``          — the 3-layer example of Fig. 4 (4 leaves, 3 spines /
  2 pods, 2 cores) for unit tests of multi-hop trees.
- ``fat_tree(...)``   — parametric 3-layer pod/core fat-tree with 1:1
  oversubscription for the large-scale simulations (§5.3: 16384 hosts,
  64-port switches, 200Gbps).

The port's own copy of the reference ``core/fattree.py``: the port imports
nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Link:
    bw: float       # bytes / second
    delay: float    # seconds (propagation + fixed switch latency)


class Topology:
    # Per-destination BFS distance maps are cached for routing; on a
    # 16384-host fat tree one map is ~25k entries and every host is
    # eventually a destination, so an unbounded cache walks into tens
    # of GB.  LRU-bound it BY MEMORY, not count: packet-level sims keep
    # hundreds of destinations hot at once (every forwarded packet does
    # a dist() lookup) and must all fit, while flow-level staging on
    # 16k-host topologies touches each destination in tight succession
    # and tolerates a small cache.  ~150B per dict entry, measured.
    DIST_CACHE_BYTES = 256 << 20
    _DIST_ENTRY_BYTES = 150
    # candidate_ports memo: one small keyed list each.  Same byte-budget
    # LRU discipline as the dist cache — a many-destination churn run
    # (every (hop node, dst) pair on every routed path of a 16k-host
    # sweep) must not grow the memo without limit.  ~100B per entry
    # (two interned key strings + a short port list), measured.
    CAND_CACHE_BYTES = 64 << 20
    _CAND_ENTRY_BYTES = 100

    def __init__(self):
        self.ports: Dict[str, Dict[int, Tuple[str, int]]] = {}
        self.links: Dict[Tuple[str, int], Link] = {}   # (node, port) -> Link
        self.hosts: List[str] = []
        self.switches: List[str] = []
        self._dist: "OrderedDict[str, Dict[str, int]]" = OrderedDict()
        self._cand: "OrderedDict[Tuple[str, str], List[int]]" = OrderedDict()
        self._csr: Optional[tuple] = None  # (names, index, indptr, nbrs, prt)
        # directed (node, port) pairs whose link is administratively or
        # fault-wise down — routing treats them as absent (fault plane)
        self._down: set = set()
        # fingerprint state: (structural revision, frozen down-set).
        # Deliberately STATE-based, not a mutation counter: transient
        # set_link_down()/clear_down() round trips (flow-engine fault
        # staging) return to the original fingerprint, so staging caches
        # keyed on it survive fault sweeps on a pristine fabric.
        self._struct_rev = 0
        self._fp: Tuple[int, frozenset] = (0, frozenset())
        # When False, dist()/candidate_ports() recompute on every call
        # without memoizing — the cache-disabled reference mode for
        # bit-identity tests (slow; testing only).
        self.route_cache = True

    # ------------------------------------------------------------ building

    def add_host(self, name: str):
        self.hosts.append(name)
        self.ports[name] = {}

    def add_switch(self, name: str):
        self.switches.append(name)
        self.ports[name] = {}

    def connect(self, a: str, b: str, bw: float, delay: float):
        pa = len(self.ports[a])
        pb = len(self.ports[b])
        self.ports[a][pa] = (b, pb)
        self.ports[b][pb] = (a, pa)
        self.links[(a, pa)] = Link(bw, delay)
        self.links[(b, pb)] = Link(bw, delay)
        self._dist.clear()
        self._cand.clear()
        self._csr = None
        self._struct_rev += 1
        self._fp = (self._struct_rev, frozenset(self._down))

    def fingerprint(self) -> Tuple[int, frozenset]:
        """Cheap identity of the current routed topology.

        Changes exactly when routing could change: on ``connect`` (the
        structural revision bumps) and whenever the down-set changes
        (``set_link_down``/``set_switch_down``/``clear_down``).  Staging
        caches key derived artifacts (trees, paths, latencies) on this
        value and drop them when it moves."""
        return self._fp

    # ------------------------------------------------------- fault plane

    def _link_ports(self, a: str, b: str) -> Tuple[int, int]:
        """Port pair of the (single) a<->b link; KeyError when absent."""
        for pa, (peer, pb) in self.ports[a].items():
            if peer == b:
                return pa, pb
        raise KeyError(f"no link {a!r} <-> {b!r}")

    def set_link_down(self, a: str, b: str, down: bool = True) -> None:
        """Mark the a<->b link down (or back up) for routing.

        Down links vanish from the BFS adjacency and the ECMP candidate
        sets, so ``dist``/``candidate_ports``/``path_links`` re-derive
        onto surviving paths — the repair half of the fault plane.  The
        routing caches are invalidated on every change."""
        pa, pb = self._link_ports(a, b)
        pairs = {(a, pa), (b, pb)}
        if down:
            self._down |= pairs
        else:
            self._down -= pairs
        self._dist.clear()
        self._cand.clear()
        self._csr = None
        self._fp = (self._struct_rev, frozenset(self._down))

    def set_switch_down(self, name: str, down: bool = True) -> None:
        """Fail (or restore) every link of a switch at once."""
        for p, (peer, pp) in self.ports[name].items():
            pairs = {(name, p), (peer, pp)}
            if down:
                self._down |= pairs
            else:
                self._down -= pairs
        self._dist.clear()
        self._cand.clear()
        self._csr = None
        self._fp = (self._struct_rev, frozenset(self._down))

    def is_down(self, node: str, port: int) -> bool:
        return (node, port) in self._down

    def clear_down(self) -> None:
        """Restore every downed link (scenario quiesce)."""
        if not self._down:
            return
        self._down.clear()
        self._dist.clear()
        self._cand.clear()
        self._csr = None
        self._fp = (self._struct_rev, frozenset())

    def down_links(self) -> frozenset:
        return frozenset(self._down)

    # ------------------------------------------------------------ routing

    def _adjacency(self):
        """CSR adjacency over integer node ids, built lazily.

        One BFS per destination is the staging hot path of large-scale
        flow batches (a 16k-host fat tree eventually BFSes every host);
        walking the per-node port dicts in Python is ~10x slower than
        level-synchronous numpy sweeps over this CSR form.
        """
        if self._csr is None:
            names = list(self.ports)
            index = {n: i for i, n in enumerate(names)}
            down = self._down
            # CSR entries keep the ports dict's insertion order, which
            # is ascending port number by construction (``connect``
            # allocates ports densely) — the same order ``sorted()``
            # yields in candidate_ports, so vectorized ECMP picks over
            # this CSR are bit-identical to the scalar walk.
            live = {n: [(p, peer) for p, (peer, _) in self.ports[n].items()
                        if not down or (n, p) not in down]
                    for n in names}
            indptr = np.zeros(len(names) + 1, np.int32)
            for i, n in enumerate(names):
                indptr[i + 1] = indptr[i] + len(live[n])
            nbrs = np.empty(indptr[-1], np.int32)
            prt = np.empty(indptr[-1], np.int32)
            k = 0
            for n in names:
                for p, peer in live[n]:
                    nbrs[k] = index[peer]
                    prt[k] = p
                    k += 1
            self._csr = (names, index, indptr, nbrs, prt)
        return self._csr

    def _bfs(self, dst: str) -> Dict[str, int]:
        """Level-synchronous numpy BFS.  Unreachable nodes get -1 (the
        builders only produce connected topologies)."""
        names, index, indptr, nbrs, _ = self._adjacency()
        dist = np.full(len(names), -1, np.int32)
        frontier = np.asarray([index[dst]], np.int32)
        dist[frontier] = 0
        d = 0
        while frontier.size:
            d += 1
            # gather all neighbors of the frontier in one CSR sweep
            starts, ends = indptr[frontier], indptr[frontier + 1]
            counts = ends - starts
            rel = np.arange(int(counts.sum()), dtype=np.int32) \
                - np.repeat(np.cumsum(counts) - counts, counts)
            cand = nbrs[np.repeat(starts, counts) + rel]
            cand = cand[dist[cand] < 0]
            if not cand.size:
                break
            dist[cand] = d
            frontier = np.flatnonzero(dist == d).astype(np.int32)
        return dict(zip(names, dist.tolist()))

    def _bfs_many(self, dst_ids: np.ndarray) -> np.ndarray:
        """Hop counts to many destinations in ONE shared frontier sweep.

        Returns a (K, N) int32 matrix, row k = distances to dst_ids[k]
        (-1 where unreachable).  All K BFS expansions advance level by
        level together, so the CSR gathers amortize across destinations
        — the batched replacement for K scalar ``_bfs`` calls when
        staging a whole sweep's groups at once.
        """
        names, index, indptr, nbrs, _ = self._adjacency()
        N = len(names)
        K = len(dst_ids)
        dist = np.full((K, N), -1, np.int32)
        fk = np.arange(K, dtype=np.int64)
        fn = np.asarray(dst_ids, np.int64)
        dist[fk, fn] = 0
        d = 0
        while fn.size:
            d += 1
            starts = indptr[fn].astype(np.int64)
            counts = (indptr[fn + 1] - indptr[fn]).astype(np.int64)
            total = int(counts.sum())
            if not total:
                break
            rel = np.arange(total, dtype=np.int64) \
                - np.repeat(np.cumsum(counts) - counts, counts)
            cand_n = nbrs[np.repeat(starts, counts) + rel].astype(np.int64)
            cand_k = np.repeat(fk, counts)
            fresh = dist[cand_k, cand_n] < 0
            if not fresh.any():
                break
            # dedupe (k, node) pairs discovered via several frontier
            # nodes at once; unique also keeps the frontier sorted
            flat = np.unique(cand_k[fresh] * N + cand_n[fresh])
            fk = flat // N
            fn = flat - fk * N
            dist[fk, fn] = d
        return dist

    # destinations per batched-BFS chunk: bounds the (K, N) distance
    # matrix (256 cols x ~17k nodes x int32 ~= 17MB on the 16k-host
    # fat tree) while keeping the shared-frontier amortization
    PATHS_CHUNK = 256

    def paths_many(self, requests: Sequence[Tuple[str, str, int]]
                   ) -> List[Tuple[Tuple[str, int], ...]]:
        """Batch ``path_links`` over many (src, dst, flow_key) requests.

        Destinations are grouped into chunks; each chunk runs one shared
        ``_bfs_many`` sweep and then every request advances one hop per
        vectorized step (padded candidate gather + masked ``flow_key %
        n_cands`` pick).  Bit-identical to per-request ``path_links``
        because the CSR preserves ascending-port candidate order and
        excludes down links at build time.
        """
        if not requests:
            return []
        names, index, indptr, nbrs, prt = self._adjacency()
        out: List[Optional[list]] = [None] * len(requests)
        by_dst: Dict[str, List[int]] = {}
        for i, (src, dst, key) in enumerate(requests):
            if src == dst:
                out[i] = []
            else:
                by_dst.setdefault(dst, []).append(i)
        dst_names = sorted(by_dst)
        max_deg = int(np.max(np.diff(indptr))) if len(names) else 0
        deg_cols = np.arange(max_deg, dtype=np.int32)
        for c0 in range(0, len(dst_names), self.PATHS_CHUNK):
            chunk = dst_names[c0:c0 + self.PATHS_CHUNK]
            dst_ids = np.asarray([index[d] for d in chunk], np.int32)
            dist = self._bfs_many(dst_ids)
            ridx: List[int] = []
            cur: List[int] = []
            col: List[int] = []
            keys: List[int] = []
            for k, dname in enumerate(chunk):
                for i in by_dst[dname]:
                    ridx.append(i)
                    cur.append(index[requests[i][0]])
                    col.append(k)
                    keys.append(requests[i][2])
                    out[i] = []
            cur_a = np.asarray(cur, np.int64)
            col_a = np.asarray(col, np.int64)
            key_a = np.asarray(keys, np.int64)
            tgt = dst_ids[col_a].astype(np.int64)
            alive = np.flatnonzero(cur_a != tgt)
            while alive.size:
                n = cur_a[alive]
                k = col_a[alive]
                d = dist[k, n]
                if (d < 0).any():
                    bad = int(alive[np.flatnonzero(d < 0)[0]])
                    i = ridx[bad]
                    raise ValueError(
                        f"{requests[i][1]!r} is unreachable from "
                        f"{requests[i][0]!r}")
                starts = indptr[n].astype(np.int64)
                counts = (indptr[n + 1] - indptr[n]).astype(np.int64)
                md = int(counts.max())
                pad = deg_cols[:md]
                gidx = np.where(pad[None, :] < counts[:, None],
                                starts[:, None] + pad[None, :], 0)
                valid = pad[None, :] < counts[:, None]
                pn = nbrs[gidx].astype(np.int64)
                cand = valid & (dist[k[:, None], pn] == (d - 1)[:, None])
                ncand = cand.sum(axis=1)
                if (ncand == 0).any():
                    bad = int(alive[np.flatnonzero(ncand == 0)[0]])
                    i = ridx[bad]
                    raise ValueError(
                        f"{requests[i][1]!r} is unreachable from "
                        f"{requests[i][0]!r}")
                pick = key_a[alive] % ncand
                # index of the pick-th True per row, in CSR (port) order
                sel = np.argmax(np.cumsum(cand, axis=1)
                                == (pick + 1)[:, None], axis=1)
                rows = np.arange(alive.size)
                port_sel = prt[gidx[rows, sel]]
                nxt = pn[rows, sel]
                for r in range(alive.size):
                    out[ridx[int(alive[r])]].append(
                        (names[int(n[r])], int(port_sel[r])))
                cur_a[alive] = nxt
                alive = alive[nxt != tgt[alive]]
        return [tuple(p) for p in out]

    def _dist_cache_cap(self) -> int:
        """Max cached distance maps within the memory budget (>= 64)."""
        per_map = max(len(self.ports), 1) * self._DIST_ENTRY_BYTES
        return max(self.DIST_CACHE_BYTES // per_map, 64)

    def dist(self, node: str, dst: str) -> int:
        if not self.route_cache:
            return self._bfs(dst)[node]
        d = self._dist.get(dst)
        if d is None:
            d = self._dist[dst] = self._bfs(dst)
            cap = self._dist_cache_cap()
            while len(self._dist) > cap:
                self._dist.popitem(last=False)
        else:
            self._dist.move_to_end(dst)
        return d[node]

    def _cand_cache_cap(self) -> int:
        """Max cached candidate lists within the memory budget (>= 1k)."""
        return max(self.CAND_CACHE_BYTES // self._CAND_ENTRY_BYTES, 1024)

    def candidate_ports(self, node: str, dst: str) -> List[int]:
        """All ports on shortest paths node -> dst (the ECMP set).

        Memoized (LRU, byte-budgeted like ``dist``): staging a
        large-scale flow batch walks the same (intermediate node,
        destination) pairs from many sources, and each uncached call
        costs one ``dist`` lookup per port.
        """
        if node == dst:
            return []
        memo = self._cand.get((node, dst)) if self.route_cache else None
        if memo is None:
            d = self.dist(node, dst)
            if d < 0:
                raise ValueError(f"{dst!r} is unreachable from {node!r}")
            memo = [
                p for p, (peer, _) in sorted(self.ports[node].items())
                if (node, p) not in self._down
                and self.dist(peer, dst) == d - 1]
            if self.route_cache:
                self._cand[(node, dst)] = memo
                cap = self._cand_cache_cap()
                while len(self._cand) > cap:
                    self._cand.popitem(last=False)
        else:
            self._cand.move_to_end((node, dst))
        return memo

    def next_hop_port(self, node: str, dst: str, flow_key: int = 0) -> int:
        cands = self.candidate_ports(node, dst)
        return cands[flow_key % len(cands)]

    def path(self, src: str, dst: str, flow_key: int = 0) -> List[str]:
        node, out = src, [src]
        while node != dst:
            p = self.next_hop_port(node, dst, flow_key)
            node = self.ports[node][p][0]
            out.append(node)
        return out

    def path_links(self, src: str, dst: str,
                   flow_key: int = 0) -> List[Tuple[str, int]]:
        """Directed (node, port) hops along the unicast path."""
        node, out = src, []
        while node != dst:
            p = self.next_hop_port(node, dst, flow_key)
            out.append((node, p))
            node = self.ports[node][p][0]
        return out

    def link(self, node: str, port: int) -> Link:
        return self.links[(node, port)]

    def peer(self, node: str, port: int) -> Tuple[str, int]:
        return self.ports[node][port]


# ---------------------------------------------------------------- builders

GBPS = 1e9 / 8.0   # bytes/s per Gbit/s


def testbed(n_hosts: int = 4, bw: float = 100 * GBPS,
            delay: float = 0.6e-6) -> Topology:
    """Fig. 8: commodity switch + FPGA Gleam logic + 4 servers @100G."""
    t = Topology()
    t.add_switch("SW0")
    for i in range(n_hosts):
        h = f"h{i}"
        t.add_host(h)
        t.connect(h, "SW0", bw, delay)
    return t


def fig4(bw: float = 100 * GBPS, delay: float = 0.6e-6) -> Topology:
    """The 3-layer example topology of Fig. 4.

    Hosts: S=h0 (under L1), R1=h1 (L2), R2=h2 (L3), R3=h3 (L4).
    Pods: (L1,L2)+(S1,S2); (L3,L4)+(S3,S4).  Cores: C1, C2.
    """
    t = Topology()
    for c in ("C1", "C2"):
        t.add_switch(c)
    for s in ("S1", "S2", "S3", "S4"):
        t.add_switch(s)
    for l in ("L1", "L2", "L3", "L4"):
        t.add_switch(l)
    for i in range(4):
        t.add_host(f"h{i}")
    # hosts to leaves
    for i, l in enumerate(("L1", "L2", "L3", "L4")):
        t.connect(f"h{i}", l, bw, delay)
    # pod 0: L1, L2 <-> S1, S2 ; pod 1: L3, L4 <-> S3, S4
    for l in ("L1", "L2"):
        for s in ("S1", "S2"):
            t.connect(l, s, bw, delay)
    for l in ("L3", "L4"):
        for s in ("S3", "S4"):
            t.connect(l, s, bw, delay)
    # cores: C1 on (S1,S3), C2 on (S2,S4) -- two spine planes
    t.connect("S1", "C1", bw, delay)
    t.connect("S3", "C1", bw, delay)
    t.connect("S2", "C2", bw, delay)
    t.connect("S4", "C2", bw, delay)
    return t


def fat_tree(n_pods: int = 4, leaves_per_pod: int = 2,
             hosts_per_leaf: int = 4, aggs_per_pod: int = 2,
             bw: float = 200 * GBPS, delay: float = 0.6e-6) -> Topology:
    """Parametric 3-layer fat-tree, 1:1 oversubscription.

    Each leaf connects to every agg in its pod; agg plane j (one agg per
    pod) connects to a dedicated core group sized to keep capacity 1:1.
    Uplink bandwidths are scaled so ingress == egress capacity at every
    tier (flow-level capacity is what matters for the fluid simulator; the
    paper's §5.3 config is port-count-exact, ours is capacity-exact).
    """
    t = Topology()
    host_bw = bw
    # leaf: hosts_per_leaf * bw down, spread over aggs_per_pod uplinks
    leaf_up_bw = hosts_per_leaf * bw / aggs_per_pod
    # agg: leaves_per_pod * leaf_up_bw down, one core uplink per agg
    agg_up_bw = leaves_per_pod * leaf_up_bw
    for j in range(aggs_per_pod):
        t.add_switch(f"C{j}")           # one core (group) per agg plane
    for p in range(n_pods):
        for j in range(aggs_per_pod):
            t.add_switch(f"A{p}.{j}")
        for l in range(leaves_per_pod):
            leaf = f"L{p}.{l}"
            t.add_switch(leaf)
            for h in range(hosts_per_leaf):
                hn = f"h{p}.{l}.{h}"
                t.add_host(hn)
                t.connect(hn, leaf, host_bw, delay)
            for j in range(aggs_per_pod):
                t.connect(leaf, f"A{p}.{j}", leaf_up_bw, delay)
        for j in range(aggs_per_pod):
            t.connect(f"A{p}.{j}", f"C{j}", agg_up_bw, delay)
    return t


def host_ip_map(topo: Topology) -> Dict[str, int]:
    """Stable host-name -> integer IP assignment (IPs >= 1)."""
    return {h: i + 1 for i, h in enumerate(topo.hosts)}
