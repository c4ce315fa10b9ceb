"""PyTorch flow-level backend — the port of the reference's
``core/flowsim_jax.py:JaxFlowSim``.

Same fluid model as ``flowsim.FlowSim`` (max-min fair shares over the
link-flow incidence; a Gleam multicast tree is ONE flow across the union
of its tree links), solved on dense tensors:

- **inner loop**: progressive-filling max-min allocation —
  ``kernels/maxmin.py:maxmin_rates``, which on a CUDA tensor is ONE
  launch of the ``maxmin_fill`` kernel with every round inside it, and on
  a CPU tensor the plain PyTorch rounds of ``kernels/ref.py``;
- **outer loop** (``_simulate``): the fluid event loop — advance time to
  the next flow completion at the current rates, zero finished flows,
  re-allocate.  It is plain PyTorch and reads one flag pair back to the
  host per epoch (the only host sync of an epoch; ``SOLVE_STATS`` counts
  them).  A serial solve warm-starts: when an epoch's completed flows
  share no link with any survivor the previous rates are reused and the
  filling is skipped (max-min allocations decompose over connected
  components of the flow-link interference graph).

Flows are an (F, H) matrix of link ids padded with a sentinel link of
infinite capacity.  F and H are padded to power-of-two buckets as in the
reference, so ``_plan_batches`` groups epochs identically; then every
lane's link ids are renumbered into a compact local range
(``compact_links``) so that the kernel's per-link vectors are as short
as the lane's own link set — short enough for shared memory in the
many-small-lanes case.  Neither padding nor renumbering changes a rate.

``solve_many`` solves INDEPENDENT epochs as lanes of one batch (the
reference's ``vmap`` axis, written out); ``segment_rates_many`` solves
the dynamic-segment fairness snapshots as float64 lanes under the
numpy-matched ``SEG_TOL``/``SEG_ROUNDS`` regime, then applies the loss
factors (two kernel launches per batch).

**Precision**: float32 until the largest staged volume exceeds the
float32 safe-integer range (2^24 bytes), float64 beyond; ``solve_dtype``
records the choice.

**Device**: ``device`` defaults to ``"cuda"`` and raises when no card is
present; ``device="cpu"`` runs the plain PyTorch versions.  Nothing
chooses between them behind the caller's back.
"""
from __future__ import annotations

import math
import threading
import time
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core.fattree import Topology
from repro_torch.core.flowsim import DCQCN_MIN_RATE, DCQCN_RATE_NUM, Flow, \
    LinkMap
from repro_torch.device import resolve_device
from repro_torch.kernels import maxmin as mm
from repro_torch.kernels import ref

#: volumes above this lose integer precision in float32 (2^24 bytes)
F32_SAFE_MAX = float(1 << 24)

#: padded-batch budget for ``_plan_batches`` (int32 link-id bytes)
MAX_BATCH_BYTES = 64 << 20

#: split a batch when the padded per-round work exceeds this multiple
#: of the epochs' individual work
MAX_PAD_WASTE = 4.0

#: solver telemetry, accumulated by every solve: wall time of the solve
#: calls, their count, the host syncs they made, and the padded shapes
SOLVE_STATS = {"solve_s": 0.0, "calls": 0, "syncs": 0, "shapes": []}
_STATS_LOCK = threading.Lock()

#: dynamic-segment solves mirror the numpy ``flowsim.static_maxmin``
#: filling: float64, the same relative freeze slack, the same 64-round cap
SEG_TOL = 1e-12
SEG_ROUNDS = 64


def reset_solve_stats():
    SOLVE_STATS.update(solve_s=0.0, calls=0, syncs=0, shapes=[])


def _bucket(n: int, lo: int) -> int:
    """Smallest power of two >= max(n, lo)."""
    return max(lo, 1 << max(int(n) - 1, 0).bit_length())


def compact_links(fl: np.ndarray, cap_ext: np.ndarray):
    """Renumber each lane's link ids into a compact local range.

    ``fl`` is (B, F, H) global link ids whose sentinel is the last index
    of ``cap_ext``.  Returns ``(local, cap)``: ``local`` (B, F, H) int32
    where lane b's links take ids 0..n_b-1 in ascending global order and
    the sentinel takes id Lc-1, and ``cap`` (B, Lc) with each lane's
    capacities (+inf for the sentinel and the unused ids between).
    """
    b = fl.shape[0]
    n_ids = len(cap_ext)
    sentinel = n_ids - 1
    key = fl.reshape(b, -1).astype(np.int64) \
        + (np.arange(b, dtype=np.int64) * n_ids)[:, None]
    uniq, inv = np.unique(key, return_inverse=True)
    lane = uniq // n_ids
    gid = uniq - lane * n_ids
    pos = np.arange(len(uniq)) - np.searchsorted(lane, np.arange(b))[lane]
    real = gid != sentinel
    n_caps = int(np.bincount(lane[real], minlength=b).max(initial=0)) + 1
    pos[~real] = n_caps - 1
    local = pos[inv.reshape(-1)].reshape(fl.shape).astype(np.int32)
    cap = np.full((b, n_caps), np.inf, dtype=cap_ext.dtype)
    cap[lane[real], pos[real]] = cap_ext[gid[real]]
    return local, cap


def _simulate(fl, cap, vol, loss=None, warm=True):
    """Fluid event loop over B lanes: completion times (B, F), host syncs.

    ``fl`` (B, F, H) compact link ids, ``cap`` (B, Lc), ``vol`` (B, F);
    ``loss`` a ``(q, wsq, wnd, ecn)`` tuple of (B, F) tensors or None.
    The loop carries the RAW max-min rates; with ``loss`` each epoch's
    rates are scaled by ``loss_factors`` for ``dt`` and the drained bytes
    only (so the warm start stays valid and factors never compound).
    With ``loss=None`` the loss kernel is never launched.  Lanes that are
    done sit out later epochs, as under the reference's vmap.
    """
    n_flows = fl.shape[1]
    n_caps = cap.shape[-1]
    dtype = cap.dtype
    eps = vol * 1e-6 + 1.0                  # completion slack (bytes)
    inf = torch.tensor(math.inf, dtype=dtype, device=cap.device)
    t = torch.zeros(fl.shape[0], dtype=dtype, device=cap.device)
    rem = vol.clone()
    done = torch.zeros_like(vol)
    rates = torch.zeros_like(vol)
    dirty = torch.ones((), dtype=torch.bool, device=cap.device)
    ids = ref.flat_ids(fl, n_caps) if warm else None
    syncs = it = 0
    while True:
        lane_live = (rem > 0.0).any(-1)
        go, refill = torch.stack([lane_live.any(), dirty]).tolist()
        syncs += 1
        if not go or it > n_flows:
            break
        active = rem > 0.0
        act = active.to(dtype)
        if refill or not warm:
            rates = mm.maxmin_rates(fl, cap, act)
        eff = rates
        if loss is not None:
            eff = rates * mm.loss_factors(
                fl, rates, act, cap, *loss, dcqcn_num=DCQCN_RATE_NUM,
                dcqcn_min=DCQCN_MIN_RATE)
        dt = torch.where(active, rem / eff, inf).amin(-1)
        dt = torch.where(lane_live, dt, 0.0)
        t = t + dt
        rem = torch.where(active, rem - eff * dt[:, None], 0.0)
        fin = active & (rem <= eps)
        done = torch.where(fin, t[:, None], done)
        rem = torch.where(fin, 0.0, rem)
        if warm:
            touched = ref.link_sum(fl, ids, fin.to(dtype), n_caps)
            touched[:, -1] = 0.0            # sentinel: no contention
            survive = active & ~fin
            dirty = (survive & (ref.link_gather(touched, fl).amax(-1)
                                > 0.0)).any()
        it += 1
    return done, syncs


class TorchFlowSim(LinkMap):
    """Drop-in for ``flowsim.FlowSim`` on PyTorch tensors.

    ``add()`` stages flows; ``run()`` packs them once and solves every
    completion epoch on ``device``; ``solve_many()`` solves a list of
    INDEPENDENT flow batches as lanes of one batch.
    """

    #: F and H pad to powers of two with these floors (the reference's
    #: buckets), so the batch planner groups epochs as the reference does
    F_BUCKET_MIN = 16
    H_BUCKET_MIN = 8

    def __init__(self, topo: Topology, shared_cache: bool = True,
                 device="cuda"):
        super().__init__(topo, shared_cache)
        self.device = resolve_device(device)
        self.flows: List[Flow] = []
        self.now = 0.0
        self.solve_dtype = None          # dtype of the last solve

    def add(self, links, volume, tag=None, loss=None) -> Flow:
        links = tuple(links)
        if not links:
            raise ValueError("a flow must traverse at least one link")
        f = Flow(links, float(volume), tag=tag, loss=loss)
        self.flows.append(f)
        return f

    # --------------------------------------------------------- solver glue

    def _select_dtype(self, flows: Sequence[Flow]):
        """float32 until volumes outgrow its integer precision."""
        vmax = max((f.volume for f in flows), default=0.0)
        return np.float64 if vmax > F32_SAFE_MAX else np.float32

    def _pack(self, flows: Sequence[Flow], dtype, f_pad: int, h_pad: int):
        """(f_pad, h_pad) link-id matrix + (f_pad,) volumes; padding
        rows/columns point at the infinite-capacity sentinel link."""
        sentinel = len(self.cap)
        n = len(flows)
        fl = np.full((f_pad, h_pad), sentinel, np.int32)
        vol = np.zeros(f_pad, dtype)
        if n:
            lens = np.fromiter((len(f.links) for f in flows), np.int64, n)
            total = int(lens.sum())
            flat = np.fromiter((l for f in flows for l in f.links),
                               np.int32, total)
            rows = np.repeat(np.arange(n), lens)
            cols = np.arange(total) - np.repeat(np.cumsum(lens) - lens,
                                                lens)
            fl[rows, cols] = flat
            vol[:n] = np.fromiter((f.volume for f in flows), np.float64, n)
        return fl, vol

    def _shape(self, flows: Sequence[Flow]):
        h = max(len(f.links) for f in flows)
        return _bucket(len(flows), self.F_BUCKET_MIN), \
            _bucket(h, self.H_BUCKET_MIN)

    def _pack_loss(self, flows: Sequence[Flow], dtype, f_pad: int):
        """(q, wsq, wnd, ecn) per-flow loss-model rows, each (f_pad,).
        All-zero rows — padding and lossless flows — solve at factor
        exactly 1."""
        arrs = np.zeros((4, f_pad), dtype)
        lossy = [(i, f.loss) for i, f in enumerate(flows)
                 if f.loss is not None]
        if lossy:
            ii = np.fromiter((i for i, _ in lossy), np.int64, len(lossy))
            arrs[0, ii] = [lp.q for _, lp in lossy]
            arrs[1, ii] = [lp.wsq for _, lp in lossy]
            arrs[2, ii] = [lp.wnd for _, lp in lossy]
            arrs[3, ii] = [1.0 if lp.ecn else 0.0 for _, lp in lossy]
        return tuple(arrs)

    def _cap_ext(self, dtype):
        return np.append(self.cap, np.inf).astype(dtype)

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _record(self, t0: float, syncs: int, shape) -> None:
        with _STATS_LOCK:
            SOLVE_STATS["solve_s"] += time.perf_counter() - t0
            SOLVE_STATS["calls"] += 1
            SOLVE_STATS["syncs"] += syncs
            SOLVE_STATS["shapes"].append(tuple(shape))

    def _dispatch(self, fl, cap, vol, loss=None, warm=False) -> np.ndarray:
        """Solve (B, F, H) lanes on the device, timed; (B, F) done times."""
        t0 = time.perf_counter()
        local, capl = compact_links(fl, cap)
        args = [self._tensor(local), self._tensor(capl), self._tensor(vol)]
        if loss is not None:
            args.append(tuple(self._tensor(a) for a in loss))
        done, syncs = _simulate(*args, warm=warm)
        done = done.cpu().numpy()
        self._record(t0, syncs + 1, fl.shape)
        return done

    def _finish(self, flows: Sequence[Flow], done: np.ndarray) -> float:
        """Back-fill completion bookkeeping WITHOUT touching volumes.

        A flow's expected RTO stall (``LossParams.tail``) lands here: it
        delays the completion timestamp without occupying fabric time in
        the solve.  The tail is added per flow as a Python float, in the
        reference's order.
        """
        n = len(flows)
        dts = np.asarray(done[:n], np.float64).tolist()
        end = 0.0
        for f, d in zip(flows, dts):
            if f.loss is not None:
                d += f.loss.tail
            f.done_t = d
            f.remaining = 0.0
            if d > end:
                end = d
        return end

    def run(self) -> float:
        if not self.flows:
            return self.now
        flows = self.flows
        dtype = self._select_dtype(flows)
        self.solve_dtype = dtype
        f_pad, h_pad = self._shape(flows)
        fl, vol = self._pack(flows, dtype, f_pad, h_pad)
        loss = None
        if any(f.loss is not None for f in flows):
            loss = tuple(a[None] for a in self._pack_loss(flows, dtype,
                                                           f_pad))
        done = self._dispatch(fl[None], self._cap_ext(dtype), vol[None],
                              loss, warm=True)
        self.now = self._finish(flows, done[0])
        return self.now

    # ------------------------------------------------------- batched solve

    def _plan_batches(self, epochs, indices, shapes=None):
        """Group epoch ``indices`` into padded stacks under the
        ``MAX_BATCH_BYTES`` and ``MAX_PAD_WASTE`` budgets (the
        reference's planner): epochs sorted by H bucket first, so
        shape-compatible epochs are adjacent."""
        if shapes is None:
            shapes = {i: self._shape(epochs[i]) for i in indices}
        shaped = sorted(indices, key=lambda i: shapes[i][::-1])
        batches, cur = [], []
        f_max = h_max = own = 0
        for i in shaped:
            f, h = shapes[i]
            nf, nh = max(f_max, f), max(h_max, h)
            ne = len(cur) + 1
            if cur and (ne * nf * nh * 4 > MAX_BATCH_BYTES
                        or ne * nf * nh > MAX_PAD_WASTE * (own + f * h)):
                batches.append(cur)
                cur, nf, nh, own = [], f, h, 0
            cur.append(i)
            f_max, h_max, own = nf, nh, own + f * h
        if cur:
            batches.append(cur)
        return batches

    def solve_many(self, epochs: Sequence[Sequence[Flow]]):
        """Solve INDEPENDENT flow batches (epochs) as lanes of one batch.

        Every epoch is an isolated fabric whose clock starts at 0.
        Returns the per-epoch completion time; per-flow ``done_t`` is
        filled in as by ``run()``.
        """
        epochs = [list(ep) for ep in epochs]
        out = [0.0] * len(epochs)
        nonempty = [i for i, ep in enumerate(epochs) if ep]
        if not nonempty:
            return out
        vmax = max(max(f.volume for f in epochs[i]) for i in nonempty)
        dtype = np.float64 if vmax > F32_SAFE_MAX else np.float32
        self.solve_dtype = dtype
        cap = self._cap_ext(dtype)
        shapes = {i: self._shape(epochs[i]) for i in nonempty}
        for batch in self._plan_batches(epochs, nonempty, shapes):
            f_pad = max(shapes[i][0] for i in batch)
            h_pad = max(shapes[i][1] for i in batch)
            packed = [self._pack(epochs[i], dtype, f_pad, h_pad)
                      for i in batch]
            fl = np.stack([p[0] for p in packed])
            vol = np.stack([p[1] for p in packed])
            loss = None
            if any(f.loss is not None for i in batch for f in epochs[i]):
                rows = [self._pack_loss(epochs[i], dtype, f_pad)
                        for i in batch]
                loss = tuple(np.stack([r[k] for r in rows])
                             for k in range(4))
            done = self._dispatch(fl, cap, vol, loss)
            for row, i in enumerate(batch):
                out[i] = self._finish(epochs[i], done[row])
        self.now = max([self.now] + out)
        return out

    # --------------------------------------------- dynamic-segment solve

    def segment_rates_many(self, problems) -> List[float]:
        """Batched override of ``LinkMap.segment_rates_many``.

        Same contract as the numpy version (one ``(link_sets, loss)``
        problem per dynamic segment, OWN flow last; returns the own
        flow's loss-corrected rate); every problem is one float64 lane,
        solved under ``SEG_TOL``/``SEG_ROUNDS`` and corrected by the loss
        factors (all-zero loss rows give exactly 1).
        """
        out = [0.0] * len(problems)
        if not problems:
            return out
        dtype = np.float64
        self.solve_dtype = dtype
        cap = self._cap_ext(dtype)
        sentinel = len(self.cap)
        shapes = {}
        for i, (sets, _) in enumerate(problems):
            f, h = len(sets), max(len(ls) for ls in sets)
            shapes[i] = (_bucket(f, self.F_BUCKET_MIN),
                         _bucket(h, self.H_BUCKET_MIN))
        batches = self._plan_batches(problems, list(range(len(problems))),
                                     shapes)
        for batch in batches:
            f_pad = max(shapes[i][0] for i in batch)
            h_pad = max(shapes[i][1] for i in batch)
            nb = len(batch)
            fl = np.full((nb, f_pad, h_pad), sentinel, np.int32)
            act = np.zeros((nb, f_pad), dtype)
            own = np.zeros(nb, np.int64)
            lrows = np.zeros((4, nb, f_pad), dtype)
            for r, i in enumerate(batch):
                sets, lp = problems[i]
                n = len(sets)
                lens = np.fromiter((len(ls) for ls in sets), np.int64, n)
                total = int(lens.sum())
                flat = np.fromiter((l for ls in sets for l in ls),
                                   np.int32, total)
                rows = np.repeat(np.arange(n), lens)
                cols = np.arange(total) - np.repeat(
                    np.cumsum(lens) - lens, lens)
                fl[r, rows, cols] = flat
                act[r, :n] = 1.0
                own[r] = n - 1
                if lp is not None:
                    lrows[:, r, n - 1] = (lp.q, lp.wsq, lp.wnd,
                                          1.0 if lp.ecn else 0.0)
            t0 = time.perf_counter()
            local, capl = compact_links(fl, cap)
            fl_t, cap_t, act_t = (self._tensor(a) for a in (local, capl, act))
            rates = mm.maxmin_rates(fl_t, cap_t, act_t, tol=SEG_TOL,
                                    max_rounds=SEG_ROUNDS)
            fac = mm.loss_factors(fl_t, rates, act_t, cap_t,
                                  *(self._tensor(a) for a in lrows),
                                  dcqcn_num=DCQCN_RATE_NUM,
                                  dcqcn_min=DCQCN_MIN_RATE)
            idx = self._tensor(own)[:, None]
            vals = (rates.gather(1, idx) * fac.gather(1, idx))[:, 0]
            vals = vals.cpu().tolist()
            self._record(t0, 1, fl.shape)
            for r, i in enumerate(batch):
                out[i] = vals[r]
        return out
