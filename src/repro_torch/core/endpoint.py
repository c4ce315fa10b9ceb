"""RC endpoint logic — the unmodified 'commodity RNIC' transport that Gleam
re-purposes (§2.1, §3.1).

One ``QP`` object carries both directions of a reliable connection:

- sender side: message queue, go-back-N window, cumulative-ACK
  interpretation, NACK-triggered rollback, retransmission timeout, and a
  DCQCN-style rate machine driven by CNPs (§3.5 reuses it untouched);
- receiver side: strict-in-order rqPSN verification (out-of-order packets
  are dropped and NACKed once per gap — RoCE semantics), ACK coalescing
  (every ``ack_freq`` packets, and always on message boundaries), WRITE
  RETH (va/rkey) validation against registered MRs, ECN-echo CNPs.

The endpoint never learns it is multicasting: it sees a single virtual
peer (GroupIP / virtual QPN) and a unicast-like feedback stream — that is
the paper's core compatibility claim, and the property tests assert it.

Appendix B source switching = ``sync_psn_for_source_switch``.

The port's own copy of the reference ``core/endpoint.py``: the port imports
nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core import packet as pk

INF = float("inf")


@dataclasses.dataclass
class Message:
    msg_id: int
    nbytes: int
    op: str                      # send | write | mr_update
    base_psn: int
    n_pkts: int
    va: int = 0
    rkey: int = 0
    payload: object = None
    t_submit: float = 0.0
    t_complete: float = -1.0     # sender-side: cumulative ACK covers last PSN


@dataclasses.dataclass
class RateState:
    """DCQCN-lite: multiplicative cut on CNP, additive recovery."""
    rate: float
    peak: float
    min_rate: float = 1e9 / 8
    alpha: float = 1.0
    g: float = 1.0 / 16
    inc: float = 5e9 / 8          # bytes/s per recovery period
    period: float = 55e-6
    last_cnp: float = -INF
    last_inc: float = 0.0

    def on_cnp(self, now: float):
        self.alpha = (1 - self.g) * self.alpha + self.g
        self.rate = max(self.min_rate, self.rate * (1 - self.alpha / 2))
        self.last_cnp = now

    def maybe_increase(self, now: float):
        if now - self.last_cnp < self.period:
            return
        while self.last_inc + self.period <= now:
            self.last_inc += self.period
            self.alpha *= (1 - self.g)
            self.rate = min(self.peak, self.rate + self.inc)


class QP:
    def __init__(self, qpn: int, ip: int, dst_ip: int, dst_qpn: int, *,
                 link_bw: float, window: int = 256, mtu: int = pk.MTU,
                 ack_freq: int = 4, rto: float = 200e-6,
                 max_retries: Optional[int] = None,
                 on_complete: Optional[Callable] = None,
                 on_deliver: Optional[Callable] = None,
                 on_error: Optional[Callable] = None):
        self.qpn = qpn
        self.ip = ip
        self.dst_ip = dst_ip
        self.dst_qpn = dst_qpn
        self.mtu = mtu
        self.window = window
        self.ack_freq = ack_freq
        self.rto = rto
        # liveness: a failed member's QP goes dead (deactivate) — the
        # NIC drops its traffic and the sender side leaves the ready set
        self.alive = True
        # bounded-retry semantics (fault plane): with ``max_retries`` set,
        # each consecutive RTO without forward progress doubles the next
        # deadline (capped 64x) and counts against the budget; at the cap
        # the QP enters a terminal error state instead of retransmitting
        # forever.  ``None`` keeps the legacy retransmit-forever behaviour
        # bit-identically (non-fault scenarios never pay for this).
        self.max_retries = max_retries
        self.retries = 0                    # consecutive unproductive RTOs
        self.error = ""                     # terminal error reason, "" = ok
        # mid-stream (re)attach marker: adopt the live stream's PSN at
        # the next DATA packet instead of NACKing from a stale rqPSN
        self.sync_next_psn = False
        self.on_complete = on_complete      # (msg, now) sender CQE
        self.on_deliver = on_deliver        # (msg_id, now) receiver done
        self.on_error = on_error            # (qp, reason, now) terminal
        # ---- NIC ready-set plumbing (set by packetsim.Host.add_qp):
        # the owning host keeps a set of QPs with sender-side work so its
        # emission loop never rescans idle connections; every transition
        # of the pending predicate below calls _ready_sync.
        self._host = None                   # packetsim.Host or None
        self._order = 0                     # stable round-robin position
        self._timer_ev = INF                # earliest armed timer event
        # ---- sender state
        self.sq_psn = 0                     # next fresh PSN to assign
        self.snd_una = 0                    # oldest unacked PSN
        self.snd_nxt = 0                    # next PSN to (re)transmit
        self.msgs: List[Message] = []
        self._done_msgs = 0
        self.rate = RateState(rate=link_bw, peak=link_bw)
        self.next_emit_t = 0.0              # rate-pacing gate
        self.timer_deadline = INF
        self.retransmitted = 0
        # ---- receiver state
        self.rq_psn = 0                     # expected PSN
        self.unacked_in = 0                 # coalescing counter
        self.nack_outstanding = False
        self.mrs: Dict[int, Tuple[int, int]] = {}   # rkey -> (va, len)
        self.mr_violations = 0
        self.delivered_bytes = 0
        self.last_cnp_t = -INF
        self.cnp_interval = 50e-6
        self.deliveries: List[Tuple[int, float]] = []

    # ------------------------------------------------------------- sender

    def _ready_sync(self) -> None:
        """Keep the owning host's ready-set consistent with this QP's
        pending predicate (the exact filter the NIC emission loop used
        to evaluate by scanning every QP)."""
        h = self._host
        if h is None:
            return
        if self.alive and (self.sq_psn != self.snd_nxt
                           or self.snd_una != self.sq_psn):
            h._mark_ready(self)
        else:
            h._mark_idle(self)

    def submit(self, nbytes: int, now: float, *, op: str = "send",
               va: int = 0, rkey: int = 0, payload=None,
               msg_id: Optional[int] = None) -> Message:
        n_pkts = max(1, math.ceil(nbytes / self.mtu))
        m = Message(msg_id if msg_id is not None else len(self.msgs),
                    nbytes, op, self.sq_psn, n_pkts, va, rkey, payload, now)
        self.msgs.append(m)
        self.sq_psn = pk.psn_add(self.sq_psn, n_pkts)
        self._ready_sync()
        return m

    def _locate(self, psn: int) -> Optional[Message]:
        # messages are contiguous in PSN space; scan from the tail cache
        for m in reversed(self.msgs):
            off = pk.psn_sub(psn, m.base_psn)
            if off < m.n_pkts:
                return m
        return None

    def has_pending(self) -> bool:
        return pk.psn_gt(self.sq_psn, self.snd_nxt) or \
            self.snd_nxt != self.sq_psn

    def outstanding(self) -> int:
        return pk.psn_sub(self.snd_nxt, self.snd_una)

    def next_packet(self, now: float) -> Tuple[Optional[pk.Packet], float]:
        """The NIC asks for the next data packet.  Returns (packet or None,
        earliest time anything could become ready)."""
        if not self.alive:
            return None, INF                       # dead/errored QP
        self.rate.maybe_increase(now)
        psn = self.snd_nxt
        if psn == self.sq_psn:
            return None, INF                       # nothing to (re)send
        if (psn - self.snd_una) % pk.PSN_MOD >= self.window:
            return None, INF                       # window closed: ACK-clocked
        if now < self.next_emit_t:
            return None, self.next_emit_t          # rate-paced
        m = self._locate(psn)
        off = (psn - m.base_psn) % pk.PSN_MOD
        nbytes = min(self.mtu, m.nbytes - off * self.mtu) if m.nbytes else 0
        nbytes = max(nbytes, 1)
        p = pk.data_packet(self.ip, self.dst_ip, self.dst_qpn, psn, nbytes,
                           op=m.op, va=m.va, rkey=m.rkey, msg_id=m.msg_id,
                           last=(off == m.n_pkts - 1), src_qpn=self.qpn)
        if m.op == "mr_update":
            p.payload = m.payload
        self.snd_nxt = (psn + 1) % pk.PSN_MOD
        self.next_emit_t = now + p.size / self.rate.rate
        if self.timer_deadline == INF:
            self.timer_deadline = now + self.rto
        return p, self.next_emit_t

    def on_ack(self, psn: int, now: float) -> None:
        """Cumulative ACK: everything <= psn is delivered everywhere."""
        M, W = pk.PSN_MOD, pk.PSN_WINDOW
        una = (psn + 1) % M
        old = self.snd_una
        if una == old or (una - old) % M >= W:     # not psn_gt(una, old)
            return
        self.retries = 0                    # forward progress: reset budget
        self.snd_una = una
        nxt = self.snd_nxt
        if una != nxt and (una - nxt) % M < W:
            self.snd_nxt = una              # ACK beyond snd_nxt (stale rtx)
        self.timer_deadline = (INF if una == self.sq_psn
                               else now + self.rto)
        # complete messages whose last PSN is covered
        while self._done_msgs < len(self.msgs):
            m = self.msgs[self._done_msgs]
            end = (m.base_psn + m.n_pkts - 1) % M
            if una == end or (una - end) % M >= W:  # not psn_gt(una, end)
                break
            m.t_complete = now
            self._done_msgs += 1
            if self.on_complete:
                self.on_complete(m, now)
        self._ready_sync()

    def on_nack(self, epsn: int, now: float) -> None:
        """Go-back-N: everything < ePSN is acked; retransmit from ePSN."""
        self.on_ack(pk.psn_sub(epsn, 1), now)
        # a stale NACK (ePSN behind the cumulative ACK) must not rewind
        # snd_nxt behind snd_una — that would leave outstanding() huge
        # and the window permanently closed
        epsn = pk.psn_max(epsn, self.snd_una)
        if pk.psn_gt(self.snd_nxt, epsn):
            self.retransmitted += pk.psn_sub(self.snd_nxt, epsn)
            self.snd_nxt = epsn
        self.retries = 0        # a NACK proves the path + peer are live
        self.timer_deadline = now + self.rto
        self._ready_sync()

    def on_cnp(self, now: float) -> None:
        self.rate.on_cnp(now)

    def on_timeout(self, now: float) -> None:
        if self.snd_una == self.sq_psn:
            self.timer_deadline = INF
            return
        if self.max_retries is not None:
            self.retries += 1
            if self.retries > self.max_retries:
                self._enter_error("retry_exceeded", now)
                return
            # exponential backoff, capped so a flapped link is re-probed
            # on a sane cadence rather than once an hour
            self.retransmitted += pk.psn_sub(self.snd_nxt, self.snd_una)
            self.snd_nxt = self.snd_una
            self.timer_deadline = now + self.rto * min(2 ** self.retries, 64)
            self._ready_sync()
            return
        self.retransmitted += pk.psn_sub(self.snd_nxt, self.snd_una)
        self.snd_nxt = self.snd_una
        self.timer_deadline = now + self.rto
        self._ready_sync()

    def _enter_error(self, reason: str, now: float) -> None:
        """Terminal: retry budget exhausted.  The QP leaves service like
        ``deactivate`` but keeps the attributable reason — every fault
        ends in measured recovery or an explicit error, never a hang."""
        if self.error:
            return
        self.error = reason
        self.alive = False
        self.timer_deadline = INF
        self._ready_sync()
        if self.on_error:
            self.on_error(self, reason, now)

    # ----------------------------------------------------------- receiver

    def register_mr(self, rkey: int, va: int, length: int) -> None:
        self.mrs[rkey] = (va, length)

    def on_data(self, p: pk.Packet, now: float) -> List[pk.Packet]:
        """RoCE receive logic; returns feedback packets to emit."""
        if self.sync_next_psn:
            # dynamic join: lock onto the live stream at whatever PSN
            # arrives first — no reset, no NACK storm for the history
            # this receiver was never meant to have
            self.sync_next_psn = False
            self.rq_psn = p.psn
            self.unacked_in = 0
            self.nack_outstanding = False
        out: List[pk.Packet] = []
        if p.ecn and now - self.last_cnp_t >= self.cnp_interval:
            self.last_cnp_t = now
            out.append(pk.cnp_packet(self.ip, p.src_ip, dst_qpn=p.src_qpn))
        rq = self.rq_psn
        if p.psn == rq:
            if p.op == "write":
                # RETH check on WRITE packets (the first packet of a
                # request carries it on the wire; our per-packet va/rkey
                # keeps the model simple, so every packet is checked)
                if p.rkey and p.rkey not in self.mrs:
                    self.mr_violations += 1
                    return out          # silently dropped (§3.3)
            self.rq_psn = rq = (rq + 1) % pk.PSN_MOD
            self.nack_outstanding = False
            size = p.size - pk.HDR
            if size > 0:
                self.delivered_bytes += size
            self.unacked_in += 1
            if p.last and self.on_deliver:
                self.deliveries.append((p.msg_id, now))
                self.on_deliver(p.msg_id, now)
            if p.last or self.unacked_in >= self.ack_freq:
                self.unacked_in = 0
                out.append(pk.ack_packet(self.ip, p.src_ip,
                                         (rq - 1) % pk.PSN_MOD,
                                         dst_qpn=p.src_qpn))
        elif rq != p.psn and (rq - p.psn) % pk.PSN_MOD < pk.PSN_WINDOW:
            # duplicate (sender went back further than our loss): re-ACK
            out.append(pk.ack_packet(self.ip, p.src_ip,
                                     (rq - 1) % pk.PSN_MOD,
                                     dst_qpn=p.src_qpn))
        else:
            # gap: NACK once per go-back-N round
            if not self.nack_outstanding:
                self.nack_outstanding = True
                out.append(pk.nack_packet(self.ip, p.src_ip, rq,
                                          dst_qpn=p.src_qpn))
        return out

    # ------------------------------------------------- membership (§3.4)

    def rearm_receiver(self) -> None:
        """Re-arm the receive side against a changed multicast stream
        WITHOUT a PSN reset: the next DATA packet's PSN becomes the
        expected PSN.  Used when a member joins a live group (its
        rqPSN is meaningless relative to the group's stream) — the
        sender side is untouched, so a later ``master-switch`` still
        finds a coherent sqPSN to synchronize (Appendix B)."""
        self.sync_next_psn = True
        self.nack_outstanding = False

    def deactivate(self) -> None:
        """Take this QP out of service (receiver failure, or the quiet
        half of a graceful leave): the NIC drops its traffic, pending
        timers never fire, and the host's ready set forgets it."""
        self.alive = False
        self.timer_deadline = INF
        self._ready_sync()

    # --------------------------------------------------------- Appendix B

    def sync_psn_for_source_switch(self, becoming_source: bool) -> None:
        """Old source: rqPSN <- sqPSN.  New source: sqPSN <- rqPSN."""
        if becoming_source:
            self.sq_psn = self.rq_psn
            self.snd_una = self.rq_psn
            self.snd_nxt = self.rq_psn
            self._ready_sync()
        else:
            self.rq_psn = self.sq_psn
