"""Packet model for the faithful Gleam layer (DESIGN.md §2.1).

One packet class covers every packet kind the paper uses:

- DATA      — RC data segment (SEND or WRITE; WRITE's first packet carries
              the RETH MR info: va / rkey).
- ACK       — cumulative acknowledgement: acks every PSN <= psn.
- NACK      — out-of-sequence NAK: psn is the receiver's *expected* PSN;
              implicitly acks every PSN < psn (go-back-N semantics, §3.4).
- CNP       — congestion notification (DCQCN-style); carries no PSN.
- ENVELOPE  — control-plane registration (Appendix A, Fig. 17); payload is
              the list of member (ip, qpn, va, rkey) states.
- ENVELOPE_ACK — member participation confirmation back to the master.
- MR_UPDATE — the extra small WRITE preceding each one-to-many WRITE that
              carries per-receiver MR states for the leaf switches (§3.3).

PSNs live in a 24-bit space (2^23 comparison window per the IB spec; the
P4 mode tightens it to 2^22 — §4).  ``psn_geq``/``psn_gt`` implement the
wrapped comparison used everywhere instead of raw ``>=``.

``Packet`` is the single hottest allocation of the packet engine (one
object per hop-copy: a 512-receiver bcast makes 511 copies per data
packet at the replicating switch), so it is a ``__slots__`` class backed
by a free-list pool instead of a dataclass:

- ``data_packet``/``ack_packet``/... and ``Packet.copy`` allocate from
  the pool when it is non-empty, refreshing every field (including a
  fresh ``uid``);
- the simulator returns packets via ``release()`` at the two points a
  packet provably has no live references left: consumed by a host's RC
  logic, or discarded by the loss model / an absorbing switch;
- the pool is best-effort: packets that never reach a release point
  (e.g. drained from a cleared event queue) simply fall to the GC.

Only code that owns a packet outright may ``release`` it — the pool
trades allocation cost for that discipline.

The port's own copy of the reference ``core/packet.py``: the port imports
nothing of the reference package.
"""
from __future__ import annotations

import itertools
from typing import Any, List, Optional

MTU = 1500                      # bytes of payload per DATA packet
HDR = 58                        # Eth+IP+UDP+BTH+ICRC overhead bytes
ACK_SIZE = 64                   # feedback packets are minimum-size frames
PSN_BITS = 24
PSN_MOD = 1 << PSN_BITS
PSN_WINDOW = 1 << 23            # standard comparison window
PSN_WINDOW_P4 = 1 << 22         # P4 single-stage variant (§4)

DATA = "data"
ACK = "ack"
NACK = "nack"
CNP = "cnp"
ENVELOPE = "envelope"
ENVELOPE_ACK = "envelope_ack"
MR_UPDATE = "mr_update"

_ids = itertools.count()


def psn_add(a: int, b: int) -> int:
    return (a + b) % PSN_MOD


def psn_sub(a: int, b: int) -> int:
    return (a - b) % PSN_MOD


def psn_geq(a: int, b: int, window: int = PSN_WINDOW) -> bool:
    """a >= b in the wrapped PSN space (within `window` of each other)."""
    return (a - b) % PSN_MOD < window


def psn_gt(a: int, b: int, window: int = PSN_WINDOW) -> bool:
    return a != b and (a - b) % PSN_MOD < window


def psn_max(a: int, b: int, window: int = PSN_WINDOW) -> int:
    return a if (a - b) % PSN_MOD < window else b


def psn_min(a: int, b: int, window: int = PSN_WINDOW) -> int:
    return b if (a - b) % PSN_MOD < window else a


class Packet:
    __slots__ = ("kind", "src_ip", "dst_ip", "dst_qpn", "src_qpn", "psn",
                 "size", "op", "va", "rkey", "msg_id", "last", "ecn",
                 "payload", "uid")

    def __init__(self, kind: str, src_ip: int, dst_ip: int,
                 dst_qpn: int = 0, src_qpn: int = 0, psn: int = 0,
                 size: int = ACK_SIZE, op: str = "send", va: int = 0,
                 rkey: int = 0, msg_id: int = 0, last: bool = False,
                 ecn: bool = False, payload: Any = None,
                 uid: Optional[int] = None):
        self.kind = kind
        self.src_ip = src_ip
        self.dst_ip = dst_ip                 # GroupIP for multicast traffic
        self.dst_qpn = dst_qpn
        self.src_qpn = src_qpn
        self.psn = psn
        self.size = size                     # bytes on the wire
        # WRITE / RETH state (first packet of a WRITE request)
        self.op = op                         # send | write
        self.va = va
        self.rkey = rkey
        # message bookkeeping (not on the wire; simulation-side)
        self.msg_id = msg_id
        self.last = last                     # end-of-message bit
        self.ecn = ecn                       # ECN-CE mark (congestion)
        self.payload = payload
        self.uid = next(_ids) if uid is None else uid

    def copy(self) -> "Packet":
        q = _alloc(self.kind, self.src_ip, self.dst_ip, self.dst_qpn,
                   self.src_qpn, self.psn, self.size, self.op, self.va,
                   self.rkey, self.msg_id, self.last)
        q.ecn = self.ecn
        q.payload = self.payload
        return q

    def __repr__(self) -> str:  # debugging aid only
        return (f"Packet({self.kind}, src={self.src_ip}, dst={self.dst_ip}"
                f", qpn={self.dst_qpn}, psn={self.psn}, size={self.size}"
                f", op={self.op}, uid={self.uid})")


# ------------------------------------------------------------ free list

_pool: List[Packet] = []
_POOL_MAX = 1 << 16             # backstop: never hoard unbounded memory


def release(p: Packet) -> None:
    """Return a packet whose last reference is being dropped to the
    free list.  The payload reference is cleared immediately so pooled
    packets never pin control-plane dicts alive."""
    p.payload = None
    if len(_pool) < _POOL_MAX:
        _pool.append(p)


def pool_size() -> int:
    """Current free-list occupancy (tests/benchmarks introspection)."""
    return len(_pool)


def _alloc(kind, src_ip, dst_ip, dst_qpn, src_qpn, psn, size, op, va,
           rkey, msg_id, last) -> Packet:
    if _pool:
        p = _pool.pop()
        p.kind = kind
        p.src_ip = src_ip
        p.dst_ip = dst_ip
        p.dst_qpn = dst_qpn
        p.src_qpn = src_qpn
        p.psn = psn
        p.size = size
        p.op = op
        p.va = va
        p.rkey = rkey
        p.msg_id = msg_id
        p.last = last
        p.ecn = False
        p.payload = None
        p.uid = next(_ids)
        return p
    return Packet(kind, src_ip, dst_ip, dst_qpn, src_qpn, psn, size, op,
                  va, rkey, msg_id, last)


def data_packet(src_ip, dst_ip, dst_qpn, psn, nbytes, *, op="send", va=0,
                rkey=0, msg_id=0, last=False, src_qpn=0) -> Packet:
    return _alloc(DATA, src_ip, dst_ip, dst_qpn, src_qpn, psn,
                  nbytes + HDR, op, va, rkey, msg_id, last)


def ack_packet(src_ip, dst_ip, psn, *, dst_qpn=0, ecn=False) -> Packet:
    p = _alloc(ACK, src_ip, dst_ip, dst_qpn, 0, psn, ACK_SIZE, "send",
               0, 0, 0, False)
    p.ecn = ecn
    return p


def nack_packet(src_ip, dst_ip, epsn, *, dst_qpn=0) -> Packet:
    return _alloc(NACK, src_ip, dst_ip, dst_qpn, 0, epsn, ACK_SIZE,
                  "send", 0, 0, 0, False)


def cnp_packet(src_ip, dst_ip, *, dst_qpn=0) -> Packet:
    return _alloc(CNP, src_ip, dst_ip, dst_qpn, 0, 0, ACK_SIZE, "send",
                  0, 0, 0, False)
