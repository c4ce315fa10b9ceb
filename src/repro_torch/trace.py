"""What a dry run counts (``launch/steps.lower_cell``).

A dry run traces one rank's step on fake tensors (``device.traced``):
no data, no kernel, no transfer.  While ``counting()`` is active:

- each kernel wrapper, given a fake tensor, adds one call of its kernel
  with the operations and bytes of its cost function (``kernels/*.cost``)
  to ``kernel`` in place of a launch;
- each function of ``core/collectives`` that moves data adds the bytes
  of its result (a point-to-point round: the bytes this rank receives)
  under the reference's kinds (``KINDS``), with the global ranks of the
  group it ran on, to ``collective``;
- ``Tally``, a dispatch mode, adds the bytes every aten op reads and
  writes, and follows the live fake storages to their peak.

Outside ``counting()`` the hooks return at once and nothing is kept.
Every count is a sum keyed by a kernel's name or a (kind, group) pair,
so a trace of any length keeps a few dozen numbers.
"""
from __future__ import annotations

import contextlib
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

#: the collective kinds, named as the reference's HLO names them
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


class Counts:
    """``kernels``: ``{name: [calls, operations, bytes]}``;
    ``collectives``: ``{(kind, ranks): [calls, bytes]}``, ``ranks`` the
    sorted global ranks of the group."""

    def __init__(self):
        self.kernels: dict = {}
        self.collectives: dict = {}


#: the counts of the dry run in progress, else None
ACTIVE: Counts | None = None


@contextlib.contextmanager
def counting():
    """Collect kernel calls and collectives into a new ``Counts``."""
    global ACTIVE
    if ACTIVE is not None:
        raise RuntimeError("a dry run is already counting")
    ACTIVE = Counts()
    try:
        yield ACTIVE
    finally:
        ACTIVE = None


def kernel(name: str, ops: int, n_bytes: int) -> None:
    """One call of kernel ``name`` on fake tensors."""
    if ACTIVE is not None:
        c = ACTIVE.kernels.setdefault(name, [0, 0, 0])
        c[0] += 1
        c[1] += int(ops)
        c[2] += int(n_bytes)


def collective(kind: str, n_bytes: int, ranks) -> None:
    """One collective of ``kind`` whose result (on this rank) is
    ``n_bytes``, on the group of global ``ranks``."""
    if ACTIVE is not None:
        c = ACTIVE.collectives.setdefault((kind, tuple(sorted(ranks))),
                                          [0, 0])
        c[0] += 1
        c[1] += int(n_bytes)


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(obj, out):
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            _tensors(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            _tensors(o, out)
    return out


#: ops that allocate without reading or writing anything
_ALLOCATE = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                       "new_empty_strided"))


class Tally(TorchDispatchMode):
    """FLOPs, bytes moved and peak live bytes of the ops run under it.

    ``flops``: the products' FLOPs, by the registry ``FlopCounterMode``
    counts with (``torch.utils.flop_counter.flop_registry``: matrix
    products, convolutions, attention), counted here so that a trace
    goes through one dispatch mode, not two.
    ``bytes``: for every aten op, each tensor argument read once and
    each result written once (``nbytes`` of the view); a view (a result
    on an argument's storage, from an op that mutates nothing), an
    allocation and an op that returns no tensor count 0.  Only ``aten``
    ops count: a collective (``c10d``) is ``collective``'s.
    ``peak``: the most bytes of fake storage alive at once, counting
    the tensors it is given (the step's arguments) from the start; a
    storage is counted when an op first returns it and dropped when it
    is freed."""

    def __init__(self, *held):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live: dict = {}
        self.current = 0
        self.peak = 0
        for t in _tensors(held, []):
            self._hold(t)

    def _freed(self, ref):
        self.current -= self.live.pop(ref)

    def _hold(self, t) -> bool:
        """Count ``t``'s storage if it is new; True if it was."""
        st = t.untyped_storage()
        ref = weakref.ref(st, self._freed)
        if ref in self.live:
            return False
        n = st.nbytes()
        self.live[ref] = n
        self.current += n
        if self.current > self.peak:
            self.peak = self.current
        return True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace != "aten":
            return out
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        results = _tensors(out, [])
        fresh = [self._hold(t) for t in results]
        view = not all(fresh) and not func._schema.is_mutable
        if results and not view and packet.__name__ not in _ALLOCATE:
            self.bytes += sum(nbytes(t) for t in _tensors((args, kwargs), []))
            self.bytes += sum(nbytes(t) for t in results)
        return out
