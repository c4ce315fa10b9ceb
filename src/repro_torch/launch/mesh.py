"""Device meshes of the port.

The port of the reference package's ``launch/mesh.py``.  A ``Mesh`` names
the axes of a grid of ranks (``("data", "model")``, or ``("pod", "data",
"model")`` across pods) and gives each its size.  A mesh of live ranks
(``make_mesh``) also holds this rank's coordinate on every axis (the
reference's ``axis_index``), its device, and one process group
per axis of more than one rank: this rank's line along that axis, whose
members are the ranks that differ from it in that coordinate alone.
Rank r takes the row-major coordinate of r in the shape, as
the reference's ``make_mesh`` orders host devices, and the card
``cuda:<local rank>``.

``abstract_mesh`` gives names and sizes without ranks, which is all the
sharding planner needs: the reference plans 512-device meshes without
devices, and so does the port.  ``single_device_mesh`` needs no process
group: every sharding rule resolves to a whole tensor there, and the
model runs its one-device path unchanged.

``fake_world`` gives rank 0's mesh of a world of any size on torch's
``fake`` process-group backend, whose collectives return at once: the
dry run (``launch/dryrun.py``) traces one rank of the production meshes
with it, on no card.
"""
from __future__ import annotations

import contextlib
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


class Mesh:
    """Axis names and sizes; for a mesh of live ranks also this rank's
    coordinates, lines and process groups (``None`` on an axis of size 1:
    nothing is ever sent along it) and its device."""

    def __init__(self, axis_names, dims, *, coords=None, lines=None,
                 groups=None, device=None):
        self.axis_names = tuple(axis_names)
        self.dims = tuple(int(n) for n in dims)
        if len(self.axis_names) != len(self.dims):
            raise ValueError(f"mesh axes {self.axis_names} do not match its "
                             f"shape {self.dims}")
        self.coords = None if coords is None else tuple(coords)
        self.lines = None if lines is None else tuple(lines)
        self.groups = None if groups is None else tuple(groups)
        self.device = device

    def __repr__(self):
        return (f"Mesh({dict(zip(self.axis_names, self.dims))}, "
                f"coords={self.coords}, device={self.device})")

    @property
    def shape(self) -> dict:
        """``{axis name: size}``, as the reference's ``mesh.shape``."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    @property
    def abstract(self) -> bool:
        """True for a mesh of names and sizes only (no ranks)."""
        return self.coords is None

    def _axis(self, name: str) -> int:
        if self.abstract:
            raise ValueError(f"{self!r} is abstract: it has no ranks")
        return self.axis_names.index(name)

    def axis_index(self, name: str) -> int:
        """This rank's coordinate on axis ``name``."""
        return self.coords[self._axis(name)]

    def group(self, name: str):
        """The process group of this rank's line along ``name`` (None on
        an axis of size 1)."""
        return self.groups[self._axis(name)]

    def peer(self, name: str, index: int) -> int:
        """The global rank at coordinate ``index`` of this rank's line
        along ``name`` (the group's rank ``index``, as
        ``dist.get_global_rank`` gives it)."""
        return self.lines[self._axis(name)][index]


def abstract_mesh(shape, axes) -> Mesh:
    """A mesh of names and sizes only, for planning."""
    return Mesh(axes, shape)


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:<LOCAL_RANK>`` (the rank modulo the
    cards of the host when no launcher set it), made the current card,
    or the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        index = int(local) if local is not None else (
            dist.get_rank() % torch.cuda.device_count()
            if dist.is_initialized() else dev.index)
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    return dev


def make_mesh(shape, axes, *, device="cuda", backend=None) -> Mesh:
    """A mesh over the ranks of the initialised default process group,
    whose size must be the product of ``shape``.  Every rank must call it
    with the same arguments (it creates every line's group, and runs one
    one-element all-reduce on each of its own, so that a later
    point-to-point schedule finds its communicators made).  ``backend``
    gives the lines' groups another backend than the default group's
    (``"gloo"`` for a CPU mesh beside an NCCL world)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process "
                           "group (torch.distributed.init_process_group)")
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                         f"the world has {world}")
    dev = rank_device(device)
    mesh = _rank_mesh(shape, axes, rank, dev, backend)
    probe = torch.ones(1, device=dev)
    for g in mesh.groups:
        if g is not None:
            dist.all_reduce(probe, group=g)
    return mesh


def _rank_mesh(shape, axes, rank, dev, backend=None) -> Mesh:
    """Rank ``rank``'s mesh: its row-major coordinates, and on each axis
    of more than one rank its line and that line's group (every line's
    group is created, as ``dist.new_group`` asks of every rank)."""
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    grid = np.arange(math.prod(shape)).reshape(shape)
    lines, groups = [], []
    for i, n in enumerate(shape):
        mine, group = (rank,), None
        if n > 1:
            for line in np.moveaxis(grid, i, -1).reshape(-1, n):
                members = [int(r) for r in line]
                g = dist.new_group(members, backend=backend)
                if rank in members:
                    mine, group = tuple(members), g
        lines.append(mine)
        groups.append(group)
    return Mesh(axes, shape, coords=coords, lines=lines, groups=groups,
                device=dev)


@contextlib.contextmanager
def fake_world(shape, axes):
    """Rank 0's ``Mesh`` of ``shape`` over ``axes`` in a world of
    ``prod(shape)`` ranks on torch's ``fake`` backend (``FakeStore``),
    as ``make_mesh`` builds it there: coordinates, lines and groups,
    whose collectives return at once without touching data.  Its device
    is the CPU, the device of the dry run's fake tensors (a fake tensor
    takes the card's path, ``device.on_card``; a build of torch without
    CUDA cannot differentiate fake CUDA tensors).  Nothing asks for a
    card.  The world is initialised only where no process group exists,
    and then destroyed on exit, so a caller's state is left as found; an
    existing world must have ``prod(shape)`` ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    ours = not dist.is_initialized()
    if ours:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=math.prod(shape))
    try:
        if dist.get_world_size() != math.prod(shape):
            raise ValueError(f"a {shape} mesh needs {math.prod(shape)} "
                             f"ranks, the world has {dist.get_world_size()}")
        yield _rank_mesh(shape, axes, dist.get_rank(), torch.device("cpu"))
    finally:
        if ours:
            dist.destroy_process_group()


def production_shape(multi_pod: bool = False) -> tuple:
    """``(shape, axes)`` of the production mesh: (16, 16) over ("data",
    "model"), or (2, 16, 16) over ("pod", "data", "model")."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> Mesh:
    """The production mesh (``production_shape``); raises unless the
    world has that many ranks."""
    shape, axes = production_shape(multi_pod)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks, the world has {world}")
    return make_mesh(shape, axes, device=device)


def single_device_mesh(device="cuda") -> Mesh:
    """A (1, 1) ("data", "model") mesh on one device, no process group."""
    return Mesh(("data", "model"), (1, 1), coords=(0, 0),
                lines=((0,), (0,)), groups=(None, None),
                device=resolve_device(device))
