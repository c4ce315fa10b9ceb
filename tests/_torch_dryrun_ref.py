"""The reference side of the dry run's checks (``tests/test_torch_dryrun.py``,
``tools/dryrun_compare.py``), run in one subprocess on 16 forced host
devices (``tests/conftest.py`` ``run_devices``).

- ``table``: ``shape_runnable``, ``n_params``, the step's kind and the
  train step's clamped microbatches of every configuration and shape on
  the pod and the multipod, planned on abstract meshes (``PlanMesh``:
  the reference's ``ShardingPlan`` reads the device grid's shape);
- ``cells``: on a (4, 4) mesh of ``Auto`` axes, granite's and mixtral's
  smoke configs at ``SMOKE_TABLE``'s cells: the compiled module's
  argument bytes and collective bytes by kind, and for a train cell
  ``probe_terms``' FLOPs and collective bytes by kind.  ``jax.make_mesh``
  gives ``Explicit`` axes in jax 0.9, on which the reference's train
  step does not lower (ROADMAP queue 3).
"""
from __future__ import annotations

import json

from tests.conftest import run_devices

#: the smoke cells both sides trace on (4, 4)
SMOKE_TABLE = {"train_4k": dict(seq=256, batch=16, kind="train", accum=2),
               "decode_32k": dict(seq=256, batch=16, kind="decode")}
SMOKE_ARCHS = ("granite_3_2b", "mixtral_8x7b")

REF_SRC = r"""
import json
import numpy as np
import jax
from jax.sharding import AxisType
from repro.configs.base import ARCH_IDS, get_config
from repro.launch import steps
from repro.launch.dryrun import probe_terms
from repro.launch.roofline import collective_bytes


class PlanMesh(jax.sharding.AbstractMesh):
    @property
    def devices(self):
        return np.empty(self.axis_sizes, dtype=object)


seen = {}
make_train_step = steps.make_train_step


def spy(cfg, mesh, opt_cfg=None, accum_steps=1):
    seen["accum"] = accum_steps
    return make_train_step(cfg, mesh, opt_cfg, accum_steps)


steps.make_train_step = spy
table = {}
for name, shape, axes in (("pod", (16, 16), ("data", "model")),
                          ("multipod", (2, 16, 16),
                           ("pod", "data", "model"))):
    mesh = PlanMesh(shape, axes, axis_types=(AxisType.Auto,) * len(shape))
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shp in steps.SHAPE_TABLE:
            seen.clear()
            ok, _ = steps.shape_runnable(cfg, shp)
            spec = steps.lowering_spec(cfg, shp, mesh)
            table[f"{arch}/{shp}/{name}"] = dict(
                runnable=ok, n_params=spec.n_params, kind=spec.kind,
                accum=seen.get("accum"))
steps.make_train_step = make_train_step

mesh = jax.make_mesh((4, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
steps.SHAPE_TABLE.update(%(smoke)r)
cells = {}
for arch in %(archs)r:
    cfg = get_config(arch, smoke=True)
    for shp in %(shapes)r:
        lowered, spec = steps.lower_cell(cfg, shp, mesh)
        compiled = lowered.compile()
        rec = dict(
            argument_bytes=compiled.memory_analysis().argument_size_in_bytes,
            collectives=collective_bytes(compiled.as_text())["bytes"])
        if spec.kind == "train":
            probes = probe_terms(cfg, shp, mesh)
            rec.update(flops=probes["flops"],
                       probe_collectives=probes["coll_by_kind"])
        cells[f"{arch}/{shp}"] = rec
print("REF " + json.dumps({"table": table, "cells": cells}))
"""


def run_reference() -> dict:
    """``{"table": ..., "cells": ...}`` from the reference package."""
    out = run_devices(REF_SRC % dict(smoke=SMOKE_TABLE, archs=SMOKE_ARCHS,
                                     shapes=tuple(SMOKE_TABLE)),
                      n_devices=16, timeout=900)
    return json.loads(out.split("REF ", 1)[1])
