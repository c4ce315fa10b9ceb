"""The port's dry run beside the reference's on the smoke cells.

Usage (from the repository root, on a CPU host):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/dryrun_compare.py

Runs the reference package once on 16 forced host devices (a subprocess,
``tests/_torch_dryrun_ref.py``): granite's and mixtral's smoke configs at
``train_4k`` = 16 x 256 in 2 microbatches and ``decode_32k`` = 16 x 256
on a (4, 4) mesh, compiled; and traces the same cells for rank 0 of a
(4, 4) fake world with the port (``launch/steps.lower_cell``).  Prints
one JSON line a cell: argument bytes, FLOPs (the reference's
``probe_terms``, the port's product FLOPs) and collective bytes by kind
(the reference's compiled module and, for a train cell, its probes'
extrapolation; the port's trace).
"""
from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(REPO, "src"), REPO]

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import fake_world  # noqa: E402
from tests._torch_dryrun_ref import (SMOKE_ARCHS, SMOKE_TABLE,  # noqa: E402
                                     run_reference)


def main() -> int:
    ref = run_reference()["cells"]
    for arch in SMOKE_ARCHS:
        cfg = get_config(arch, smoke=True)
        for shape in SMOKE_TABLE:
            with fake_world((4, 4), ("data", "model")) as mesh:
                counts, _ = steps.lower_cell(cfg, shape, mesh,
                                             table=SMOKE_TABLE)
            kinds: dict = {}
            for c in counts["collectives"]:
                kinds[c["kind"]] = kinds.get(c["kind"], 0) + c["bytes"]
            want = ref[f"{arch}/{shape}"]
            print(json.dumps({
                "arch": arch, "shape": shape,
                "argument_bytes": [want["argument_bytes"],
                                   counts["argument_bytes"]],
                "flops": [want.get("flops"), counts["flops"]],
                "collectives_reference_module": want["collectives"],
                "collectives_reference_probes":
                    want.get("probe_collectives"),
                "collectives_port": kinds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
