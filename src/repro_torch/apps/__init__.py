"""Application traffic plane — lower the LM stack onto the fabric.

The port's model stack (``repro_torch.models``, ``repro_torch.launch``,
``repro_torch.runtime``) and its network simulators (``repro_torch.core``)
meet here:

- ``collectives_lowering`` — derive TP/PP/MoE collective sizes from an
  ``ArchConfig`` and a mesh shape, emitting per-step ``Workload``s
  whose ops carry a ``phase`` label (tp-allreduce, moe-alltoall,
  pp-boundary, dp-gradsync, weights, prefill, decode, kv-replicate,
  ckpt-write).
- ``traffic`` — open-loop serving generator (seeded Poisson or
  deterministic-trace arrivals, MLPerf-offline style) mapping request
  arrivals to prefill/decode/replication ops across replicas and
  reporting offered-load vs achieved QPS.
- ``metrics`` — per-phase and per-request JCT aggregation with
  p50/p99/p999 quantiles on top of ``MsgRecord``s.

See ``docs/ARCHITECTURE.md`` §"Application traffic plane" and
``benchmarks/fig_apps.py`` for the end-to-end comparison (train-step
time and serve-QPS per transport, both engines).

The port's own copy of the reference ``apps/__init__.py``: the port imports
nothing of the reference package.
"""
from repro_torch.apps.collectives_lowering import (MeshShape, param_count,
                                                   kv_cache_bytes,
                                                   tp_allreduce_bytes,
                                                   moe_a2a_pair_bytes,
                                                   pp_boundary_bytes,
                                                   train_step_workload,
                                                   weight_bcast_workload)
from repro_torch.apps.metrics import (PhaseStats, jct, phase_stats,
                                      quantile, request_quantiles,
                                      step_time)
from repro_torch.apps.traffic import (ArrivalSpec, ServeReport,
                                      ServingGenerator)

__all__ = [
    "MeshShape", "param_count", "kv_cache_bytes", "tp_allreduce_bytes",
    "moe_a2a_pair_bytes", "pp_boundary_bytes", "train_step_workload",
    "weight_bcast_workload", "PhaseStats", "jct", "phase_stats",
    "quantile", "request_quantiles", "step_time", "ArrivalSpec",
    "ServeReport", "ServingGenerator",
]
