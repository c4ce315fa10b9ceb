"""Topology, workload IR, the packet simulator and the engines (see
``engine.py``)."""
