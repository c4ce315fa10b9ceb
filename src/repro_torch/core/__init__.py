"""Topology, workload IR and the flow engine (see ``engine.py``)."""
