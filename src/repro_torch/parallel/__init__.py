"""The parallel layer: the sharding planner and the pipeline schedule."""
