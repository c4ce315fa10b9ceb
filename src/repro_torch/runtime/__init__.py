"""Serving runtime (continuous batching over the port's decode path)."""
