"""Token pipelines (a copy of the reference's ``data/``)."""
