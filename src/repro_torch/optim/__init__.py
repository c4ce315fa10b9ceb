"""AdamW (the port of the reference's ``optim/``)."""
