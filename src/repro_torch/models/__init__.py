"""The LM stack's decode path: blocks, attention and the dense model."""
