"""Atomic, background checkpointing of tensor trees (`store`)."""
