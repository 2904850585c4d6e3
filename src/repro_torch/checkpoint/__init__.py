"""Atomic, asynchronous checkpoints of the training state."""
