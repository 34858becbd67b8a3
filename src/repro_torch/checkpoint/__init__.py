"""Atomic, async checkpoints of the training state."""
