"""Atomic, keep-k, grid-agnostic ``.npz`` checkpoints."""
