"""PyTorch / CUDA port of the Ising Monte Carlo system.

A second package beside the JAX reference ``repro``, with the same module
layout and names. It imports ``torch`` and numpy, never ``jax`` and
nothing of ``repro``. See ``repro_torch.api`` for the front door.
"""
