"""The decomposed lattice over ``torch.distributed``: halo exchange, the
generic loop, and the 2-D and 3-D Ising bindings."""
