"""Over ``torch.distributed``: the decomposed lattice (halo exchange, the
generic loop, the 2-D and 3-D Ising bindings), the LM's sharding rules and
int8 gradient compression."""
