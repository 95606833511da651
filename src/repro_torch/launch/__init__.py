"""Process grids and the simulation, serving and training launchers."""
