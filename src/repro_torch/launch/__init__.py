"""Process grids and the simulation launcher."""
