"""Lattice layouts, update rules, checkerboard sweeps, measurement, chains."""
