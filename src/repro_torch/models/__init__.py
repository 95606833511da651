"""The decoder LM: layers, the RG-LRU, Mamba2 and MoE blocks, the
transformer and the model API (the port of ``repro.models`` on one
device)."""
