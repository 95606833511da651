"""The decoder LM: layers, the RG-LRU, Mamba2 and MoE blocks (expert
parallel on a process grid), the transformer and the model API with its
logical-dim spec trees (the port of ``repro.models``)."""
