"""The decoder LM: layers, the transformer and the model API (the port of
``repro.models``, its attention kinds with the dense MLP)."""
