"""Optimizers, the train step and the fault-tolerant loop (the port of
``repro.train``)."""
