"""Monte Carlo serving plane: continuous-batched simulation requests.

The port of ``repro.serve``::

    from repro_torch.serve import MCServeEngine, SimRequest

    engine = MCServeEngine(replica_width=8, chunk_sweeps=16)  # the card
    rid = engine.submit(SimRequest(L=64, beta=0.44, n_sweeps=200,
                                   n_samples=4, seed=7))
    engine.run_until_idle()
    print(engine.result(rid).moments)

Every request's streamed moments are bitwise equal to a standalone
``IsingEngine(request.engine_config()).simulate(seed=request.seed)`` run,
independent of how requests were bucketed, slotted, or interleaved, and
to the JAX package's serving plane — see :mod:`repro_torch.serve.engine`
for the argument and ``tests/test_torch_serve.py`` for the pins.
"""
from repro_torch.serve.engine import MCServeEngine, slot_template
from repro_torch.serve.request import (CANCELLED, DONE, PENDING, RUNNING,
                                       RequestResult, RequestUpdate,
                                       SimRequest)
from repro_torch.serve.scheduler import BucketScheduler

__all__ = ["MCServeEngine", "SimRequest", "RequestResult", "RequestUpdate",
           "BucketScheduler", "slot_template",
           "PENDING", "RUNNING", "DONE", "CANCELLED"]
