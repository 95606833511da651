"""Public API of the PyTorch port: the single front door.

    from repro_torch.api import IsingEngine, EngineConfig

    engine = IsingEngine(EngineConfig(size=256, beta=0.44))  # on "cuda"
    result = engine.simulate(seed=0)

See :mod:`repro_torch.api.engine` for which scenarios are ported.
"""
from repro_torch.api.engine import (EngineConfig, EngineConfigError,
                                    EngineResult, IsingEngine, beta_ladder)

__all__ = ["IsingEngine", "EngineConfig", "EngineConfigError",
           "EngineResult", "beta_ladder"]
