"""Config registry: ``get_config(name)`` / ``list_configs()``.

The port's own copy of ``repro.configs`` (pure Python, the same
configurations and names), so that nothing here imports the reference.
"""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, ShapeConfig, IsingConfig,
    LM_SHAPES, TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K,
)

_REGISTRY = {}
_ISING_REGISTRY = {}


def register(cfg):
    _REGISTRY[cfg.name] = cfg
    return cfg


def register_ising(cfg):
    _ISING_REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    return _REGISTRY[name]


def get_ising_config(name: str) -> IsingConfig:
    _ensure_loaded()
    return _ISING_REGISTRY[name]


def list_configs():
    _ensure_loaded()
    return sorted(_REGISTRY)


def list_ising_configs():
    _ensure_loaded()
    return sorted(_ISING_REGISTRY)


_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    from repro_torch.configs import archs  # noqa: F401  (registers everything)
    _LOADED = True
