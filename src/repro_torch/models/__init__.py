"""Model registry: config dataclass type -> bundle factory (counterpart of
``repro/models/__init__.py``)."""
from __future__ import annotations


def build_bundle(config, mesh):
    """The ModelBundle of ``config`` over ``mesh`` (``launch.mesh``)."""
    from repro_torch.configs.base import GNNConfig, LiraSystemConfig, LMConfig, RecsysConfig

    if isinstance(config, LMConfig):
        from repro_torch.models import transformer

        return transformer.make_bundle(config, mesh)
    if isinstance(config, GNNConfig):
        from repro_torch.models import dimenet

        return dimenet.make_bundle(config, mesh)
    if isinstance(config, RecsysConfig):
        from repro_torch.models import recsys

        return recsys.make_bundle(config, mesh)
    if isinstance(config, LiraSystemConfig):
        from repro_torch.serving import engine

        return engine.make_bundle(config, mesh)
    raise TypeError(f"unknown config type {type(config)}")
