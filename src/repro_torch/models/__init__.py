"""Model registry: config dataclass type -> bundle factory (counterpart of
``repro/models/__init__.py``)."""
from __future__ import annotations


def build_bundle(config, mesh):
    """The ModelBundle of ``config`` over ``mesh`` (``launch.mesh``). The LM
    and LIRA configs are ported; the graph and recsys architectures are not
    yet, and their configs have no class in the port to pass here."""
    from repro_torch.configs.base import LiraSystemConfig, LMConfig

    if isinstance(config, LMConfig):
        from repro_torch.models import transformer

        return transformer.make_bundle(config, mesh)
    if isinstance(config, LiraSystemConfig):
        from repro_torch.serving import engine

        return engine.make_bundle(config, mesh)
    raise TypeError(f"unknown config type {type(config)}: the port builds LM and LIRA "
                    f"bundles only (GNN and recsys are not ported yet)")
