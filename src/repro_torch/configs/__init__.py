"""Architecture registry: ``get_config(arch_id)`` -> (config, shapes)
(counterpart of ``repro/configs/__init__.py``).

The five LM architectures and the paper's own system (lira-ann, lira-ann-q),
in the reference's order. Each module defines CONFIG, SHAPES, SMOKE (a
reduced same-family config for the CPU tests) and SMOKE_SHAPES. The GNN and
recsys architectures are not ported yet.
"""
from __future__ import annotations

import importlib

ARCH_IDS = (
    "qwen3_moe_235b_a22b",
    "moonshot_v1_16b_a3b",
    "deepseek_coder_33b",
    "mistral_large_123b",
    "stablelm_3b",
    "lira_ann",
    "lira_ann_q",
)


def canon(arch: str) -> str:
    """CLI ids use dashes, module names underscores."""
    return arch.replace("-", "_")


def get_config(arch: str):
    mod = importlib.import_module(f"repro_torch.configs.{canon(arch)}")
    return mod.CONFIG, mod.SHAPES


def get_smoke(arch: str):
    mod = importlib.import_module(f"repro_torch.configs.{canon(arch)}")
    return mod.SMOKE, getattr(mod, "SMOKE_SHAPES", None)


def all_cells():
    """Every (arch, config, shape) cell of the ported architectures."""
    for arch in ARCH_IDS:
        cfg, shapes = get_config(arch)
        for shape in shapes:
            yield arch, cfg, shape
