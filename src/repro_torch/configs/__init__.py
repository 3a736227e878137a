"""Architecture registry: ``get_config(name)`` / ``get_smoke_config(name)``
(port of ``repro.configs``; ROADMAP item 18a).

The ten assigned LM architectures of the JAX package, each file with its
published source, then granite-4.0-h-micro, which only the port runs (an
``InterleavedConfig``); the paper's own SNN networks are made by
``repro_torch.models.snn`` and are not part of this registry.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.shapes import SHAPES, ShapeSpec, shapes_for  # noqa: F401

_MODULES = {
    "llama-3.2-vision-11b": "repro_torch.configs.llama32_vision_11b",
    "qwen1.5-32b": "repro_torch.configs.qwen15_32b",
    "yi-9b": "repro_torch.configs.yi_9b",
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe_42b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "granite-4.0-h-micro": "repro_torch.configs.granite_4_0_h_micro",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {list(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


def get_smoke_config(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {list(_MODULES)}")
    return importlib.import_module(_MODULES[name]).SMOKE


def all_configs():
    return {n: get_config(n) for n in ARCH_NAMES}
