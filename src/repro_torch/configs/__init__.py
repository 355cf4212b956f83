"""Architecture registry of the port: ``--arch <id>`` ids map to
ModelConfigs.

The port runs every architecture of the JAX package's registry, in the
reference's order: dense GQA (``h2o-danube-3-4b`` with sliding-window
attention, ``mistral-large-123b``, ``stablelm-1.6b``), MLA
(``minicpm3-4b``), Mamba-2 + attention + MoE (``jamba-v0.1-52b``), SSM
(``mamba2-130m``), a VLM with a vision-stub frontend (``internvl2-76b``),
MoE (``moonshot-v1-16b-a3b``, ``qwen3-moe-30b-a3b``) and an
encoder-decoder with an audio-stub frontend (``seamless-m4t-medium``).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "h2o-danube-3-4b",
    "mistral-large-123b",
    "minicpm3-4b",
    "stablelm-1.6b",
    "jamba-v0.1-52b",
    "mamba2-130m",
    "internvl2-76b",
    "moonshot-v1-16b-a3b",
    "qwen3-moe-30b-a3b",
    "seamless-m4t-medium",
)

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ARCH_IDS}


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id])


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return _module(arch_id).SMOKE_CONFIG


def all_configs() -> dict:
    return {a: get_config(a) for a in ARCH_IDS}
