"""Architecture registry of the port: ``--arch <id>`` ids map to
ModelConfigs.

The port runs two of the JAX package's ten architectures so far: the
dense ``stablelm-1.6b`` (flash attention in every prefill) and the
attention-free ``mamba2-130m`` (the SSD scan in every prefill).  The
other ids wait for the rest of the model stack (ROADMAP item 14: MoE,
MLA, encoder-decoder, frontends).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "stablelm-1.6b",
    "mamba2-130m",
)

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ARCH_IDS}


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"arch {arch_id!r} is not ported yet (ROADMAP item "
                       f"14, the rest of the model stack); ported: "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id])


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return _module(arch_id).SMOKE_CONFIG


def all_configs() -> dict:
    return {a: get_config(a) for a in ARCH_IDS}
