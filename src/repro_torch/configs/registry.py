"""Arch registry: maps an arch id to its full or smoke config."""
from __future__ import annotations

from repro_torch.configs import smollm_135m

_MODULES = {smollm_135m.ARCH_ID: smollm_135m}


def get_config(arch_id: str, smoke: bool = False):
    if arch_id not in _MODULES:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(_MODULES)}")
    m = _MODULES[arch_id]
    return m.smoke_config() if smoke else m.config()
