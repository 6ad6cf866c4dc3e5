"""Arch registry: maps an arch id to its full or smoke config."""
from __future__ import annotations

from repro_torch.configs import (bst, dlrm_mlperf, mind, smollm_135m,
                                two_tower)

_MODULES = {m.ARCH_ID: m for m in (smollm_135m, dlrm_mlperf, bst, mind,
                                   two_tower)}


def get_config(arch_id: str, smoke: bool = False):
    if arch_id not in _MODULES:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(_MODULES)}")
    m = _MODULES[arch_id]
    return m.smoke_config() if smoke else m.config()
