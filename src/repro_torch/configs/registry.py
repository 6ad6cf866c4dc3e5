"""Arch registry: maps an arch id to its ArchBundle (full and smoke
configs, the assigned shapes)."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import (bst, dlrm_mlperf, gcn_cora, gemma2_2b, mind,
                                moonshot_16b_a3b, qwen25_14b,
                                qwen3_moe_30b_a3b, smollm_135m, two_tower)
from repro_torch.configs.base import ArchBundle

# The reference registry's order.
_MODULES = {m.ARCH_ID: m for m in (smollm_135m, qwen25_14b, gemma2_2b,
                                   moonshot_16b_a3b, qwen3_moe_30b_a3b,
                                   gcn_cora, bst, dlrm_mlperf, two_tower,
                                   mind)}
_BUNDLES: Dict[str, ArchBundle] = {}


def arch_ids() -> List[str]:
    return list(_MODULES)


def get_bundle(arch_id: str) -> ArchBundle:
    if arch_id not in _MODULES:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(_MODULES)}")
    if arch_id not in _BUNDLES:
        _BUNDLES[arch_id] = _MODULES[arch_id].bundle()
    return _BUNDLES[arch_id]


def get_config(arch_id: str, smoke: bool = False):
    b = get_bundle(arch_id)
    return b.smoke if smoke else b.config
