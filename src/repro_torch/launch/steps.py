"""Per-architecture step helpers.

Counterpart of ``repro.launch.steps``, cut to ``_recsys_loss`` (the
recommender module whose ``init_params`` and ``loss_fn`` train a
``RecsysConfig``). The reference's mesh cells (``_lm_cell``,
``_recsys_cell``, ``_gnn_cell``, ``build_cell``, ``input_specs``) lower
sharded steps for the multi-pod dry-run and wait for the distribution
slice (ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

from repro_torch.configs.base import RecsysConfig


def _recsys_loss(cfg: RecsysConfig):
    if cfg.model == "dlrm":
        from repro_torch.models.recsys import dlrm as M
    elif cfg.model == "bst":
        from repro_torch.models.recsys import bst as M
    elif cfg.model == "two_tower":
        from repro_torch.models.recsys import two_tower as M
    elif cfg.model == "mind":
        from repro_torch.models.recsys import mind as M
    else:
        raise ValueError(cfg.model)
    return M
