from repro_torch.configs.base import (ArchBundle, EmbeddingTableConfig,
                                      GNNConfig, MoEConfig, RecsysConfig,
                                      ShapeSpec, TransformerConfig,
                                      TrustIRConfig, GNN_SHAPES, LM_SHAPES,
                                      RECSYS_SHAPES, reduced)
from repro_torch.configs.registry import arch_ids, get_bundle, get_config

__all__ = [
    "ArchBundle", "EmbeddingTableConfig", "GNNConfig", "MoEConfig",
    "RecsysConfig", "ShapeSpec", "TransformerConfig", "TrustIRConfig",
    "GNN_SHAPES", "LM_SHAPES", "RECSYS_SHAPES", "reduced",
    "arch_ids", "get_bundle", "get_config",
]
