"""two-tower-retrieval — sampled-softmax retrieval (YouTube-style).

[RecSys'19 (Yi et al., YouTube); unverified] embed_dim=256
tower_mlp=1024-512-256 interaction=dot, in-batch sampled softmax with
logQ correction.
"""
from repro_torch.configs.base import (ArchBundle, RECSYS_SHAPES,
                                      EmbeddingTableConfig, RecsysConfig,
                                      reduced)

ARCH_ID = "two-tower-retrieval"
SOURCE = "RecSys'19 (YouTube two-tower)"


def config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH_ID,
        model="two_tower",
        embed_dim=256,
        tower_mlp=(1024, 512, 256),
        interaction="dot",
        tables=(
            EmbeddingTableConfig(name="user_id", vocab=50_000_000, dim=256),
            EmbeddingTableConfig(name="item_id", vocab=10_000_000, dim=256),
            EmbeddingTableConfig(name="user_feats", vocab=1_000_000, dim=256),
            EmbeddingTableConfig(name="item_feats", vocab=1_000_000, dim=256),
        ),
    )


def smoke_config() -> RecsysConfig:
    return reduced(
        config(),
        name=ARCH_ID + "-smoke",
        embed_dim=16,
        tower_mlp=(32, 16),
        tables=(
            EmbeddingTableConfig(name="user_id", vocab=200, dim=16),
            EmbeddingTableConfig(name="item_id", vocab=300, dim=16),
            EmbeddingTableConfig(name="user_feats", vocab=50, dim=16),
            EmbeddingTableConfig(name="item_feats", vocab=50, dim=16),
        ),
    )


def bundle() -> ArchBundle:
    return ArchBundle(
        arch_id=ARCH_ID,
        config=config(),
        smoke=smoke_config(),
        shapes=RECSYS_SHAPES,
        source="RecSys'19 (YouTube two-tower)",
    )
