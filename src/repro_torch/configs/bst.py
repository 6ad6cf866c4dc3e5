"""bst — Behavior Sequence Transformer (Alibaba).

[arXiv:1905.06874; paper] embed_dim=32 seq_len=20 n_blocks=1 n_heads=8
mlp=1024-512-256 interaction=transformer-seq. Item vocab sized to the
Taobao-scale setting used in the paper's production deployment.
"""
from repro_torch.configs.base import (ArchBundle, RECSYS_SHAPES,
                                      EmbeddingTableConfig, RecsysConfig,
                                      reduced)

ARCH_ID = "bst"
SOURCE = "arXiv:1905.06874"


def config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH_ID,
        model="bst",
        embed_dim=32,
        seq_len=20,
        n_blocks=1,
        n_heads=8,
        mlp=(1024, 512, 256),
        interaction="transformer-seq",
        tables=(
            EmbeddingTableConfig(name="item", vocab=4_000_000, dim=32),
            EmbeddingTableConfig(name="category", vocab=100_000, dim=32),
            EmbeddingTableConfig(name="user_profile", vocab=1_000_000, dim=32),
            EmbeddingTableConfig(name="context", vocab=10_000, dim=32),
        ),
    )


def smoke_config() -> RecsysConfig:
    return reduced(
        config(),
        name=ARCH_ID + "-smoke",
        embed_dim=16,
        seq_len=8,
        n_heads=4,
        mlp=(32, 16),
        tables=(
            EmbeddingTableConfig(name="item", vocab=200, dim=16),
            EmbeddingTableConfig(name="category", vocab=50, dim=16),
            EmbeddingTableConfig(name="user_profile", vocab=100, dim=16),
            EmbeddingTableConfig(name="context", vocab=20, dim=16),
        ),
    )


def bundle() -> ArchBundle:
    return ArchBundle(
        arch_id=ARCH_ID,
        config=config(),
        smoke=smoke_config(),
        shapes=RECSYS_SHAPES,
        source='arXiv:1905.06874',
    )
