"""mind — Multi-Interest Network with Dynamic routing (Alibaba).

[arXiv:1904.08030; unverified] embed_dim=64 n_interests=4 capsule_iters=3
interaction=multi-interest. Behavior-to-Interest (B2I) dynamic routing over
the user history; label-aware attention at train time.
"""
from repro_torch.configs.base import (ArchBundle, RECSYS_SHAPES,
                                      EmbeddingTableConfig, RecsysConfig,
                                      reduced)

ARCH_ID = "mind"
SOURCE = "arXiv:1904.08030"


def config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH_ID,
        model="mind",
        embed_dim=64,
        n_interests=4,
        capsule_iters=3,
        hist_len=50,
        interaction="multi-interest",
        tables=(
            EmbeddingTableConfig(name="item", vocab=10_000_000, dim=64),
            EmbeddingTableConfig(name="user_profile", vocab=1_000_000, dim=64),
        ),
    )


def smoke_config() -> RecsysConfig:
    return reduced(
        config(),
        name=ARCH_ID + "-smoke",
        embed_dim=16,
        n_interests=2,
        capsule_iters=2,
        hist_len=10,
        tables=(
            EmbeddingTableConfig(name="item", vocab=300, dim=16),
            EmbeddingTableConfig(name="user_profile", vocab=100, dim=16),
        ),
    )


def bundle() -> ArchBundle:
    return ArchBundle(
        arch_id=ARCH_ID,
        config=config(),
        smoke=smoke_config(),
        shapes=RECSYS_SHAPES,
        source='arXiv:1904.08030',
    )
