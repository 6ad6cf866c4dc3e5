"""moonshot-v1-16b-a3b — Moonlight-style MoE (DeepSeek-family layout).

[hf:moonshotai/Moonlight-16B-A3B; hf] 48L d_model=2048 16H (GQA kv=16 == MHA)
d_expert=1408 vocab=163840, MoE 64 experts top-6, 2 shared experts, first
layer dense (d_ff_dense=11264 per the HF config).

The numbers are the reference's (``repro.configs.moonshot_16b_a3b``),
copied as they are; ROADMAP.md (Queue 3) notes where they part from the
published checkpoint's config.
"""
from repro_torch.configs.base import (ArchBundle, LM_SHAPES,
                                      MoEConfig, TransformerConfig, reduced)

ARCH_ID = "moonshot-v1-16b-a3b"


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_head=128,
        d_ff=1408,
        vocab_size=163840,
        tie_embeddings=False,
        rope_theta=50_000.0,
        norm_eps=1e-5,
        act="silu",
        moe=MoEConfig(
            n_experts=64,
            top_k=6,
            d_expert=1408,
            n_shared_experts=2,
            d_shared=1408,
            first_k_dense=1,
            d_ff_dense=11264,
            capacity_factor=1.25,
            norm_topk_prob=True,
            dispatch="ep_shard_map",
        ),
    )


def smoke_config() -> TransformerConfig:
    return reduced(
        config(),
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=96,
        vocab_size=256,
        moe=MoEConfig(
            n_experts=8,
            top_k=2,
            d_expert=96,
            n_shared_experts=1,
            d_shared=96,
            first_k_dense=1,
            d_ff_dense=128,
            capacity_factor=1.5,
        ),
        remat=False,
        dtype="float32",
    )


def bundle() -> ArchBundle:
    return ArchBundle(
        arch_id=ARCH_ID,
        config=config(),
        smoke=smoke_config(),
        shapes=LM_SHAPES,
        source='hf:moonshotai/Moonlight-16B-A3B',
    )
