"""qwen3-moe-30b-a3b — 128-expert top-8 MoE.

[hf:Qwen/Qwen3-30B-A3B; hf] 48L d_model=2048 32H (GQA kv=4) d_expert=768
vocab=151936, MoE 128 experts top-8, no shared experts, norm_topk_prob.
"""
from repro_torch.configs.base import (ArchBundle, LM_SHAPES,
                                      MoEConfig, TransformerConfig, reduced)

ARCH_ID = "qwen3-moe-30b-a3b"


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        d_head=128,
        d_ff=768,
        vocab_size=151936,
        tie_embeddings=False,
        rope_theta=1_000_000.0,
        norm_eps=1e-6,
        act="silu",
        moe=MoEConfig(
            n_experts=128,
            top_k=8,
            d_expert=768,
            n_shared_experts=0,
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
        n_kv_heads=2,
        d_head=16,
        d_ff=96,
        vocab_size=256,
        moe=MoEConfig(
            n_experts=8,
            top_k=2,
            d_expert=96,
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
        source='hf:Qwen/Qwen3-30B-A3B',
    )
