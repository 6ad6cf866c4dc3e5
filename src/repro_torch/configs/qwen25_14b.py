"""qwen2.5-14b — dense LM with GQA and QKV bias.

[hf:Qwen/Qwen2.5-14B; hf] 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064, QKV bias, RoPE theta 1e6.
"""
from repro_torch.configs.base import (ArchBundle, LM_SHAPES,
                                      TransformerConfig, reduced)

ARCH_ID = "qwen2.5-14b"


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_head=128,
        d_ff=13824,
        vocab_size=152064,
        qkv_bias=True,
        tie_embeddings=False,
        rope_theta=1_000_000.0,
        norm_eps=1e-5,
        act="silu",
    )


def smoke_config() -> TransformerConfig:
    return reduced(
        config(),
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=96,
        n_heads=8,
        n_kv_heads=2,
        d_head=12,
        d_ff=256,
        vocab_size=256,
        remat=False,
        dtype="float32",
    )


def bundle() -> ArchBundle:
    return ArchBundle(
        arch_id=ARCH_ID,
        config=config(),
        smoke=smoke_config(),
        shapes=LM_SHAPES,
        source='hf:Qwen/Qwen2.5-14B',
    )
