"""smollm-135m — llama-arch small dense LM.

[hf:HuggingFaceTB/SmolLM-135M; hf] 30L d_model=576 9H (GQA kv=3) d_ff=1536
vocab=49152, tied embeddings, RoPE theta 10k.
"""
from repro_torch.configs.base import (ArchBundle, LM_SHAPES,
                                      TransformerConfig, reduced)

ARCH_ID = "smollm-135m"


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=30,
        d_model=576,
        n_heads=9,
        n_kv_heads=3,
        d_head=64,
        d_ff=1536,
        vocab_size=49152,
        tie_embeddings=True,
        rope_theta=10_000.0,
        norm_eps=1e-5,
        act="silu",
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
        d_ff=128,
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
        source='hf:HuggingFaceTB/SmolLM-135M',
    )
