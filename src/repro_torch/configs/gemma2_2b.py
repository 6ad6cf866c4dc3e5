"""gemma2-2b — dense LM with alternating local/global attention + softcaps.

[arXiv:2408.00118; hf] 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
Local layers use sliding window 4096; attention logits softcapped at 50,
final logits at 30; GeGLU; pre+post RMSNorm; sqrt(d_model) embedding scale;
query scaled by 1/sqrt(256).
"""
from repro_torch.configs.base import (ArchBundle, LM_SHAPES,
                                      TransformerConfig, reduced)

ARCH_ID = "gemma2-2b"


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        d_head=256,
        d_ff=9216,
        vocab_size=256000,
        tie_embeddings=True,
        rope_theta=10_000.0,
        norm_eps=1e-6,
        act="gelu",
        sliding_window=4096,
        local_global_pattern=True,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        post_norm=True,
        scale_embeddings=True,
        query_pre_attn_scalar=256.0,
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
        sliding_window=16,
        query_pre_attn_scalar=16.0,
        remat=False,
        dtype="float32",
    )


def bundle() -> ArchBundle:
    return ArchBundle(
        arch_id=ARCH_ID,
        config=config(),
        smoke=smoke_config(),
        shapes=LM_SHAPES,
        source='arXiv:2408.00118',
    )
