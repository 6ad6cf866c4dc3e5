"""dlrm-mlperf — MLPerf DLRM benchmark config (Criteo 1TB).

[arXiv:1906.00091; paper] n_dense=13 n_sparse=26 embed_dim=128
bot_mlp=13-512-256-128 top_mlp=1024-1024-512-256-1 interaction=dot.
Table row counts are the published Criteo-Terabyte per-field cardinalities
used by the MLPerf reference implementation.
"""
from repro_torch.configs.base import (ArchBundle, RECSYS_SHAPES,
                                      EmbeddingTableConfig, RecsysConfig,
                                      reduced)

ARCH_ID = "dlrm-mlperf"

# Criteo 1TB per-field cardinalities (MLPerf DLRM reference, day 0-23).
CRITEO_1TB_ROWS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)


def config() -> RecsysConfig:
    tables = tuple(
        EmbeddingTableConfig(name=f"sparse_{i}", vocab=v, dim=128)
        for i, v in enumerate(CRITEO_1TB_ROWS)
    )
    return RecsysConfig(
        name=ARCH_ID,
        model="dlrm",
        embed_dim=128,
        tables=tables,
        n_dense=13,
        bot_mlp=(13, 512, 256, 128),
        top_mlp=(1024, 1024, 512, 256, 1),
        interaction="dot",
    )


def smoke_config() -> RecsysConfig:
    tables = tuple(
        EmbeddingTableConfig(name=f"sparse_{i}", vocab=100, dim=16)
        for i in range(4)
    )
    return reduced(
        config(),
        name=ARCH_ID + "-smoke",
        embed_dim=16,
        tables=tables,
        n_dense=13,
        bot_mlp=(13, 32, 16),
        top_mlp=(32, 16, 1),
    )


def bundle() -> ArchBundle:
    return ArchBundle(
        arch_id=ARCH_ID,
        config=config(),
        smoke=smoke_config(),
        shapes=RECSYS_SHAPES,
        source='arXiv:1906.00091 (MLPerf reference)',
    )
