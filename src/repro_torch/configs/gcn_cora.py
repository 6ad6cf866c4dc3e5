"""gcn-cora — 2-layer GCN (Kipf & Welling).

[arXiv:1609.02907; paper] n_layers=2 d_hidden=16 aggregator=mean norm=sym.
Cora: 2708 nodes, 10556 edges, 1433 features, 7 classes.

In the serving engine this backbone doubles as the trust-propagation
evaluator: TrustRank-style smoothing of trust over the web link graph.
"""
from repro_torch.configs.base import ArchBundle, GNN_SHAPES, GNNConfig, reduced

ARCH_ID = "gcn-cora"


def config() -> GNNConfig:
    return GNNConfig(
        name=ARCH_ID,
        n_layers=2,
        d_hidden=16,
        d_feat=1433,
        n_classes=7,
        aggregator="mean",
        norm="sym",
        dropout=0.5,
    )


def smoke_config() -> GNNConfig:
    return reduced(
        config(),
        name=ARCH_ID + "-smoke",
        d_feat=24,
        d_hidden=8,
        n_classes=3,
        dropout=0.0,
    )


def bundle() -> ArchBundle:
    return ArchBundle(
        arch_id=ARCH_ID,
        config=config(),
        smoke=smoke_config(),
        shapes=GNN_SHAPES,
        source='arXiv:1609.02907',
    )
