"""trust_ir — the paper's own system configuration.

The Enhanced Trustworthy and High-Quality IR pipeline of [1] with the
Optimal Load Shedding Algorithm of this paper in front of the Trust
Evaluator. Parameters follow the paper's experimental setup (§6, Nutch):
base deadline is the "optimum response time", the overload deadline is the
relaxed target used under Heavy load, and the Very-Heavy extension weight
implements §4.3's "weight based on Uload".

Counterpart of ``repro.configs.trust_ir``: the same values, on the port's
own ``TrustIRConfig``.
"""
from repro_torch.configs.base import TrustIRConfig


def config() -> TrustIRConfig:
    return TrustIRConfig(
        name="trust_ir",
        u_capacity=2048,
        u_threshold=1024,
        deadline_s=0.5,
        overload_deadline_s=1.0,
        very_heavy_weight=0.5,
        chunk_size=256,
        cache_slots=65536,
        cache_ways=4,
        prior_buckets=1,            # paper-faithful global average trust
        prior_ewma=0.05,
        quality_weights=(0.5, 0.3, 0.2),
        evaluator_arch="smollm-135m",
        trust_scale=5.0,
        # Tail-tolerant fan-out (fanout), the paper's "answer from
        # the prior rather than miss the deadline" extended to
        # stragglers: the gather waits for all shards by default
        # (quorum_k=0 — full trustworthy answers), but the selective-
        # replication policy is armed so a deployment that raises
        # quorum_k/hedging inherits the paper-scale thresholds.
        fanout_quorum_k=0,
        fanout_slow_factor=2.5,
        fanout_recover_factor=1.4,
        fanout_max_mirrors=2,
    )


def smoke_config() -> TrustIRConfig:
    return TrustIRConfig(
        name="trust_ir-smoke",
        u_capacity=64,
        u_threshold=32,
        deadline_s=0.05,
        overload_deadline_s=0.1,
        very_heavy_weight=0.5,
        chunk_size=16,
        cache_slots=256,
        cache_ways=2,
        prior_buckets=1,
        prior_ewma=0.05,
        evaluator_arch="smollm-135m",
    )
