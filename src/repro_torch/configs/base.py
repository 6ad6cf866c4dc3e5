"""The port's own copy of the config dataclasses it reads.

Counterpart of ``repro.configs.base``, cut to the fields the port
reads: the dense transformer of the trust evaluator, the recommenders
(DLRM, BST, MIND and the two-tower retrieval model), the load
shedder's parameters, the drain executor, the scheduler's quarantine,
the serving fleet (replicas, gossip, autoscaling, forecasting, and the
fan-out fields ``configs.trust_ir`` sets), and the retrieval front end.
Later slices add the fields their modules read.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    act: str = "silu"                  # SwiGLU
    dtype: str = "bfloat16"            # compute type
    param_dtype: str = "float32"


@dataclass(frozen=True)
class EmbeddingTableConfig:
    """One sparse embedding table."""
    name: str
    vocab: int
    dim: int


@dataclass(frozen=True)
class RecsysConfig:
    """A recommender backbone (the reference's fields)."""
    name: str
    model: str                     # "dlrm" | "bst" | "two_tower" | "mind"
    embed_dim: int
    tables: Tuple[EmbeddingTableConfig, ...] = ()
    n_dense: int = 0
    bot_mlp: Tuple[int, ...] = ()
    top_mlp: Tuple[int, ...] = ()
    tower_mlp: Tuple[int, ...] = ()
    interaction: str = "dot"
    # BST
    seq_len: int = 0
    n_blocks: int = 0
    n_heads: int = 0
    mlp: Tuple[int, ...] = ()
    # MIND
    n_interests: int = 0
    capsule_iters: int = 0
    hist_len: int = 0
    item_vocab: int = 0
    user_vocab: int = 0
    dtype: str = "float32"
    param_dtype: str = "float32"


@dataclass(frozen=True)
class TrustIRConfig:
    """The paper's serving-pipeline parameters (defaults as in
    ``repro.configs.base.TrustIRConfig``)."""
    name: str = "trust_ir"
    # Load shedder parameters (paper §4)
    u_capacity: int = 2048              # URLs evaluable within base deadline
    u_threshold: int = 1024             # extra URLs within overload deadline
    deadline_s: float = 0.5             # optimum response time (base deadline)
    overload_deadline_s: float = 1.0    # optimum response time under overload
    very_heavy_weight: float = 0.5      # deadline-extension weight w (§4.3)
    chunk_size: int = 256               # host-path deadline-check granularity
    # Trust DB cache: (n_ways, n_slots) ways-leading by default, the
    # legacy (n_slots, n_ways) layout when False
    cache_slots: int = 65536
    cache_ways: int = 4
    cache_ways_leading: bool = True
    # Average-trust prior
    prior_buckets: int = 1              # 1 = paper-faithful global average
    prior_ewma: float = 0.05
    # Quality subsystem weights (content, context, ratings)
    quality_weights: Tuple[float, float, float] = (0.5, 0.3, 0.2)
    # Evaluator backbone (arch id from the registry)
    evaluator_arch: str = "smollm-135m"
    trust_scale: float = 5.0            # paper reports trust on a scale of 5
    # Micro-batch drain executor: "host" = LoadShedder.process (host
    # chunk loop with a wall-clock deadline), "fused" = FusedLoadShedder
    # (one device step per micro-batch on the CUDA kernels)
    drain_mode: str = "host"
    # DrainExecutor in-flight window: depth 1 syncs every drain call,
    # depth >= 2 keeps batches in flight across drain calls
    pipeline_depth: int = 2
    # Adaptive pipeline depth (cluster.depth.DepthController) inside
    # [adaptive_depth_min, pipeline_depth]; False = static depth
    adaptive_depth: bool = False
    adaptive_depth_min: int = 1
    adaptive_depth_backlog_batches: float = 2.0
    adaptive_depth_latency_frac: float = 0.5
    adaptive_depth_hysteresis: int = 2
    adaptive_depth_cooldown_ticks: int = 2
    # Serving fleet (cluster): independent replica engines; weights bias
    # the consistent-hash ring's virtual-node counts (empty = equal)
    n_replicas: int = 1
    replica_weights: Tuple[float, ...] = ()
    # Elastic membership: with max_replicas > 0 the autoscaler may join
    # and gracefully remove replicas in [max(min_replicas, 1),
    # max_replicas]; 0 = membership fixed at n_replicas
    min_replicas: int = 0
    max_replicas: int = 0
    # Cross-replica Trust-DB gossip of fresh cache fills, delivered to
    # every sibling ("broadcast") or to ceil(log2 n) sampled peers plus
    # an anti-entropy pull ("epidemic")
    gossip: bool = False
    gossip_mode: str = "broadcast"
    # Poison-pill quarantine (scheduling.quarantine): open a breaker
    # after quarantine_k executor errors of one work signature, probe
    # again after quarantine_probe_after_s; 0 = disabled
    quarantine_k: int = 0
    quarantine_probe_after_s: float = 2.0
    # WatermarkAutoscaler hysteresis (cluster.autoscale_watermarks):
    # scale up above up_pressure, down below down_pressure, then wait
    # cooldown_ticks autoscaler updates before voting again
    autoscale_up_pressure: float = 0.75
    autoscale_down_pressure: float = 0.15
    autoscale_cooldown_ticks: int = 2
    # Feedforward capacity planning (cluster.capacity): forecast the
    # arrival curve warmup_lead_s ahead over a sliding window and vote
    # prewarmed joins before the predicted breach; False = reactive only
    forecast: bool = False
    warmup_lead_s: float = 0.5
    forecast_window_s: float = 2.0
    # Retrieval front end (retrieval): the synthetic corpus is fully
    # determined by (corpus_docs, corpus_vocab, corpus_zipf_a,
    # corpus_seed)
    corpus_docs: int = 4096             # synthetic corpus size
    corpus_vocab: int = 2048            # Zipf-ranked content vocabulary
    corpus_zipf_a: float = 1.15         # term-frequency skew
    corpus_seed: int = 0
    index_block_docs: int = 512         # documents per index build block
    index_partitions: int = 16          # doc-partition stripes
    retrieve_top_k: int = 64            # candidate-set size per query
    # Tail-tolerant scatter-gather (fanout): first-k-of-n quorum,
    # per-shard hedges onto mirror stripes, selective replication.
    # quorum_k 0 = synchronous full gather.
    fanout_quorum_k: int = 0
    fanout_adaptive_quorum: bool = False
    fanout_hedge_after_s: float = 0.0
    fanout_slow_factor: float = 2.5
    fanout_recover_factor: float = 1.4
    fanout_max_mirrors: int = 2


def reduced(cfg, **overrides):
    """Return a copy of a frozen dataclass config with overrides applied."""
    return dataclasses.replace(cfg, **overrides)


def cap_table_rows(cfg: RecsysConfig, max_rows: int) -> RecsysConfig:
    """``cfg`` with every embedding table cut to at most ``max_rows`` rows
    (MLPerf DLRM's ``--max-ind-range``); widths, table count, MLPs and
    dtype unchanged."""
    if max_rows < 1:
        raise ValueError(f"max_rows must be positive, got {max_rows}")
    return reduced(cfg, tables=tuple(
        reduced(t, vocab=min(t.vocab, max_rows)) for t in cfg.tables))
