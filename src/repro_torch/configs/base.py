"""The port's own copy of the config dataclasses it reads.

Counterpart of ``repro.configs.base``, cut to the fields the port
reads: the dense transformer of the trust evaluator, the DLRM
recommender (the other evaluator backbone the port serves), the load
shedder's parameters, the drain executor, the scheduler's quarantine,
and the retrieval front end. Later slices add the fields their modules
read.
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
    """A recommender backbone; the port reads the DLRM fields."""
    name: str
    model: str                     # "dlrm"
    embed_dim: int
    tables: Tuple[EmbeddingTableConfig, ...] = ()
    n_dense: int = 0
    bot_mlp: Tuple[int, ...] = ()
    top_mlp: Tuple[int, ...] = ()
    interaction: str = "dot"
    dtype: str = "float32"
    param_dtype: str = "float32"


@dataclass(frozen=True)
class TrustIRConfig:
    """The paper's serving-pipeline parameters (defaults as in
    ``repro.configs.base.TrustIRConfig``)."""
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
    # Poison-pill quarantine (scheduling.quarantine): open a breaker
    # after quarantine_k executor errors of one work signature, probe
    # again after quarantine_probe_after_s; 0 = disabled
    quarantine_k: int = 0
    quarantine_probe_after_s: float = 2.0
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
