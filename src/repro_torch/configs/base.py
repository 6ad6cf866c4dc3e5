"""The port's own copy of the config dataclasses it reads.

Counterpart of ``repro.configs.base``: the shape layer of the mesh
cells (``SHAPE_KINDS``, ``ShapeSpec``, ``LM_SHAPES`` / ``RECSYS_SHAPES``
/ ``GNN_SHAPES``), the architecture configs with their ``family``,
``n_params`` and ``n_active_params`` (the transformer of the trust
evaluators, dense with Gemma-2's and Qwen2.5's fields or MoE, the GCN
trust propagator, the recommenders), ``ArchBundle`` (what the registry
returns), and the serving pipeline's ``TrustIRConfig``: the load
shedder, the drain executor, the scheduler's quarantine, the serving
fleet and the retrieval front end. The reference's JAX-only switches
(``use_pallas``, ``scan_layers``) are left out: the port picks its
kernels by device and runs its layers in a Python loop.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple


# ---------------------------------------------------------------------------
# Shape specs (one per dry-run cell)
# ---------------------------------------------------------------------------

# Kinds determine which step function a cell runs.
SHAPE_KINDS = (
    "train",            # train_step: full fwd+bwd+optimizer
    "prefill",          # prefill_step: forward, fills KV cache
    "decode",           # serve_step: one new token against a KV cache
    "serve",            # serve_step: pure forward scoring (recsys / gnn inference)
    "retrieval",        # serve_step: 1 query vs n_candidates scoring
    "graph_full",       # full-batch graph train_step
    "graph_minibatch",  # sampled-subgraph train_step
    "graph_batched",    # batched small graphs train_step
)


@dataclass(frozen=True)
class ShapeSpec:
    """One (input-shape) cell for an architecture."""

    name: str
    kind: str
    # LM shapes
    seq_len: int = 0
    global_batch: int = 0
    # recsys shapes
    batch: int = 0
    n_candidates: int = 0
    # graph shapes
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: Tuple[int, ...] = ()
    nodes_per_graph: int = 0
    edges_per_graph: int = 0

    def __post_init__(self) -> None:
        if self.kind not in SHAPE_KINDS:
            raise ValueError(f"unknown shape kind {self.kind!r}")


# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                      # FFN hidden size per expert
    n_shared_experts: int = 0
    d_shared: int = 0                  # FFN hidden of the shared expert(s)
    first_k_dense: int = 0             # leading layers that stay dense
    d_ff_dense: int = 0                # FFN hidden for those dense layers
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.001     # load-balance loss coefficient
    norm_topk_prob: bool = True        # renormalize top-k gate weights
    dispatch: str = "dense_scatter"    # "dense_scatter" | "ep_shard_map"


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
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    act: str = "silu"                  # "silu" (SwiGLU) | "gelu" (GeGLU)
    # gemma2-style extras
    sliding_window: int = 0            # >0: window size for local layers
    local_global_pattern: bool = False # alternate local/global attention
    attn_logit_softcap: float = 0.0    # >0: tanh softcap on attention logits
    final_logit_softcap: float = 0.0   # >0: tanh softcap on output logits
    post_norm: bool = False            # gemma2 post-block RMSNorm
    scale_embeddings: bool = False     # gemma2 sqrt(d_model) embed scaling
    query_pre_attn_scalar: float = 0.0 # gemma2 overrides 1/sqrt(d_head)
    # MoE
    moe: Optional[MoEConfig] = None
    dtype: str = "bfloat16"            # compute type
    param_dtype: str = "float32"
    remat: bool = True                 # activation checkpointing per block

    @property
    def family(self) -> str:
        return "moe" if self.moe is not None else "dense"

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def _attn_params(self) -> int:
        d = self.d_model
        return self.n_layers * (self.n_heads * self.d_head * d * 2
                                + self.n_kv_heads * self.d_head * d * 2)

    def _ffn_params(self, experts: int) -> int:
        """FFN parameters with ``experts`` routed experts a MoE layer."""
        d, L = self.d_model, self.n_layers
        if self.moe is None:
            return L * 3 * d * self.d_ff
        m = self.moe
        moe_layers = L - m.first_k_dense
        return (m.first_k_dense * 3 * d * (m.d_ff_dense or self.d_ff)
                + moe_layers * (experts * 3 * d * m.d_expert
                                + m.n_shared_experts * 3 * d
                                * (m.d_shared or m.d_expert)
                                + d * m.n_experts))       # router

    def _rest_params(self) -> int:
        """Embeddings (once if tied) and norms."""
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return emb + self.n_layers * 2 * d + d

    def n_params(self) -> int:
        """Approximate parameter count (embeddings included once if
        tied), the reference's formula."""
        experts = self.moe.n_experts if self.moe is not None else 0
        return (self._attn_params() + self._ffn_params(experts)
                + self._rest_params())

    def n_active_params(self) -> int:
        """Active (per-token) parameter count: a MoE layer activates
        top_k experts."""
        if self.moe is None:
            return self.n_params()
        return (self._attn_params() + self._ffn_params(self.moe.top_k)
                + self._rest_params())


@dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int
    d_hidden: int
    d_feat: int
    n_classes: int
    aggregator: str = "mean"       # "mean" | "sum" | "max"
    norm: str = "sym"              # "sym" (D^-1/2 A D^-1/2) | "rw" | "none"
    dropout: float = 0.0
    dtype: str = "float32"
    param_dtype: str = "float32"

    @property
    def family(self) -> str:
        return "gnn"

    def n_params(self) -> int:
        p = self.d_feat * self.d_hidden + self.d_hidden
        for _ in range(self.n_layers - 2):
            p += self.d_hidden * self.d_hidden + self.d_hidden
        p += self.d_hidden * self.n_classes + self.n_classes
        return p


@dataclass(frozen=True)
class EmbeddingTableConfig:
    """One sparse embedding table (or a stack of same-shape tables)."""
    name: str
    vocab: int
    dim: int
    count: int = 1                 # number of identical tables stacked


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

    @property
    def family(self) -> str:
        return "recsys"

    def n_params(self) -> int:
        p = sum(t.vocab * t.dim * t.count for t in self.tables)

        def mlp_params(dims: Tuple[int, ...], d_in: int) -> int:
            total, d = 0, d_in
            for h in dims:
                total += d * h + h
                d = h
            return total
        if self.model == "dlrm":
            p += mlp_params(self.bot_mlp[1:], self.bot_mlp[0])
            n_f = len(self.tables) + 1
            d_int = n_f * (n_f - 1) // 2 + self.bot_mlp[-1]
            p += mlp_params(self.top_mlp, d_int)
        elif self.model == "bst":
            d = self.embed_dim
            p += self.n_blocks * (4 * d * d + 8 * d * d)   # attn + ffn approx
            p += mlp_params(self.mlp + (1,), d * (self.seq_len + 1))
        elif self.model == "two_tower":
            p += 2 * mlp_params(self.tower_mlp + (self.embed_dim,),
                                self.embed_dim)
        elif self.model == "mind":
            d = self.embed_dim
            p += d * d  # routing bilinear
            p += mlp_params((4 * d, d), d)
        return p


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


# ---------------------------------------------------------------------------
# Arch bundle: what the registry returns
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ArchBundle:
    arch_id: str
    config: Any                         # TransformerConfig | GNNConfig | RecsysConfig
    smoke: Any                          # reduced same-family config
    shapes: Tuple[ShapeSpec, ...]
    source: str = ""                    # provenance note


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


# LM shape set shared by the five LM-family archs.
LM_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec(name="train_4k", kind="train", seq_len=4096, global_batch=256),
    ShapeSpec(name="prefill_32k", kind="prefill", seq_len=32768, global_batch=32),
    ShapeSpec(name="decode_32k", kind="decode", seq_len=32768, global_batch=128),
    ShapeSpec(name="long_500k", kind="decode", seq_len=524288, global_batch=1),
)

RECSYS_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec(name="train_batch", kind="train", batch=65536),
    ShapeSpec(name="serve_p99", kind="serve", batch=512),
    ShapeSpec(name="serve_bulk", kind="serve", batch=262144),
    ShapeSpec(name="retrieval_cand", kind="retrieval", batch=1, n_candidates=1_000_000),
)

GNN_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec(name="full_graph_sm", kind="graph_full",
              n_nodes=2708, n_edges=10556, d_feat=1433),
    ShapeSpec(name="minibatch_lg", kind="graph_minibatch",
              n_nodes=232_965, n_edges=114_615_892, batch_nodes=1024,
              fanout=(15, 10), d_feat=602),
    ShapeSpec(name="ogb_products", kind="graph_full",
              n_nodes=2_449_029, n_edges=61_859_140, d_feat=100),
    ShapeSpec(name="molecule", kind="graph_batched",
              n_nodes=30, n_edges=64, batch=128, d_feat=32,
              nodes_per_graph=30, edges_per_graph=64),
)
