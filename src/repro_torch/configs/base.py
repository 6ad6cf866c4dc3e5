"""The port's own copy of the config dataclasses it reads.

Counterpart of ``repro.configs.base``, cut to the fields this slice
reads: the dense transformer of the trust evaluator and the load
shedder's parameters. Later slices add the fields their modules read.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


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
    # Evaluator backbone (arch id from the registry)
    evaluator_arch: str = "smollm-135m"
    trust_scale: float = 5.0            # paper reports trust on a scale of 5


def reduced(cfg, **overrides):
    """Return a copy of a frozen dataclass config with overrides applied."""
    return dataclasses.replace(cfg, **overrides)
