"""The benchmark's yardstick of work: the operations and bytes a piece of
work needs, computed from shapes, and the chip's data-sheet peaks
(``peaks.json``). Kept with the benchmark so that a change to the
system cannot move it.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())


def causal_pairs(s: int) -> int:
    """(query, key) pairs of causal attention over s positions."""
    return s * (s + 1) // 2


def doc_flops(m: Dict, doc_tokens: int) -> float:
    """Operations of one evaluation of a document of ``doc_tokens``
    tokens (the score reads positions 0..S-2 and predicts 1..S-1): every
    layer's projections, attention over causal pairs, the feed-forward
    (for MoE the router and the top-k experts a token uses, with no
    capacity padding), and the log-probabilities over the vocabulary.
    A multiply-add is two operations."""
    s = doc_tokens - 1
    d, hq, hkv, dh = (m["hidden_size"], m["num_attention_heads"],
                      m["num_key_value_heads"], m["head_dim"])
    proj = 2 * d * (2 * hq * dh + 2 * hkv * dh)
    if m.get("num_experts"):
        ffn = 2 * d * m["num_experts"] + \
            m["num_experts_per_tok"] * 3 * 2 * d * m["moe_intermediate_size"]
    else:
        ffn = 3 * 2 * d * m["intermediate_size"]
    per_layer = s * (proj + ffn) + hq * 4 * dh * causal_pairs(s)
    head = s * 2 * d * m["vocab_size"]
    return float(m["num_hidden_layers"] * per_layer + head)


def attention_work(m: Dict, rows: int, doc_tokens: int,
                   elem_bytes: int = 2) -> Dict[str, float]:
    """Operations and bytes of one causal attention call over ``rows``
    sequences of S = doc_tokens - 1: q, k and v read once and o written
    once; QK^T and PV over the causal pairs."""
    s = doc_tokens - 1
    hq, hkv, dh = (m["num_attention_heads"], m["num_key_value_heads"],
                   m["head_dim"])
    n_bytes = rows * s * dh * (2 * hq + 2 * hkv) * elem_bytes
    flops = rows * hq * 4 * dh * causal_pairs(s)
    return {"flops": float(flops), "bytes": float(n_bytes)}


def bound_s(work: Dict[str, float], dtype: str = "bfloat16") -> float:
    """The least time the chip could take: the larger of bytes over the
    memory rate and operations over the peak rate of ``dtype``."""
    return max(work["bytes"] / PEAKS["hbm_bytes_per_s"],
               work["flops"] / PEAKS["flops_per_s"][dtype])
