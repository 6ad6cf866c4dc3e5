"""Seeded evaluator weights, made on the device in the type they are
served in.

One flat buffer is drawn with one ``normal_`` call from a
``torch.Generator`` on the device; every leaf is an aligned view into it,
scaled in place. The tree uses the parameter names the system's
transformer reads (``embed.table``, ``blocks[i].attn.wq.w``, ...), with
dense weights as (d_in, d_out). Norm scales are drawn too (the norm
multiplies by ``1 + scale``), so a norm that ignored them would show.

Scales: inputs of a product N(0, 1/d_in); the embedding N(0, 0.02^2);
the projections back into the residual stream (``wo``, the feed-forward
and experts' ``down``) RESID^2/d_in, so that each layer adds about RESID
to the stream, as in a trained model, where a layer's update is small
beside the stream; the router ROUTER^2/d_in, so that a token's top
experts stand clear of the rest, as a trained router's do. With both at
1 a random 48-layer MoE is chaotic: which expert wins a near tie, and
which pair an expert's capacity drops, swing its output by more than
float8 rounding does, and no comparison can tell bf16 from float8.

Both the system under test and the reference are given this tree: it
is an input of the benchmark, like the traffic.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

_ALIGN = 128          # elements: every leaf starts 256-byte aligned
NORM_STD = 0.1
RESID = 0.1
ROUTER = 3.0


def leaf_specs(m: Dict) -> List[Tuple[Tuple, Tuple[int, ...], float]]:
    """(path, shape, std) of every leaf of model ``m`` (the config file's
    ``model`` group), in a fixed order."""
    d, L = m["hidden_size"], m["num_hidden_layers"]
    hq, hkv, dh = (m["num_attention_heads"], m["num_key_value_heads"],
                   m["head_dim"])
    specs = [(("embed", "table"), (m["vocab_size"], d), 0.02)]
    for i in range(L):
        b = ("blocks", i)
        specs += [
            (b + ("ln1", "scale"), (d,), NORM_STD),
            (b + ("ln2", "scale"), (d,), NORM_STD),
            (b + ("attn", "wq", "w"), (d, hq * dh), d ** -0.5),
            (b + ("attn", "wk", "w"), (d, hkv * dh), d ** -0.5),
            (b + ("attn", "wv", "w"), (d, hkv * dh), d ** -0.5),
            (b + ("attn", "wo", "w"), (hq * dh, d), RESID * (hq * dh) ** -0.5),
        ]
        if m.get("num_experts"):
            e, f = m["num_experts"], m["moe_intermediate_size"]
            specs += [
                (b + ("moe", "router", "w"), (d, e), ROUTER * d ** -0.5),
                (b + ("moe", "w_gate"), (e, d, f), d ** -0.5),
                (b + ("moe", "w_up"), (e, d, f), d ** -0.5),
                (b + ("moe", "w_down"), (e, f, d), RESID * f ** -0.5),
            ]
        else:
            f = m["intermediate_size"]
            specs += [
                (b + ("ffn", "gate", "w"), (d, f), d ** -0.5),
                (b + ("ffn", "up", "w"), (d, f), d ** -0.5),
                (b + ("ffn", "down", "w"), (f, d), RESID * f ** -0.5),
            ]
    specs.append((("final_norm", "scale"), (d,), NORM_STD))
    if not m["tie_word_embeddings"]:
        specs.append((("unembed", "w"), (d, m["vocab_size"]), d ** -0.5))
    return specs


def _put(tree: Dict, path: Tuple, leaf: torch.Tensor) -> None:
    node = tree
    for i, key in enumerate(path[:-1]):
        nxt = path[i + 1]
        if isinstance(node, list):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = leaf


def make_weights(m: Dict, seed: int, dtype: torch.dtype,
                 device) -> Dict:
    """The parameter tree of model ``m`` drawn from ``seed`` on
    ``device`` in ``dtype``."""
    specs = leaf_specs(m)
    sizes = [-(-math.prod(s) // _ALIGN) * _ALIGN for _, s, _ in specs]
    flat = torch.empty(sum(sizes), dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & ((1 << 63) - 1))
    flat.normal_(generator=gen)
    tree: Dict = {}
    off = 0
    for (path, shape, std), size in zip(specs, sizes):
        leaf = flat[off:off + math.prod(shape)].view(shape)
        leaf.mul_(std)
        _put(tree, path, leaf)
        off += size
    return tree
