"""Times the fused scoring head (``kernels.score_head``) on the card at
the evaluators' steps, beside its bound, the plain chunked path and one
library call that computes the same function, and checks it against the
plain path there.

    python3 src/repro_torch/launch/time_score_head.py [--iters N]
        [--shape NAME ...]

The shapes (``SHAPES``): smollm-135m's step (3,072 rows x 31 positions,
d 576, a tied (V, d) table of 49,152), qwen3-moe-30b-a3b's (2,048 x 31,
d 2048, an untied (d, V) unembedding of 151,936) and qwen2.5-14b's
(4,096 x 31, d 5120, untied, 152,064: the widest head the rule sends to
the kernel, ``score_head.MAX_WIDTH``). For each it prints one JSON line:
``rule`` (the path ``score_head.instance`` gives the shape),
``kernel_ms`` (CUDA events, L2 flushed between calls), ``bound_ms`` (the
larger of its operations at the bf16 peak and its bytes at the HBM rate,
``kernels.score_head.cost``), ``plain_ms`` (the chunked float32
log-softmax the rule keeps for every other head,
``models.transformer._chunked_token_logprob`` at the transformer's
chunk), ``library_ms`` (``torch.nn.functional.cross_entropy`` on the
materialised bf16 logits, product included: a yardstick the port never
calls; None where those logits would pass ``LIBRARY_LOGIT_BYTES``) and
the check (each position within 1e-4 plus one bf16 ulp of its target's
logit). ``chip_smoke.py`` runs ``run_shape`` for every shape.

Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels import score_head as SH
from repro_torch.models import transformer as T

# name -> (P, d, V, tied): the evaluators' step at the main path's rows
SHAPES = {"smollm-135m": (3072 * 31, 576, 49152, True),
          "qwen3-moe-30b-a3b": (2048 * 31, 2048, 151936, False),
          "qwen2.5-14b": (4096 * 31, 5120, 152064, False)}
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# the library yardstick's bf16 logits, at most (twice that with its
# log-softmax beside them)
LIBRARY_LOGIT_BYTES = 24e9


def inputs(P: int, d: int, V: int, tied: bool, seed: int, dev):
    """x (P, d), the weight ((V, d) tied, (d, V) untied) in bf16 with
    logits of about 1, and int32 targets in [0, V)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((P, d), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((V, d), generator=g, device=dev) * d ** -0.5).to(
        torch.bfloat16)
    tgt = torch.randint(0, V, (P,), generator=g, device=dev,
                        dtype=torch.int32)
    return x, (w if tied else w.T.contiguous()), tgt


def target_tolerance(x, w, tgt, tied: bool) -> torch.Tensor:
    """Each position's tolerance against the plain path: 1e-4 plus one
    bf16 ulp (7 stored bits) of its target's logit, taken a little above
    the logit so that one just under a power of two gets the larger unit.
    The product's order of summation can flip that logit's one bf16
    rounding; the log-sum-exp's own order moves far less than 1e-4."""
    rows = w[tgt.long()] if tied else w.T[tgt.long()]
    t = (x.float() * rows.float()).sum(-1)
    return 1e-4 + torch.exp2(torch.floor(torch.log2(
        (t.abs() * (1 + 2.0 ** -6)).clamp_min(2.0 ** -126))) - 7)


def head_config(tied: bool, V: int):
    """A transformer config whose head is (V, d) tied or (d, V) untied,
    with no final softcap: all the chunked head reads of it."""
    return dataclasses.replace(get_config("smollm-135m"),
                               tie_embeddings=tied, vocab_size=V,
                               final_logit_softcap=0.0)


def plain(x, w, tgt, tied: bool, token_chunk: int = 0) -> torch.Tensor:
    """The chunked path the rule keeps for every other head,
    ``models.transformer._chunked_token_logprob``, over a head of weight
    ``w``, ``token_chunk`` positions at a time (0: the transformer's
    chunk at this vocabulary). x (P, d), tgt (P,) -> (P,) float32."""
    V = w.shape[0] if tied else w.shape[1]
    cfg = head_config(tied, V)
    params = {"embed": {"table": w}} if tied else {"unembed": {"w": w}}
    return T._chunked_token_logprob(params, cfg, x, tgt.long(),
                                    token_chunk or T._token_chunk(cfg))


def check(x, w, tgt, tied: bool, got) -> dict:
    """The kernel's result against the plain path, each position within
    ``target_tolerance``."""
    want = plain(x, w, tgt, tied)
    err = (got - want).abs()
    return {"max_abs_err": float(err.max()),
            "beyond_tolerance": int(
                (err > target_tolerance(x, w, tgt, tied)).sum()),
            "finite": bool(torch.isfinite(got).all())}


def timed_ms(fn, iters: int, flush) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, CUDA events
    around each, ``flush`` between them outside the events."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / len(pairs)


def run_shape(name: str, dev, flush, iters: int = 10,
              seed: int = 0) -> dict:
    """One shape's check and times (see the module note)."""
    P, d, V, tied = SHAPES[name]
    x, w, tgt = inputs(P, d, V, tied, seed, dev)
    got = SH.score_head(x, w, tgt, tied=tied)
    row = {"shape": name, "P": P, "d": d, "V": V, "tied": tied,
           "rule": SH.instance(x, w, tied=tied),
           **check(x, w, tgt, tied, got)}
    row["repeat_bits"] = bool(torch.equal(
        got, SH.score_head(x, w, tgt, tied=tied)))
    flops, n_bytes = SH.cost(P, d, V)
    by_ops, by_bytes = flops / BF16_FLOP_PER_S, n_bytes / HBM_BYTES_PER_S
    row["bound_ms"] = max(by_ops, by_bytes) * 1e3
    row["bound_by"] = "operations" if by_ops >= by_bytes else "bytes"
    row["kernel_ms"] = timed_ms(lambda: SH.score_head(x, w, tgt, tied=tied),
                                iters, flush)
    row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
    row["plain_ms"] = timed_ms(lambda: plain(x, w, tgt, tied),
                               max(2, iters // 4), flush)
    wt = w.T if tied else w
    tl = tgt.long()
    row["library_ms"] = (timed_ms(lambda: F.cross_entropy(
        x @ wt, tl, reduction="none"), max(2, iters // 4), flush)
        if 2 * P * V <= LIBRARY_LOGIT_BYTES else None)
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--shape", nargs="*", default=list(SHAPES),
                    choices=list(SHAPES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_score_head: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    logs = _build.build(["score_head"])
    for line in logs.get("score_head", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas score_head: {line.strip()}", flush=True)
    scratch = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    for name in args.shape:
        print(json.dumps(run_shape(name, dev, scratch.zero_, args.iters)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
