"""Serving launcher: ``python -m repro_torch.launch.serve --sync``.

Counterpart of the single-engine path of ``repro.launch.serve``. It
boots one ``ServingEngine`` with the chosen trust-evaluator backbone
(smoke width), calibrates Ucapacity/Uthreshold to the measured
evaluator throughput (the Load Monitor's job, §4), and serves a seeded
request stream through the priority scheduler one request at a time
(``--sync``), printing one line per request and the P50/P99 scoreboard.

``--corpus N`` attaches the retrieval front end: a deterministic N-doc
Zipf corpus indexed into one shard on the device; requests then arrive
as raw query strings (parse -> BM25 -> ``topk_select`` picks each
candidate set). ``--device`` defaults to ``cuda``; ``--device cpu``
runs the plain PyTorch versions of the kernels.

Everything that needs the serving fleet (``ClusterCoordinator``) — the
default scheduled mode without ``--sync``, ``--replicas`` above 1,
``--trace``, gossip, chaos, quorum fan-out, hedging, elastic
membership, forecasting — and the mesh-sharded evaluator (``--sharded``)
exits with status 2 and says where ROADMAP.md queues it.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

CLUSTER_ITEM = "ROADMAP.md, Queue 1, item 3 (fanout, cluster, chaos)"
SHARDED_ITEM = "ROADMAP.md, Queue 1, item 6 (distribution)"

# Flags of the reference launcher that only the fleet (or the mesh)
# serves: (flag, attribute, "is it set?", where the port queues it).
_NOT_PORTED = (
    ("--replicas > 1", "replicas", lambda v: v > 1, CLUSTER_ITEM),
    ("--min-replicas", "min_replicas", bool, CLUSTER_ITEM),
    ("--max-replicas", "max_replicas", bool, CLUSTER_ITEM),
    ("--forecast", "forecast", bool, CLUSTER_ITEM),
    ("--gossip", "gossip", bool, CLUSTER_ITEM),
    ("--trace", "trace", bool, CLUSTER_ITEM),
    ("--chaos-flash", "chaos_flash", bool, CLUSTER_ITEM),
    ("--chaos-poison", "chaos_poison", bool, CLUSTER_ITEM),
    ("--chaos-crash", "chaos_crash", bool, CLUSTER_ITEM),
    ("--chaos-restart", "chaos_restart", bool, CLUSTER_ITEM),
    ("--hedge-after-ms", "hedge_after_ms", bool, CLUSTER_ITEM),
    ("--quorum-k", "quorum_k", bool, CLUSTER_ITEM),
    ("--shard-hedge-ms", "shard_hedge_ms", bool, CLUSTER_ITEM),
    ("--straggle-mult", "straggle_mult", bool, CLUSTER_ITEM),
    ("--sharded", "sharded", bool, SHARDED_ITEM),
)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", default="smollm-135m")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions of the kernels)")
    p.add_argument("--n-requests", type=int, default=10)
    p.add_argument("--deadline-ms", type=float, default=50.0)
    p.add_argument("--overload-deadline-ms", type=float, default=100.0)
    p.add_argument("--adaptive", action="store_true",
                   help="adaptive Very-Heavy deadline weight (§7)")
    p.add_argument("--sync", action="store_true",
                   help="per-request path: enqueue + drain each request "
                        "(the only mode the port serves so far)")
    p.add_argument("--drain-mode", choices=("host", "fused"),
                   default="host",
                   help="micro-batch executor: host chunk loop "
                        "(wall-clock deadline) or the fused "
                        "one-device-step-per-batch drain")
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="DrainExecutor in-flight window (fused drain)")
    p.add_argument("--adaptive-depth", action="store_true",
                   help="adaptive DrainExecutor window, clamped by "
                        "--pipeline-depth")
    p.add_argument("--corpus", type=int, default=0,
                   help="attach the retrieval front end: synthetic Zipf "
                        "corpus of this many docs; requests become raw "
                        "query strings (0 = pre-retrieved requests)")
    p.add_argument("--index-shards", type=int, default=0,
                   help="doc-partition count (0 = config default); the "
                        "single engine owns every partition")
    p.add_argument("--quarantine-k", type=int, default=0,
                   help="poison-pill breaker: quarantine a work "
                        "signature after this many executor errors "
                        "(0 disables)")
    p.add_argument("--seed", type=int, default=0)
    fleet = p.add_argument_group(
        "not ported yet (exit 2)",
        f"fleet modes wait for {CLUSTER_ITEM}; --sharded waits for "
        f"{SHARDED_ITEM}")
    fleet.add_argument("--replicas", type=int, default=1)
    fleet.add_argument("--min-replicas", type=int, default=0)
    fleet.add_argument("--max-replicas", type=int, default=0)
    fleet.add_argument("--forecast", action="store_true")
    fleet.add_argument("--warmup-lead-s", type=float, default=0.5)
    fleet.add_argument("--gossip", action="store_true")
    fleet.add_argument("--gossip-mode", choices=("broadcast", "epidemic"),
                       default="broadcast")
    fleet.add_argument("--trace", type=float, default=0.0)
    fleet.add_argument("--chaos-qps", type=float, default=60.0)
    fleet.add_argument("--chaos-flash", type=float, default=0.0)
    fleet.add_argument("--chaos-poison", type=float, default=0.0)
    fleet.add_argument("--chaos-crash", type=int, default=0)
    fleet.add_argument("--chaos-restart", action="store_true")
    fleet.add_argument("--hedge-after-ms", type=float, default=0.0)
    fleet.add_argument("--drain-every", type=int, default=4)
    fleet.add_argument("--quorum-k", type=int, default=0)
    fleet.add_argument("--shard-hedge-ms", type=float, default=0.0)
    fleet.add_argument("--straggle-mult", type=float, default=0.0)
    fleet.add_argument("--sharded", action="store_true")
    return p


def _not_ported(args) -> str:
    """The refusal message for a fleet/mesh flag, or '' when the command
    line stays on the single-engine path."""
    for flag, attr, is_set, item in _NOT_PORTED:
        if is_set(getattr(args, attr)):
            return (f"{flag} is not ported to repro_torch yet; it waits "
                    f"for {item}")
    if not args.sync:
        return ("the scheduled fleet mode (no --sync) needs "
                f"ClusterCoordinator, which waits for {CLUSTER_ITEM}; "
                "run with --sync")
    return ""


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    refusal = _not_ported(args)
    if refusal:
        print(f"serve: {refusal}", file=sys.stderr)
        return 2

    from repro_torch.configs.base import TrustIRConfig
    from repro_torch.core.adaptive import AdaptiveWeightController
    from repro_torch.device import resolve
    from repro_torch.scheduling import Priority
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.evaluators import make_evaluator

    dev = resolve(args.device)
    ev, mk = make_evaluator(args.arch, smoke=True, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    feats64 = {k: torch.as_tensor(v, device=dev) for k, v in mk(64).items()}
    ev(feats64)
    sync()
    t0 = time.perf_counter()
    ev(feats64)
    sync()
    rate = 64 / max(time.perf_counter() - t0, 1e-6)
    dl = args.deadline_ms / 1e3
    odl = args.overload_deadline_ms / 1e3
    cfg_kw = dict(u_capacity=max(int(rate * dl), 16),
                  u_threshold=max(int(rate * (odl - dl)), 8),
                  deadline_s=dl, overload_deadline_s=odl,
                  chunk_size=64,
                  quarantine_k=max(args.quarantine_k, 0),
                  pipeline_depth=max(args.pipeline_depth, 1),
                  adaptive_depth=args.adaptive_depth)
    if args.corpus > 0:
        cfg_kw["corpus_docs"] = args.corpus
        if args.index_shards > 0:
            cfg_kw["index_partitions"] = args.index_shards
    cfg = TrustIRConfig(**cfg_kw)
    print(f"{args.arch} on {dev}: {rate:,.0f} items/s -> "
          f"Ucap={cfg.u_capacity} Uthr={cfg.u_threshold} "
          f"deadline={dl * 1e3:.0f}ms (overload {odl * 1e3:.0f}ms)"
          + (" [adaptive]" if args.adaptive else "")
          + " [sync]"
          + f" [drain={args.drain_mode}"
          + (f" depth={cfg.pipeline_depth}]"
             if args.drain_mode == "fused" else "]"))

    retriever = queries = None
    if args.corpus > 0:
        from repro_torch.retrieval import (CorpusRetrieval, SyntheticCorpus,
                                           ZipfQueryModel)

        def doc_features(docs):    # retrieved docs -> backbone features
            return mk(len(docs),
                      fseed=int(docs[0]) % 1_000_000 if len(docs) else 0)

        t0 = time.perf_counter()
        corpus = SyntheticCorpus(n_docs=cfg.corpus_docs,
                                 vocab_size=cfg.corpus_vocab,
                                 zipf_a=cfg.corpus_zipf_a,
                                 seed=cfg.corpus_seed)
        retrieval = CorpusRetrieval(corpus,
                                    n_partitions=cfg.index_partitions,
                                    block_docs=cfg.index_block_docs,
                                    feature_fn=doc_features, device=dev)
        queries = ZipfQueryModel.for_corpus(corpus, seed=args.seed + 1)
        # the single engine owns every doc-partition in one shard
        retriever = retrieval.searcher(
            [retrieval.build_shard(range(cfg.index_partitions))])
        print(f"retrieval: {corpus.n_docs} docs / vocab "
              f"{corpus.vocab_size} -> {cfg.index_partitions} "
              f"doc-partitions in one shard, top-k={cfg.retrieve_top_k} "
              f"({time.perf_counter() - t0:.2f}s corpus+index)")

    eng = ServingEngine(cfg, ev, drain_mode=args.drain_mode,
                        evaluate_batch=ev, retriever=retriever, device=dev)
    if args.adaptive:
        eng.shedder.adaptive = AdaptiveWeightController()

    r = np.random.default_rng(args.seed)
    sizes = np.clip(r.zipf(1.4, size=args.n_requests) * 64, 64, 4096)
    # Priority mix: mostly NORMAL, some HIGH/CRITICAL, a LOW tail.
    prio_choices = [Priority.CRITICAL, Priority.HIGH, Priority.NORMAL,
                    Priority.LOW]
    prios = r.choice(4, size=args.n_requests, p=[0.1, 0.2, 0.5, 0.2])
    if queries is None:
        for n in sorted(set(int(s) for s in sizes)):  # warm each size
            eng.shedder.process(
                np.arange(10**6, 10**6 + n, dtype=np.uint32),
                np.zeros(n, np.int32), mk(n, fseed=999))
        eng.enqueue(np.arange(1, 65, dtype=np.uint32),
                    np.zeros(64, np.int32), mk(64, fseed=998))
    else:
        # one real query warms the front half (dense index form, BM25,
        # top-k) plus the evaluator batch shape; a fixed string, so the
        # query model's stream is untouched
        eng.enqueue_query("term00001 term00002", slo_s=odl * 2.5)
    eng.drain()
    eng.completed.clear()

    for i, n in enumerate(int(s) for s in sizes):
        prio = prio_choices[int(prios[i])]
        if queries is not None:
            q = queries.sample()
            rid = eng.enqueue_query(q, slo_s=odl * 2.5, priority=prio)
            eng.drain()
            resp = next(rr for rr in reversed(eng.completed)
                        if rr.request_id == rid)
            sh = resp.shed
            print(f"  req {i:>3} q={q[:22]!r:<24} {prio.name:<9} "
                  f"{sh.regime.name:<11} "
                  f"{resp.latency_s * 1e3:7.1f} ms  "
                  f"eval {sh.n_evaluated:>5} cached "
                  f"{sh.n_cached:>5} prior {sh.n_prior:>5} "
                  f"{'SLO ok' if resp.met_slo else 'SLO MISS'}")
            continue
        keys = np.arange(i * 10_000 + 1, i * 10_000 + n + 1,
                         dtype=np.uint32)
        buckets = r.integers(0, 64, n).astype(np.int32)
        resp = eng.submit(keys, buckets, mk(n, fseed=i),
                          slo_s=odl * 2.5, priority=prio)
        s = resp.shed
        print(f"  req {i:>3} n={n:<5} {prio.name:<9} "
              f"{s.regime.name:<11} {resp.latency_s * 1e3:7.1f} ms  "
              f"eval {s.n_evaluated:>5} cached {s.n_cached:>5} "
              f"prior {s.n_prior:>5} "
              f"{'SLO ok' if resp.met_slo else 'SLO MISS'}")
    if retriever is not None:
        live = [s for s in retriever.shards if s.n_docs]
        print(f"retrieval: {retriever.n_searches} searches "
              f"({retriever.n_fallback} fallback), {len(live)} live "
              f"shard(s), {sum(s.n_docs for s in live)} docs resident")
    board = eng.slo_stats()
    print(f"P50 {board['p50_s'] * 1e3:.1f} ms  P99 "
          f"{board['p99_s'] * 1e3:.1f} ms  SLO met "
          f"{100 * board['slo_met_frac']:.0f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
