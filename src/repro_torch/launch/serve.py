"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Counterpart of ``repro.launch.serve``. It boots an N-replica serving
fleet (``cluster.ClusterCoordinator``) with the chosen trust-evaluator
backbone (smoke width), calibrates Ucapacity/Uthreshold to the measured
evaluator throughput (the Load Monitor's job, §4), and serves a seeded
request stream through the priority scheduler: requests arrive with a
CRITICAL/HIGH/NORMAL/LOW mix, route to a replica by tenant (consistent
hashing), are admitted per regime, queue EDF, rebalance by work
stealing, and drain as micro-batches round-robin across replicas; it
prints one line per response, the scheduler and cluster counters and
the P50/P99 scoreboard. ``--replicas 1`` (the default) is the
single-host fleet; ``--sync`` serves one ``ServingEngine`` one request
at a time; ``--trace SECONDS`` replays a seeded chaos trace against a
simulated fleet instead (see the epilog).

``--corpus N`` attaches the retrieval front end: a deterministic N-doc
Zipf corpus split into ``--index-shards`` doc-partitions, which the
consistent-hash ring assigns to replicas (one shard per replica on the
device); requests then arrive as raw query strings (parse -> BM25 ->
``topk_select`` on every live shard -> merge). ``--quorum-k``,
``--shard-hedge-ms`` and ``--straggle-mult`` make that gather
tail-tolerant (``fanout``): first-k-of-n quorum over simulated shard
service times, per-shard hedges onto mirror stripes, replica ``r0``
slowed to show them. ``--device`` defaults to ``cuda``; ``--device
cpu`` runs the plain PyTorch versions of the kernels.

``--arch`` names the trust evaluator: ``smollm-135m`` (default),
``dlrm-mlperf``, ``bst``, ``mind`` or ``two-tower-retrieval``, each at
smoke width.

The mesh-sharded evaluator (``--sharded``) is not ported yet: it exits
with status 2 and says where ROADMAP.md queues it.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

SHARDED_ITEM = "ROADMAP.md, Queue 1, item 6 (distribution)"

_EPILOG = """\
chaos trace replay (--trace)
----------------------------
--trace SECONDS replays a deterministic chaos trace (chaos) against the
fleet instead of the request loop: diurnal + flash-crowd arrivals with
Zipf tenant skew and hot-URL floods, driven on simulated per-replica
clocks calibrated to the measured evaluator throughput of --arch, with
the oracle evaluator and the Trust DBs on --device. The fault timeline
is scripted by the --chaos-* flags; everything derives from --seed, so
the same command line replays bit-identically within a process.

  --trace 6 --replicas 8                  clean diurnal trace
  --trace 6 --chaos-flash 5               + flash crowd x5 mid-trace
  --trace 6 --chaos-poison 4 \\
           --quarantine-k 3               + query-of-death flood; the
                                          per-signature breaker
                                          prior-answers repeats after
                                          3 evaluator crashes
  --trace 6 --chaos-crash 3               + 3 replicas crash the same
                                          tick at 70% of the trace
  --trace 6 --chaos-restart               + rolling restart at 85%
  --gossip --gossip-mode epidemic         O(log n)-fanout push +
                                          anti-entropy pull
  --trace 6 --max-replicas 6 --forecast   feedforward joins
                                          --warmup-lead-s ahead
"""


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, epilog=_EPILOG,
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
                   help="per-request path on one ServingEngine: enqueue "
                        "+ drain each request")
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
    p.add_argument("--replicas", type=int, default=1,
                   help="serving fleet size (1 = single host)")
    p.add_argument("--min-replicas", type=int, default=0,
                   help="elastic lower bound (0 = membership fixed at "
                        "--replicas)")
    p.add_argument("--max-replicas", type=int, default=0,
                   help="elastic upper bound: the autoscaler may join "
                        "replicas up to this many (0 = fixed)")
    p.add_argument("--forecast", action="store_true",
                   help="feedforward autoscaling: join prewarmed "
                        "replicas --warmup-lead-s before the predicted "
                        "breach (needs --max-replicas)")
    p.add_argument("--warmup-lead-s", type=float, default=0.5,
                   help="forecast horizon of the planner")
    p.add_argument("--gossip", action="store_true",
                   help="cross-replica Trust-DB gossip of fresh cache "
                        "fills")
    p.add_argument("--gossip-mode", choices=("broadcast", "epidemic"),
                   default="broadcast",
                   help="delta dissemination: every-sibling broadcast "
                        "or epidemic push + anti-entropy pull")
    p.add_argument("--quarantine-k", type=int, default=0,
                   help="poison-pill breaker: quarantine a work "
                        "signature after this many executor errors "
                        "(0 disables)")
    p.add_argument("--trace", type=float, default=0.0,
                   help="replay a chaos trace of this many simulated "
                        "seconds instead of the request loop (see "
                        "epilog)")
    p.add_argument("--chaos-qps", type=float, default=60.0,
                   help="chaos trace base arrival rate")
    p.add_argument("--chaos-flash", type=float, default=0.0,
                   help="flash-crowd rate multiplier over the middle of "
                        "the trace (0 = none)")
    p.add_argument("--chaos-poison", type=float, default=0.0,
                   help="query-of-death arrivals/s in the poison window "
                        "(0 = none)")
    p.add_argument("--chaos-crash", type=int, default=0,
                   help="replicas crashing on one tick at 70%% of the "
                        "trace (0 = none)")
    p.add_argument("--chaos-restart", action="store_true",
                   help="rolling-restart sweep at 85%% of the trace")
    p.add_argument("--hedge-after-ms", type=float, default=0.0,
                   help="cluster hedge latency (0 disables; needs "
                        "--replicas >= 2)")
    p.add_argument("--drain-every", type=int, default=4,
                   help="drain one round every N enqueues")
    p.add_argument("--corpus", type=int, default=0,
                   help="attach the retrieval front end: synthetic Zipf "
                        "corpus of this many docs; requests become raw "
                        "query strings (0 = pre-retrieved requests)")
    p.add_argument("--index-shards", type=int, default=0,
                   help="doc-partition count (0 = config default); the "
                        "ring assigns partitions to replicas")
    p.add_argument("--quorum-k", type=int, default=0,
                   help="tail-tolerant gather (fanout, needs --corpus): "
                        "answer at the first k of n shard completions, "
                        "prior-answering late stripes (0 = wait for "
                        "every shard)")
    p.add_argument("--shard-hedge-ms", type=float, default=0.0,
                   help="per-shard probe hedge latency: a stripe probe "
                        "slower than this races a twin on a sibling's "
                        "mirror (0 disables)")
    p.add_argument("--straggle-mult", type=float, default=0.0,
                   help="pin a persistent service-time multiplier on "
                        "replica r0's shard (straggler demo for "
                        "--quorum-k/--shard-hedge-ms; 0 = off)")
    p.add_argument("--seed", type=int, default=0)
    later = p.add_argument_group(
        "not ported yet (exit 2)", f"--sharded waits for {SHARDED_ITEM}")
    later.add_argument("--sharded", action="store_true")
    return p


def calibrate(arch: str, dev):
    """The smoke-width evaluator of ``arch`` on ``dev`` and its measured
    throughput in items/s (64 items, after one warm-up call)."""
    from repro_torch.serving.evaluators import make_evaluator

    ev, mk = make_evaluator(arch, smoke=True, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    feats64 = {k: torch.as_tensor(v, device=dev) for k, v in mk(64).items()}
    ev(feats64)
    sync()
    t0 = time.perf_counter()
    ev(feats64)
    sync()
    return ev, mk, 64 / max(time.perf_counter() - t0, 1e-6)


def serve_config(args, rate: float):
    """The ``TrustIRConfig`` the flags ask for, with Ucapacity and
    Uthreshold calibrated to ``rate`` (the Load Monitor's job, §4)."""
    from repro_torch.configs.base import TrustIRConfig

    dl = args.deadline_ms / 1e3
    odl = args.overload_deadline_ms / 1e3
    cfg_kw = dict(u_capacity=max(int(rate * dl), 16),
                  u_threshold=max(int(rate * (odl - dl)), 8),
                  deadline_s=dl, overload_deadline_s=odl,
                  chunk_size=64, n_replicas=max(args.replicas, 1),
                  min_replicas=args.min_replicas,
                  max_replicas=args.max_replicas,
                  gossip=args.gossip, gossip_mode=args.gossip_mode,
                  quarantine_k=max(args.quarantine_k, 0),
                  pipeline_depth=max(args.pipeline_depth, 1),
                  adaptive_depth=args.adaptive_depth,
                  forecast=args.forecast,
                  warmup_lead_s=max(args.warmup_lead_s, 0.0))
    if args.corpus > 0:
        cfg_kw["corpus_docs"] = args.corpus
        if args.index_shards > 0:
            cfg_kw["index_partitions"] = args.index_shards
        cfg_kw["fanout_quorum_k"] = max(args.quorum_k, 0)
        cfg_kw["fanout_hedge_after_s"] = max(args.shard_hedge_ms, 0.0) / 1e3
    return TrustIRConfig(**cfg_kw)


def _print_response(resp, label: str) -> None:
    s = resp.shed
    flag = ("REJECTED " + resp.reason if not resp.admitted
            else ("SLO ok" if resp.met_slo else "SLO MISS"))
    print(f"  req {label} {resp.priority.name:<9} {s.regime.name:<11} "
          f"{resp.latency_s * 1e3:7.1f} ms  eval {s.n_evaluated:>5} "
          f"cached {s.n_cached:>5} prior {s.n_prior:>5} {flag}")


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.sharded:
        print(f"serve: --sharded is not ported to repro_torch yet; it "
              f"waits for {SHARDED_ITEM}", file=sys.stderr)
        return 2
    if args.trace > 0 and args.sync:
        print("serve: --trace drives a fleet; drop --sync",
              file=sys.stderr)
        return 2

    from repro_torch.cluster import ClusterConfig, ClusterCoordinator
    from repro_torch.core.adaptive import AdaptiveWeightController
    from repro_torch.device import resolve
    from repro_torch.scheduling import Priority
    from repro_torch.serving.engine import ServingEngine

    dev = resolve(args.device)
    ev, mk, rate = calibrate(args.arch, dev)
    cfg = serve_config(args, rate)
    dl, odl = cfg.deadline_s, cfg.overload_deadline_s
    n_rep, elastic = cfg.n_replicas, cfg.max_replicas > 0
    print(f"{args.arch} on {dev}: {rate:,.0f} items/s -> "
          f"Ucap={cfg.u_capacity} Uthr={cfg.u_threshold} "
          f"deadline={dl * 1e3:.0f}ms (overload {odl * 1e3:.0f}ms)"
          + (" [adaptive]" if args.adaptive else "")
          + (" [sync]" if args.sync
             else f" [scheduled x{n_rep} replica(s)]")
          + (f" [elastic {max(args.min_replicas, 1)}"
             f"..{args.max_replicas}]" if elastic else "")
          + (" [gossip]" if args.gossip else "")
          + f" [drain={args.drain_mode}"
          + (f" depth={cfg.pipeline_depth}]"
             if args.drain_mode == "fused" else "]"))

    if args.trace > 0:
        coord, rep = trace_fleet(args, cfg, rate, dev)
        return 0 if report_trace(args, coord, rep) else 1

    retrieval = queries = fanout_model = None
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
        print(f"retrieval: {corpus.n_docs} docs / vocab "
              f"{corpus.vocab_size} -> {cfg.index_partitions} "
              f"doc-partitions, top-k={cfg.retrieve_top_k} "
              f"({time.perf_counter() - t0:.2f}s corpus+stats)")
        if cfg.fanout_quorum_k > 0 or cfg.fanout_hedge_after_s > 0:
            from repro_torch.fanout import ShardServiceModel
            fanout_model = ShardServiceModel(seed=args.seed)
            if args.straggle_mult > 1.0:
                fanout_model.set_persistent("r0", args.straggle_mult)
            print(f"fanout: quorum_k={cfg.fanout_quorum_k or 'n'} "
                  f"shard-hedge={args.shard_hedge_ms:.1f}ms "
                  + (f"straggler r0 x{args.straggle_mult:.0f}"
                     if args.straggle_mult > 1.0 else "no straggler"))

    if args.sync:
        retriever = None
        if retrieval is not None:
            # the single engine owns every doc-partition in one shard
            retriever = retrieval.searcher(
                [retrieval.build_shard(range(cfg.index_partitions))])
        eng = ServingEngine(cfg, ev, drain_mode=args.drain_mode,
                            evaluate_batch=ev, retriever=retriever,
                            device=dev)
        if args.adaptive:
            eng.shedder.adaptive = AdaptiveWeightController()
        shedders = [eng.shedder]
    else:
        # N-replica fleet; n_replicas=1 is the single host.
        eng = ClusterCoordinator(
            cfg, ev,
            cluster_cfg=ClusterConfig(
                hedge_after_s=args.hedge_after_ms / 1e3,
                autoscale=n_rep > 1 or elastic,
                min_replicas=args.min_replicas,
                max_replicas=args.max_replicas,
                gossip=args.gossip, gossip_mode=args.gossip_mode,
                forecast=args.forecast,
                warmup_lead_s=max(args.warmup_lead_s, 0.0)),
            drain_mode=args.drain_mode, evaluate_batch=ev,
            retrieval=retrieval, fanout_model=fanout_model, device=dev)
        if args.adaptive:
            for rep in eng.replicas:
                rep.engine.shedder.adaptive = AdaptiveWeightController()
        shedders = [rep.engine.shedder for rep in eng.replicas]

    r = np.random.default_rng(args.seed)
    sizes = np.clip(r.zipf(1.4, size=args.n_requests) * 64, 64, 4096)
    # Priority mix: mostly NORMAL, some HIGH/CRITICAL, a LOW tail.
    prio_choices = [Priority.CRITICAL, Priority.HIGH, Priority.NORMAL,
                    Priority.LOW]
    prios = r.choice(4, size=args.n_requests, p=[0.1, 0.2, 0.5, 0.2])
    if queries is None:
        for n in sorted(set(int(s) for s in sizes)):  # warm each size
            for shedder in shedders:     # on every replica, now
                shedder.process(
                    np.arange(10**6, 10**6 + n, dtype=np.uint32),
                    np.zeros(n, np.int32), mk(n, fseed=999))
    # ... and the padded micro-batch shape of the submit/drain path, on
    # every engine; in corpus mode one real query warms the front half
    # (dense index form, BM25, top-k) too. A fixed string, so the query
    # model's stream is untouched.
    warm_q = "term00001 term00002"
    engines = [eng] if args.sync else [rep.engine for rep in eng.replicas]
    for e in engines:
        if queries is not None:
            e.enqueue_query(warm_q, slo_s=odl * 2.5)
        else:
            e.enqueue(np.arange(1, 65, dtype=np.uint32),
                      np.zeros(64, np.int32), mk(64, fseed=998))
        e.drain()
    if not args.sync:
        eng.drain()                  # collect warm responses, then drop
    eng.completed.clear()

    for i, n in enumerate(int(s) for s in sizes):
        prio = prio_choices[int(prios[i])]
        tenant = f"tenant{i % (4 * n_rep)}"   # the ring spreads them
        if queries is not None:
            q = queries.sample()
            if args.sync:
                rid = eng.enqueue_query(q, slo_s=odl * 2.5, priority=prio)
                eng.drain()
                resp = next(rr for rr in reversed(eng.completed)
                            if rr.request_id == rid)
                _print_response(resp, f"{i:>3} q={q[:22]!r:<24}")
            else:
                eng.enqueue_query(q, slo_s=odl * 2.5, priority=prio,
                                  tenant=tenant)
                if (i + 1) % args.drain_every == 0:
                    eng.drain(1)             # one round
            continue
        keys = np.arange(i * 10_000 + 1, i * 10_000 + n + 1,
                         dtype=np.uint32)
        buckets = r.integers(0, 64, n).astype(np.int32)
        if args.sync:
            resp = eng.submit(keys, buckets, mk(n, fseed=i),
                              slo_s=odl * 2.5, priority=prio)
            _print_response(resp, f"{i:>3} n={n:<5}")
        else:
            eng.enqueue(keys, buckets, mk(n, fseed=i), slo_s=odl * 2.5,
                        priority=prio, tenant=tenant)
            if (i + 1) % args.drain_every == 0:
                eng.drain(1)                 # one round
    if not args.sync:
        eng.drain()
        for resp in eng.completed:
            _print_response(resp, f"{resp.request_id:>3} "
                                  f"n={len(resp.trust):<5}")
        st = eng.scheduler_stats()
        print(f"scheduler: {st['n_batches']} batches, mean fill "
              f"{st['mean_batch_fill']:.0f} items, "
              f"{st['n_rejected']} rejected {st['rejected_by_reason']}, "
              f"{st['n_hedges']} hedges")
        c = st["cluster"]
        print(f"cluster: {len(eng.replicas)} replicas, "
              f"{c['n_steals']} steals, {c['n_hedges']} cross-replica "
              f"hedges, {c['n_twin_drops']} twins deduplicated, "
              f"{c['n_joins']} joins / {c['n_leaves']} leaves")
        if "gossip" in st:
            g = st["gossip"]
            print(f"gossip: {g['n_broadcast']} deltas broadcast "
                  f"({g['n_dropped_budget']} over budget, "
                  f"{g['n_dropped_stale']} stale), "
                  f"{c['n_duplicate_evals']} duplicate evals fleet-wide")
    if retrieval is not None:
        sr = eng.retriever if args.sync else eng.searcher
        live = [s for s in sr.shards if s.n_docs]
        print(f"retrieval: {sr.n_searches} searches "
              f"({sr.n_fallback} fallback), {len(live)} live "
              f"shard(s), {sum(s.n_docs for s in live)} docs resident")
        if hasattr(sr, "gather_stats") and sr.n_gathers:
            fs = sr.gather_stats()    # simulated times, not the device's
            print(f"fanout: gather p50/p99 "
                  f"{fs['gather_p50_s'] * 1e3:.1f}/"
                  f"{fs['gather_p99_s'] * 1e3:.1f} ms simulated (full "
                  f"{fs['full_p50_s'] * 1e3:.1f}/"
                  f"{fs['full_p99_s'] * 1e3:.1f} ms), "
                  f"{fs['n_late_shards']} late stripes "
                  f"({fs['n_cache_fills']} cache-filled, "
                  f"{fs['n_prior_answered']} prior), "
                  f"{fs['n_shard_hedges']} shard hedges "
                  f"({fs['n_shard_hedge_wins']} wins), "
                  f"{fs['n_mirrors_built']} mirrors built / "
                  f"{fs['n_mirrors_dropped']} dropped")
    board = eng.slo_stats()
    print(f"P50 {board['p50_s'] * 1e3:.1f} ms  P99 "
          f"{board['p99_s'] * 1e3:.1f} ms  SLO met "
          f"{100 * board['slo_met_frac']:.0f}%")
    return 0


def trace_fleet(args, cfg, rate: float, dev):
    """Replay the chaos trace the flags describe against a simulated
    fleet calibrated to the measured evaluator rate (the trace needs
    deterministic per-replica clocks; the oracle evaluator stands in for
    the backbone so the poison feature column can detonate it). The
    Trust DBs live on ``dev``. Returns ``(coordinator, report)``."""
    from repro_torch.chaos import (FlashCrowd, PoisonSpec, RegionalFailure,
                                   RollingRestartEvent, TraceConfig,
                                   poisonable, run_fleet_trace)
    from repro_torch.cluster import ClusterConfig, ClusterCoordinator
    from repro_torch.core.pipeline import (SyntheticSearcher,
                                           exact_oracle_evaluator)

    searcher = SyntheticSearcher(corpus_size=20_000, seed=args.seed)
    coord = ClusterCoordinator(
        cfg, poisonable(exact_oracle_evaluator(searcher)),
        cluster_cfg=ClusterConfig(
            hedge_after_s=args.hedge_after_ms / 1e3,
            gossip=args.gossip, gossip_mode=args.gossip_mode,
            autoscale=args.max_replicas > 0 or max(args.replicas, 1) > 1,
            min_replicas=args.min_replicas,
            max_replicas=args.max_replicas,
            forecast=args.forecast,
            warmup_lead_s=max(args.warmup_lead_s, 0.0)),
        sim_rate_items_per_s=rate, device=dev)
    d = args.trace
    tc = TraceConfig(
        duration_s=d, base_qps=args.chaos_qps,
        diurnal_period_s=d, seed=args.seed,
        flash_crowds=([FlashCrowd(0.35 * d, 0.5 * d, args.chaos_flash)]
                      if args.chaos_flash > 1.0 else []),
        poison=([PoisonSpec(0.15 * d, 0.55 * d, qps=args.chaos_poison)]
                if args.chaos_poison > 0 else []),
        failures=([RegionalFailure(t=0.7 * d, n_crash=args.chaos_crash)]
                  if args.chaos_crash > 0 else []),
        restarts=([RollingRestartEvent(t=0.85 * d)]
                  if args.chaos_restart else []))
    return coord, run_fleet_trace(coord, searcher, tc)


def report_trace(args, coord, rep) -> bool:
    """Print a trace replay's outcome; True when no-drop held (every
    request answered exactly once)."""
    st = rep.scheduler_stats
    rids = [r.request_id for r in rep.responses]
    adm = [r for r in rep.responses if r.admitted]
    lat = np.asarray([r.latency_s for r in adm])
    no_drop = (len(rids) == len(set(rids)) == st["n_submitted"])
    print(f"trace: {args.trace:.0f}s, {len(rids)} responses "
          f"({len(adm)} admitted, {st['n_quarantined']} quarantined, "
          f"{st['n_executor_errors']} executor errors), fleet "
          f"{coord.n_replicas} final; "
          f"no-drop {'OK' if no_drop else 'VIOLATED'}")
    for row in rep.churn_log:
        print(f"  event t={row[0]:.2f}s {row[1]}"
              + (f" {row[2]}" if row[2] else "")
              + f" -> {row[3]} replicas")
    if len(lat):
        print(f"P50 {np.percentile(lat, 50) * 1e3:.1f} ms  "
              f"P99 {np.percentile(lat, 99) * 1e3:.1f} ms")
    if "gossip" in st:
        g = st["gossip"]
        print(f"gossip[{args.gossip_mode}]: {g['n_messages']} messages"
              f" ({g['max_round_messages']} busiest round)")
    if "forecast" in st:
        f = st["forecast"]
        print(f"forecast: rate now {f['rate_now_items_per_s']:.0f} -> "
              f"+{args.warmup_lead_s:.1f}s "
              f"{f['rate_forecast_items_per_s']:.0f} items/s, "
              f"{f['n_prewarm_joins']} prewarm joins "
              f"({f['n_cold_joins']} cold)")
    return no_drop


if __name__ == "__main__":
    sys.exit(main())
