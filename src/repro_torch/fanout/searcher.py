"""Tail-tolerant scatter-gather searcher.

:class:`FanoutSearcher` is a drop-in :class:`CorpusSearcher`: same
``retrieve``/``search`` interface, same (score desc, doc id asc)
merge — but the gather is tail-tolerant:

* every live shard is probed and its simulated completion time drawn
  from a :class:`ShardServiceModel` (deterministic per ``(seed, key,
  probe#)``, so chaos tests stay bit-reproducible);
* a probe slower than the hedge latency races a twin against a sibling
  replica's **mirror** of the same stripes (when selective replication
  has built one). First completion wins; exactly one answer per shard
  enters the merge, the loser is deduplicated (counted, never merged).
  Hedges spend the fleet ``HedgedDispatch`` token bucket — per-shard
  probes and whole-request twins draw from the same budget;
* the gather completes at the first-``quorum_k``-of-``n`` threshold
  (:class:`QuorumGather`); late shards are prior-answered from the
  **stripe answer cache** — the per-(query, shard) candidates that
  shard returned last time, whose trust the Trust-DB already holds —
  or left to the downstream trust prior. A late probe's fresh result
  still folds into the cache when it eventually lands (the work was
  done; only the response didn't wait), so hot Zipf queries recover
  full recall on the very next repeat;
* ``quorum_k == n`` (or 0) answers every shard and is bit-identical to
  the synchronous full gather.

Simulated gather latency lives in ``last_gather_s`` / ``gather_times``
(and :class:`GatherReport`) only — ``search`` keeps stamping the WALL
time ``last_retrieve_s``, so the LoadMonitor's wall-clocks-only rule is
untouched.

Counterpart of ``repro.fanout.searcher`` (host logic, copied) over the
port's :class:`IndexShard`, which lives on the card unless the caller
names another device. Every shard probe, every hedge won by a mirror
and every mirror's warm-up probe is one ``IndexShard.retrieve``: one
BM25 pass, one ``topk_select`` launch and one host copy. Hedges that
lose their race run no probe: their service time is simulated.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.distribution.fault_tolerance import HedgedDispatch
from repro_torch.retrieval.corpus import SyntheticCorpus
from repro_torch.retrieval.shard import CorpusSearcher, IndexShard, Q_MAX, \
    merge_topk
from repro_torch.retrieval.text import normalize

from .quorum import GatherReport, QuorumGather
from .replication import ReplicationPolicy, StripeReplicator, \
    mirror_shard_of
from .service_model import ShardServiceModel


class FanoutSearcher(CorpusSearcher):
    """Quorum + hedged + selectively-replicated scatter-gather."""

    def __init__(self, corpus: SyntheticCorpus,
                 shards: Optional[List[IndexShard]] = None,
                 keys: Optional[Sequence[str]] = None, *,
                 quorum_k: int = 0,
                 service_model: Optional[ShardServiceModel] = None,
                 hedge: Optional[HedgedDispatch] = None,
                 hedge_after_s: float = 0.0,
                 replicator: Optional[StripeReplicator] = None,
                 feature_fn: Optional[Callable] = None,
                 answer_cache_entries: int = 8192):
        super().__init__(corpus, shards, feature_fn=feature_fn)
        self.quorum = QuorumGather(quorum_k)
        self.service_model = service_model
        # ``hedge`` may be the CLUSTER's dispatcher (or a
        # HedgeBudgetView over it): shared bucket, budget refilled by
        # admitted traffic. With none given and a latency set, this
        # searcher owns a probe-granularity bucket and earns per probe.
        self._hedge_owned = hedge is None and hedge_after_s > 0
        if self._hedge_owned:
            hedge = HedgedDispatch(hedge_after_s, budget_frac=0.1,
                                   budget_burst=4.0)
        self.hedge = hedge
        self.replicator = replicator or StripeReplicator()
        # slow shard key -> (host key, mirror IndexShard)
        self.mirrors: Dict[str, Tuple[str, IndexShard]] = {}
        self._keys: List[str] = list(
            keys if keys is not None
            else (f"s{i}" for i in range(len(self.shards))))
        if len(self._keys) != len(self.shards):
            raise ValueError("keys and shards must parallel")
        self._answer_cache: "OrderedDict[Tuple[str, str], tuple]" = \
            OrderedDict()
        self._answer_cache_entries = int(answer_cache_entries)
        # gather observability
        self.last_gather_s = 0.0         # simulated quorum completion
        self.last_full_gather_s = 0.0    # simulated slowest shard
        self.last_report: Optional[GatherReport] = None
        self.gather_times: List[float] = []
        self.full_times: List[float] = []
        self.n_gathers = 0
        self.n_late_shards = 0
        self.n_cache_fills = 0
        self.n_prior_answered = 0
        self.n_shard_hedges = 0
        self.n_shard_hedge_wins = 0
        self.n_shard_twin_drops = 0
        self.n_mirrors_built = 0
        self.n_mirrors_dropped = 0

    # -- fleet membership ----------------------------------------------------

    def set_fleet(self, keyed_shards: Sequence[Tuple[str, IndexShard]]
                  ) -> None:
        """Replace the shard set (cluster attach / membership change).
        Stripe ownership may have moved, so the per-shard answer cache
        is invalidated wholesale, and mirrors whose slow shard or host
        left the fleet are dropped."""
        self._keys = [k for k, _ in keyed_shards]
        self.shards = [s for _, s in keyed_shards]
        self._answer_cache.clear()
        live = set(self._keys)
        for key in [k for k, (host, _) in self.mirrors.items()
                    if k not in live or host not in live]:
            self.drop_mirror(key)

    # -- mirrors -------------------------------------------------------------

    def add_mirror(self, key: str, host_key: str,
                   shard: IndexShard, warm: bool = True) -> None:
        """Register a mirror stripe for ``key`` hosted on ``host_key``.

        ``warm`` fires one scoring probe at build time, forcing the
        mirror's dense form to build on its device NOW —
        replication is the slow path already, so the cost lands there.
        Without it, the first hedged probe against a fresh mirror paid
        the whole dense build inside its measured service time, which
        both inflated the hedge's latency and fed the replicator's EWMA
        a cold-start outlier for the very shard it was rescuing."""
        if warm and shard.n_docs > 0:
            term = next(iter(shard.index.postings), None)
            if term is not None:
                shard.retrieve(term, 1)
        self.mirrors[key] = (host_key, shard)
        self.n_mirrors_built += 1

    def drop_mirror(self, key: str) -> None:
        if self.mirrors.pop(key, None) is not None:
            self.n_mirrors_dropped += 1

    def replication_due(self) -> List[str]:
        return self.replicator.due(set(self.mirrors))

    def mirrors_recovered(self) -> List[str]:
        return self.replicator.recovered(set(self.mirrors))

    def set_slowdown(self, key: str, mult: float) -> None:
        """Pin/clear a persistent slowdown (chaos hook; mult<=1 clears)."""
        if self.service_model is not None:
            self.service_model.set_persistent(key, mult)

    def maintain(self) -> None:
        """Standalone replication round (the cluster coordinator runs
        its own ring-aware version): mirror each due shard's stripes
        onto the fastest OTHER shard's replica via the export->absorb
        round trip; drop recovered mirrors."""
        for key in self.replication_due():
            i = self._keys.index(key)
            hosts = [k for k in self._keys if k != key]
            if not hosts or self.shards[i].n_docs == 0:
                continue
            host = min(hosts,
                       key=lambda k: (self.replicator.ewma_of(k), k))
            self.add_mirror(key, host, mirror_shard_of(self.shards[i]))
        for key in self.mirrors_recovered():
            self.drop_mirror(key)

    # -- the gather ----------------------------------------------------------

    def _cache_key(self, query: str) -> str:
        return " ".join(normalize(query)[:Q_MAX])

    def _cache_put(self, qkey: str, shard_key: str, part: tuple) -> None:
        k = (qkey, shard_key)
        self._answer_cache[k] = part
        self._answer_cache.move_to_end(k)
        while len(self._answer_cache) > self._answer_cache_entries:
            self._answer_cache.popitem(last=False)

    def retrieve(self, query: str, k: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Scatter to every live shard, quorum-gather with per-shard
        hedging; identical to the synchronous gather when no service
        model is attached (production wall-clock mode) or when the
        quorum is the whole fan-out."""
        if self.service_model is None:
            return super().retrieve(query, k)
        live = [(self._keys[i], sh)
                for i, sh in enumerate(self.shards) if sh.n_docs]
        # Pass 1 — every shard's PRIMARY probe: draw completions,
        # observe EWMAs, and collect the hedge-eligible stragglers
        # (mirror exists, past the hedge latency) WITHOUT spending any
        # budget yet. Spending first-come in shard order starved the
        # widest-gap straggler whenever an earlier, mildly-slow shard
        # drained the shared bucket first.
        answers = []          # [key, docs, scores, t_effective]
        hedge_cands = []      # (ewma gap above fleet baseline, index)
        for key, sh in live:
            if self.hedge is not None and self._hedge_owned:
                self.hedge.note_request()   # probe-granularity budget
            docs, scores = sh.retrieve(query, k)
            t = self.service_model.sample(key)
            # EWMAs see the PRIMARY completion only: a shard rescued by
            # its mirror must still look slow, or replication would
            # drop the mirror that is doing the rescuing.
            self.replicator.observe(key, t)
            if key in self.mirrors and self.hedge is not None \
                    and t >= self.hedge.hedge_after_s:
                hedge_cands.append((0.0, len(answers)))
            answers.append([key, docs, scores, t])
        if hedge_cands:
            # Gaps read AFTER the whole scatter observed, so every
            # candidate is ranked on the same (post-round) EWMA state.
            baseline = self.replicator.baseline()
            hedge_cands = [
                (self.replicator.ewma_of(answers[i][0]) - baseline, i)
                for _, i in hedge_cands]
        # Pass 2 — spend the per-round hedge budget widest-EWMA-gap
        # first: the chronically slowest shard gets the first token,
        # not the shard that happened to iterate first. Budget is
        # re-checked per spend (should_hedge) so a drained bucket stops
        # the ladder exactly where first-come would have, just in merit
        # order. Ties (equal gap) fall back to scatter order, keeping
        # the single-straggler case bit-identical to the old path.
        hedge_cands.sort(key=lambda c: (-c[0], c[1]))
        for _, i in hedge_cands:
            key, _, _, t = answers[i]
            if not self.hedge.should_hedge(t, 0):
                continue
            host_key, mshard = self.mirrors[key]
            self.hedge.record_hedge()
            self.n_shard_hedges += 1
            # The twin runs on the HOST replica: its own rng stream
            # (keyed per (host, shard) — spend ORDER never perturbs
            # any draw), the host's persistent health.
            t_twin = self.hedge.hedge_after_s \
                + self.service_model.sample(f"{host_key}|m|{key}",
                                            mult_key=host_key)
            if t_twin < t:
                docs, scores = mshard.retrieve(query, k)
                answers[i] = [key, docs, scores, t_twin]
                self.n_shard_hedge_wins += 1
            # first completion wins; the loser never reaches the
            # merge — exactly one answer per shard, fleet-wide
            self.n_shard_twin_drops += 1

        t_quorum, answered = self.quorum.split([a[3] for a in answers])
        n = len(answers)
        report = GatherReport(
            n_shards=n, quorum_k=self.quorum.effective_k(max(n, 1)),
            t_quorum_s=t_quorum,
            t_full_s=max((a[3] for a in answers), default=0.0),
            n_hedges=0, n_hedge_wins=0)
        qkey = self._cache_key(query)
        parts = []
        for (key, docs, scores, t), ok in zip(answers, answered):
            if ok:
                parts.append((docs, scores))
            else:
                report.late_keys.append(key)
                cached = self._answer_cache.get((qkey, key))
                if cached is not None:
                    # prior-answered: the shard's last candidates for
                    # this query — already evaluated, trust on file
                    parts.append(cached)
                    report.n_cache_fills += 1
                else:
                    # nothing on file: the downstream trust prior
                    # covers this stripe (paper §5 — answer from the
                    # prior rather than miss the deadline)
                    report.n_prior_answered += 1
            # fresh results always fold into the stripe answer cache —
            # late probes complete after the response left, and their
            # work still warms the next repeat of a hot query
            self._cache_put(qkey, key, (docs, scores))
        docs, scores = merge_topk(parts, k)

        self.last_gather_s = t_quorum
        self.last_full_gather_s = report.t_full_s
        self.gather_times.append(t_quorum)
        self.full_times.append(report.t_full_s)
        self.n_gathers += 1
        self.n_late_shards += len(report.late_keys)
        self.n_cache_fills += report.n_cache_fills
        self.n_prior_answered += report.n_prior_answered
        self.last_report = report
        return docs, scores

    # -- observability -------------------------------------------------------

    def gather_stats(self) -> Dict:
        gt = np.asarray(self.gather_times or [0.0])
        ft = np.asarray(self.full_times or [0.0])
        return {
            "quorum_k": self.quorum.quorum_k,
            "n_gathers": self.n_gathers,
            "n_late_shards": self.n_late_shards,
            "n_cache_fills": self.n_cache_fills,
            "n_prior_answered": self.n_prior_answered,
            "n_shard_hedges": self.n_shard_hedges,
            "n_shard_hedge_wins": self.n_shard_hedge_wins,
            "n_shard_twin_drops": self.n_shard_twin_drops,
            "n_mirrors_built": self.n_mirrors_built,
            "n_mirrors_dropped": self.n_mirrors_dropped,
            "n_mirrors_live": len(self.mirrors),
            "gather_p50_s": float(np.percentile(gt, 50)),
            "gather_p99_s": float(np.percentile(gt, 99)),
            "full_p50_s": float(np.percentile(ft, 50)),
            "full_p99_s": float(np.percentile(ft, 99)),
        }
