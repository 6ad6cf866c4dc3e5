"""Batched serving engine: priority scheduler + Load Shedder admission.

Counterpart of ``repro.serving.engine``. The engine runs on ``device``
(``cuda`` unless the caller names another; ``device.resolve``): the
shedder's Trust DB and prior live there, the fused drain's step and the
retriever's BM25 + ``topk_select`` run there.

Request lifecycle: arrive (a raw query string via ``enqueue_query`` —
parse -> index lookup -> BM25 top-k retrieve through the attached
``retrieval`` searcher — or a pre-retrieved candidate set via
``enqueue``) -> admit (``scheduling`` priority ladder +
per-tenant rate limits) -> EDF queue -> micro-batch -> shed (the
paper's three-tier ladder decides EVAL / CACHED / PRIOR per coalesced
batch) -> response. LM decode requests additionally claim KV slots
from a ``kv_pool`` (duck-typed: ``serving.kv_cache.KVCachePool`` or a
bare ``SlotAllocator``).

The engine is the production face of ``core.shedder``: it owns the
monitor (throughput EWMA), the Trust DB cache and the prior state, and
exposes per-request SLO accounting for straggler/hedging policies
(``distribution.fault_tolerance``).

API:
  * ``enqueue(...) -> request_id`` then ``drain() -> [Response]`` — the
    scheduled path: requests coalesce into budget-shaped micro-batches
    (one Trust-DB probe / insert / prior update and full evaluator
    chunks per *batch* instead of per request).
  * ``submit(...) -> Response`` — compat shim for the original
    synchronous API: enqueue + drain, returns this request's response.

Rejected requests (LOW priority under pressure, rate-limited tenants,
queue backpressure) complete immediately with an explicit
``admitted=False`` response answered from the average-trust prior —
the no-drop invariant extends to the admission layer.
"""
from __future__ import annotations

import itertools
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.configs.base import TrustIRConfig
from repro_torch.core.fused_shedder import FusedLoadShedder
from repro_torch.core.load_monitor import LoadMonitor, WarmupGate
from repro_torch.core.shedder import LoadShedder, SimClock
from repro_torch.device import resolve
from repro_torch.scheduling import (Priority, Request, Response, Scheduler,
                                    SchedulerConfig)

__all__ = ["Request", "Response", "ServingEngine", "slo_stats_of"]


def slo_stats_of(completed: List[Response]) -> Dict[str, float]:
    """P50/P99 latency + SLO attainment over admitted responses (shared
    by the single engine and the cluster coordinator)."""
    admitted = [r for r in completed if r.admitted]
    if not admitted:
        return {"n": 0, "n_rejected": len(completed),
                "p50_s": float("nan"), "p99_s": float("nan"),
                "slo_met_frac": float("nan")}
    lat = np.asarray([r.latency_s for r in admitted])
    return {
        "n": len(admitted),
        "n_rejected": len(completed) - len(admitted),
        "p50_s": float(np.percentile(lat, 50)),
        "p99_s": float(np.percentile(lat, 99)),
        "slo_met_frac": float(np.mean([r.met_slo for r in admitted])),
    }


class ServingEngine:
    def __init__(self, cfg: TrustIRConfig, evaluate_chunk: Callable,
                 sim_clock: Optional[SimClock] = None,
                 sched_cfg: Optional[SchedulerConfig] = None,
                 kv_pool=None, request_ids=None,
                 drain_mode: Optional[str] = None,
                 evaluate_batch: Optional[Callable] = None,
                 fused_max_evals: Optional[int] = None,
                 retriever=None,
                 feature_sharding=None, device=None):
        """``drain_mode`` (default ``cfg.drain_mode``) selects the
        micro-batch executor: ``"host"`` is the chunked wall-clock-
        deadline path (paper figures), ``"fused"`` runs one device
        step per batch (``core.fused_shedder``). Both take an evaluator
        in the port's protocol (a dict of tensors on the engine's device
        in, a tensor of scores out); ``evaluate_batch`` overrides
        ``evaluate_chunk`` for the fused step. ``fused_max_evals`` caps
        the fused evaluator batch width (default: the full padded batch
        — always tier-exact; a smaller cap demotes overflow evals to the
        prior).

        ``retriever`` (a ``retrieval.CorpusSearcher`` or anything with
        ``search(query, n) -> SearchResults``) enables
        :meth:`enqueue_query` — raw query strings in, candidate sets
        out — with the retrieve stage's measured latency folded into
        the LoadMonitor under the WarmupGate rule.

        ``feature_sharding`` (mesh-sharded evaluator windows) is not
        ported: passing it raises ``NotImplementedError``.

        ``device`` (``cuda`` unless named) is where the shedder's state
        and the fused step live."""
        if feature_sharding is not None:
            raise NotImplementedError(
                "feature_sharding (mesh-sharded evaluator windows) is not "
                "ported yet; see ROADMAP.md, Queue 1, item 6")
        self.cfg = cfg
        self.device = resolve(device)
        self.monitor = LoadMonitor(cfg)
        mode = drain_mode or getattr(cfg, "drain_mode", "host")
        if mode not in ("host", "fused"):
            raise ValueError(f"unknown drain_mode {mode!r}")
        self.drain_mode = mode
        if mode == "fused":
            shedder = FusedLoadShedder(
                cfg, evaluate_batch or evaluate_chunk,
                monitor=self.monitor, sim_clock=sim_clock,
                max_evals=fused_max_evals, device=self.device)
        else:
            shedder = LoadShedder(cfg, evaluate_chunk,
                                  monitor=self.monitor,
                                  sim_clock=sim_clock, device=self.device)
        self.sim_clock = sim_clock
        self.scheduler = Scheduler(cfg, shedder,
                                   sched_cfg or SchedulerConfig(),
                                   now=self._now, kv_pool=kv_pool)
        # ``request_ids`` lets a ClusterCoordinator share one id source
        # across replica engines so request ids stay fleet-unique.
        self._ids = request_ids if request_ids is not None \
            else itertools.count()
        self.completed: List[Response] = []
        # Retrieval front end (retrieval): optional — engines fed
        # pre-retrieved candidate sets never touch it.
        self.retriever = retriever
        self._retrieval_gate = WarmupGate()

    # The scheduler executes whatever shedder the engine carries, so the
    # two references stay one (baseline drivers swap in ProcessAll/RLSEDA
    # by assigning ``engine.shedder``).
    @property
    def shedder(self) -> LoadShedder:
        return self.scheduler.shedder

    @shedder.setter
    def shedder(self, s: LoadShedder) -> None:
        self.scheduler.shedder = s

    def _now(self) -> float:
        return (self.sim_clock.now() if self.sim_clock
                else time.monotonic())

    # -- scheduled API ------------------------------------------------------
    def enqueue(self, item_keys: np.ndarray, buckets: np.ndarray,
                features: Dict[str, np.ndarray],
                slo_s: Optional[float] = None,
                priority: Priority = Priority.NORMAL,
                tenant: str = "default",
                needs_kv_slot: bool = False) -> int:
        """Admit a request into the scheduler; returns its request id.

        A rejected request completes immediately (its explicit response
        lands in ``self.completed``); an admitted one completes on a
        subsequent ``drain``. ``needs_kv_slot`` marks LM decode requests
        that must claim a ``KVCachePool`` slot before they can be
        batched.
        """
        rid = next(self._ids)
        # NOTE: an explicit slo_s=0.0 is honored (`or` would silently
        # replace it with the config default).
        req = Request(rid, item_keys, buckets, features,
                      arrival_s=self._now(),
                      slo_s=(self.cfg.overload_deadline_s
                             if slo_s is None else slo_s),
                      needs_kv_slot=needs_kv_slot)
        rejection = self.scheduler.submit(req, priority=priority,
                                          tenant=tenant)
        if rejection is not None:
            self.completed.append(rejection)
        return rid

    def note_retrieval(self, n_items: int, elapsed_s: float,
                       features: Dict[str, np.ndarray]) -> None:
        """Fold a retrieve stage's measured latency into the
        LoadMonitor, under the same WarmupGate rule the drain executors
        use: the first sight of a (quantized item count, feature
        shapes) signature is warmup — its elapsed time measures the
        dense index build and first launches, not retrieval — and is
        skipped. Wall
        clocks only: a simulated timeline advances by item rate, and
        mixing real seconds into it would corrupt the EWMA."""
        if self.sim_clock is not None or n_items <= 0:
            return
        # Quantize the count the way the device path does (top-k pads
        # to a power of two), so one warmup skip covers its bucket.
        q = 1 << max(int(n_items) - 1, 0).bit_length()
        sig = ("retrieve", q) + WarmupGate.signature(0, features)[1:]
        if self._retrieval_gate.warm(sig):
            self.monitor.observe(n_items, elapsed_s)

    def enqueue_query(self, query: str, n_results: Optional[int] = None,
                      slo_s: Optional[float] = None,
                      priority: Priority = Priority.NORMAL,
                      tenant: str = "default",
                      needs_kv_slot: bool = False) -> int:
        """The full front half: parse -> retrieve -> admit. Takes a raw
        query string, retrieves its BM25 top-k candidate set from the
        attached ``retriever``, and enqueues it like any pre-retrieved
        request. Retrieval latency feeds the LoadMonitor (see
        :meth:`note_retrieval`) so Ucapacity reflects the whole
        pipeline, not just the evaluator."""
        if self.retriever is None:
            raise RuntimeError(
                "enqueue_query needs a retriever (pass retriever= or "
                "use enqueue with a pre-retrieved candidate set)")
        k = (n_results if n_results is not None
             else getattr(self.cfg, "retrieve_top_k", 64))
        t0 = time.perf_counter()
        res = self.retriever.search(query, k)
        elapsed = time.perf_counter() - t0
        feats = dict(res.features)
        feats["trust"] = res.exact_trust    # oracle evaluators may use it
        self.note_retrieval(len(res.url_ids), elapsed, feats)
        return self.enqueue(res.url_ids, res.buckets, feats,
                            slo_s=slo_s, priority=priority,
                            tenant=tenant, needs_kv_slot=needs_kv_slot)

    def drain(self, max_batches: Optional[int] = None,
              flush: Optional[bool] = None) -> List[Response]:
        """Drain queued micro-batches; returns the responses produced.

        ``flush=False`` (honored at ``cfg.pipeline_depth >= 2`` with an
        async executor) leaves up to depth batches in flight on return
        — the serving-loop pattern: device compute overlaps the next
        iteration's enqueues and batch formation, and the responses
        surface from a later ``drain``/``poll``/``flush``."""
        out = self.scheduler.drain(max_batches, flush=flush)
        self.completed.extend(out)
        return out

    def poll(self) -> List[Response]:
        """Fold back every in-flight batch that already completed,
        without blocking on the ones still computing."""
        out = self.scheduler.poll()
        self.completed.extend(out)
        return out

    def flush(self) -> List[Response]:
        """Block until every in-flight batch has landed."""
        out = self.scheduler.flush()
        self.completed.extend(out)
        return out

    # -- compat shim (original synchronous API) -----------------------------
    def submit(self, item_keys: np.ndarray, buckets: np.ndarray,
               features: Dict[str, np.ndarray],
               slo_s: Optional[float] = None,
               priority: Priority = Priority.NORMAL,
               tenant: str = "default") -> Response:
        """Enqueue + drain; returns this request's response."""
        rid = self.enqueue(item_keys, buckets, features, slo_s=slo_s,
                           priority=priority, tenant=tenant)
        self.drain()
        for resp in reversed(self.completed):
            if resp.request_id == rid:
                return resp
        raise RuntimeError(            # pragma: no cover — no-drop invariant
            f"request {rid} produced no response")

    # -- observability ------------------------------------------------------
    def slo_stats(self) -> Dict[str, float]:
        return slo_stats_of(self.completed)

    def scheduler_stats(self) -> Dict:
        return self.scheduler.stats.as_dict()
