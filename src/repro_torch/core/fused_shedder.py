"""Device-resident fused drain: one device step per micro-batch.

Counterpart of ``repro.core.fused_shedder``. ``LoadShedder.process`` is
the host chunk loop with a real (or simulated) clock and one device
round-trip per chunk; ``FusedLoadShedder`` runs the whole shedding
decision as ONE stream of device work per micro-batch:

    shed_partition (CUDA kernel: Trust-DB probe + tier scans, compacted
                    eval ranks)
      -> eval_indices_from_rank   O(N) scatter, no argsort
      -> static-shape gather      features picked once, on device
      -> evaluator forward        one batched call (flash_attention
                                  kernel inside), no chunk loop
      -> scatter + combine        trust per tier
      -> TC.insert / AT.update    cache + prior fold-back

``stage`` enqueues the host->device copies, ``dispatch_staged`` launches
the step on the current stream without waiting for it, and
``process_async`` composes the two into a :class:`PendingShed` whose
tensors stay on the device until ``.result()``, the only sync point.
``scheduling.executor.DrainExecutor`` sequences these handles in a
depth-k window. With a ``SimClock`` the step resolves eagerly.

The evaluator runs on ``max_evals = n_total`` rows whatever the eval
count is, so every step has one shape and the host never waits for the
count.

Tier parity: ``budget_total = floor(rate * deadline_eff)`` comes from
the same Load-Monitor parameters and deadline controller as
``LoadShedder.process``, and the kernel nets out normal-queue
evaluations itself (``budget_is_total=True``). The host executor grants
drop-queue evaluations at chunk granularity against a running clock;
with chunk-aligned budgets the two paths agree exactly.

Cache and prior updates are functional (a new state per step, as in the
reference without donation): a state a caller holds by reference is
never written.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.configs.base import TrustIRConfig
from repro_torch.core import average_trust as AT
from repro_torch.core import trust_cache as TC
from repro_torch.core.deadline import effective_deadline
from repro_torch.core.load_monitor import LoadMonitor, WarmupGate
from repro_torch.core.regimes import classify
from repro_torch.core.shedder import (LoadShedder, ShedResult, SimClock,
                                      TIER_CACHED, TIER_EVAL, TIER_PRIOR,
                                      combine_trust, eval_indices_from_rank,
                                      keys_as_int32)
from repro_torch.distribution.placement import device_put, full_tensor
from repro_torch.kernels.shed_partition import shed_partition
from repro_torch.tracing import span, traced


class StagedBatch:
    """One micro-batch after its host->device transfer."""

    __slots__ = ("keys_t", "buckets_t", "valid_t", "feats_t", "n",
                 "n_total", "t_start", "wall_start", "item_keys")

    def __init__(self, keys_t, buckets_t, valid_t, feats_t, n: int,
                 n_total: int, t_start: float, wall_start: float,
                 item_keys: Optional[np.ndarray] = None):
        self.keys_t = keys_t
        self.buckets_t = buckets_t
        self.valid_t = valid_t
        self.feats_t = feats_t
        self.n = n
        self.n_total = n_total
        self.t_start = t_start
        self.wall_start = wall_start
        self.item_keys = item_keys


class PendingShed:
    """Handle to an in-flight fused shedding step.

    ``trust``/``tier`` stay on the device (possibly still computing) until
    :meth:`result` copies them back, charges the clock/monitor, and
    builds the :class:`ShedResult`. On CUDA, completion is a
    ``torch.cuda.Event`` recorded after the step; on the CPU the step is
    complete when the handle exists. While a profiler runs
    (``tracing.enabled``) it is a timing event and ``start`` one recorded
    before the step: their interval is :meth:`device_ms`. ``max_evals``
    is the evaluator's row count of the step.
    """

    def __init__(self, shedder: "FusedLoadShedder", trust, tier,
                 n_evald, *, t_start: float, wall_start: float,
                 n: int, regime, deadline_eff: float,
                 skip_observe: bool = False,
                 done: Optional[torch.cuda.Event] = None,
                 item_keys: Optional[np.ndarray] = None,
                 start: Optional[torch.cuda.Event] = None,
                 max_evals: Optional[int] = None):
        self._shedder = shedder
        self._trust = trust
        self._tier = tier
        self._n_evald = n_evald
        self._t_start = t_start
        self._wall_start = wall_start
        self._n = n
        self._regime = regime
        self._deadline_eff = deadline_eff
        self._skip_observe = skip_observe
        self._done = done
        self._start = start
        self.max_evals = max_evals
        # host keys of the batch, for the shedder's on_shed tap
        self._item_keys = item_keys
        self._result: Optional[ShedResult] = None
        # Wall time at which the step was FIRST observed complete
        # (stamped by is_ready): the honest end of the throughput window
        # when finalize happens long after completion.
        self._wall_ready: Optional[float] = None

    def result(self) -> ShedResult:
        if self._result is None:
            self._result = self._shedder._finish(self)
        return self._result

    def is_ready(self) -> bool:
        """True when the device step has completed (materializing would
        not block)."""
        if self._result is not None:
            return True
        done = self._done is None or self._done.query()
        if done and self._wall_ready is None:
            self._wall_ready = time.monotonic()
        return done

    @property
    def wall_ready(self) -> Optional[float]:
        """When the host first saw the step complete (None before)."""
        return self._wall_ready

    def device_ms(self) -> Optional[float]:
        """The step's time on the device in ms, once it has completed
        (None off CUDA or with no profiler running at its launch)."""
        if self._start is None or self._done is None:
            return None
        return self._start.elapsed_time(self._done)


class FusedLoadShedder(LoadShedder):
    """Drop-in ``LoadShedder`` whose ``process`` runs the fused device
    step. ``evaluate_batch``: features dict of tensors (leading dim
    ``max_evals``) -> (max_evals,) scores, on this shedder's device."""

    supports_async = True

    def __init__(self, cfg: TrustIRConfig, evaluate_batch: Callable,
                 monitor: Optional[LoadMonitor] = None,
                 cache_state: Optional[Dict] = None,
                 prior_state: Optional[Dict] = None,
                 sim_clock: Optional[SimClock] = None,
                 max_evals: Optional[int] = None,
                 device=None, adaptive=None, feature_sharding=None):
        """``feature_sharding`` (optional) places staged features for a
        mesh-sharded evaluator: a dict of
        ``distribution.placement.NamedSharding`` matching the features,
        or a callable ``features -> that dict`` (what
        ``serving.evaluators.make_sharded_evaluator`` returns). ``stage``
        then moves each rank's own piece of each leaf to the device and
        holds it as a DTensor; the step's gather reads the leaves whole
        (on one device that is the staged tensor itself)."""
        super().__init__(cfg, evaluate_batch, monitor=monitor,
                         cache_state=cache_state, prior_state=prior_state,
                         sim_clock=sim_clock, device=device,
                         adaptive=adaptive)
        self.evaluate_batch = evaluate_batch
        self.max_evals = max_evals
        self.feature_sharding = feature_sharding
        # Wall time of the last throughput observation: pipelined
        # batches overlap, so each observation charges only the
        # marginal window since the previous one (see _finish).
        self._last_obs_wall = 0.0

    # -- the fused device step ----------------------------------------------
    @torch.no_grad()
    def _step(self, cache, prior, keys, buckets, valid, features,
              u_capacity: int, u_threshold: int, budget_total: int,
              max_evals: int):
        n = keys.shape[0]
        with span("step.shed_partition"):
            tier, cval, rank = shed_partition(
                keys, valid, cache["keys"], cache["values"],
                u_capacity, u_threshold, budget_total,
                budget_is_total=True)
        with span("step.gather"):
            # Safety on a too-small max_evals: overflow evals fall back
            # to the prior tier (no-drop) instead of silently scoring 0.
            # The default max_evals = batch capacity can never overflow.
            tier = torch.where((rank >= max_evals) & (tier == TIER_EVAL),
                               TIER_PRIOR, tier)
            idx, eval_valid = eval_indices_from_rank(rank, max_evals)
            gidx = idx.clamp(max=n - 1)              # clamp pad slots
            sub = {k: full_tensor(v)[gidx] for k, v in features.items()}
        with span("step.evaluate"):
            scores = self.evaluate_batch(sub).to(torch.float32)
        with span("step.fold_back"):
            # Pad slots scatter into an extra slot n that is sliced off.
            scattered = torch.zeros(n + 1, dtype=torch.float32,
                                    device=keys.device)
            scattered.scatter_(0, idx, torch.where(
                eval_valid, scores, torch.zeros_like(scores)))
            prior_vals = AT.query(prior, buckets)
            trust = combine_trust(tier, scattered[:n], cval, prior_vals)
            evald = tier == TIER_EVAL
            new_cache = TC.insert(cache, keys, trust, evald)
            new_prior = AT.update(prior, buckets, trust, evald,
                                  ewma=self.cfg.prior_ewma)
        return (trust, tier, evald.sum(), new_cache, new_prior)

    # -- stage / dispatch / finish --------------------------------------------
    @traced("shedder.stage")
    def stage(self, item_keys: np.ndarray, buckets: np.ndarray,
              features, n_valid: Optional[int] = None) -> StagedBatch:
        """Front half of the fused step: ONE host->device transfer per
        batch (the host path re-gathers per chunk)."""
        t_start = self._now()
        wall_start = time.monotonic()
        n_total = len(item_keys)
        n = n_total if n_valid is None else int(n_valid)
        valid = np.zeros((n_total,), bool)
        valid[:n] = True
        dev = self.device

        def put(a):
            return torch.as_tensor(a).to(dev, non_blocking=True)

        if self.feature_sharding is None:
            feats = {k: put(v) for k, v in features.items()}
        else:
            sharding = (self.feature_sharding(features)
                        if callable(self.feature_sharding)
                        else self.feature_sharding)
            feats = {k: device_put(v, sharding[k], dev)
                     for k, v in features.items()}
        return StagedBatch(
            keys_t=put(keys_as_int32(item_keys)),
            buckets_t=put(np.asarray(buckets, np.int32)),
            valid_t=put(valid),
            feats_t=feats,
            n=n, n_total=n_total, t_start=t_start, wall_start=wall_start,
            item_keys=np.asarray(item_keys))

    @traced("shedder.dispatch")
    def dispatch_staged(self, staged: StagedBatch) -> PendingShed:
        """Back half: launch the shedding step on staged tensors without
        waiting for it; returns a handle whose ``.result()`` materializes
        the :class:`ShedResult`. With a ``SimClock`` the handle resolves
        eagerly (deterministic sequential timeline)."""
        start = None
        if staged.keys_t.is_cuda and tracing.enabled():
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(staged.keys_t.device))
        n, n_total = staged.n, staged.n_total
        ucap, uthr = self.monitor.parameters()
        regime = classify(n, ucap, uthr)
        deadline_eff = effective_deadline(
            n, ucap, uthr, deadline_s=self.cfg.deadline_s,
            overload_deadline_s=self.cfg.overload_deadline_s,
            weight=self._vh_weight())
        # Same budget math as the host path: rate * effective deadline.
        budget_total = int(np.floor(
            ucap / self.cfg.deadline_s * deadline_eff))
        max_evals = self.max_evals or n_total

        # First sight of a work shape is warmup — the SAME exclusion
        # rule the host chunk loop applies (WarmupGate).
        warm = self._warmup.warm(
            WarmupGate.signature(n_total, staged.feats_t) + (max_evals,))
        trust, tier, n_evald, self.cache, self.prior = self._step(
            self.cache, self.prior, staged.keys_t, staged.buckets_t,
            staged.valid_t, staged.feats_t, ucap, uthr, budget_total,
            max_evals)
        done = None
        if trust.is_cuda:
            done = torch.cuda.Event(enable_timing=start is not None)
            done.record(torch.cuda.current_stream(trust.device))
        pending = PendingShed(self, trust, tier, n_evald,
                              t_start=staged.t_start,
                              wall_start=staged.wall_start,
                              n=n, regime=regime,
                              deadline_eff=deadline_eff,
                              skip_observe=not warm, done=done,
                              item_keys=staged.item_keys, start=start,
                              max_evals=max_evals)
        if self.sim_clock is not None:
            pending.result()
        return pending

    def process_async(self, item_keys: np.ndarray, buckets: np.ndarray,
                      features, n_valid: Optional[int] = None
                      ) -> PendingShed:
        """Stage + dispatch in one call (the DrainExecutor's entry)."""
        return self.dispatch_staged(
            self.stage(item_keys, buckets, features, n_valid=n_valid))

    def _finish(self, p: PendingShed) -> ShedResult:
        t_entry = time.monotonic()
        ready_at_entry = p.is_ready()   # stamps _wall_ready if so
        with span("shedder.sync"):
            trust = p._trust.cpu().numpy()          # sync point
            tier = p._tier.cpu().numpy()
            n_evald = int(p._n_evald)
        wall_end = time.monotonic()
        if self.sim_clock is not None:
            self.sim_clock.charge_probe()
            self.sim_clock.charge_eval(n_evald)
        elif n_evald and not p._skip_observe:
            # Marginal service window: from the LATER of this batch's
            # dispatch and the previous observation, to the batch's
            # completion (earliest is_ready stamp, or the sync just
            # paid when the step was still running; a batch that
            # finished unobserved falls back to the entry time, an
            # overestimate LoadMonitor's rate clamp bounds).
            if p._wall_ready is not None \
                    and p._wall_ready < t_entry - 1e-6:
                completed = p._wall_ready       # stamped earlier
            elif not ready_at_entry:
                completed = wall_end            # we blocked: honest end
            else:
                completed = t_entry             # bounded overestimate
            base = max(p._wall_start, self._last_obs_wall)
            if completed > base:
                self.monitor.observe(n_evald, completed - base)
                self._last_obs_wall = completed
        if p._wall_ready is None:
            p._wall_ready = wall_end      # the blocking copy's end
        rt = self._now() - p._t_start
        result = ShedResult(
            trust=trust, tier=tier, regime=p._regime,
            response_time_s=rt, deadline_eff_s=p._deadline_eff,
            n_evaluated=n_evald,
            n_cached=int((tier == TIER_CACHED).sum()),
            n_prior=int((tier == TIER_PRIOR).sum()),
            uload=p._n)
        if self.adaptive is not None:
            self.adaptive.observe(result)
        if self.on_shed is not None and p._item_keys is not None:
            self.on_shed(p._item_keys, result)
        return result

    # -- synchronous API (drop-in for LoadShedder.process) --------------------
    def process(self, item_keys: np.ndarray, buckets: np.ndarray,
                features, n_valid: Optional[int] = None) -> ShedResult:
        return self.process_async(item_keys, buckets, features,
                                  n_valid=n_valid).result()
