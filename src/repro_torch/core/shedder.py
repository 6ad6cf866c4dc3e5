"""The Optimal Load Shedding Algorithm (paper §5), on torch tensors.

Counterpart of ``repro.core.shedder``. Paper semantics preserved:
  * three regimes (Normal / Heavy / Very Heavy) from (Uload, Ucapacity,
    Uthreshold),
  * Normal Queue = first Ucapacity URLs in arrival order — Trust-DB hits
    assigned from cache, the rest fully evaluated (no deadline check),
  * Drop Queue = the remainder — cache hits first, then evaluation until
    the (possibly extended) deadline, then the average-trust prior,
  * Very Heavy extends the deadline per §4.3 before running the Heavy
    procedure,
  * NO item is ever dropped: every URL leaves with a trust value.

``shed_plan`` is the tensor form of the tier assignment (the oracle of
the ``shed_partition`` kernel); ``LoadShedder.process`` is the host loop
at chunk granularity with a real or simulated clock — the host oracle
the fused drain (``core.fused_shedder``) is held against.

Evaluators take a dict of tensors on the shedder's device (leading dim =
items) and return a (items,) tensor of scores.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import TrustIRConfig
from repro_torch.core import average_trust as AT
from repro_torch.core import trust_cache as TC
from repro_torch.core.deadline import effective_deadline, extension_factor
from repro_torch.core.load_monitor import LoadMonitor, WarmupGate
from repro_torch.core.regimes import Regime, classify
from repro_torch.device import resolve

# Tier codes (answer ladder)
TIER_EVAL = 0      # full trust evaluation (model forward)
TIER_CACHED = 1    # Trust DB hit
TIER_PRIOR = 2     # average-trustworthiness fallback
TIER_INVALID = 3   # padding


def keys_as_int32(item_keys) -> np.ndarray:
    """uint32 item keys as the int32 bit patterns the port stores."""
    return np.ascontiguousarray(item_keys, dtype=np.uint32).view(np.int32)


# ---------------------------------------------------------------------------
# Tensor planning
# ---------------------------------------------------------------------------

def shed_plan(valid: torch.Tensor, cache_hit: torch.Tensor,
              u_capacity: int, u_threshold: int, *,
              deadline_s: float, overload_deadline_s: float,
              very_heavy_weight: float) -> Dict:
    """Assign a tier to every item of a padded batch.

    valid: (N,) bool arrival-ordered validity mask; cache_hit: (N,) bool.
    Returns ``tier`` (N,) int32 plus the host scalars ``regime``,
    ``uload``, ``deadline_eff``, ``eval_budget_dq`` and
    ``n_normal_evals``. Reads Uload back to the host (an oracle, not
    the serving path).
    """
    valid = valid.to(torch.bool)
    cache_hit = cache_hit & valid
    uload = int(valid.sum())
    regime = classify(uload, u_capacity, u_threshold)
    # float32 effective deadline, as the reference's traced twin
    # computes it
    if regime == Regime.NORMAL:
        deadline_eff = np.float32(deadline_s)
    else:
        f = (extension_factor(uload, u_capacity, u_threshold,
                              very_heavy_weight)
             if regime == Regime.VERY_HEAVY else np.float32(1.0))
        deadline_eff = np.float32(overload_deadline_s) * f

    # Arrival position among valid items.
    pos = torch.cumsum(valid.to(torch.int32), 0) - 1
    in_normal = valid & (pos < u_capacity)

    # Normal queue: cache hit -> CACHED else EVAL (no deadline check, §5.2).
    # Drop queue: cache hit -> CACHED (§5.3 first loop).
    tier = torch.where(cache_hit, TIER_CACHED, TIER_PRIOR)
    tier = torch.where(in_normal & ~cache_hit, TIER_EVAL, tier)

    # Drop-queue evaluation budget: floor(rate * deadline_eff) minus
    # the normal-queue evaluations (§5.3 second loop), in float32.
    n_normal_evals = int((in_normal & ~cache_hit).sum())
    rate = np.float32(u_capacity) / np.float32(deadline_s)
    budget_total = int(np.floor(rate * deadline_eff))
    budget_dq = max(budget_total - n_normal_evals, 0)

    dq_eval_cand = valid & ~in_normal & ~cache_hit
    dq_rank = torch.cumsum(dq_eval_cand.to(torch.int32), 0) - 1
    tier = torch.where(dq_eval_cand & (dq_rank < budget_dq), TIER_EVAL, tier)
    tier = torch.where(valid, tier, TIER_INVALID)
    return {
        "tier": tier.to(torch.int32),
        "regime": regime,
        "uload": uload,
        "deadline_eff": float(deadline_eff),
        "eval_budget_dq": budget_dq,
        "n_normal_evals": n_normal_evals,
    }


def eval_indices_from_rank(eval_rank: torch.Tensor, max_evals: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(N) gather-index compaction from the ``shed_partition`` kernel's
    ``eval_rank`` output (arrival-ordered rank of each EVAL item, -1
    otherwise).

    Returns (idx (max_evals,) int64, valid (max_evals,) bool). Invalid
    slots hold ``n`` (out of range). Items outside the budget scatter to
    an extra slot ``max_evals`` that is sliced off, which stands in for
    the reference's ``mode="drop"``.
    """
    n = eval_rank.shape[0]
    rank = eval_rank.to(torch.int64)
    in_budget = (rank >= 0) & (rank < max_evals)
    slot = torch.where(in_budget, rank, torch.full_like(rank, max_evals))
    idx = torch.full((max_evals + 1,), n, dtype=torch.int64,
                     device=eval_rank.device)
    idx.scatter_(0, slot, torch.arange(n, device=eval_rank.device))
    idx = idx[:max_evals]
    return idx, idx < n


def combine_trust(tier: torch.Tensor, eval_scores_scattered: torch.Tensor,
                  cached_vals: torch.Tensor,
                  prior_vals: torch.Tensor) -> torch.Tensor:
    """Final per-item trust by tier (answer ladder, §5)."""
    t = torch.where(tier == TIER_EVAL, eval_scores_scattered,
                    torch.where(tier == TIER_CACHED, cached_vals,
                                prior_vals))
    return torch.where(tier == TIER_INVALID, torch.zeros_like(t), t)


# ---------------------------------------------------------------------------
# Host chunked executor (wall-clock or simulated clock)
# ---------------------------------------------------------------------------

@dataclass
class ShedResult:
    trust: np.ndarray                # (N,) final trust for every item
    tier: np.ndarray                 # (N,) tier per item
    regime: Regime
    response_time_s: float           # measured (or simulated) latency
    deadline_eff_s: float
    n_evaluated: int
    n_cached: int
    n_prior: int
    uload: int

    @property
    def no_item_dropped(self) -> bool:
        return bool(np.all(self.tier != TIER_INVALID))


class SimClock:
    """Deterministic clock: evaluation chunks cost chunk/rate seconds."""

    def __init__(self, rate_items_per_s: float, probe_cost_s: float = 0.0):
        self.t = 0.0
        self.rate = rate_items_per_s
        self.probe_cost_s = probe_cost_s

    def now(self) -> float:
        return self.t

    def charge_eval(self, n_items: int) -> None:
        self.t += n_items / self.rate

    def charge_probe(self) -> None:
        self.t += self.probe_cost_s


def to_host(features) -> Dict[str, np.ndarray]:
    """A feature dict with numpy leaves (tensors are copied back)."""
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in features.items()}


class LoadShedder:
    """Host-side Optimal Load Shedding executor (paper §5 procedures).

    evaluate_chunk: Callable[(features chunk dict of tensors)] -> scores;
    chunks are padded to ``cfg.chunk_size`` so every call has one shape.
    The cache and prior live on ``device`` (``cuda`` unless named).
    """

    # The host chunk loop is synchronous: the DrainExecutor runs it
    # eagerly (dispatch + finalize per submit) instead of windowing.
    supports_async = False

    def __init__(self, cfg: TrustIRConfig,
                 evaluate_chunk: Callable,
                 monitor: Optional[LoadMonitor] = None,
                 cache_state: Optional[Dict] = None,
                 prior_state: Optional[Dict] = None,
                 sim_clock: Optional[SimClock] = None,
                 device=None, adaptive=None):
        self.cfg = cfg
        self.device = resolve(device)
        self.evaluate_chunk = evaluate_chunk
        self.monitor = monitor or LoadMonitor(cfg)
        self.cache = (cache_state if cache_state is not None
                      else TC.init(cfg.cache_slots, cfg.cache_ways,
                                   ways_leading=cfg.cache_ways_leading,
                                   device=self.device))
        self.prior = (prior_state if prior_state is not None
                      else AT.init(cfg.prior_buckets, device=self.device))
        self.sim_clock = sim_clock
        # optional AdaptiveWeightController (core.adaptive): closes the
        # loop on the Very-Heavy extension weight (paper §7)
        self.adaptive = adaptive
        # Optional per-shed tap ``on_shed(item_keys, result)`` (a fleet
        # replica records its fresh evaluations here for gossip)
        self.on_shed: Optional[Callable[[np.ndarray, "ShedResult"],
                                        None]] = None
        # Shared warmup exclusion (host and fused paths apply the SAME
        # rule, so their Ucapacity estimates are comparable).
        self._warmup = WarmupGate()

    def _vh_weight(self) -> float:
        return (self.adaptive.weight if self.adaptive is not None
                else self.cfg.very_heavy_weight)

    # -- clock helpers -----------------------------------------------------
    def _now(self) -> float:
        return self.sim_clock.now() if self.sim_clock else time.monotonic()

    def _eval(self, features: Dict[str, np.ndarray],
              idx: np.ndarray) -> np.ndarray:
        """Evaluate items ``idx`` in padded chunks; returns scores.
        ``features`` leaves are numpy (``process`` converts once)."""
        cs = self.cfg.chunk_size
        n = len(idx)
        out = np.zeros((n,), np.float32)
        for s in range(0, n, cs):
            chunk_idx = idx[s:s + cs]
            pad = cs - len(chunk_idx)
            padded = np.concatenate([chunk_idx,
                                     np.zeros((pad,), chunk_idx.dtype)])
            sub = {k: torch.as_tensor(v[padded], device=self.device)
                   for k, v in features.items()}
            warm = self._warmup.warm(WarmupGate.signature(cs, sub))
            t0 = time.monotonic()
            scores = self.evaluate_chunk(sub).to(torch.float32).cpu().numpy()
            if self.sim_clock:
                self.sim_clock.charge_eval(len(chunk_idx))
            elif warm:
                self.monitor.observe(len(chunk_idx),
                                     time.monotonic() - t0)
            out[s:s + len(chunk_idx)] = scores[:len(chunk_idx)]
        return out

    # -- the algorithm (§5.1 Load_Shedder) ----------------------------------
    def process(self, item_keys: np.ndarray, buckets: np.ndarray,
                features, n_valid: Optional[int] = None) -> ShedResult:
        """Shed one (possibly padded) batch.

        ``n_valid`` marks the valid prefix of a padded batch: items past
        it are padding, excluded from Uload, tiered ``TIER_INVALID`` and
        masked out of the Trust-DB / prior fold-back.
        """
        t_start = self._now()
        n_total = len(item_keys)
        n = n_total if n_valid is None else int(n_valid)
        ucap, uthr = self.monitor.parameters()
        regime = classify(n, ucap, uthr)
        deadline_eff = effective_deadline(
            n, ucap, uthr, deadline_s=self.cfg.deadline_s,
            overload_deadline_s=self.cfg.overload_deadline_s,
            weight=self._vh_weight())
        deadline_t = t_start + deadline_eff

        keys_t = torch.from_numpy(keys_as_int32(item_keys)).to(self.device)
        cached_t, hit_t = TC.lookup(self.cache, keys_t)
        if self.sim_clock:
            self.sim_clock.charge_probe()
        cached_vals = cached_t.cpu().numpy()
        hit = hit_t.cpu().numpy()
        features = to_host(features)

        trust = np.zeros((n_total,), np.float32)
        tier = np.full((n_total,), TIER_INVALID, np.int32)
        tier[:n] = TIER_PRIOR

        # ---- Normal Queue (§5.2): first Ucapacity items ----
        n_normal = min(n, ucap)
        nq = np.arange(n_normal)
        nq_hit = nq[hit[:n_normal]]
        nq_eval = nq[~hit[:n_normal]]
        trust[nq_hit] = cached_vals[nq_hit]
        tier[nq_hit] = TIER_CACHED
        if len(nq_eval):
            trust[nq_eval] = self._eval(features, nq_eval)
            tier[nq_eval] = TIER_EVAL

        # ---- Drop Queue (§5.3 / §5.4) ----
        if n > n_normal:
            dq = np.arange(n_normal, n)
            dq_hit = dq[hit[n_normal:n]]
            trust[dq_hit] = cached_vals[dq_hit]
            tier[dq_hit] = TIER_CACHED
            dq_eval_cand = dq[~hit[n_normal:n]]
            # Chunk-granular adaptation of §5.3's per-URL clock check:
            # only start a chunk if its estimated completion still fits
            # within the deadline.
            cs = self.cfg.chunk_size
            rate = (self.sim_clock.rate if self.sim_clock
                    else self.monitor.rate)
            done = 0
            while done < len(dq_eval_cand):
                take = dq_eval_cand[done:done + cs]
                if self._now() + len(take) / rate > deadline_t + 1e-9:
                    break
                trust[take] = self._eval(features, take)
                tier[take] = TIER_EVAL
                done += len(take)
            # rest: average trustworthiness (prior)
            rest = dq_eval_cand[done:]
            if len(rest):
                means = self.prior["mean"].cpu().numpy()
                trust[rest] = means[np.asarray(buckets)[rest] % len(means)]
                tier[rest] = TIER_PRIOR

        # ---- fold results back into Trust DB + prior ----
        evald = tier == TIER_EVAL
        if evald.any():
            trust_t = torch.from_numpy(trust).to(self.device)
            evald_t = torch.from_numpy(evald).to(self.device)
            self.cache = TC.insert(self.cache, keys_t, trust_t, evald_t)
            self.prior = AT.update(
                self.prior,
                torch.as_tensor(np.asarray(buckets), device=self.device),
                trust_t, evald_t, ewma=self.cfg.prior_ewma)

        rt = self._now() - t_start
        result = ShedResult(
            trust=trust, tier=tier, regime=regime,
            response_time_s=rt, deadline_eff_s=deadline_eff,
            n_evaluated=int(evald.sum()),
            n_cached=int((tier == TIER_CACHED).sum()),
            n_prior=int((tier == TIER_PRIOR).sum()),
            uload=n)
        if self.adaptive is not None:
            self.adaptive.observe(result)
        if self.on_shed is not None:
            self.on_shed(np.asarray(item_keys), result)
        return result
