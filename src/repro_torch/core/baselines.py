"""Comparison systems from the paper's §2/§6.

Counterpart of ``repro.core.baselines``:

* ``ProcessAll`` — the "Existing System" [1]: every URL is fully trust-
  evaluated regardless of load; response time grows linearly with Uload.
* ``RLSEDA`` — Effective Deadline-Aware Random Load Shedding [2]: when
  Uload exceeds capacity, excess tuples are randomly *shed without
  processing* (the limitation the paper's algorithm removes — shed items
  get NO trust value and vanish from the results).

Both evaluate through ``LoadShedder._eval`` (padded chunks on the
shedder's device), whose features are numpy: ``to_host`` copies tensor
leaves back first.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.regimes import classify
from repro_torch.core.shedder import (LoadShedder, ShedResult, TIER_EVAL,
                                      TIER_INVALID, to_host)


class ProcessAll(LoadShedder):
    """Existing System [1]: no shedding — evaluate everything."""

    def process(self, item_keys: np.ndarray, buckets: np.ndarray,
                features, n_valid: Optional[int] = None) -> ShedResult:
        t_start = self._now()
        n_total = len(item_keys)
        n = n_total if n_valid is None else int(n_valid)
        ucap, uthr = self.monitor.parameters()
        features = to_host(features)                 # _eval precondition
        trust = np.zeros((n_total,), np.float32)
        tier = np.full((n_total,), TIER_INVALID, np.int32)
        trust[:n] = self._eval(features, np.arange(n))
        tier[:n] = TIER_EVAL
        rt = self._now() - t_start
        return ShedResult(trust=trust, tier=tier,
                          regime=classify(n, ucap, uthr),
                          response_time_s=rt,
                          deadline_eff_s=self.cfg.deadline_s,
                          n_evaluated=n, n_cached=0, n_prior=0, uload=n)


class RLSEDA(LoadShedder):
    """RLS-EDA [2]: random shedding of excess load, shed items dropped.
    The keep set is ``np.random.default_rng(seed).permutation``, as in
    the reference, so both packages keep the same items."""

    def __init__(self, *args, seed: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self._rng = np.random.default_rng(seed)

    def process(self, item_keys: np.ndarray, buckets: np.ndarray,
                features, n_valid: Optional[int] = None) -> ShedResult:
        t_start = self._now()
        n_total = len(item_keys)
        n = n_total if n_valid is None else int(n_valid)
        ucap, uthr = self.monitor.parameters()
        budget = min(n, ucap + uthr)
        keep = np.sort(self._rng.permutation(n)[:budget])
        features = to_host(features)                 # _eval precondition
        trust = np.zeros((n_total,), np.float32)
        tier = np.full((n_total,), TIER_INVALID, np.int32)  # shed == dropped
        if len(keep):
            trust[keep] = self._eval(features, keep)
            tier[keep] = TIER_EVAL
        rt = self._now() - t_start
        return ShedResult(trust=trust, tier=tier,
                          regime=classify(n, ucap, uthr),
                          response_time_s=rt,
                          deadline_eff_s=self.cfg.overload_deadline_s,
                          n_evaluated=int(len(keep)), n_cached=0,
                          n_prior=0, uload=n)
