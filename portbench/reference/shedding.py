"""Plain NumPy reference of the paper's load shedder (§4-5) and its
state: the Trust DB, the average-trust prior and the three-tier ladder.

``Replay`` walks the system's finished micro-batches in order. For each
it works out, from its own Trust DB and prior and the step's
load-monitor inputs (Ucapacity, Uthreshold, the budget and the
evaluator's row count), which tier each item should get, what a
Trust-DB hit should read and what the prior is; then it folds the
batch's evaluated trust into its own state, as the paper's system does.

The Trust DB is set-associative: set = hash32(key) mod n_sets; a lookup
reads the first way holding the key; an insert takes, against the state
before the batch, the way holding the key, else an empty way, else the
oldest, and of several writes to one entry in a batch the latest item's
is kept. Key 0 means empty.

The load-monitor inputs come from the system's wall-clock rate estimate
and are taken as the system reports them: the reference re-derives the
budget from them but not them from the clock.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

TIER_EVAL, TIER_CACHED, TIER_PRIOR, TIER_INVALID = 0, 1, 2, 3
_M32 = np.uint64(0xFFFFFFFF)


def hash32(keys: np.ndarray) -> np.ndarray:
    """The Trust DB's avalanche hash of uint32 keys (uint64 results)."""
    x = np.asarray(keys).astype(np.uint64) & _M32
    x = ((x ^ (x >> np.uint64(16))) * np.uint64(0x7FEB352D)) & _M32
    x = ((x ^ (x >> np.uint64(15))) * np.uint64(0x846CA68B)) & _M32
    return x ^ (x >> np.uint64(16))


def deadline_budget(n: int, ucap: int, uthr: int, cfg: Dict) -> int:
    """floor(rate * effective deadline): the paper's regime ladder with
    the Very-Heavy extension factor in float32."""
    if n <= ucap:
        eff = cfg["deadline_s"]
    elif n <= ucap + uthr:
        eff = cfg["overload_deadline_s"]
    else:
        frac = np.clip(np.float32(n - ucap - uthr)
                       / np.maximum(np.float32(n), np.float32(1.0)),
                       np.float32(0.0), np.float32(1.0))
        ext = np.float32(1.0) + np.float32(cfg["very_heavy_weight"]) * frac
        eff = cfg["overload_deadline_s"] * float(ext)
    return int(math.floor(ucap / cfg["deadline_s"] * eff))


class Replay:
    def __init__(self, cfg: Dict):
        self.cfg = cfg
        self.n_sets, self.n_ways = cfg["cache_slots"], cfg["cache_ways"]
        self.keys = np.zeros((self.n_ways, self.n_sets), np.uint32)
        self.vals = np.zeros((self.n_ways, self.n_sets), np.float32)
        self.age = np.zeros((self.n_ways, self.n_sets), np.int64)
        self.clock = 0
        self.prior = np.float32(cfg["prior_init"])
        self.priors: List[np.float32] = [self.prior]   # after each batch

    def lookup(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        s = (hash32(keys) % np.uint64(self.n_sets)).astype(np.int64)
        match = self.keys[:, s].T == keys[:, None]           # (N, ways)
        hit = match.any(1) & (keys != 0)
        way = match.argmax(1)
        return np.where(hit, self.vals[way, s], 0.0).astype(np.float32), hit

    def tiers(self, keys: np.ndarray, n_valid: int, ucap: int,
              budget: int, max_evals: int):
        """(tier, expected cached value) of one batch, before its
        fold-back."""
        n = len(keys)
        valid = np.arange(n) < n_valid
        cval, hit = self.lookup(keys)
        hit &= valid
        in_normal = valid & (np.arange(n) < ucap)
        tier = np.where(hit, TIER_CACHED, TIER_PRIOR)
        tier = np.where(in_normal & ~hit, TIER_EVAL, tier)
        dq = valid & ~in_normal & ~hit
        rank = np.cumsum(dq) - dq
        left = max(budget - int((in_normal & ~hit).sum()), 0)
        tier = np.where(dq & (rank < left), TIER_EVAL, tier)
        ev = tier == TIER_EVAL
        tier = np.where(ev & (np.cumsum(ev) - ev >= max_evals), TIER_PRIOR,
                        tier)
        tier = np.where(valid, tier, TIER_INVALID)
        return tier.astype(np.int32), cval

    def fold(self, keys: np.ndarray, trust: np.ndarray,
             evald: np.ndarray) -> None:
        """Insert the batch's evaluated items and update the prior."""
        s = (hash32(keys) % np.uint64(self.n_sets)).astype(np.int64)
        ck, ca = self.keys[:, s].T, self.age[:, s].T
        prio = (ck == keys[:, None]) * (1 << 30) + (ck == 0) * (1 << 20) - ca
        way = prio.argmax(1)
        self.clock += 1
        for i in np.flatnonzero(evald & (keys != 0)):   # latest write wins
            self.keys[way[i], s[i]] = keys[i]
            self.vals[way[i], s[i]] = trust[i]
            self.age[way[i], s[i]] = self.clock
        cnt = int(evald.sum())
        if cnt:
            mean = np.float32(trust[evald].astype(np.float32).sum()
                              / np.float32(cnt))
            a = np.float32(self.cfg["prior_ewma"])
            self.prior = np.float32((np.float32(1.0) - a) * self.prior
                                    + a * mean)
        self.priors.append(self.prior)


# How far a prior may sit from the replayed one before it counts as
# wrong: the two sum each batch's trust in float32 in different orders,
# and the EWMA keeps up to 1 / prior_ewma = 20 batches' rounding; 1e-4
# is some 400 float32 ulps at the trust scale's midpoint, and a prior
# that missed or doubled a batch moves by its share of the batch mean's
# distance from it, orders of magnitude more.
PRIOR_ATOL = 1e-4


def check_batches(cfg: Dict, steps: List, batches: List[Dict]) -> Dict:
    """Replay every finished batch; count what disagrees. Returns the
    counts, the widest prior gap, and the replay (its prior after each
    batch answers the admission's rejections)."""
    rp = Replay(cfg)
    out = {"tier_mismatch": 0, "budget_mismatch": 0, "cached_mismatch": 0,
           "prior_mismatch": 0, "prior_gap": 0.0}
    if len(steps) != len(batches):
        out["tier_mismatch"] += abs(len(steps) - len(batches)) + 1
    for (ucap, uthr, budget, max_evals), b in zip(steps, batches):
        keys, n = b["keys"], b["n_valid"]
        if deadline_budget(n, ucap, uthr, cfg) != budget:
            out["budget_mismatch"] += 1
        tier, cval = rp.tiers(keys, n, ucap, budget, max_evals)
        got_t, got = b["tier"], b["trust"]
        out["tier_mismatch"] += int((tier != got_t).sum())
        c = (tier == TIER_CACHED) & (got_t == TIER_CACHED)
        out["cached_mismatch"] += int((got[c] != cval[c]).sum())
        p = (tier == TIER_PRIOR) & (got_t == TIER_PRIOR)
        if p.any():
            gap = float(np.abs(got[p] - rp.prior).max())
            out["prior_gap"] = max(out["prior_gap"], gap)
            out["prior_mismatch"] += int(
                (np.abs(got[p] - rp.prior) > PRIOR_ATOL).sum())
        rp.fold(keys, got, got_t == TIER_EVAL)
    out["replay"] = rp
    return out
