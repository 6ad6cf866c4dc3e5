"""Arithmetic shared by the per-layer metrics' readers
(``metrics/<name>.py``). Each reader takes the run's observations (see
``harness.observations``) and its own data file, and returns the number,
or None when the run has nothing for it to read: never 0 for a share of
a roofline or of a peak.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

from portbench import work


def p_nearest(values, q: float) -> Optional[float]:
    """The q-quantile by nearest rank; None for no values or an infinite
    one (a request never answered)."""
    if not values:
        return None
    v = sorted(values)[max(0, math.ceil(q * len(values)) - 1)]
    return None if math.isinf(v) else v


def tier_share(obs: Dict, tier: int) -> Optional[float]:
    """% of the window's admitted items answered from ``tier``."""
    n = sum(obs["admitted_tiers"].values())
    return 100.0 * obs["admitted_tiers"].get(tier, 0) / n if n else None


def evaluator_mfu(obs: Dict) -> Optional[float]:
    """% of the chip's bf16 peak that the window's fresh evaluations
    needed: each evaluated item priced at one document's operations."""
    if not obs["eval_items"]:
        return None
    flops = work.doc_flops(obs["model"], obs["doc_tokens"]) \
        * obs["eval_items"]
    return 100.0 * flops / (obs["seconds"]
                            * work.PEAKS["flops_per_s"]["bfloat16"])


def kernel_roofline(obs: Dict, kernels) -> Optional[float]:
    """% of the traced time of the named attention kernels that their
    bound needs: launches x the bound of one evaluator call's attention
    (rows x S, read q, k, v once, write o once) over the kernels' time."""
    tr = obs["trace"]
    if not tr:
        return None
    t, n = 0.0, 0
    for name, (sec, count) in tr["kernels"].items():
        if any(k in name for k in kernels):
            t, n = t + sec, n + count
    if not n or t <= 0:
        return None
    bound = work.bound_s(work.attention_work(obs["model"], obs["eval_rows"],
                                             obs["doc_tokens"]))
    return 100.0 * n * bound / t


def idle_share(obs: Dict) -> Optional[float]:
    """% of the traced window in which no kernel ran on the device."""
    tr = obs["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (tr["window_s"] - tr["busy_s"]) / tr["window_s"]
