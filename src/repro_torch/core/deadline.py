"""Deadline controller (paper §4.2–4.3).

Base deadline = the user's optimum response time. Under Heavy load the
system targets the overload response time. Under Very Heavy load the
deadline is extended by a bounded monotone rule:

    overflow_frac = clip((Uload - Ucap - Uthr) / Uload, 0, 1)
    deadline'     = overload_deadline * (1 + w * overflow_frac)

The extension factor is computed in float32, as the reference does, so
the eval budget ``floor(rate * deadline')`` agrees with it exactly.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.regimes import Regime, classify


def extension_factor(uload, u_capacity, u_threshold,
                     weight: float) -> np.float32:
    """Very-Heavy extension factor (>= 1), in float32."""
    uload_f = np.maximum(np.float32(uload), np.float32(1.0))
    overflow = np.float32(uload - u_capacity - u_threshold)
    frac = np.clip(overflow / uload_f, np.float32(0.0), np.float32(1.0))
    return np.float32(1.0) + np.float32(weight) * frac


def effective_deadline(uload: int, u_capacity: int, u_threshold: int, *,
                       deadline_s: float, overload_deadline_s: float,
                       weight: float) -> float:
    """Host-side effective deadline per regime."""
    regime = classify(uload, u_capacity, u_threshold)
    if regime == Regime.NORMAL:
        return deadline_s
    if regime == Regime.HEAVY:
        return overload_deadline_s
    f = float(extension_factor(uload, u_capacity, u_threshold, weight))
    return overload_deadline_s * f
