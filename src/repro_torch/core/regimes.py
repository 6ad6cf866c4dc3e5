"""Load-regime classification (paper §4).

  Normal:      Uload <= Ucapacity
  Heavy:       Ucapacity < Uload <= Ucapacity + Uthreshold
  Very Heavy:  Uload > Ucapacity + Uthreshold
"""
from __future__ import annotations

import enum


class Regime(enum.IntEnum):
    NORMAL = 0
    HEAVY = 1
    VERY_HEAVY = 2


def classify(uload: int, u_capacity: int, u_threshold: int) -> Regime:
    """Host-side classification."""
    if uload <= u_capacity:
        return Regime.NORMAL
    if uload <= u_capacity + u_threshold:
        return Regime.HEAVY
    return Regime.VERY_HEAVY
