"""Adaptive Very-Heavy deadline control — the paper's stated future work.

Counterpart of ``repro.core.adaptive`` (host logic, copied).

Paper §7: "to handle this very heavy overload condition an adaptive
approach is analyzed to reduce this trade off [between response time and
trustworthiness]". Following the control-theoretic load-shedding line the
paper cites ([3] Tu & Prabhakar ICDE'06, [8] Tu et al. ICDE'07), we close
the loop on the observable quality proxy — the **PRIOR-answer fraction**
(items answered from the average-trust fallback): every PRIOR answer is a
potential fidelity loss, while a larger deadline extension buys
evaluations at a latency cost.

Discrete PI controller on the extension weight w (§4.3):

    err_t = prior_frac_t - target_prior_frac
    w_t   = clip(w_{t-1} + kp * (err_t - err_{t-1}) + ki * err_t,
                 0, w_max)

When overload pushes the prior fraction above target, w grows (longer
extended deadlines, more evaluations); when traffic relaxes, w decays back
so latency is not donated for free. The static paper behaviour is the
kp = ki = 0 fixed point.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.shedder import ShedResult


@dataclass
class AdaptiveWeightController:
    target_prior_frac: float = 0.15
    kp: float = 1.5
    ki: float = 0.6
    w_init: float = 0.5
    w_max: float = 2.0
    ewma: float = 0.4

    _w: float = field(default=None, init=False)          # type: ignore
    _prev_err: float = field(default=0.0, init=False)
    _prior_frac: float = field(default=0.0, init=False)
    n_observations: int = field(default=0, init=False)

    def __post_init__(self):
        self._w = self.w_init

    @property
    def weight(self) -> float:
        return self._w

    @property
    def prior_frac(self) -> float:
        return self._prior_frac

    def observe(self, result: ShedResult) -> float:
        """Fold one request's outcome; returns the updated weight."""
        if result.uload <= 0:
            return self._w
        frac = result.n_prior / result.uload
        self._prior_frac = (self.ewma * frac
                            + (1 - self.ewma) * self._prior_frac)
        err = self._prior_frac - self.target_prior_frac
        self._w = min(self.w_max,
                      max(0.0, self._w + self.kp * (err - self._prev_err)
                          + self.ki * err))
        self._prev_err = err
        self.n_observations += 1
        return self._w
