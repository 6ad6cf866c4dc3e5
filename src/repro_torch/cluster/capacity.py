"""Per-stage service-time samples (the part of ``repro.cluster.capacity``
that adaptive pipeline depth reads).

Counterpart of ``repro.cluster.capacity``, host logic copied:
:class:`StageStats` accumulates ``(n_items, elapsed_s)`` samples per
serving stage and :class:`ServiceTimeModel` holds one accumulator per
stage for one ``(drain_mode, pipeline_depth, batch_items)``
configuration; ``cluster.depth`` reads its queue stage. The taps that
fill it, the fitted rates, the queueing what-if ``predict`` and the
``ForecastPlanner`` belong to the cluster slice of the port.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Optional

import numpy as np


class StageStats:
    """Bounded per-stage accumulator of ``(n_items, elapsed_s)`` samples."""

    __slots__ = ("n", "sum_items", "sum_s", "_elapsed", "max_samples")

    def __init__(self, max_samples: int = 4096):
        self.n = 0
        self.sum_items = 0.0
        self.sum_s = 0.0
        self._elapsed: Deque[float] = deque(maxlen=max_samples)
        self.max_samples = max_samples

    def observe(self, n_items: float, elapsed_s: float) -> None:
        if elapsed_s < 0.0:
            return
        self.n += 1
        self.sum_items += float(n_items)
        self.sum_s += float(elapsed_s)
        self._elapsed.append(float(elapsed_s))

    def percentile_s(self, q: float) -> Optional[float]:
        if not self._elapsed:
            return None
        return float(np.percentile(np.asarray(self._elapsed), q))


STAGE_RETRIEVE = "retrieve"
STAGE_QUEUE = "queue"
STAGE_BATCH = "batch"
STAGE_DEVICE = "device"
STAGE_GATHER = "gather"
STAGES = (STAGE_RETRIEVE, STAGE_QUEUE, STAGE_BATCH, STAGE_DEVICE,
          STAGE_GATHER)


class ServiceTimeModel:
    """Per-stage service-time samples for ONE ``(drain_mode,
    pipeline_depth, batch_items)`` serving configuration. ``queue`` holds
    the scheduler-measured ``Response.queue_delay_s`` samples."""

    def __init__(self, cfg, *, drain_mode: str, pipeline_depth: int,
                 batch_items: int):
        self.cfg = cfg
        self.drain_mode = str(drain_mode)
        self.pipeline_depth = int(pipeline_depth)
        self.batch_items = int(batch_items)
        self.stages: Dict[str, StageStats] = {s: StageStats() for s in STAGES}
