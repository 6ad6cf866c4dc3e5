"""Priority-aware admission and scheduling in front of the Load Shedder
(counterpart of ``repro.scheduling``).

Request lifecycle, and the module that owns each hop:

    retrieve  serving.engine.enqueue_query   raw query -> BM25 on the
       |      (retrieval.CorpusSearcher)     device -> topk_select kernel
    admit     scheduling.scheduler           per-regime priority ladder
       |      (priorities, ratelimit,        + tenant token buckets +
       |       quarantine)                   poison breakers; rejections
       |                                     answered from the prior
    enqueue   scheduling.queues              EDF per priority class,
       |                                     static-capacity backpressure
    batch     scheduling.batcher             padded, budget-shaped
       |                                     micro-batches
    drain     scheduling.executor            depth-k in-flight window
       |                                     (cluster.depth may retune it)
    shed      core.shedder (host) or         three-tier ladder per batch;
       |      core.fused_shedder (fused)     the fused step runs the
       |                                     shed_partition and
       |                                     flash_attention kernels
    respond   scheduling.scheduler           per-request Responses;
                                             hedged re-dispatch via
                                             distribution.fault_tolerance
"""
from repro_torch.scheduling.batcher import (MicroBatch, MicroBatcher,
                                            to_fused_inputs)
from repro_torch.scheduling.executor import DrainExecutor
from repro_torch.scheduling.priorities import (AdmissionPolicy, Priority,
                                               REASON_QUARANTINED,
                                               REASON_QUEUE_FULL,
                                               REASON_RATE_LIMITED,
                                               REASON_SHED_LOW_HEAVY,
                                               REASON_SHED_LOW_VERY_HEAVY,
                                               REASON_SHED_NORMAL_VERY_HEAVY)
from repro_torch.scheduling.quarantine import (PoisonQuarantine,
                                               QuarantineStats,
                                               work_signature)
from repro_torch.scheduling.queues import (EDFQueue, PriorityQueueBank,
                                           QueuedRequest)
from repro_torch.scheduling.ratelimit import TenantRateLimiter, TokenBucket
from repro_torch.scheduling.scheduler import (Request, Response, Scheduler,
                                              SchedulerConfig,
                                              SchedulerStats)

__all__ = [
    "AdmissionPolicy", "Priority",
    "REASON_QUARANTINED", "REASON_QUEUE_FULL", "REASON_RATE_LIMITED",
    "REASON_SHED_LOW_HEAVY", "REASON_SHED_LOW_VERY_HEAVY",
    "REASON_SHED_NORMAL_VERY_HEAVY",
    "EDFQueue", "PriorityQueueBank", "QueuedRequest",
    "TenantRateLimiter", "TokenBucket",
    "DrainExecutor",
    "MicroBatch", "MicroBatcher", "to_fused_inputs",
    "PoisonQuarantine", "QuarantineStats", "work_signature",
    "Request", "Response", "Scheduler", "SchedulerConfig",
    "SchedulerStats",
]
