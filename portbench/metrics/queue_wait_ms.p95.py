"""p95 (nearest rank) over the window's admitted requests of the time
from the request's enqueue to its micro-batch's staging, in ms: the
scheduling queues and the batcher (``Scheduler.batch_records``, kept
while the profiler runs: the requests enqueued and answered inside the
traced part, ``spans.window_rows``).

No entry of ``BENCHMARK.json`` names this reader yet: the harness
passes no program records or spans, so only ``portbench/probe.py`` reads
it."""
from portbench.spans import lag_ms


def read(obs, data):
    return lag_ms(obs, "enqueued", "staged", 0.95)
