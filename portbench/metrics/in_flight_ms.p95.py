"""p95 (nearest rank) over the window's admitted requests of the time
from their micro-batch's staging to the host's first sight of its step
complete, in ms: the executor's in-flight window (``BatchRecord``
``ready`` less ``staged``); requests as ``queue_wait_ms.p95``.

No entry of ``BENCHMARK.json`` names this reader yet: the harness
passes no program records or spans, so only ``portbench/probe.py`` reads
it."""
from portbench.spans import lag_ms


def read(obs, data):
    return lag_ms(obs, "staged", "ready", 0.95)
