"""p95 (nearest rank) over the window's admitted requests of the time
from the host's first sight of their step complete to their responses
handed back, in ms: the fused shedder's finish and the scheduler's split
(``BatchRecord`` ``answered`` less ``ready``); requests as
``queue_wait_ms.p95``.

No entry of ``BENCHMARK.json`` names this reader yet: the harness
passes no program records or spans, so only ``portbench/probe.py`` reads
it."""
from portbench.spans import lag_ms


def read(obs, data):
    return lag_ms(obs, "ready", "answered", 0.95)
