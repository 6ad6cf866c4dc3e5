"""p99 (nearest rank) over the traced part's index-shard copies back to
the host of the host ms each took: the ``retrieval.copy_back`` spans
(``spans.span_ms``).

No entry of ``BENCHMARK.json`` names this reader yet: the harness
passes no program records or spans, so only ``portbench/probe.py`` reads
it."""
from portbench.readers import p_nearest


def read(obs, data):
    program = (obs.get("trace") or {}).get("program") or {}
    return p_nearest((program.get("span_ms") or {}).get(
        "retrieval.copy_back") or [], 0.99)
