"""Median over the window's fused steps of the step's time on the
device, between the CUDA events recorded at the head of its dispatch
and after it (``BatchRecord.device_ms``, kept while the profiler runs),
in ms.

No entry of ``BENCHMARK.json`` names this reader yet: the harness
passes no program records or spans, so only ``portbench/probe.py`` reads
it."""
from portbench.readers import p_nearest


def read(obs, data):
    return p_nearest([b["device_ms"] for b in obs.get("batches") or []
                      if b["device_ms"] is not None], 0.5)
