"""% of the MoE layers' device time in routing the tokens: the device
seconds of kernels launched inside ``moe.dispatch`` or ``moe.combine``
over those launched inside any ``moe.*`` span, in the traced part
(``spans.device_s_by_span``, by launch).

No entry of ``BENCHMARK.json`` names this reader yet: the harness
passes no program records or spans, so only ``portbench/probe.py`` reads
it."""


def read(obs, data):
    by = ((obs.get("trace") or {}).get("program") or {}).get(
        "device_s_by_span") or {}
    moe = {k: v for k, v in by.items() if k.startswith("moe.")}
    total = sum(moe.values())
    if total <= 0:
        return None
    return 100.0 * (moe.get("moe.dispatch", 0.0)
                    + moe.get("moe.combine", 0.0)) / total
