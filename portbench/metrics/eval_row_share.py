"""% of the evaluator's rows that scored an item, over the window's fused
steps: the evaluated items over the rows the evaluator ran
(``BatchRecord`` ``n_evaluated`` over ``max_evals``, kept while the
profiler runs).

No entry of ``BENCHMARK.json`` names this reader yet: the harness
passes no program records or spans, so only ``portbench/probe.py`` reads
it."""


def read(obs, data):
    rows = [b for b in obs.get("batches") or []
            if b["max_evals"] and b["n_evaluated"] is not None]
    total = sum(b["max_evals"] for b in rows)
    return (100.0 * sum(b["n_evaluated"] for b in rows) / total
            if total else None)
