#!/usr/bin/env python3
"""Run one cell as ``run.py`` does, and read the program's own spans and
records as well.

    python3 portbench/probe.py --workload <name> --seed <n> --seconds <s>

from the root of a checkout, on a machine with an NVIDIA GPU. The run is
``harness.run``'s with ``--trace 1``, with two additions that change
nothing it measures: its tracer also reduces the program's spans
(``spans.program_events``), and the scheduler's batch records (kept
while the profiler runs) are held past the engine's release. Prints the
cell's result line, then one JSON line ``probe``:

* ``readings``: the per-layer readers ``queue_wait_ms.p95``,
  ``in_flight_ms.p95``, ``answer_lag_ms.p95``, ``search_sync_ms.p99``,
  ``step_device_ms.p50``, ``eval_row_share`` and ``moe_route_share`` on
  the run's observations with the records' rows added
  (``spans.window_rows``) and the ``retrieval.copy_back`` spans' ms;
* ``idle_by_span``: the traced part's idle seconds by the innermost
  span over each gap, and the share under a client span with no
  program span open;
* ``device_s_by_span``: device seconds by launching program span;
* ``spans``: count, total and self host seconds of each span in the
  traced part;
* ``syncs``: the searches' copy-back, the batches' staging, the
  rejections' prior copy and the finish's blocking copy, each as spans'
  time in the traced part, split by whether a kernel was running when
  the span began, with the count of those that ended while one ran (a
  copy that waited for every step in flight ends on an idle device).

The same JSON is written to ``chiprun_out/probe_<workload>_<seed>.json``.

This is a stopgap beside ``run.py``: no entry of ``BENCHMARK.json`` reads
the program's spans or records, because ``harness.py`` passes its
readers neither. It swaps the harness's module-level ``Tracer`` and keeps
the records through ``harness.run``'s ``fault`` hook. Its work belongs in
``run.py --trace 1`` (``sut.py`` returning the records, ``harness.py``
adding them to the observations, ``trace.py`` reducing the program's
spans, the seven ``per_layer`` entries), after which this file goes.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"
READERS = ("queue_wait_ms.p95", "in_flight_ms.p95", "answer_lag_ms.p95",
           "search_sync_ms.p99", "step_device_ms.p50", "eval_row_share",
           "moe_route_share")
SYNCS = ("retrieval.copy_back", "shedder.stage", "scheduler.reject_prior",
         "shedder.sync")


def _mean(values):
    values = list(values)
    return statistics.fmean(values) if values else None


def probe(files, seed, seconds, device, info):
    from portbench import harness, spans
    from portbench.trace import Tracer

    class ProgramTracer(Tracer):
        """The harness's tracer, which also reduces the program's
        spans."""
        made = []

        def __init__(self, *a):
            super().__init__(*a)
            self.program = None
            ProgramTracer.made.append(self)

        def reduce(self):
            out = super().reduce()
            if out is not None:
                sp, kern, launched = spans.program_events(
                    self.prof.events())
                self.program = {"spans": sp, "kernels": kern,
                                "device_s_by_span":
                                    spans.device_s_by_span(launched)}
                out["program"] = {
                    "device_s_by_span": self.program["device_s_by_span"],
                    "span_ms": {"retrieval.copy_back": spans.span_ms(
                        sp, "retrieval.copy_back")}}
            return out

    held = {}

    def keep_records(system):
        held["batches"] = system.engine.scheduler.batch_records

    sink = {}
    harness.Tracer = ProgramTracer
    try:
        line = harness.run(files, seed, seconds, True, device, T_START,
                           info, fault=keep_records, sink=sink)
    finally:
        harness.Tracer = Tracer
    tr = ProgramTracer.made[0]
    obs = dict(sink["obs"])
    if tr.t_off is not None:
        obs.update(spans.window_rows(held["batches"], tr.t_on, tr.t_off))
    out = {"readings": {n: harness.read_metric(n, obs) for n in READERS}}
    out["n_rows"] = {k: len(obs.get(k) or ()) for k in ("batches",
                                                         "requests")}
    if tr.program is not None:
        p = tr.program
        idle = spans.idle_by_span(p["kernels"], p["spans"])
        total = sum(idle.values())
        bare = sum(v for k, v in idle.items()
                   if k.startswith(spans.CLIENT) or k == spans.NO_SPAN)
        out["idle_by_span"] = dict(sorted(idle.items(),
                                          key=lambda kv: -kv[1]))
        out["idle_s"] = total
        out["idle_bare_client_share"] = bare / total if total else None
        out["device_s_by_span"] = p["device_s_by_span"]
        out["spans"] = spans.span_stats(p["spans"])
        out["syncs"] = syncs(p["spans"], p["kernels"])
    return line, out


def syncs(sp, kern):
    """Host time of each candidate sync in the traced part, split by
    whether the device was busy (a kernel running) when it began."""
    from portbench.trace import union
    busy = union([(s, e) for s, e, _ in kern])
    starts = [s for s, _ in busy]

    def busy_at(t):
        j = bisect.bisect_right(starts, t) - 1
        return j >= 0 and busy[j][1] > t

    out = {}
    for name in SYNCS:
        d = {"busy": [], "idle": []}
        ended_busy = 0
        for s, e, n in sp:
            if n == name:
                d["busy" if busy_at(s) else "idle"].append((e - s) * 1e-3)
                ended_busy += busy_at(e + 1.0)
        out[name] = {k: {"n": len(v), "mean_ms": _mean(v),
                         "max_ms": max(v) if v else None}
                     for k, v in d.items()}
        out[name]["ended_busy"] = ended_busy
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())

    import torch

    from portbench import harness

    files = harness.cell_files(manifest, args.workload)
    if not torch.cuda.is_available():
        print(f"{args.workload} needs an NVIDIA GPU", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}
    line, out = probe(files, args.seed, args.seconds, device, info)
    print(json.dumps(line), flush=True)
    print(json.dumps({"probe": out}), flush=True)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / f"probe_{args.workload}_{args.seed}.json").write_text(
        json.dumps({"line": line, "probe": out}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
