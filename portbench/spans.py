"""The program's spans and records in a traced window.

The port marks its serving path with named host spans
(``repro_torch.tracing.span``: ``engine.enqueue_query``,
``shedder.sync``, ``moe.dispatch``, ...) and, while a profiler runs,
keeps a record of each micro-batch (``Scheduler.batch_records``). This
module reads both:

* ``program_events`` takes a ``torch.profiler`` event list apart into
  the host spans (the program's and the client's ``portbench.*``), the
  kernels, and each kernel's device seconds beside the innermost program
  span around the host op that launched it (torch links a kernel to its
  launching op by correlation id; the op's parent chain leads to the
  span). Attribution is by launch, not by overlap: a kernel launched
  inside ``moe.dispatch`` counts there however late it runs.
* ``device_s_by_span`` sums those seconds by span; ``idle_by_span``
  names each idle gap between kernels by the innermost span that covers
  most of it; ``span_stats`` gives each span's count, total and self
  host seconds; ``span_ms`` each call's host ms of one span.
* ``window_rows`` turns the records into the rows the per-layer readers
  take: the window's batches and their admitted requests (each with its
  batch's stamps).

Nothing in ``BENCHMARK.json`` reads these yet: ``harness.py`` passes its
readers no program spans or records, so only ``probe.py`` computes the
readers that take them, until a benchmark change moves this into
``run.py --trace 1``.

Times of spans and kernels are in microseconds, as the profiler gives
them; the records' stamps are ``time.monotonic`` seconds.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

from portbench.trace import union

PROGRAM = ("engine.", "retrieval.", "scheduler.", "batcher.", "executor.",
           "shedder.", "step.", "moe.")
CLIENT = "portbench."
NO_SPAN = "no span"
NO_PROGRAM_SPAN = "no program span"

Span = Tuple[float, float, str]


def is_program(name: str) -> bool:
    return name.startswith(PROGRAM)


def launching_span(event) -> Optional[str]:
    """The innermost program span at or above ``event`` in its host
    parent chain (None outside every program span)."""
    while event is not None:
        if is_program(event.name):
            return event.name
        event = event.cpu_parent
    return None


def program_events(events) -> Tuple[List[Span], List[Span],
                                    List[Tuple[Optional[str], float]]]:
    """A profiler's events -> (host spans, kernels, [(launching program
    span, device seconds)] a kernel). Device-side annotation ranges of
    the client's spans are not kernels."""
    from torch.autograd import DeviceType
    spans: List[Span] = []
    kern: List[Span] = []
    launched: List[Tuple[Optional[str], float]] = []
    seen = set()
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith(CLIENT) and not is_program(e.name) \
                    and tr.end > tr.start:
                kern.append((tr.start, tr.end, e.name))
            continue
        if is_program(e.name) or e.name.startswith(CLIENT):
            spans.append((tr.start, tr.end, e.name))
        # a launching op's kernels; events the profiler adds under an
        # op (module loading, buffer requests) repeat its id and kernels
        if e.kernels and e.id not in seen:
            seen.add(e.id)
            owner = launching_span(e)
            launched.extend((owner, k.duration * 1e-6) for k in e.kernels)
    return spans, kern, launched


def device_s_by_span(launched: Iterable[Tuple[Optional[str], float]]
                     ) -> Dict[str, float]:
    out: Dict[str, float] = defaultdict(float)
    for owner, sec in launched:
        out[owner or NO_PROGRAM_SPAN] += sec
    return dict(out)


def _nested(spans: List[Span]) -> Tuple[List[Span], List[float],
                                         List[float]]:
    """Spans sorted outer-first, their starts, and the running maximum of
    their ends (to stop a backward walk early)."""
    order = sorted(spans, key=lambda s: (s[0], -s[1]))
    pmax, m = [], float("-inf")
    for s in order:
        m = max(m, s[1])
        pmax.append(m)
    return order, [s[0] for s in order], pmax


def _innermost_cover(a: float, b: float, order, starts, pmax
                     ) -> Dict[str, float]:
    """Time of [a, b) under each innermost span (the host's spans nest:
    at any instant the open span that started last is the innermost)."""
    cand = []
    j = bisect.bisect_left(starts, b) - 1
    while j >= 0 and pmax[j] > a:
        if order[j][1] > a:
            cand.append(order[j])
        j -= 1
    if not cand:
        return {}
    cuts = sorted({a, b} | {x for s, e, _ in cand for x in (s, e)
                            if a < x < b})
    cover: Dict[str, float] = defaultdict(float)
    for x, y in zip(cuts, cuts[1:]):
        mid = 0.5 * (x + y)
        best = None
        for s, e, name in cand:
            if s <= mid < e and (best is None or s > best[0]
                                 or (s == best[0] and e < best[1])):
                best = (s, e, name)
        if best is not None:
            cover[best[2]] += y - x
    return cover


def idle_by_span(kern: List[Span], spans: List[Span]) -> Dict[str, float]:
    """Idle seconds between kernels (from the first traced event to the
    last, as ``trace.reduce_events`` counts them), each gap under the
    innermost span that covers most of it."""
    merged = union([(s, e) for s, e, _ in kern])
    edges = [x for iv in merged for x in iv]
    ends = [s for s, _, _ in spans] + [e for _, e, _ in spans] + edges
    if not ends:
        return {}
    edges = [min(ends)] + edges + [max(ends)]
    order, starts, pmax = _nested(spans)
    gaps: Dict[str, float] = defaultdict(float)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        cover = _innermost_cover(a, b, order, starts, pmax)
        name = max(cover, key=cover.get) if cover else NO_SPAN
        gaps[name] += (b - a) * 1e-6
    return dict(gaps)


def span_stats(spans: List[Span]) -> Dict[str, Dict[str, float]]:
    """Per span name: calls, total host seconds and self seconds (the
    total less the time in spans nested directly inside)."""
    out: Dict[str, Dict[str, float]] = {}
    stack: List[List] = []          # [end, name, duration, child time]

    def close(item):
        _, name, dur, child = item
        st = out.setdefault(name, {"n": 0, "total_s": 0.0, "self_s": 0.0})
        st["n"] += 1
        st["total_s"] += dur * 1e-6
        st["self_s"] += (dur - child) * 1e-6

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            close(stack.pop())
        if stack:
            stack[-1][3] += e - s
        stack.append([e, name, e - s, 0.0])
    while stack:
        close(stack.pop())
    return out


def span_ms(spans: List[Span], name: str) -> List[float]:
    """Host ms of each call of the span ``name``."""
    return [(e - s) * 1e-3 for s, e, n in spans if n == name]


def window_rows(batches: Iterable, t_on: float, t_off: float
                ) -> Dict[str, List[Dict]]:
    """The records' rows for the readers, from the profiler's start
    ``t_on`` to its stop ``t_off`` (the stop waits for the device and
    processes the trace, stalling the host for seconds, and the start
    stalls it too): ``batches``, the micro-batches dispatched in
    [t_on, t_off); ``requests``, those batches' admitted requests
    enqueued at or after ``t_on`` and answered by ``t_off``, with their
    batch's stamps (a request batched twice, as a hedge, by its first
    batch)."""
    rows = [b if isinstance(b, dict) else b.as_dict() for b in batches]
    win = [b for b in rows if b["dispatched"] is not None
           and t_on <= b["dispatched"] < t_off]
    reqs: Dict[int, Dict] = {}
    for b in win:
        if b["answered"] is None or b["answered"] > t_off:
            continue
        for rid, enq in zip(b["request_ids"], b["enqueued"]):
            if enq >= t_on and rid not in reqs:
                reqs[rid] = {"request_id": rid, "batch_id": b["batch_id"],
                             "enqueued": enq,
                             **{k: b[k] for k in ("staged", "dispatched",
                                                  "ready", "answered")}}
    return {"batches": win, "requests": list(reqs.values())}


def lag_ms(obs: Dict, start: str, end: str, q: float) -> Optional[float]:
    """The q-quantile (nearest rank) over the window's admitted requests
    of the stamp ``end`` less the stamp ``start``, in ms."""
    from portbench.readers import p_nearest
    rows = obs.get("requests") or []
    v = p_nearest([r[end] - r[start] for r in rows
                   if r[start] is not None and r[end] is not None], q)
    return None if v is None else 1e3 * v
