"""Device trace of a part of the measured window (``--trace 1``).

``torch.profiler`` records the device's kernels and the host's
operations over ``[start, start + length)`` seconds of the window; the
benchmark's own spans (``span``: ``portbench.offer``, ``.drain``,
``.poll``, ``.wait``) mark what the open-loop client was doing.
``reduce`` turns the trace into: the busy seconds (the union of kernel
intervals, so overlapping kernels count once), device time and launches
by kernel name, and the idle gaps between kernels, each named by the
span that covers most of it.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch


def span(name: str):
    """A named host span in the trace (free when nothing traces)."""
    return torch.profiler.record_function(name)


class Tracer:
    def __init__(self, start_s: float, length_s: float):
        self.start_s, self.length_s = start_s, length_s
        self.prof = None
        self.done = False
        self.t_on: Optional[float] = None
        self.t_off: Optional[float] = None
        self.enter_s = 0.0

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once during set-up: its first
        start initialises the device tracer, which takes seconds."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):
            x = torch.ones(8, device="cuda" if torch.cuda.is_available()
                           else "cpu")
            x.add_(1)
            if torch.cuda.is_available():
                torch.cuda.synchronize()

    def tick(self, t: float, now: float) -> None:
        """Called with the window time ``t`` (and the clock ``now``):
        starts the profiler at ``start_s`` and stops it ``length_s``
        later."""
        if self.done:
            return
        if self.prof is None and t >= self.start_s:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.t_on = time.monotonic()
            self.enter_s = self.t_on - now
        elif self.prof is not None and t >= self.start_s + self.length_s:
            self.stop(now)

    def stop(self, now: float) -> None:
        if self.prof is not None and not self.done:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)
            self.t_off = now
            self.done = True

    def reduce(self) -> Optional[Dict]:
        """Busy seconds, window seconds, kernels by name and the idle gaps
        by host span; None when nothing was traced."""
        if self.prof is None or not self.done:
            return None
        from torch.autograd import DeviceType
        kern: List[Tuple[float, float, str]] = []
        spans: List[Tuple[float, float, str]] = []
        for e in self.prof.events():
            tr = e.time_range
            if e.name.startswith("portbench."):
                # the client's spans; on the device timeline too, as
                # annotations, which are not device work
                if e.device_type != DeviceType.CUDA:
                    spans.append((tr.start, tr.end, e.name))
            elif e.device_type == DeviceType.CUDA:
                if tr.end > tr.start:
                    kern.append((tr.start, tr.end, e.name))
        out = reduce_events(kern, spans)
        out["window_s"] = self.t_off - self.t_on
        return out


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Disjoint sorted intervals covering the same time."""
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def reduce_events(kern: List[Tuple[float, float, str]],
                  spans: List[Tuple[float, float, str]]) -> Dict:
    """Kernels (start, end, name) and client spans (start, end, name), in
    microseconds -> busy seconds (their union), seconds and launches by
    kernel name, and idle seconds by the span covering most of each gap
    (from the first traced event to the last)."""
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for s, e, name in kern:
        by_name[name][0] += (e - s) * 1e-6
        by_name[name][1] += 1
    merged = union([(s, e) for s, e, _ in kern])
    busy = sum(e - s for s, e in merged) * 1e-6
    edges = [x for iv in merged for x in iv]
    ends = [s for s, _, _ in spans] + [e for _, e, _ in spans] + edges
    if not ends:
        return {"busy_s": 0.0, "kernels": {}, "gaps": {}}
    edges = [min(ends)] + edges + [max(ends)]
    spans = sorted(spans)
    starts = [s for s, _, _ in spans]
    gaps: Dict[str, float] = defaultdict(float)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        best, name = 0.0, "no span of the client"
        # the client's spans follow one another on one thread: walk back
        # from the last that starts before the gap ends
        j = bisect.bisect_left(starts, b) - 1
        while j >= 0 and spans[j][1] > a:
            s, e, nm = spans[j]
            ov = min(b, e) - max(a, s)
            if ov > best:
                best, name = ov, nm
            j -= 1
        gaps[name] += (b - a) * 1e-6
    return {"busy_s": busy,
            "kernels": {k: tuple(v) for k, v in by_name.items()},
            "gaps": dict(gaps)}
