"""Named host spans of the serving path, on the profiler's clock.

``span(name)`` marks a stretch of host code as ``<module>.<stage>``
(``engine.enqueue_query``, ``shedder.dispatch``, ``moe.combine``, ...);
``traced(name)`` makes every call of a function such a span.
While a ``torch.profiler`` profile runs it is a profiler record, so the
span lands in the same trace as the device's kernels: each kernel is
linked to the host op that launched it, and that op's parent chain
leads to the innermost span around the launch. While no profile runs it
is one shared no-op context. There is no switch of its own: tracing is
on exactly when a profiler is (``enabled()``), and the serving path's
records (``Scheduler.batch_records``, a step's device time) are kept
only then, so with no profiler the path does the work it does untraced.

The record is ``torch._C._profiler._RecordFunctionFast``, a function
record: unlike ``torch.profiler.record_function`` (a user annotation)
it puts no annotation range on the device's timeline, so a reader that
takes every device event for a kernel counts the same kernels with the
program's spans in place as without them.
"""
from __future__ import annotations

import contextlib
import functools

import torch

_OFF = contextlib.nullcontext()
_RECORD = torch._C._profiler._RecordFunctionFast


def enabled() -> bool:
    """Whether a profiler runs, so spans and records are kept."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """A context marking ``name`` in the trace while a profiler runs."""
    if torch.autograd._profiler_enabled():
        return _RECORD(name)
    return _OFF


def traced(name: str):
    """Decorator: each call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap
