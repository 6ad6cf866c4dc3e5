"""The unified drain executor: ONE depth-k in-flight window for every
shedding path (counterpart of ``repro.scheduling.executor``, a near-
verbatim copy: the sequencing is host logic).

Before this module, drain *execution* logic lived in three places: the
scheduler hard-coded a one-deep dispatch/finalize pipeline
(``_execute``/``_finalize``), the fused shedder handed out raw
``PendingShed`` handles its callers had to sequence themselves, and the
cluster coordinator round-robined ``engine.drain(max_batches=1)`` calls
that each SYNCED on return — so a fused fleet ran its device steps
sequentially and steal/hedge decisions read stats one batch late.
``DrainExecutor`` is the single owner of that sequencing:

* **depth-k in-flight window** — ``submit(batch)`` stages the batch's
  host->device transfer, dispatches the shedder step, and only blocks
  to finalize the *oldest* in-flight batch once more than
  ``depth`` batches are outstanding. Depth 1 reproduces the previous
  scheduler behaviour bit-for-bit (dispatch N+1, then finalize N;
  nothing outstanding between drain calls). Depth >= 2 additionally
  lets the window survive across ``drain`` calls (``flush=False``), so
  a serving loop draining one micro-batch per iteration overlaps
  device compute with the next iteration's admission + batch formation
  instead of paying a full device sync per call.
* **completion callbacks** — each batch lands through the ``finalize``
  callback (response splitting, stats, Trust-DB/prior/LoadMonitor
  fold-back happen *per batch as it completes*, not at the end of the
  window), and :meth:`poll` finalizes every *already-ready* batch
  without blocking — the cluster coordinator calls it before its
  steal/hedge/autoscale scans so those decisions read fresh stats.
* **exception-mid-window recovery** — a batch whose dispatch or
  finalize raises is answered through the ``rescue`` callback (the
  scheduler answers it from the average-trust prior: degraded, never
  dropped), and every *other* in-flight batch still finalizes
  normally. Overload systems shed work; they do not shed the rest of
  the window because one batch's evaluator blew up.

Sequential executors degenerate cleanly: a shedder without
``supports_async`` (the host chunk-loop path) or with a ``SimClock``
(deterministic timelines are sequential by construction — finalizing N
after dispatching N+1 would stamp N's responses with a clock already
charged for N+1) runs eagerly at effective depth 0: submit dispatches
and finalizes in one step, exactly the pre-executor behaviour.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Deque, List, Optional, Tuple

from repro_torch.tracing import traced


class DrainExecutor:
    """Depth-k micro-batch execution window over a shedder.

    ``finalize(batch, shed_result) -> list`` folds one completed batch
    back into responses (and whatever per-batch state the caller
    owns); ``rescue(batch, exc) -> list`` answers a batch whose
    dispatch or finalize raised. Both are supplied by the scheduler —
    the executor owns *sequencing only*. An optional ``on_error(batch,
    exc)`` observer fires before ``rescue`` so the owner can key
    defences (the poison quarantine) off the failing work's signature.
    """

    def __init__(self, shedder, finalize: Callable[[Any, Any], List],
                 depth: int = 1,
                 rescue: Optional[Callable[[Any, Exception], List]] = None,
                 on_error: Optional[Callable[[Any, Exception], None]] = None):
        self.shedder = shedder
        self._finalize = finalize
        self._rescue = rescue
        self._on_error = on_error
        self.depth = max(1, int(depth))
        self._window: Deque[Tuple[Any, Any]] = deque()
        self.n_dispatched = 0
        self.n_completed = 0
        self.n_rescued = 0

    # -- window state --------------------------------------------------------
    @property
    def in_flight(self) -> int:
        return len(self._window)

    @property
    def n_submitted(self) -> int:
        """Batches accepted by ``submit`` — dispatched OR rescued.
        Progress checks (did this drain round consume queue work?) must
        use this, not ``n_dispatched``: a batch whose dispatch raised
        still popped its requests and answered them."""
        return self.n_dispatched + self.n_rescued

    @property
    def eager(self) -> bool:
        """True when pipelining is meaningless: the shedder is
        synchronous (host chunk loop) or runs a simulated clock (the
        handle resolves eagerly and deferring finalize would stamp
        responses with a clock already charged for later batches)."""
        return (not getattr(self.shedder, "supports_async", False)
                or getattr(self.shedder, "sim_clock", None) is not None)

    @property
    def effective_depth(self) -> int:
        return 0 if self.eager else self.depth

    def set_depth(self, depth: int) -> None:
        """Re-bound the in-flight window (adaptive pipeline depth —
        ``cluster.depth.DepthController``). Takes effect at the next
        ``submit``: a shrink finalizes the overhang oldest-first then
        (in arrival order, exactly as a full window would), a growth
        simply stops forcing finalization until the new bound fills.
        No in-flight batch is ever abandoned."""
        self.depth = max(1, int(depth))

    # -- the pipeline --------------------------------------------------------
    @traced("executor.submit")
    def submit(self, batch) -> List:
        """Dispatch one micro-batch; returns the responses of any OLDER
        batches finalized to keep the window at ``depth``.

        Order of operations matches the depth-1 contract exactly:
        dispatch N+1 first, then finalize N — device compute of N (and
        under depth >= 2, of several predecessors) overlaps this
        batch's host-side staging."""
        if self._window:
            # Opportunistic completion stamp on the window head (a
            # cheap device query): busy loops thereby record WHEN each
            # batch finished at submit cadence, which is what keeps the
            # pipelined throughput observations honest (see
            # FusedLoadShedder._finish).
            self._is_ready(self._window[0][1])
        try:
            handle = self._dispatch(batch)
        except Exception as exc:                  # noqa: BLE001
            return self._do_rescue(batch, exc)
        self._window.append((batch, handle))
        self.n_dispatched += 1
        out: List = []
        while len(self._window) > self.effective_depth:
            out.extend(self._finalize_oldest())
        return out

    def _dispatch(self, batch):
        sh = self.shedder
        rec = getattr(batch, "record", None)
        if not getattr(sh, "supports_async", False):
            handle = _EagerHandle(sh.process(batch.item_keys, batch.buckets,
                                             batch.features,
                                             n_valid=batch.n_valid))
        elif hasattr(sh, "stage"):
            # Transfer stage first, step dispatch second: the
            # host->device copies enqueue behind the in-flight
            # steps of older batches (asynchronous CUDA launches), so at
            # depth >= 2 batch N+2's features stream to the device
            # while N computes and N+1 waits its turn.
            staged = sh.stage(batch.item_keys, batch.buckets,
                              batch.features, n_valid=batch.n_valid)
            if rec is not None:
                rec.staged = time.monotonic()
            handle = sh.dispatch_staged(staged)
        else:
            handle = sh.process_async(batch.item_keys, batch.buckets,
                                      batch.features, n_valid=batch.n_valid)
        if rec is not None:
            rec.note_dispatch(handle)
        return handle

    @traced("executor.finalize")
    def _finalize_oldest(self) -> List:
        batch, handle = self._window.popleft()
        try:
            shed = handle.result()
            out = self._finalize(batch, shed)
        except Exception as exc:                  # noqa: BLE001
            return self._do_rescue(batch, exc)
        if getattr(batch, "record", None) is not None:
            batch.record.note_result(handle, shed)
        self.n_completed += 1
        return out

    def _do_rescue(self, batch, exc: Exception) -> List:
        self.n_rescued += 1
        if self._on_error is not None:
            # Error-signature surfacing: the owner sees WHICH work blew
            # up (the poison quarantine keys circuit breakers off it)
            # before the batch is rescue-answered. Observational only —
            # the rescue path below is unchanged.
            self._on_error(batch, exc)
        if self._rescue is None:
            raise exc
        return self._rescue(batch, exc)

    @traced("executor.poll")
    def poll(self) -> List:
        """Finalize every in-flight batch that is already complete,
        WITHOUT blocking on one that is still computing. The cluster
        coordinator calls this before steal/hedge/autoscale scans so
        fleet decisions read stats as fresh as the hardware allows."""
        out: List = []
        while self._window and self._is_ready(self._window[0][1]):
            out.extend(self._finalize_oldest())
        return out

    @staticmethod
    def _is_ready(handle) -> bool:
        ready = getattr(handle, "is_ready", None)
        if ready is None:
            return True                 # eager handle: always complete
        return bool(ready())

    def flush(self) -> List:
        """Finalize the whole window (blocking), oldest first."""
        out: List = []
        while self._window:
            out.extend(self._finalize_oldest())
        return out


class _EagerHandle:
    """Adapter giving synchronous shedders the async-handle interface
    (the result exists the moment the handle does)."""

    __slots__ = ("_result",)

    def __init__(self, result):
        self._result = result

    def result(self):
        return self._result

    def is_ready(self) -> bool:
        return True
