"""One run of one cell: set-up, warm-up, the measured open-loop window,
the check against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file found by its name in ``BENCHMARK.json``:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<workload>.json`` (the cell's trust tolerance) and
``metrics/<metric>.py`` (with an optional ``metrics/<metric>.json`` of
data). Nothing here names a cell.

The client is open-loop on one thread: it offers every request whose due
time has passed, keeps the engine's pipeline full (``drain(1,
flush=False)``, ``poll()``), and sleeps only when nothing is due and
nothing is queued. A request's latency runs from its due time to the
host time at which its response came back. When the window closes it
stops offering and drains what is left; answers that come after the
close keep their real latency.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench import readers, traffic_gen, weights
from portbench.reference import bm25, model, shedding
from portbench.sut import System, release
from portbench.trace import Tracer, span

ROOT = Path(__file__).resolve().parent
TIER_EVAL, TIER_CACHED, TIER_PRIOR, TIER_INVALID = 0, 1, 2, 3
DRAIN_GRACE_S = 60.0          # a minute past the close for late answers
TRACE_S = 6.0                 # the traced part: the window's last seconds
SEARCH_SAMPLE = 256           # searches held against the BM25 reference
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
_WEIGHT_TAG = 0x5EED


def load_json(path: Path) -> Dict:
    return json.loads(path.read_text())


def cell_files(manifest: Dict, workload: str) -> Dict:
    """The cell's entry and the files its names lead to."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    metrics = [m for m in manifest["per_layer"]
               if workload in m.get("workloads", [workload])]
    e2e = [m for m in manifest["end_to_end"]
           if workload in m.get("workloads", [workload])]
    return {"cell": cell,
            "config": load_json(ROOT.parent / conf["file"]),
            "traffic": load_json(ROOT / "traffic" / f"{cell['traffic']}.json"),
            "limits": load_json(ROOT / "limits" / f"{workload}.json"),
            "end_to_end": e2e, "per_layer": metrics}


def forbidden_modules() -> List[str]:
    """Modules of the JAX package or JAX itself in this process,
    compared by whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# the open-loop client
# ---------------------------------------------------------------------------

class Client:
    """Offers a schedule to a ``sut.System`` and stamps what comes back."""

    def __init__(self, system):
        self.sys = system
        self.due: Dict[int, float] = {}          # request id -> due time
        self.answers: Dict[int, List] = {}       # request id -> [(t, resp)]
        self.late: Dict[int, float] = {}         # request id -> lateness
        self.rejected_at: Dict[int, int] = {}    # request id -> steps then
        self.searched: Dict[int, tuple] = {}     # request id -> search tap
        self.search_s: Dict[int, float] = {}     # request id -> its search
        self.longest_call_s = 0.0                 # one offer, drain or poll
        self.gc_s = [0.0, 0.0]                    # total, longest collection
        self.req: Dict[int, traffic_gen.Request] = {}

    def collect(self) -> None:
        now = time.monotonic()
        for r in self.sys.new_responses():
            self.answers.setdefault(r.request_id, []).append((now, r))
            if not r.admitted:
                self.rejected_at[r.request_id] = len(self.sys.steps)

    def _timed(self, fn, *args):
        t = time.monotonic()
        out = fn(*args)
        self.longest_call_s = max(self.longest_call_s, time.monotonic() - t)
        return out

    def _gc(self, phase: str, info: Dict) -> None:
        if phase == "start":
            self._gc_t = time.monotonic()
        elif hasattr(self, "_gc_t"):
            d = time.monotonic() - self._gc_t
            self.gc_s = [self.gc_s[0] + d, max(self.gc_s[1], d)]

    def offer(self, req, due: float) -> int:
        late = time.monotonic() - due
        with span("portbench.offer"):
            rid = self._timed(self.sys.offer, req)
        self.due[rid], self.req[rid], self.late[rid] = due, req, late
        if req.query is not None:
            self.searched[rid] = self.sys.searches[-1]
            self.search_s[rid] = self.sys.search_s[-1]
        self.collect()
        return rid

    def serve(self, reqs, seconds: float, tracer: Optional[Tracer] = None
              ) -> float:
        """Offer ``reqs`` over ``seconds`` from now; returns the start."""
        t0 = time.monotonic()
        end, i, n = t0 + seconds, 0, len(reqs)
        while True:
            now = time.monotonic()
            if now >= end:
                break
            if tracer is not None:
                tracer.tick(now - t0, now)
            while i < n and t0 + reqs[i].due <= now:
                self.offer(reqs[i], t0 + reqs[i].due)
                i += 1
            if self.sys.queued_items():
                with span("portbench.drain"):
                    self._timed(self.sys.drain_one)
                self.collect()
                continue
            with span("portbench.poll"):
                self._timed(self.sys.poll)
            self.collect()
            nxt = min(t0 + reqs[i].due if i < n else end, end)
            wait = nxt - time.monotonic()
            if wait > 0:
                with span("portbench.wait"):
                    time.sleep(min(wait, 5e-4) if self.sys.in_flight()
                               else wait)
        if tracer is not None:
            tracer.stop(time.monotonic())
        # requests that fell due while the client was blocked in the last
        # drain are offered now, late, and keep their due time
        while i < n:
            self.offer(reqs[i], t0 + reqs[i].due)
            i += 1
        return t0

    def finish(self, deadline: float) -> None:
        """Drain what is queued and in flight, until ``deadline``."""
        while self.sys.queued_items() and time.monotonic() < deadline:
            self.sys.drain_one()
            self.collect()
        self.sys.flush()
        self.collect()


# ---------------------------------------------------------------------------
# the check against the reference
# ---------------------------------------------------------------------------

def serving_reference(config: Dict) -> Dict:
    s = config["serving"]
    return {k: s[k] for k in ("cache_slots", "cache_ways", "prior_ewma",
                              "prior_init", "deadline_s",
                              "overload_deadline_s", "very_heavy_weight")}


def eval_rows(batch: Dict, max_evals: int) -> np.ndarray:
    """Positions of the batch the evaluator call read, in its row order:
    the evaluated items by rank, then pad rows, which read the batch's
    last row."""
    ev = np.flatnonzero(batch["tier"] == TIER_EVAL)
    pad = np.full(max_evals - len(ev), len(batch["keys"]) - 1)
    return np.concatenate([ev, pad])


def batch_tokens(seed: int, batch: Dict, rows: np.ndarray, vocab: int,
                 doc_tokens: int) -> np.ndarray:
    """Tokens of batch rows; padding rows hold zeros."""
    keys = batch["keys"][rows]
    tok = traffic_gen.item_tokens(seed, keys, vocab, doc_tokens)
    tok[keys == 0] = 0
    return tok


def check_evaluator(config: Dict, tree: Dict, seed: int, doc_tokens: int,
                    window: List[Dict], steps: List, first: int,
                    device, tol: float, control: bool) -> Dict:
    """How many judged fresh answers lie more than ``tol`` from the
    float32 reference's trust, and the widest gap (with ``control``, the
    same two for the float8 reference on the same items)."""
    m, chk = config["model"], config["check"]
    rng = np.random.default_rng([seed, 3])
    trust_scale = config["serving"]["trust_scale"]
    model.set_exact_float32()
    out = {"wrong_answers": 0, "trust_gap": 0.0, "n_items": 0}
    if control:
        out.update(control_wrong_answers=0, control_trust_gap=0.0)
    jobs = []      # (tokens of the call's rows, which rows to judge, served)
    if m.get("num_experts"):
        # the experts' capacity couples an evaluator call's rows: the
        # reference runs whole calls as the system made them, drawn from
        # the calls that evaluated at least the median count
        counts = [int((b["tier"] == TIER_EVAL).sum()) for b in window]
        floor = np.median([n for n in counts if n]) if any(counts) else 1
        cands = [i for i, n in enumerate(counts) if n and n >= floor]
        for i in rng.choice(cands, size=min(chk["eval_batches"], len(cands)),
                            replace=False):
            b = window[i]
            max_evals = steps[first + i][3]
            rows = eval_rows(b, max_evals)
            jobs.append((batch_tokens(seed, b, rows, m["vocab_size"],
                                      doc_tokens), np.arange(counts[i]),
                         b["trust"][rows[:counts[i]]]))
    else:
        items = [(bi, p) for bi, b in enumerate(window)
                 for p in np.flatnonzero(b["tier"] == TIER_EVAL)]
        if items:
            pick = rng.choice(len(items), size=min(chk["eval_items"],
                                                   len(items)),
                              replace=False)
            sel = [items[j] for j in np.sort(pick)]
            tok = traffic_gen.item_tokens(
                seed, np.asarray([window[bi]["keys"][p] for bi, p in sel]),
                m["vocab_size"], doc_tokens)
            served = np.asarray([window[bi]["trust"][p] for bi, p in sel])
            blk = chk["rows_per_call"]
            for lo in range(0, len(sel), blk):
                part = tok[lo:lo + blk]
                jobs.append((part, np.arange(len(part)),
                             served[lo:lo + blk]))
    for tok, judge, served in jobs:
        t = torch.as_tensor(tok, device=device)
        ref = model.trust_scores(tree, m, t, trust_scale).cpu().numpy()
        gap = np.abs(served.astype(np.float64) - ref[judge])
        out["wrong_answers"] += int((gap > tol).sum())
        out["trust_gap"] = max(out["trust_gap"], float(gap.max()))
        out["n_items"] += len(judge)
        if control:
            low = model.trust_scores(tree, m, t, trust_scale,
                                     precision="fp8").cpu().numpy()
            cg = np.abs(low[judge] - ref[judge])
            out["control_wrong_answers"] += int((cg > tol).sum())
            out["control_trust_gap"] = max(out["control_trust_gap"],
                                           float(cg.max()))
        del t
    return out


def check_run(files: Dict, client: Client, system, tree: Dict,
              corpus, seed: int, t0: float, device, control: bool
              ) -> Dict:
    """Every compared number of the run, with the readings beside."""
    config, traffic = files["config"], files["traffic"]
    doc_tokens = int(traffic["doc_tokens"])
    out: Dict = {}
    # 1. every request due answered exactly once, every item answered
    win = [rid for rid, d in client.due.items() if d >= t0]
    out["unanswered"] = sum(len(client.answers.get(r, [])) != 1
                            for r in client.due)
    dropped = 0
    for rid, got in client.answers.items():
        for _, r in got:
            n = len(client.req[rid].keys) if client.req[rid].keys \
                is not None else len(client.searched[rid][1])
            if len(r.trust) != n or len(r.tier) != n \
                    or (r.tier == TIER_INVALID).any() \
                    or not np.isfinite(r.trust).all():
                dropped += 1
    out["dropped_answers"] = dropped
    out["executor_errors"] = int(system.stats()["n_executor_errors"])
    # 2. the shedder: tiers, budgets, Trust-DB hits and the prior, replayed
    rep = shedding.check_batches(serving_reference(config), system.steps,
                                 system.batches)
    rp = rep.pop("replay")
    prior_gap = rep.pop("prior_gap")
    out.update(rep)
    # 3. each answer is its batch's rows for its request's keys; a
    # rejection is the prior of the moment, item by item
    slice_bad = 0
    for b in system.batches:
        for rid, s, ln in b["slices"]:
            got = client.answers.get(rid)
            keys = (client.req[rid].keys if client.req[rid].keys is not None
                    else client.searched[rid][1].astype(np.uint32) + 1)
            if not got or not np.array_equal(b["keys"][s:s + ln], keys) \
                    or not np.array_equal(got[0][1].tier, b["tier"][s:s + ln]) \
                    or not np.array_equal(got[0][1].trust,
                                          b["trust"][s:s + ln]):
                slice_bad += 1
    for rid, k in client.rejected_at.items():
        r = client.answers[rid][0][1]
        gap = np.abs(r.trust - rp.priors[k])
        prior_gap = max(prior_gap, float(gap.max()) if len(gap) else 0.0)
        if (r.tier != TIER_PRIOR).any() or (gap > shedding.PRIOR_ATOL).any():
            slice_bad += 1
    out["answer_mismatch"] = slice_bad
    readings = {"prior_gap": prior_gap}
    # 4. retrieval, on a sample of the window's searches: the shard's ids
    # and scores, and the keys the request was batched under
    if corpus is not None:
        rng = np.random.default_rng([seed, 5])
        batched = {rid: b["keys"][s:s + ln] for b in system.batches
                   for rid, s, ln in b["slices"]}
        qs = [rid for rid in win if rid in client.searched]
        pick = rng.choice(len(qs), size=min(SEARCH_SAMPLE, len(qs)),
                          replace=False)
        ref = bm25.BM25(corpus.ranks, corpus.offsets, corpus.vocab)
        searches = []
        for j in np.sort(pick):
            rid = qs[j]
            q, ids, scores = client.searched[rid]
            served = batched.get(rid, ids.astype(np.uint32) + 1)
            searches.append((q, ids, scores, served))
        out["retrieval_mismatch"] = bm25.check_searches(
            ref, searches, int(traffic["query"]["top_k"]))
        readings["searches_checked"] = len(searches)
    # 5. the evaluator, against the float32 reference; the system's
    # state is freed first, the weights kept (they are the input)
    first = next((i for i, b in enumerate(system.batches) if b["t"] >= t0),
                 len(system.batches))
    window, steps = system.batches[first:], system.steps
    release(system)
    gc.collect()
    tol = files["limits"]["trust_tol"]
    ev = check_evaluator(config, tree, seed, doc_tokens, window, steps,
                         first, device, tol, control)
    out["wrong_answers"] = ev.pop("wrong_answers")
    readings.update(ev, trust_tol=tol)
    return {"checks": out, "readings": readings}


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def observations(client: Client, system, t0: float, seconds: float,
                 stats0: Dict, stats1: Dict, files: Dict,
                 host_until: float = None) -> Dict:
    """What the readers and the end-to-end metrics read. The host-clock
    readings of the client (lateness, search time, the overload tail)
    take only requests due before ``host_until``: in a traced run, the
    start of the traced part, where the profiler slows the host."""
    end = t0 + seconds
    win = [rid for rid, d in client.due.items() if d >= t0]
    host = [rid for rid in win
            if host_until is None or client.due[rid] < host_until]
    gave_up = time.monotonic()
    lat = []
    tiers = Counter()
    rejected = 0
    trusted = 0
    evals_in_window = 0
    for rid in win:
        got = client.answers.get(rid, [])
        # a request never answered counts with all the time it waited
        lat.append(got[0][0] - client.due[rid] if got
                   else gave_up - client.due[rid])
        for t, r in got:
            if r.admitted:
                tiers.update(r.tier.tolist())
            else:
                rejected += 1
    for rid, got in client.answers.items():
        for t, r in got:
            if t0 <= t <= end:
                trusted += int(((r.tier == TIER_EVAL)
                                | (r.tier == TIER_CACHED)).sum())
                evals_in_window += int((r.tier == TIER_EVAL).sum())
    nb = stats1["n_batches"] - stats0["n_batches"]
    ni = stats1["n_batched_items"] - stats0["n_batched_items"]
    config = files["config"]
    max_evals = config["serving"].get("fused_max_evals") or system.max_batch
    return {"seconds": seconds, "latency_s": lat,
            "host_latency_s": [lat[i] for i, rid in enumerate(win)
                               if host_until is None
                               or client.due[rid] < host_until],
            "late_s": [client.late[rid] for rid in host],
            "n_requests": len(win), "n_rejected": rejected,
            "admitted_tiers": dict(tiers),
            "trusted_items": trusted, "eval_items": evals_in_window,
            "batch_fill": (ni / nb / system.max_batch) if nb else None,
            "search_s": [client.search_s[r] for r in host
                          if r in client.search_s],
            "model": config["model"],
            "doc_tokens": int(files["traffic"]["doc_tokens"]),
            "eval_rows": int(max_evals), "trace": None}


def end_to_end(obs: Dict, setup_s: float) -> Dict[str, float]:
    return {"p95_query_s": readers.p_nearest(obs["latency_s"], 0.95),
            "trusted_items_per_s": obs["trusted_items"] / obs["seconds"],
            "setup_s": setup_s}


def read_metric(name: str, obs: Dict) -> Optional[float]:
    """The per-layer metric ``name`` by its own reader,
    ``metrics/<name>.py`` (with ``metrics/<name>.json`` as ``data``)."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    data_path = ROOT / "metrics" / f"{name}.json"
    data = load_json(data_path) if data_path.exists() else None
    return mod.read(obs, data)


def breakdown(trace: Dict) -> Dict:
    ops = sorted(trace["kernels"].items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(trace["gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v[0]] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def run(files: Dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, device_info: Dict,
        fault: Optional[Callable] = None, control: bool = False,
        sink: Optional[Dict] = None) -> Dict:
    """One run of a cell. ``fault(system)`` (tests only) breaks the timed
    path after it is built; ``control`` also reads the float8 control's
    gap on the items the check judges; ``sink`` (a dict) receives the
    observations and the load-monitor inputs of the window's steps."""
    config, traffic = files["config"], files["traffic"]
    dtype = getattr(torch, config["dtype"])
    tree = weights.make_weights(config["model"], seed ^ _WEIGHT_TAG, dtype,
                                device)
    corpus = (traffic_gen.make_corpus(traffic, seed)
              if traffic["kind"] == "search" else None)
    warm = traffic_gen.make_requests(traffic, seed, seconds, 1, corpus)
    reqs = traffic_gen.make_requests(traffic, seed, seconds, 0, corpus)
    system = System(config, traffic, seed, tree, device, corpus)
    if fault is not None:
        fault(system)
    client = Client(system)
    # warm-up: the same mix at the same rate, then everything drained
    client.serve(warm, warm[-1].due + 1e-3)
    client.finish(time.monotonic() + 10 * DRAIN_GRACE_S)
    if device.type == "cuda":
        torch.cuda.synchronize()
    stats0 = system.stats()
    tracer = None
    if trace:
        Tracer.warm()
        tracer = Tracer(max(seconds - TRACE_S, seconds / 2),
                        min(TRACE_S, seconds / 2))
    # the window's host stalls: its longest client call and the time in
    # the interpreter's garbage collections
    client.longest_call_s = 0.0
    gc.callbacks.append(client._gc)
    t0 = time.monotonic()
    setup_s = t0 - t_start
    try:
        client.serve(reqs, seconds, tracer)
    finally:
        gc.callbacks.remove(client._gc)
    backlog = system.queued_items()
    n_steps0 = len(system.steps)
    # the window has closed: no more offers; late answers keep their time
    client.finish(t0 + seconds + DRAIN_GRACE_S)
    stats1 = system.stats()
    if device.type == "cuda":
        torch.cuda.synchronize()
        device_info["memory_peak_bytes"] = int(
            torch.cuda.max_memory_allocated(device))
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")
    obs = observations(client, system, t0, seconds, stats0, stats1, files,
                       None if tracer is None else t0 + tracer.start_s)
    if tracer is not None:
        obs["trace"] = tracer.reduce()
    if sink is not None:
        sink.update(obs=obs, backlog_end=backlog, setup_s=setup_s,
                    steps=system.steps[:n_steps0],
                    window_steps=sum(b["t"] >= t0 for b in system.batches))
    metrics_ = end_to_end(obs, setup_s)
    res = check_run(files, client, system, tree, corpus, seed, t0, device,
                    control)
    # every compared number is a count of faults: its limit is 0
    checks = {k: {"value": v, "limit": 0} for k, v in res["checks"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    if trace:
        names = [m for m in files["per_layer"]]
        got = {m["name"]: read_metric(m["name"], obs) for m in names}
        out_metrics = {m["name"]: {"value": got[m["name"]], "unit": m["unit"]}
                       for m in names if got[m["name"]] is not None}
    else:
        out_metrics = {m["name"]: {"value": metrics_[m["name"]],
                                   "unit": m["unit"]}
                       for m in files["end_to_end"]}
    dev = dict(device_info)
    line = {"correct": correct, "attempted": obs["n_requests"],
            "failed": int(res["checks"]["unanswered"]), "metrics": out_metrics,
            "device": dev}
    if trace and obs["trace"] is not None:
        dev["busy_s"] = obs["trace"]["busy_s"]
        dev["window_s"] = obs["trace"]["window_s"]
        line["breakdown"] = breakdown(obs["trace"])
    res["readings"].update(longest_call_s=client.longest_call_s,
                           gc_total_s=client.gc_s[0], gc_longest_s=client.gc_s[1])
    if tracer is not None:
        res["readings"]["trace_start_s"] = tracer.enter_s
    line["readings"] = res["readings"]
    line["checks"] = checks
    return line
