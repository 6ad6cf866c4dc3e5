"""The program's spans and records as the per-layer readers take them
(``spans.py``, ``metrics/{queue_wait_ms.p95, in_flight_ms.p95,
answer_lag_ms.p95, search_sync_ms.p99, step_device_ms.p50,
eval_row_share, moe_route_share}.py``) on synthetic events and
observations: each reader's value, None with nothing to read; kernels
attributed by launch; idle gaps named by the innermost span."""
from types import SimpleNamespace

import pytest
import torch

from portbench import spans
from portbench.harness import read_metric

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
NEW = ("queue_wait_ms.p95", "in_flight_ms.p95", "answer_lag_ms.p95",
       "search_sync_ms.p99", "step_device_ms.p50", "eval_row_share",
       "moe_route_share")


def _ev(name, start, end, device=CPU, parent=None, kernels=(), eid=0):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=device, cpu_parent=parent, id=eid,
        kernels=[SimpleNamespace(name=k, duration=d) for k, d in kernels])


def _request(enq, staged, ready, answered):
    return {"enqueued": enq, "staged": staged, "dispatched": staged,
            "ready": ready, "answered": answered}


def _batch(device_ms, n_eval, max_evals):
    return {"device_ms": device_ms, "n_evaluated": n_eval,
            "max_evals": max_evals}


OBS = {
    # 20 requests: queue waits 1..20 ms, in flight 10x that, lag 2 ms
    "requests": [_request(0.0, i * 1e-3, i * 11e-3, i * 11e-3 + 2e-3)
                 for i in range(1, 21)],
    "batches": [_batch(200.0 + i, 100, 3072) for i in range(5)]
    + [_batch(None, None, None)],
    "trace": {"program": {
        "device_s_by_span": {
            "moe.router": 0.5, "moe.dispatch": 2.0, "moe.experts": 4.0,
            "moe.combine": 1.5, "step.gather": 9.0},
        "span_ms": {"retrieval.copy_back": [i * 0.1
                                            for i in range(1, 101)]}}},
}


@pytest.mark.parametrize("name,want", [
    ("queue_wait_ms.p95", 19.0), ("in_flight_ms.p95", 190.0),
    ("answer_lag_ms.p95", 2.0), ("search_sync_ms.p99", 9.9),
    ("step_device_ms.p50", 202.0),
    ("eval_row_share", 100.0 * 500 / (5 * 3072)),
    ("moe_route_share", 100.0 * 3.5 / 8.0)])
def test_reader_value_on_synthetic_obs(name, want):
    assert read_metric(name, OBS) == pytest.approx(want)


@pytest.mark.parametrize("name", NEW)
def test_reader_none_with_nothing_to_read(name):
    # an observation without the program's records, as the harness makes
    # it, and one whose records are empty
    bare = {"trace": None, "latency_s": [1.0]}
    empty = {"requests": [], "batches": [],
             "trace": {"busy_s": 1.0, "kernels": {}, "gaps": {}}}
    no_spans = {"requests": [], "batches": [], "trace": {"program": {
        "device_s_by_span": {}, "span_ms": {"retrieval.copy_back": []}}}}
    assert read_metric(name, bare) is None
    assert read_metric(name, empty) is None
    assert read_metric(name, no_spans) is None


def test_kernels_count_under_the_span_that_launched_them():
    """A kernel launched inside ``moe.dispatch`` counts there even though
    it runs on the device after the span has closed and while
    ``moe.experts`` is open on the host."""
    client = _ev("portbench.drain", 0, 1000)
    step = _ev("step.evaluate", 10, 900, parent=client)
    disp = _ev("moe.dispatch", 20, 40, parent=step)
    gather = _ev("aten::index", 22, 30, parent=disp,
                 kernels=[("index_elementwise_kernel", 300.0)], eid=7)
    # the profiler repeats an op's id and kernels on events it adds
    loading = _ev("Lazy Function Loading", 23, 25, parent=gather,
                  kernels=[("index_elementwise_kernel", 300.0)], eid=7)
    experts = _ev("moe.experts", 40, 60, parent=step)
    bmm = _ev("aten::bmm", 41, 50, parent=experts,
              kernels=[("nvjet_gemm", 100.0)], eid=8)
    raw = _ev("moe.combine", 60, 70, parent=step,
              kernels=[("custom_kernel", 50.0)], eid=9)
    outside = _ev("aten::add", 950, 960, parent=client,
                  kernels=[("elementwise", 5.0)], eid=10)
    kern = [_ev("index_elementwise_kernel", 400, 700, device=CUDA),
            _ev("nvjet_gemm", 700, 800, device=CUDA),
            _ev("portbench.drain", 0, 1000, device=CUDA)]
    sp, kernels, launched = spans.program_events(
        [client, step, disp, gather, loading, experts, bmm, raw, outside]
        + kern)
    by = spans.device_s_by_span(launched)
    assert by == pytest.approx({"moe.dispatch": 300e-6,
                                "moe.experts": 100e-6,
                                "moe.combine": 50e-6,
                                spans.NO_PROGRAM_SPAN: 5e-6})
    # the client's device-side annotation is not a kernel
    assert [k[2] for k in kernels] == ["index_elementwise_kernel",
                                       "nvjet_gemm"]
    assert {s[2] for s in sp} == {"portbench.drain", "step.evaluate",
                                  "moe.dispatch", "moe.experts",
                                  "moe.combine"}
    assert read_metric("moe_route_share", {"trace": {"program": {
        "device_s_by_span": by}}}) == pytest.approx(100.0 * 350 / 450)


def test_idle_gaps_named_by_the_innermost_span():
    host = [(0, 1000, "portbench.drain"),
            (100, 600, "scheduler.drain"),
            (150, 550, "shedder.sync"),
            (700, 710, "executor.poll"),
            (1000, 1500, "portbench.wait")]
    kern = [(0, 120, "a"), (560, 690, "b"), (1490, 1500, "c")]
    gaps = spans.idle_by_span(kern, host)
    # 120..560: 30 us under scheduler.drain, 400 under shedder.sync;
    # 690..1490: 300 under portbench.drain (10 under executor.poll),
    # 490 under portbench.wait
    assert gaps == pytest.approx({"shedder.sync": 440e-6,
                                  "portbench.wait": 800e-6})
    assert spans.idle_by_span([], []) == {}
    assert spans.idle_by_span([(0, 10, "a"), (20, 30, "b")], []) == \
        pytest.approx({spans.NO_SPAN: 10e-6})


def test_span_stats_split_self_from_nested_time():
    st = spans.span_stats([(0, 100, "scheduler.drain"),
                           (10, 40, "executor.submit"),
                           (15, 35, "shedder.stage"),
                           (50, 90, "executor.finalize"),
                           (200, 260, "scheduler.drain")])
    assert st["scheduler.drain"] == pytest.approx(
        {"n": 2, "total_s": 160e-6, "self_s": 90e-6})
    assert st["executor.submit"] == pytest.approx(
        {"n": 1, "total_s": 30e-6, "self_s": 10e-6})
    assert st["shedder.stage"]["self_s"] == pytest.approx(20e-6)


def test_window_rows_select_the_window_and_join_stamps():
    def rec(bid, rids, enq, disp):
        return {"batch_id": bid, "request_ids": rids, "enqueued": enq,
                "staged": disp - 0.01, "dispatched": disp,
                "ready": disp + 0.2, "answered": disp + 0.21}
    batches = [rec(0, (1, 2), (9.0, 9.5), 9.9),       # before the start
               rec(1, (3, 4, 7), (10.1, 10.2, 9.8), 10.3),   # 7: too early
               rec(2, (5, 3), (14.5, 10.2), 14.5),    # 3: a hedge twin
               rec(3, (8,), (14.7,), 14.9),           # answered too late
               rec(4, (6,), (15.5,), 15.6)]           # after the stop
    rows = spans.window_rows(batches, 10.0, 15.0)
    assert [b["batch_id"] for b in rows["batches"]] == [1, 2, 3]
    got = {r["request_id"]: r["batch_id"] for r in rows["requests"]}
    assert got == {3: 1, 4: 1, 5: 2}
    assert rows["requests"][0]["staged"] == pytest.approx(10.29)
    assert spans.span_ms([(0, 1500, "retrieval.copy_back"),
                          (10, 20, "retrieval.search")],
                         "retrieval.copy_back") == [1.5]
