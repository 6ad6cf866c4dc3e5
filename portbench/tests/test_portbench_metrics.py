"""The metric arithmetic on synthetic records: a tail over all requests
with the missing ones counted, trusted items over the whole window, the
device's idle share from a union of intervals, and the work formulas
against hand counts."""
import math

import numpy as np
import pytest

from portbench import readers, work
from portbench.harness import Client, end_to_end, observations
from portbench.trace import reduce_events, union


class _Resp:
    def __init__(self, rid, tier, admitted=True):
        self.request_id, self.tier, self.admitted = rid, np.asarray(tier), \
            admitted
        self.trust = np.zeros(len(tier), np.float32)


class _Sys:
    max_batch = 8
    search_s = []
    steps = []

    def new_responses(self):
        return []


MODEL = {"hidden_size": 4, "num_attention_heads": 2,
         "num_key_value_heads": 1, "head_dim": 2, "intermediate_size": 8,
         "num_hidden_layers": 3, "vocab_size": 10}


def _files():
    return {"config": {"model": MODEL, "serving": {"fused_max_evals": None}},
            "traffic": {"doc_tokens": 4}}


def _client(t0):
    c = Client(_Sys())
    # four window requests (one never answered) and one warm-up request
    c.due = {0: t0 - 5.0, 1: t0 + 0.0, 2: t0 + 1.0, 3: t0 + 2.0,
             4: t0 + 3.0}
    c.late = {r: 0.001 * r for r in c.due}
    c.answers = {
        0: [(t0 - 4.0, _Resp(0, [0, 0]))],
        1: [(t0 + 0.5, _Resp(1, [0, 1, 2]))],          # in the window
        2: [(t0 + 1.2, _Resp(2, [2, 2], admitted=False))],
        3: [(t0 + 10.5, _Resp(3, [1, 1]))],             # after the close
    }
    return c


def test_tail_counts_every_request_and_the_missing_one():
    t0 = 100.0
    obs = observations(_client(t0), _Sys(), t0, 4.0,
                       {"n_batches": 0, "n_batched_items": 0},
                       {"n_batches": 2, "n_batched_items": 12}, _files(),
                       host_until=t0 + 1.5)
    assert obs["n_requests"] == 4 and obs["n_rejected"] == 1
    lat = obs["latency_s"]
    assert lat[:3] == pytest.approx([0.5, 0.2, 8.5])
    assert lat[3] > 1.0                      # never answered: all its wait
    # the client's host readings stop where the trace starts
    assert obs["late_s"] == [0.001, 0.002]
    assert obs["host_latency_s"] == lat[:2]
    assert readers.p_nearest(lat, 0.5) == pytest.approx(0.5)
    assert readers.p_nearest([1.0, math.inf], 0.95) is None
    # trusted: EVAL or CACHED items answered inside [t0, t0 + 4]
    assert obs["trusted_items"] == 2 and obs["eval_items"] == 1
    assert obs["batch_fill"] == pytest.approx(12 / 2 / 8)
    e2e = end_to_end(obs, 7.0)
    assert e2e["trusted_items_per_s"] == pytest.approx(0.5)
    assert e2e["setup_s"] == 7.0
    assert readers.tier_share(obs, 2) == pytest.approx(100 * 1 / 5)
    assert readers.tier_share(obs, 1) == pytest.approx(100 * 3 / 5)


def test_union_and_idle_gaps():
    assert union([(0, 2), (1, 3), (5, 6), (6, 7)]) == [(0, 3), (5, 7)]
    kern = [(0.0, 2e6, "a"), (1e6, 3e6, "b"), (5e6, 6e6, "a")]
    spans = [(2.5e6, 4.5e6, "portbench.drain"),
             (4.5e6, 8e6, "portbench.wait")]
    r = reduce_events(kern, spans)
    assert r["busy_s"] == pytest.approx(4.0)       # [0,3] and [5,6]
    assert r["kernels"]["a"] == pytest.approx((3.0, 2))
    assert r["gaps"]["portbench.drain"] == pytest.approx(2.0)   # [3, 5]
    assert r["gaps"]["portbench.wait"] == pytest.approx(2.0)    # [6, 8]
    obs = {"trace": dict(r, window_s=8.0)}
    assert readers.idle_share(obs) == pytest.approx(50.0)


def test_doc_flops_by_hand():
    # S = 3 positions; per token: projections 2*4*(2*2*2 + 2*1*2) = 96,
    # SwiGLU 3*2*4*8 = 192; attention per layer 2 heads * 4 * 2 * 6 pairs
    # = 96; head 3 * 2 * 4 * 10 = 240
    want = 3 * (3 * (96 + 192) + 96) + 240
    assert work.doc_flops(MODEL, 4) == want
    moe = dict(MODEL, num_experts=4, num_experts_per_tok=2,
               moe_intermediate_size=3)
    ffn = 2 * 4 * 4 + 2 * 3 * 2 * 4 * 3
    assert work.doc_flops(moe, 4) == 3 * (3 * (96 + ffn) + 96) + 240


def test_attention_work_and_bound_by_hand():
    w = work.attention_work(MODEL, rows=5, doc_tokens=4)
    assert w["bytes"] == 5 * 3 * 2 * (2 * 2 + 2 * 1) * 2
    assert w["flops"] == 5 * 2 * 4 * 2 * 6
    b = work.bound_s(w)
    assert b == max(w["bytes"] / 3.35e12, w["flops"] / 989e12)
    share = readers.kernel_roofline(
        {"trace": {"kernels": {"fa_fwd_short_kernel<64>": (4 * b, 2),
                               "gemm": (1.0, 9)}},
         "model": MODEL, "eval_rows": 5, "doc_tokens": 4},
        ["fa_fwd_short_kernel"])
    assert share == pytest.approx(50.0)
    assert readers.kernel_roofline({"trace": None}, ["x"]) is None
