"""The port's CUDA kernels against their plain PyTorch versions on the
card (marker ``cuda``; skipped without a CUDA device). Run on a machine
with an NVIDIA GPU:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

``shed_partition`` and ``topk_select`` must equal their plain versions
exactly; attention, ``flash_decode`` and ``dot_interaction`` within atol
2e-2 in bf16 (output rounding) and 1e-4 in f32 (summation order); the
DLRM, BST, MIND and two-tower evaluators and the KV-cache decode on the
card against the CPU; a fan-out mirror stripe's retrieve equal to its
primary's bit for bit on the card; the ragged embedding bag repeating
its bits run after run on the card."""
import numpy as np
import pytest
import torch

from repro_torch.configs import TrustIRConfig
from repro_torch.core import average_trust as AT
from repro_torch.core import trust_cache as TC
from repro_torch.core.fused_shedder import FusedLoadShedder
from repro_torch.core.shedder import TIER_CACHED, SimClock
from repro_torch.configs import get_config
from repro_torch.kernels.dot_interaction import (dot_interaction,
                                                 dot_interaction_ref,
                                                 group_size)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_decode import (flash_decode,
                                              flash_decode_ref, piece_length)
from repro_torch.kernels.shed_partition import (shed_partition,
                                                shed_partition_ref)
from repro_torch.kernels.topk_select import (NEG_INF, TILE, staged_capacity,
                                             topk_select, topk_select_ref)
from repro_torch.models import transformer as T
from repro_torch.fanout import mirror_shard_of
from repro_torch.models.recsys import bst as BST
from repro_torch.models.recsys import dlrm as D
from repro_torch.models.recsys import embedding as E
from repro_torch.models.recsys import mind as MIND
from repro_torch.models.recsys import two_tower as TWO_TOWER
from repro_torch.retrieval import (CorpusRetrieval, SyntheticCorpus,
                                   ZipfQueryModel)
from repro_torch.serving.evaluators import make_evaluator

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("ways_leading", [True, False])
@pytest.mark.parametrize("budget_is_total", [True, False])
@pytest.mark.parametrize("n,n_valid", [(0, 0), (1, 1), (33, 20),
                                       (1024, 1024), (3000, 2900),
                                       (5000, 4999)])
def test_shed_partition_kernel_equals_plain(dev, n, n_valid, ways_leading,
                                            budget_is_total):
    g = torch.Generator(device=dev).manual_seed(n)
    state = TC.init(512, 4, ways_leading=ways_leading, device=dev)
    pool = torch.randint(-2 ** 31, 2 ** 31 - 1, (3000,), generator=g,
                         device=dev, dtype=torch.int32)
    state = TC.insert(state, pool[:1500], torch.rand(1500, device=dev),
                      torch.ones(1500, dtype=torch.bool, device=dev))
    keys = pool[torch.randint(0, 3000, (n,), generator=g, device=dev)]
    valid = torch.arange(n, device=dev) < n_valid
    args = (keys.contiguous(), valid, state["keys"], state["values"],
            700, 300, 900)
    got = shed_partition(*args, budget_is_total=budget_is_total)
    want = shed_partition_ref(*args, budget_is_total=budget_is_total)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _shed_inputs(dev, n, *, ways=4, ways_leading=True, mask="prefix",
                 cache="half", offset=0, seed=0):
    """Keys, flags and a Trust DB of 1024 sets for one exact check.
    ``cache``: half the key pool inserted, ``all_hit`` (every key drawn
    from 200 inserted ones), ``all_miss`` (nothing inserted) or
    ``first_way`` (every way of a set holds the key of way 0, each with
    its own value, so the first matching way must win). ``mask``: the
    first 90% valid or 70% at random. ``offset`` views keys and flags
    one element into a larger buffer (the kernel's unaligned path)."""
    g = torch.Generator(device=dev).manual_seed(seed + n)
    st = TC.init(1024, ways, ways_leading=ways_leading, device=dev)
    pool = torch.randint(-2 ** 31, 2 ** 31 - 1, (4000,), generator=g,
                         device=dev, dtype=torch.int32)
    pick = torch.randint(0, 4000, (n + offset,), generator=g, device=dev)
    if cache == "all_hit":
        pool = pool[:200]
        pick = pick % 200
    # all_hit inserts one key at a time: keys of one set that arrive in
    # one batch would take the same empty way
    cached = pool[:0] if cache == "all_miss" else pool[:2000]
    step = 1 if cache == "all_hit" else max(cached.shape[0], 1)
    for i in range(0, cached.shape[0], step):
        ins = cached[i:i + step]
        st = TC.insert(st, ins, torch.rand(ins.shape[0], generator=g,
                                           device=dev),
                       torch.ones(ins.shape[0], dtype=torch.bool,
                                  device=dev))
    if cache == "first_way":
        way0 = st["keys"][:1] if ways_leading else st["keys"][:, :1]
        st["keys"] = way0.expand_as(st["keys"]).contiguous()
    keys = pool[pick]
    if mask == "gapped":
        valid = torch.rand(n + offset, generator=g, device=dev) < 0.7
    else:
        valid = torch.arange(n + offset, device=dev) < offset + n - n // 10
    return keys[offset:], valid[offset:], st["keys"], st["values"]


def _assert_shed_exact(inputs, ucap, budget, budget_is_total):
    args = (*inputs, ucap, 0, budget)
    got = shed_partition(*args, budget_is_total=budget_is_total)
    want = shed_partition_ref(*args, budget_is_total=budget_is_total)
    for a, b, name in zip(got, want, ("tier", "cval", "rank")):
        assert torch.equal(a, b), name
    return want


@pytest.mark.parametrize("ways_leading", [True, False])
@pytest.mark.parametrize("budget_is_total", [True, False])
@pytest.mark.parametrize("mask", ["prefix", "gapped"])
@pytest.mark.parametrize("n", [1025, 2048, 2049, 3072, 4095, 4096, 4097,
                               8191, 8192, 8193, 20000])
def test_shed_partition_kernel_round_edges(dev, n, mask, ways_leading,
                                           budget_is_total):
    """N at the edges of the kernel's rounds (1024 threads owning 1, 2, 4
    or 8 items each, so one round covers up to 8192 items), the Normal
    queue closing in the last round (ucap 5/8 of N), prefix and gapped
    flags."""
    inputs = _shed_inputs(dev, n, ways_leading=ways_leading, mask=mask)
    _assert_shed_exact(inputs, n * 5 // 8, n // 4, budget_is_total)


SHED_EDGES = {
    "ucap_0": dict(n=5000, ucap=0),
    "ucap_n": dict(n=5000, ucap=5000),
    "ucap_over_n": dict(n=20000, ucap=30000),
    "budget_0": dict(n=9000, budget=0),
    "budget_0_ucap_0": dict(n=4096, ucap=0, budget=0),
    "all_hit": dict(n=8193, cache="all_hit"),
    "all_miss": dict(n=8193, cache="all_miss"),
    "first_way_wins": dict(n=4096, cache="first_way", mask="gapped"),
    "ways_1": dict(n=9000, ways=1),
    "ways_2": dict(n=9000, ways=2, mask="gapped"),
    "ways_8": dict(n=9000, ways=8),
    "ways_2_first_way_wins": dict(n=3000, ways=2, cache="first_way"),
    "offset_view": dict(n=4096, offset=1),
    "offset_view_gapped": dict(n=8193, offset=1, mask="gapped"),
    "offset_view_ways_2": dict(n=1000, offset=1, ways=2),
}


@pytest.mark.parametrize("ways_leading", [True, False])
@pytest.mark.parametrize("budget_is_total", [True, False])
@pytest.mark.parametrize("edge", list(SHED_EDGES))
def test_shed_partition_kernel_edges(dev, edge, ways_leading,
                                     budget_is_total):
    """Capacity and budget at their limits, all-hit and all-miss batches,
    the generic probe of 1, 2 and 8 ways, duplicate keys in a set, and
    views that take the unaligned load path."""
    spec = dict(SHED_EDGES[edge])
    n = spec.pop("n")
    ucap, budget = spec.pop("ucap", 700), spec.pop("budget", 900)
    inputs = _shed_inputs(dev, n, ways_leading=ways_leading, **spec)
    want = _assert_shed_exact(inputs, ucap, budget, budget_is_total)
    valid = inputs[1]
    if spec.get("cache") == "all_hit":        # the case is what it says
        assert bool((want[0][valid] == TIER_CACHED).all())
    if spec.get("cache") == "all_miss":
        assert not bool((want[0] == TIER_CACHED).any())


@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,window,softcap,causal", [
    (3, 31, 9, 3, 64, 0, 0.0, True),       # the evaluator's shape
    (5, 31, 4, 2, 16, 0, 0.0, True),       # the smoke evaluator's shape
    (2, 77, 4, 4, 16, 0, 0.0, False),
    (1, 257, 4, 1, 16, 64, 30.0, True),
    (2, 1, 4, 2, 64, 0, 0.0, True),
    (2, 100, 8, 2, 128, 0, 0.0, True),
    (1, 257, 6, 1, 64, 64, 30.0, True),
    (2, 77, 4, 4, 64, 0, 0.0, False),
    (1, 300, 4, 2, 128, 50, 0.0, False),
])
def test_flash_attention_kernel_close_to_plain(dev, B, S, Hq, Hkv, D,
                                               window, softcap, causal,
                                               dtype, atol):
    g = torch.Generator(device=dev).manual_seed(S)
    q, k, v = (torch.randn((B, S, h, D), generator=g, device=dev).to(dtype)
               for h in (Hq, Hkv, Hkv))
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,window,softcap,causal", [
    (2, 33, 8, 1, 64, 0, 0.0, True),       # G = 8: 264 packed rows
    (1, 300, 8, 1, 128, 40, 20.0, False),  # G = 8, window, softcap
    (2, 45, 4, 4, 64, 0, 0.0, True),       # G = 1
    (3, 17, 6, 2, 16, 0, 0.0, True),       # G * S = 51, not a multiple of 16
    (1, 1984, 9, 3, 64, 0, 0.0, True),     # prefill of the longest prompt
    (3072, 31, 9, 3, 64, 0, 0.0, True),    # the engine's micro-batch
])
def test_flash_attention_kernel_packed_rows_close_to_plain(
        dev, B, S, Hq, Hkv, D, window, softcap, causal, dtype, atol):
    """The edges of packing a GQA group's heads into the rows of a tile:
    whole groups of 8 or 1, a ragged last tile, long and wide grids."""
    g = torch.Generator(device=dev).manual_seed(B + S + Hq)
    q, k, v = (torch.randn((B, S, h, D), generator=g, device=dev).to(dtype)
               for h in (Hq, Hkv, Hkv))
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = torch.randn((1, 8, 4, 32), device=dev)
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :, :2], q[:, :, :2])            # D = 32
    q = torch.randn((1, 8, 4, 64), device=dev)
    with pytest.raises(ValueError):
        flash_attention(q[:, ::2], q[:, ::2], q[:, ::2])        # strided
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())
    keys = torch.ones(8, dtype=torch.int32, device=dev)
    st = TC.init(64, 2, device=dev)
    with pytest.raises(ValueError):
        shed_partition(keys, torch.ones(8, dtype=torch.bool), st["keys"],
                       st["values"], 4, 4, 4)                   # mixed devices


@pytest.mark.parametrize("n_buckets", [1, 7, 64])
def test_average_trust_update_repeats_its_bits_on_card(dev, n_buckets):
    """The prior's per-bucket sums on the card give the same bits run
    after run (a replayed trace must fingerprint the same), and agree
    with the CPU's index-order sums within float32 rounding."""
    g = torch.Generator().manual_seed(n_buckets)
    n = 89_141
    buckets = torch.randint(0, 1000, (n,), generator=g, dtype=torch.int32)
    values = torch.rand(n, generator=g) * 5
    mask = torch.rand(n, generator=g) < 0.7
    state = AT.init(n_buckets)
    outs = [AT.update({k: v.to(dev) for k, v in state.items()},
                      buckets.to(dev), values.to(dev), mask.to(dev))
            for _ in range(3)]
    for out in outs[1:]:
        for k in out:
            assert torch.equal(out[k], outs[0][k]), k
    cpu = AT.update(state, buckets, values, mask)
    for k in cpu:
        torch.testing.assert_close(outs[0][k].cpu(), cpu[k], rtol=0,
                                   atol=1e-5)


def test_fused_shedder_on_card_matches_cpu(dev):
    w = torch.linspace(-1, 1, 8)

    def ev(chunk):
        return torch.sigmoid(chunk["x"] @ w.to(chunk["x"].device)) * 5.0

    cfg = TrustIRConfig(u_capacity=128, u_threshold=128, chunk_size=16,
                        cache_slots=1024, cache_ways=2)
    rate = cfg.u_capacity / cfg.deadline_s
    out = {}
    for d in ("cpu", dev):
        sh = FusedLoadShedder(cfg, ev, sim_clock=SimClock(rate), device=d)
        res = []
        for off in (1, 5000, 1):
            keys = np.arange(off, off + 410, dtype=np.uint32)
            feats = {"x": np.random.default_rng(off).normal(
                size=(410, 8)).astype(np.float32)}
            res.append(sh.process(keys, np.zeros(410, np.int32), feats))
        out[str(d)] = res
    for a, b in zip(out["cpu"], out["cuda"]):
        np.testing.assert_array_equal(a.tier, b.tier)
        np.testing.assert_allclose(a.trust, b.trust, atol=1e-5)


def _topk_scores(kind, n, g, dev, dtype):
    if kind == "normal":
        return torch.randn(n, generator=g, device=dev, dtype=dtype)
    if kind == "dups":                    # few distinct values: ties
        return torch.randint(0, 5, (n,), generator=g, device=dev).to(dtype)
    if kind == "neg_inf":
        return torch.full((n,), NEG_INF, device=dev, dtype=dtype)
    # +0.0 and -0.0 interleaved with a few positives and negatives
    s = torch.zeros(n, device=dev, dtype=dtype)
    s[torch.rand(n, generator=g, device=dev) < 0.5] = -0.0
    pick = torch.rand(n, generator=g, device=dev)
    s[pick < 0.1] = 1.0
    s[pick > 0.9] = -1.0
    return s


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["normal", "dups", "neg_inf", "zeros"])
@pytest.mark.parametrize("n,k", [(1, 1), (7, 3), (1000, 1000), (4096, 64),
                                 (4097, 64), (9000, 1), (70_000, 64),
                                 (10_000, 1025), (10_000, 2049),
                                 (10_000, 10_000)])
def test_topk_select_kernel_equals_plain(dev, kind, n, k, dtype):
    g = torch.Generator(device=dev).manual_seed(n + k)
    scores = _topk_scores(kind, n, g, dev, dtype)
    got_v, got_i = topk_select(scores, k)
    want_v, want_i = topk_select_ref(scores, k)
    assert got_v.dtype == dtype
    assert torch.equal(got_i, want_i)
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    assert torch.equal(got_v.view(bits), want_v.view(bits))


def _topk_edge(kind, n, g, dev, dtype):
    """Scores for the edges of the cluster radix select."""
    u = torch.rand(n, generator=g, device=dev, dtype=torch.float64)
    if kind == "tied_kth_every_cta":    # 40 above T, T at every 32nd place
        s = u * 0.5
        s[7::32] = 1.5
        s[torch.randperm(n, generator=g, device=dev)[:40]] = 2.0 + u[:40]
    elif kind == "ties_above_k":        # 10 above T, ~n/3 ties at T
        s = u * 0.5
        s[u < 1 / 3] = 1.0
        s[torch.randperm(n, generator=g, device=dev)[:10]] = 3.0
    elif kind == "bm25":                # non-negative, mostly exact zeros
        s = torch.where(u < 0.9, torch.zeros_like(u),
                        torch.round(-torch.log(u) * 64) / 8)
    else:                               # "normal"
        s = torch.randn(n, generator=g, device=dev, dtype=torch.float64)
    return s.to(dtype)


def _assert_topk_equal(scores, k):
    got_v, got_i = topk_select(scores, k)
    want_v, want_i = topk_select_ref(scores, k)
    assert got_v.dtype == scores.dtype
    assert torch.equal(got_i, want_i)
    bits = torch.int32 if scores.dtype == torch.float32 else torch.int64
    assert torch.equal(got_v.view(bits), want_v.view(bits))
    return got_v.view(bits), got_i


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", [
    ("tied_kth_every_cta", 65536, "half_tile"), ("tied_kth_every_cta", 65536,
                                                 64),
    ("ties_above_k", 65536, 64), ("ties_above_k", 70_001, 7),
    ("bm25", 65536, 64), ("bm25", 65536, "half_tile"),
    ("normal", "staged-1", 64), ("normal", "staged", 64),
    ("normal", "staged+1", 64), ("normal", "big", 64),
    ("normal", 65536, "half_tile"), ("normal", 65536, "half_tile+1"),
    ("tied_kth_every_cta", "staged+1", 100),
])
def test_topk_select_kernel_radix_select_edges(dev, case, dtype):
    """The cluster path's edges: the k-th score tied across every CTA,
    more ties at the threshold than k, N around the staged capacity and
    past it (f32 1M, f64 256k), k where the path switches, BM25-shaped
    scores; exact against the plain version, and the same bits twice."""
    kind, n, k = case
    cap = staged_capacity(dtype)
    n = {"staged-1": cap - 1, "staged": cap, "staged+1": cap + 1,
         "big": (1 << 20) if dtype == torch.float32 else (1 << 18)}.get(n, n)
    k = {"half_tile": TILE[dtype] // 2,
         "half_tile+1": TILE[dtype] // 2 + 1}.get(k, k)
    g = torch.Generator(device=dev).manual_seed(n + k)
    scores = _topk_edge(kind, n, g, dev, dtype)
    first = _assert_topk_equal(scores, k)
    again = _assert_topk_equal(scores, k)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", ["twice_staged", "twice_staged+1"])
def test_topk_select_kernel_sixteen_cta_cluster(dev, n, dtype):
    """Past the staged capacity the cluster has 16 CTAs: up to twice it
    they stage their chunks, one past it they walk them from global
    memory; exact against the plain version either way."""
    n = 2 * staged_capacity(dtype) + (n == "twice_staged+1")
    g = torch.Generator(device=dev).manual_seed(n)
    for kind in ("normal", "ties_above_k", "bm25"):
        _assert_topk_equal(_topk_edge(kind, n, g, dev, dtype), 64)


@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_dot_interaction_kernel_f32_large_rows(dev, scale):
    """float32 rows as the DLRM bottom MLP gives them, non-negative after
    its ReLU and of norm ~8 (~32 in the second case), beside unit-norm
    table rows: the 3xTF32 split holds 1e-4 at these norms, where a bf16
    product of the cross terms errs by up to ~6e-5."""
    g = torch.Generator(device=dev).manual_seed(int(scale))
    x = torch.randn((3072, 27, 128), generator=g, device=dev) * 128 ** -0.5
    x[:, 0] = torch.relu(torch.randn((3072, 128), generator=g, device=dev)
                         ) * scale
    got = dot_interaction(x)
    want = dot_interaction_ref(x)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("edge", ["below_sms", "ragged_groups",
                                  "unaligned_run", "unaligned_input", "f1",
                                  "f2", "odd_d"])
def test_dot_interaction_kernel_group_walk_edges(dev, edge, dtype, atol):
    """The persistent grid's edges: fewer samples than SMs, B not a
    multiple of the group (F 8 groups several samples), a group whose
    output run starts unaligned (F 63 in bf16), x not 16-byte aligned,
    F 1 and 2, odd D."""
    B, F, D = {"below_sms": (37, 27, 128), "ragged_groups": (4097, 8, 64),
               "unaligned_run": (45, 63, 64),
               "unaligned_input": (50, 27, 128), "f1": (40, 1, 128),
               "f2": (300, 2, 128), "odd_d": (33, 27, 127)}[edge]
    grp = group_size(F, D, dtype)
    if edge == "ragged_groups":
        assert B % grp
    if edge == "unaligned_run" and dtype == torch.bfloat16:
        assert grp * F * (F - 1) // 2 * 2 % 16
    g = torch.Generator(device=dev).manual_seed(B * F + D)
    n = B * F * D
    flat = (torch.randn(n + 1, generator=g, device=dev) * D ** -0.5
            ).to(dtype)
    x = (flat[1:] if edge == "unaligned_input" else flat[:n]).view(B, F, D)
    got = dot_interaction(x)
    want = dot_interaction_ref(x)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("B,F,D", [(37, 27, 128), (128, 27, 128),
                                   (16, 8, 64), (5, 12, 32), (1, 27, 128),
                                   (7, 5, 16), (9, 27, 13), (3, 2, 4),
                                   (2, 1, 8), (0, 27, 128)])
def test_dot_interaction_kernel_close_to_plain(dev, B, F, D, dtype, atol):
    g = torch.Generator(device=dev).manual_seed(B * F + D)
    # the model's scale: 1/sqrt(D) rows, as the embedding tables
    x = (torch.randn((B, F, D), generator=g, device=dev) * D ** -0.5
         ).to(dtype)
    got = dot_interaction(x)
    want = dot_interaction_ref(x)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("B,L,Hq,Hkv,D,window,softcap", [
    (3, 512, 4, 2, 64, 0, 0.0),
    (2, 512, 8, 1, 128, 100, 30.0),
    (2, 256, 8, 8, 64, 0, 0.0),
    (1, 1024, 9, 3, 64, 0, 0.0),
    (4, 64, 4, 2, 16, 0, 0.0),
    (3, 100, 6, 3, 32, 7, 5.0),
    (128, 2048, 9, 3, 64, 0, 0.0),          # the decode path's shape
])
def test_flash_decode_kernel_close_to_plain(dev, B, L, Hq, Hkv, D, window,
                                            softcap, dtype, atol):
    g = torch.Generator(device=dev).manual_seed(L + B)
    q = torch.randn((B, Hq, D), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((B, L, Hkv, D), generator=g, device=dev).to(dtype)
            for _ in range(2))
    ragged = torch.randint(1, L + 1, (B,), generator=g, device=dev)
    edges = torch.tensor([0, 1, L, L - 1], device=dev)[:B]
    ragged[:edges.numel()] = edges
    for lengths in (ragged.to(torch.int32),
                    torch.full((B,), L, dtype=torch.int32, device=dev)):
        kw = dict(window=window, softcap=softcap)
        got = flash_decode(q, k, v, lengths, **kw)
        want = flash_decode_ref(q, k, v, lengths, **kw)
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=0)
    assert not got.isnan().any()


@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("G", [1, 3, 8])
@pytest.mark.parametrize("spread", ["one_long", "all_full", "window_piece"])
def test_flash_decode_kernel_length_spreads(dev, spread, G, dtype, atol):
    """Spreads of lengths that stress the balanced pieces: one row at L and
    the rest at 1, every row at L, and a window that ends at the first
    piece boundary."""
    B, L, Hkv, D = 64, 1500, 2, 64          # pieces of a few tiles
    piece = piece_length(B, Hkv, L, dtype, D)
    g = torch.Generator(device=dev).manual_seed(G)
    q = torch.randn((B, G * Hkv, D), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((B, L, Hkv, D), generator=g, device=dev).to(dtype)
            for _ in range(2))
    window = 0
    if spread == "one_long":
        lengths = torch.ones(B, dtype=torch.int32, device=dev)
        lengths[B // 2] = L
    elif spread == "all_full":
        lengths = torch.full((B,), L, dtype=torch.int32, device=dev)
    else:
        lengths = torch.randint(1, L + 1, (B,), generator=g, device=dev,
                                dtype=torch.int32)
        lengths[:3] = torch.tensor([piece, piece + 1, L], device=dev)
        window = piece
    got = flash_decode(q, k, v, lengths, window=window)
    want = flash_decode_ref(q, k, v, lengths, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


def test_flash_decode_kernel_respects_lengths(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((2, 4, 64), generator=g, device=dev)
    k, v = (torch.randn((2, 256, 4, 64), generator=g, device=dev)
            for _ in range(2))
    lengths = torch.tensor([100, 37], dtype=torch.int32, device=dev)
    out1 = flash_decode(q, k, v, lengths)
    k[:, 200:], v[:, 200:] = 1e4, -1e4      # poison the invalid region
    torch.testing.assert_close(flash_decode(q, k, v, lengths), out1,
                               rtol=0, atol=0)


def _to(tree, d):
    if isinstance(tree, dict):
        return {k: _to(v, d) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, d) for v in tree]
    return tree.to(d)


def test_dlrm_on_card_matches_cpu(dev):
    cfg = get_config("dlrm-mlperf", smoke=True)
    params = D.init_params(cfg, torch.Generator().manual_seed(3))
    _, mk = make_evaluator("dlrm-mlperf", smoke=True, device="cpu")
    feats = mk(300, fseed=1)
    dense, sparse = (torch.from_numpy(feats[k]) for k in ("dense", "sparse"))
    want = D.relevance_scores(params, cfg, dense, sparse)
    before = dot_interaction.launches
    got = D.relevance_scores(_to(params, dev), cfg, dense.to(dev),
                             sparse.to(dev))
    assert dot_interaction.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


def test_decode_on_card_matches_cpu(dev):
    cfg = get_config("smollm-135m", smoke=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (3, 9),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for d in ("cpu", dev):
        p = _to(params, d)
        _, cache = T.prefill(p, cfg, toks[:, :5].to(d), max_len=12)
        logits = []
        for t in range(5, 9):
            lg, cache = T.decode_step(p, cfg, toks[:, t].to(d), cache)
            logits.append(lg.cpu())
        out[str(d)] = torch.stack(logits)
    torch.testing.assert_close(out["cuda"], out["cpu"], atol=2e-3, rtol=0)


def _numpy_params(tree):
    if isinstance(tree, dict):
        return {k: _numpy_params(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_params(v) for v in tree]
    return tree.numpy()


@pytest.mark.parametrize("arch", ["bst", "mind", "two-tower-retrieval"])
def test_recsys_evaluators_on_card_match_cpu(dev, arch):
    """One set of seeded weights (drawn on the CPU) scores the same items
    on the card and on the CPU within 1e-4 of trust."""
    model = {"bst": BST, "mind": MIND, "two-tower-retrieval": TWO_TOWER}[arch]
    cfg = get_config(arch, smoke=True)
    params = _numpy_params(model.init_params(
        cfg, torch.Generator().manual_seed(3)))
    ev_c, mk = make_evaluator(arch, smoke=True, device="cpu", params=params)
    ev_g, _ = make_evaluator(arch, smoke=True, device=dev, params=params)
    feats = mk(300, fseed=1)
    want = ev_c({k: torch.from_numpy(v) for k, v in feats.items()})
    got = ev_g({k: torch.from_numpy(v).to(dev) for k, v in feats.items()})
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


def test_mirror_shard_retrieve_equals_primary_on_card(dev):
    """A fan-out mirror built by the export -> absorb round trip on the
    card ranks exactly as its primary: ids and float64 score bits."""
    corpus = SyntheticCorpus(n_docs=4096, vocab_size=512, seed=3)
    ret = CorpusRetrieval(corpus, n_partitions=8, block_docs=256,
                          device=dev)
    primary = ret.build_shard([1, 2, 5])
    mirror = mirror_shard_of(
        primary, [ret.partition_doc_ids(p) for p in (1, 2, 5)])
    assert mirror.device == primary.device == dev
    before = topk_select.launches
    qm = ZipfQueryModel.for_corpus(corpus, seed=4)
    for _ in range(24):
        q = qm.sample()
        d0, s0 = primary.retrieve(q, 64)
        d1, s1 = mirror.retrieve(q, 64)
        assert d0.tolist() == d1.tolist()
        assert s0.tobytes() == s1.tobytes()
    assert topk_select.launches == before + 48


@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
def test_ragged_embedding_bag_repeats_its_bits_on_card(dev, combiner):
    """The ragged bag's order-fixed reduction gives the same bits run
    after run on the card (``index_add_`` would not), and the CPU's
    within float32 rounding."""
    g = torch.Generator().manual_seed(5)
    table = {"table": torch.randn(5000, 64, generator=g)}
    flat = torch.randint(0, 5000, (20_000,), generator=g)
    seg = torch.randint(0, 700, (20_000,), generator=g)
    on_card = {"table": table["table"].to(dev)}
    outs = [E.ragged_embedding_bag(on_card, flat.to(dev), seg.to(dev), 701,
                                   combiner=combiner) for _ in range(3)]
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    cpu = E.ragged_embedding_bag(table, flat, seg, 701, combiner=combiner)
    torch.testing.assert_close(outs[0].cpu(), cpu, atol=1e-5, rtol=0)
    assert not outs[0][700].any()                          # an empty bag
