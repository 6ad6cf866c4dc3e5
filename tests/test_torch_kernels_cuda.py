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
its bits run after run on the card; the forward's warp-specialised
wgmma instance (long sequences: S around ``LONG_FROM``, odd lengths, D
64, 128 and 256, G 1, 2, 3 and 5, with and without the lse, two calls
equal bit for bit, a row whose every score is -inf; at D 256 gemma2's
window and biting softcap); its short instance (the evaluators' S 31:
S 1 to ``SHORT_TO``, G 1, 3, 5 and 8, pairs around the persistent grid,
the same checks, and the override that runs the replaced kernel); and
training: the forward's
log-sum-exp, both backward kernels (``flash_attention_bwd`` and
``dot_interaction_bwd``) against their plain versions within 2e-2 (bf16)
and 1e-4 (f32) of each output's max abs, and ``loss.backward()`` through
``attention`` and DLRM on CUDA reaching the weights with the plain
path's gradients. ``score_head`` (the fused scoring head, tied and
untied weights, d 64 / 576 / 2048, V 1000 / 49152 / 151936, P 7 and
3,072 x 31) within 1e-4 plus one bf16 ulp of the target's logit of the
plain chunked path (the transformer's own), rows whose logits reach
tens included; the transformer's head on the kernel at smollm-135m's,
qwen3-moe-30b-a3b's and qwen2.5-14b's (d 5120) published widths."""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import TrustIRConfig
from repro_torch.core import average_trust as AT
from repro_torch.core import trust_cache as TC
from repro_torch.core.fused_shedder import FusedLoadShedder
from repro_torch.core.shedder import TIER_CACHED, SimClock
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import score_head as SH
from repro_torch.launch import time_score_head as TSH
from repro_torch.kernels.dot_interaction import (dot_interaction,
                                                 dot_interaction_bwd,
                                                 dot_interaction_bwd_ref,
                                                 dot_interaction_ref,
                                                 group_size)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_ref,
                                                 flash_attention_lse_ref,
                                                 flash_attention_ref,
                                                 pad_head_dim)
from repro_torch.kernels.flash_decode import (flash_decode,
                                              flash_decode_ref, piece_length)
from repro_torch.kernels.shed_partition import (shed_partition,
                                                shed_partition_ref)
from repro_torch.kernels.topk_select import (NEG_INF, TILE, staged_capacity,
                                             topk_select, topk_select_ref)
from repro_torch.models import transformer as T
from repro_torch.models.attention import attention
from repro_torch.fanout import mirror_shard_of
from repro_torch.models.recsys import bst as BST
from repro_torch.models.recsys import dlrm as D
from repro_torch.models.recsys import embedding as E
from repro_torch.models.recsys import mind as MIND
from repro_torch.models.recsys import two_tower as TWO_TOWER
from repro_torch.retrieval import (CorpusRetrieval, SyntheticCorpus,
                                   ZipfQueryModel)
from repro_torch.serving.evaluators import make_evaluator
from repro_torch.training.tree import tree_map

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


@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,window,softcap,causal", [
    (64, 31, 8, 4, 256, 4096, 50.0, True),   # gemma2's evaluator, local
    (64, 31, 8, 4, 256, 0, 50.0, True),      # gemma2's evaluator, global
    (1, 700, 8, 4, 256, 256, 50.0, True),    # the window bites
    (2, 300, 8, 1, 256, 0, 0.0, True),       # G = 8: tiles of 4 warps
    (1, 130, 8, 4, 256, 0, 0.0, False),
    (32, 31, 40, 8, 128, 0, 0.0, True),      # qwen2.5-14b's heads
    (32, 31, 32, 4, 128, 0, 0.0, True),      # qwen3-moe's heads
    (32, 31, 16, 16, 128, 0, 0.0, True),     # moonshot's MHA heads: G = 1
    (5, 31, 8, 2, 12, 0, 0.0, True),         # qwen2.5 smoke: D 12 padded
    (2, 40, 8, 2, 12, 16, 30.0, True),
])
def test_flash_attention_kernel_new_head_dims_close_to_plain(
        dev, B, S, Hq, Hkv, D, window, softcap, causal, dtype, atol):
    """D 256 with Gemma-2's softcap and window, the D 128 heads of the
    Qwen models, and the D 12 smoke head zero-padded to 16 (one launch,
    output cut back to D 12)."""
    g = torch.Generator(device=dev).manual_seed(B + S + D)
    q, k, v = (torch.randn((B, S, h, D), generator=g, device=dev).to(dtype)
               for h in (Hq, Hkv, Hkv))
    kw = dict(causal=causal, window=window, softcap=softcap,
              sm_scale=0.0625 if D == 256 else None)
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


# q scaled so that q.k * scale has a spread of about 40: logits of 30 to
# 100+, where a softcap of 50 changes the softmax by far more than the
# tolerance (with unit q the logits stay near 1 and the cap barely moves)
BITE_Q = 40.0


@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,window,softcap", [
    (16, 31, 8, 4, 256, 4096, 50.0),     # gemma2's evaluator, local layer
    (16, 31, 8, 4, 256, 0, 50.0),        # gemma2's evaluator, global layer
    (1, 700, 8, 4, 256, 256, 50.0),      # the window bites as well
    (4, 77, 9, 3, 64, 0, 30.0),
    (2, 150, 8, 1, 128, 40, 20.0),
])
def test_flash_attention_kernel_softcap_bites(dev, B, S, Hq, Hkv, D, window,
                                              softcap, dtype, atol):
    """Logits far past the cap: the capped plain version moves by more
    than ten tolerances from the uncapped one, and the kernel stays
    within one of the capped."""
    g = torch.Generator(device=dev).manual_seed(B + S + D + 1)
    q, k, v = (torch.randn((B, S, h, D), generator=g, device=dev)
               for h in (Hq, Hkv, Hkv))
    q, k, v = (q * BITE_Q).to(dtype), k.to(dtype), v.to(dtype)
    kw = dict(causal=True, window=window, sm_scale=D ** -0.5)
    want = flash_attention_ref(q, k, v, softcap=softcap, **kw)
    uncapped = flash_attention_ref(q, k, v, softcap=0.0, **kw)
    assert (want.float() - uncapped.float()).abs().max() > 10 * atol
    got = flash_attention(q, k, v, softcap=softcap, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("B,L,Hq,Hkv,D,window,softcap", [
    (16, 8192, 8, 4, 256, 4096, 50.0),   # gemma2's decode, local layer
    (16, 8192, 8, 4, 256, 0, 50.0),      # gemma2's decode, global layer
    (3, 512, 8, 1, 128, 100, 30.0),
    (3, 100, 6, 3, 32, 7, 5.0),
])
def test_flash_decode_kernel_softcap_bites(dev, B, L, Hq, Hkv, D, window,
                                           softcap, dtype, atol):
    """As the attention case above, for one query over a KV cache whose
    rows end before, at and past the window."""
    g = torch.Generator(device=dev).manual_seed(L + B + D + 1)
    q = (torch.randn((B, Hq, D), generator=g, device=dev) * BITE_Q).to(dtype)
    k, v = (torch.randn((B, L, Hkv, D), generator=g, device=dev).to(dtype)
            for _ in range(2))
    lengths = torch.randint(1, L + 1, (B,), generator=g, device=dev,
                            dtype=torch.int32)
    lengths[:3] = torch.tensor([L, max(window, 1), 1], device=dev)[:B]
    kw = dict(window=window, sm_scale=D ** -0.5)
    want = flash_decode_ref(q, k, v, lengths, softcap=softcap, **kw)
    uncapped = flash_decode_ref(q, k, v, lengths, softcap=0.0, **kw)
    assert (want.float() - uncapped.float()).abs().max() > 10 * atol
    got = flash_decode(q, k, v, lengths, softcap=softcap, **kw)
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


@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("B,L,Hq,Hkv,D,window,softcap", [
    (16, 8192, 8, 4, 256, 4096, 50.0),     # gemma2's decode, local layer
    (16, 8192, 8, 4, 256, 0, 50.0),        # gemma2's decode, global layer
    (3, 700, 8, 1, 256, 100, 0.0),
    (4, 64, 8, 2, 12, 0, 0.0),             # qwen2.5 smoke: D 12 padded
    (4, 96, 8, 8, 128, 7, 0.0),            # moonshot's MHA heads
])
def test_flash_decode_kernel_new_head_dims_close_to_plain(
        dev, B, L, Hq, Hkv, D, window, softcap, dtype, atol):
    """D 256 with Gemma-2's window and softcap over rows both shorter and
    longer than the window, and the D 12 smoke head padded to 16."""
    g = torch.Generator(device=dev).manual_seed(L + B + D)
    q = torch.randn((B, Hq, D), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((B, L, Hkv, D), generator=g, device=dev).to(dtype)
            for _ in range(2))
    lengths = torch.randint(1, L + 1, (B,), generator=g, device=dev,
                            dtype=torch.int32)
    lengths[:3] = torch.tensor([0, L, max(window, 1)], device=dev)[:B]
    kw = dict(window=window, softcap=softcap,
              sm_scale=0.0625 if D == 256 else None)
    before = flash_decode.launches
    got = flash_decode(q, k, v, lengths, **kw)
    want = flash_decode_ref(q, k, v, lengths, **kw)
    assert flash_decode.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


def _tma_lengths(spread, B, L, window, g, dev):
    """Spreads of lengths for the TMA instance's tile split: one row at L
    and the rest at 1, every row at L, a window edge (rows at the
    window, one past it, and the tile edges around it), and the edges (0,
    1, L, L - 1, a tile, a tile + 1) among random lengths."""
    if spread == "one_long":
        lengths = torch.ones(B, dtype=torch.int32, device=dev)
        lengths[B // 2] = L
    elif spread == "all_full":
        lengths = torch.full((B,), L, dtype=torch.int32, device=dev)
    else:
        lengths = torch.randint(1, L + 1, (B,), generator=g, device=dev,
                                dtype=torch.int32)
        edges = ([window, window + 1, window + 64, window - 63, L]
                 if spread == "window_edge" else [0, 1, L, L - 1, 64, 65])
        lengths[:len(edges)] = torch.tensor(edges, device=dev)
    return lengths


@pytest.mark.parametrize("G", [1, 2, 8])
@pytest.mark.parametrize("spread,window", [
    ("one_long", 0), ("all_full", 0), ("window_edge", 300), ("edges", 0),
    ("edges", 100)])
def test_flash_decode_tma_instance_length_spreads(dev, spread, window, G):
    """The TMA instance (bf16, D 256) within 2e-2 of the plain version
    over the spreads of ``_tma_lengths``, G 1, 2 and 8, one launch a call
    on the instance ``tma_instance`` names."""
    B, L, Hkv, D = 48, 1500, 2, 256
    g = torch.Generator(device=dev).manual_seed(G + window)
    q = torch.randn((B, G * Hkv, D), generator=g, device=dev)
    k, v = (torch.randn((B, L, Hkv, D), generator=g, device=dev)
            for _ in range(2))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    lengths = _tma_lengths(spread, B, L, window, g, dev)
    kw = dict(window=window, softcap=50.0, sm_scale=0.0625)
    assert FD.instance(G, D, torch.bfloat16) == "tma"
    before = dict(flash_decode.by_instance)
    got = flash_decode(q, k, v, lengths, **kw)
    want = flash_decode_ref(q, k, v, lengths, **kw)
    assert flash_decode.by_instance["tma"] == before["tma"] + 1
    assert flash_decode.by_instance["pieces"] == before["pieces"]
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)
    if spread == "edges":
        assert not got[0].any()             # length 0: zeros


@pytest.mark.parametrize("B,L,Hq,Hkv,window,softcap", [
    (16, 8192, 8, 4, 4096, 50.0),           # gemma2's decode, local layer
    (16, 8192, 8, 4, 0, 50.0),              # gemma2's decode, global layer
    (3, 40, 8, 4, 0, 0.0),                  # a cache shorter than a tile
    (5, 130, 16, 2, 7, 0.0),                # G 8, a window inside a tile
    (200, 300, 8, 4, 0, 50.0),              # more rows than consumers
])
def test_flash_decode_tma_instance_close_to_plain(dev, B, L, Hq, Hkv,
                                                  window, softcap):
    """Both instances forced at the same inputs: each within 2e-2 of the
    plain version, the lse instance's o equal to the serving one's bit
    for bit and its lse within 2e-2 of the plain lse (-inf at length 0),
    and two calls equal bit for bit."""
    g = torch.Generator(device=dev).manual_seed(B + L + Hq)
    q = torch.randn((B, Hq, 256), generator=g, device=dev)
    k, v = (torch.randn((B, L, Hkv, 256), generator=g, device=dev)
            for _ in range(2))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    lengths = torch.randint(1, L + 1, (B,), generator=g, device=dev,
                            dtype=torch.int32)
    lengths[:3] = torch.tensor([0, L, max(window, 1)], device=dev)
    kw = dict(window=window, softcap=softcap, sm_scale=0.0625)
    want, lse_ref = flash_decode_ref(q, k, v, lengths, return_lse=True, **kw)
    for kernel in ("tma", "pieces"):
        got = flash_decode(q, k, v, lengths, kernel=kernel, **kw)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=0)
    got = flash_decode(q, k, v, lengths, **kw)
    assert torch.equal(got, flash_decode(q, k, v, lengths, **kw))
    o, lse = flash_decode(q, k, v, lengths, return_lse=True, **kw)
    assert torch.equal(o, got)
    assert torch.isneginf(lse[0]).all() and torch.isneginf(lse_ref[0]).all()
    torch.testing.assert_close(lse[1:], lse_ref[1:], atol=2e-2, rtol=0)


@pytest.mark.parametrize("window", [0, 100])
def test_flash_decode_tma_instance_never_reads_nan_past_the_valid_range(
        dev, window):
    """NaN in the caches past every row's length and before its window
    (the rows read past the length share the last tile with valid ones)
    leaves the output equal to the unpoisoned call's, bit for bit."""
    B, L, Hq, Hkv = 6, 700, 8, 4
    g = torch.Generator(device=dev).manual_seed(window + 3)
    q = torch.randn((B, Hq, 256), generator=g, device=dev)
    k, v = (torch.randn((B, L, Hkv, 256), generator=g, device=dev)
            for _ in range(2))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    lengths = torch.tensor([1, 63, 64, 65, 333, 650], dtype=torch.int32,
                           device=dev)
    kw = dict(window=window, softcap=50.0, sm_scale=0.0625)
    clean = flash_decode(q, k, v, lengths, **kw)
    want = flash_decode_ref(q, k, v, lengths, **kw)
    pos = torch.arange(L, device=dev)[None, :]
    bad = pos >= lengths[:, None]
    if window:
        bad |= pos < lengths[:, None] - window
    k[bad], v[bad] = float("nan"), float("nan")
    got = flash_decode(q, k, v, lengths, **kw)
    assert torch.equal(got, clean)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)


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


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2.5-14b",
                                  "qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b",
                                  "gcn-cora"])
def test_new_evaluators_on_card_match_cpu(dev, arch):
    """The smoke-width evaluators of the other families (float32;
    attention at D 16, D 12 padded to 16) on the card and on the CPU,
    one set of weights: trust within 1e-4."""
    from repro_torch.models import gnn as G
    model = G if arch == "gcn-cora" else T
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


@pytest.mark.parametrize("aggregator", ["sum", "max"])
def test_gcn_propagate_repeats_its_bits_on_card(dev, aggregator):
    """The GCN's ordered segment sums give the same bits run after run
    on the card, with one node taking thousands of edges (as the fused
    step's padded rows give it) and ids past the graph dropped; the
    CPU's within float32 rounding."""
    from repro_torch.models import gnn as G
    g = torch.Generator().manual_seed(7)
    n = 3000
    x = torch.randn(n, 48, generator=g)
    ei = torch.randint(0, n, (2, 30_000), generator=g)
    ei[1, :8000] = 17                                  # a skewed segment
    ei[:, -50:] += n                                   # out of range
    outs = [G.propagate(x.to(dev), ei.to(dev), aggregator=aggregator)
            for _ in range(3)]
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    cpu = G.propagate(x, ei, aggregator=aggregator)
    torch.testing.assert_close(outs[0].cpu(), cpu, atol=1e-5, rtol=0)


# --- training: the forward's log-sum-exp and the two backward kernels ------
# Tolerances relative to each output's max abs: 2e-2 in bf16 (dS and P
# rounded to bf16 as the products' A operand, outputs rounded to bf16),
# 1e-4 in f32 (summation order).

BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
BWD_CASES = [
    # B, S, Hq, Hkv, D, window, softcap, causal
    (2, 37, 9, 3, 64, 0, 0.0, True),        # GQA 9/3, ragged tiles
    (1, 200, 4, 2, 16, 0, 0.0, True),       # smoke heads
    (1, 300, 8, 4, 128, 40, 0.0, True),     # window
    (2, 70, 8, 4, 256, 0, 50.0, True),      # D 256, softcap
    (1, 150, 8, 1, 64, 32, 20.0, True),     # G 8, window + softcap
    (1, 130, 4, 4, 128, 0, 0.0, False),     # MHA, not causal
    (1, 40, 8, 2, 12, 16, 30.0, True),      # D 12: padded to 16
    # the warpgroup kernel's tile edges (128 keys, 64 query positions)
    (1, 127, 9, 3, 64, 0, 0.0, True),       # S = Bc - 1
    (2, 129, 9, 3, 64, 0, 0.0, True),       # S = Bc + 1
    (1, 257, 4, 4, 64, 0, 0.0, True),       # S = 2 Bc + 1, G 1
    (1, 257, 6, 2, 128, 0, 0.0, True),      # G 3 at D 128
    (1, 200, 10, 2, 64, 0, 0.0, True),      # G 5
    (1, 129, 8, 1, 128, 0, 0.0, True),      # G 8 at D 128
    (1, 700, 6, 2, 64, 100, 0.0, True),     # window: whole key tiles out
    (1, 600, 8, 4, 128, 130, 0.0, True),    # the same at D 128
    (1, 257, 6, 2, 128, 0, 0.0, False),     # D 128, not causal
    (1, 300, 4, 2, 64, 64, 0.0, False),     # not causal, window
    (1, 1024, 9, 3, 64, 0, 0.0, True),      # the training shape, B 1 S 1024
    # D 256's warpgroup kernel (64 keys a work tile, 32-position query
    # tiles, the two warpgroups 128 columns each)
    (1, 31, 8, 4, 256, 0, 50.0, True),      # S < Br
    (2, 32, 8, 4, 256, 0, 0.0, True),       # S = Br
    (1, 33, 8, 8, 256, 0, 50.0, True),      # S = Br + 1, G 1
    (1, 63, 8, 1, 256, 0, 0.0, True),       # S = Bc - 1, G 8
    (1, 65, 4, 2, 256, 0, 50.0, False),     # S = Bc + 1, not causal
    (1, 129, 8, 4, 256, 0, 50.0, True),     # S = 2 Bc + 1
    (1, 300, 8, 4, 256, 40, 50.0, True),    # window: whole key tiles out
    (1, 257, 4, 4, 256, 70, 0.0, False),    # not causal, window, G 1
    # D 16's warpgroup kernel (two pipelines a block, 128 keys a work
    # tile as two 64-key halves, 64-position query tiles)
    (2, 63, 9, 3, 16, 0, 0.0, True),        # S = Br - 1, G 3
    (1, 65, 8, 1, 16, 0, 0.0, True),        # S = Br + 1, G 8
    (1, 300, 6, 2, 16, 0, 0.0, False),      # not causal, G 3
    (1, 300, 8, 8, 16, 40, 0.0, True),      # a window inside a tile, G 1
    (2, 129, 4, 2, 16, 0, 30.0, True),      # softcap 30, S = Bc + 1
    (1, 257, 8, 1, 16, 100, 30.0, False),   # window + softcap, G 8
]


def _rel_close(got, want, tol, what):
    scale = max(float(want.float().abs().max()), 1e-6)
    err = float((got.float() - want.float()).abs().max())
    assert torch.isfinite(got.float()).all() and err <= tol * scale, (
        what, err, scale)


def _attn_inputs(dev, B, S, Hq, Hkv, D, dtype, seed, q_mult=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn((B, S, h, D), generator=g, device=dev)
                   for h in (Hq, Hkv, Hkv, Hq))
    return (q * q_mult).to(dtype), k.to(dtype), v.to(dtype), do.to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,window,softcap,causal", BWD_CASES)
def test_flash_attention_lse_matches_plain(dev, B, S, Hq, Hkv, D, window,
                                           softcap, causal, dtype):
    if D < 16:
        pytest.skip("the kernel sees D 12 padded; covered by the backward")
    q, k, v, _ = _attn_inputs(dev, B, S, Hq, Hkv, D, dtype, S)
    kw = dict(causal=causal, window=window, softcap=softcap,
              sm_scale=D ** -0.5)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=dev)
    before = flash_attention.launches
    o = FA._forward(q, k, v, lse=lse, **kw)
    assert flash_attention.launches == before + 1
    if FA.instance(S, Hq // Hkv, D, dtype, window=window,
                   softcap=softcap) in ("wgmma", "short"):
        # the wgmma and short instances round P to bf16 once where they
        # write the lse (as the reference does) and split it where they do
        # not: the two o differ by P's rounding, each within the tolerance
        # of the plain
        torch.testing.assert_close(
            o.float(), flash_attention_ref(q, k, v, **kw).float(),
            atol=BWD_TOL[dtype], rtol=0)
    else:
        torch.testing.assert_close(o, flash_attention(q, k, v, **kw))
    want = flash_attention_lse_ref(q, k, **kw)
    torch.testing.assert_close(lse, want, atol=1e-3 if dtype ==
                               torch.bfloat16 else 1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,window,softcap,causal", BWD_CASES)
def test_flash_attention_bwd_kernel_close_to_plain(dev, B, S, Hq, Hkv, D,
                                                   window, softcap, causal,
                                                   dtype):
    """Autograd through ``flash_attention`` on CUDA (the forward kernel
    with its lse, then the backward kernel) against the plain backward on
    the same o and lse; the softcap cases scale q so that the cap
    bites."""
    q, k, v, do = _attn_inputs(dev, B, S, Hq, Hkv, D, dtype, S + D,
                               q_mult=8.0 if softcap else 1.0)
    kw = dict(causal=causal, window=window, softcap=softcap)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = flash_attention_bwd.launches
    o = flash_attention(*leaves, **kw)
    assert o.grad_fn is not None
    o.backward(do)
    assert flash_attention_bwd.launches == before + 1
    qp, kp, vp, dop = pad_head_dim(q, k, v, do)
    kw_d = dict(kw, sm_scale=D ** -0.5)      # the unpadded head's scale
    lse = flash_attention_lse_ref(qp, kp, **kw_d)
    op = pad_head_dim(flash_attention_ref(q, k, v, **kw))[0]
    want = flash_attention_bwd_ref(qp, kp, vp, op, lse, dop, **kw_d)
    for t, w, name in zip(leaves, want, ("dq", "dk", "dv")):
        assert t.grad.dtype == dtype
        _rel_close(t.grad, w[..., :D], BWD_TOL[dtype], name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [16, 64, 128, 256])
def test_flash_attention_bwd_kernel_row_that_saw_no_key(dev, D, dtype):
    """A row handed an lse of -inf gives and gets no gradient (zeros, not
    NaN), as the plain version."""
    B, S, Hq, Hkv = 1, 90, 4, 2
    q, k, v, do = _attn_inputs(dev, B, S, Hq, Hkv, D, dtype, 7)
    kw = dict(causal=True, window=24, softcap=0.0)
    o = flash_attention(q, k, v, **kw)
    lse = flash_attention_lse_ref(q, k, **kw)
    lse[0, 1, 50] = float("-inf")
    lse[0, 3, 0] = float("-inf")
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    assert float(got[0][0, 50, 1].float().abs().max()) == 0.0
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        _rel_close(g, w, BWD_TOL[dtype], name)


@pytest.mark.parametrize("D", [16, 64, 128, 256])
def test_flash_attention_bwd_kernel_repeats_its_bits(dev, D):
    """Two calls give the same bits (dq is added in a fixed order), with a
    call at another shape in between, so that a counter or an accumulator
    left set by one call would show in the next."""
    q, k, v, do = _attn_inputs(dev, 2, 300, 8, 2, D, torch.bfloat16, 11)
    o = flash_attention(q, k, v, causal=True)
    lse = flash_attention_lse_ref(q, k, causal=True)
    first = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    q2, k2, v2, do2 = _attn_inputs(dev, 1, 200, 4, 4, D, torch.bfloat16, 12)
    o2 = flash_attention(q2, k2, v2, causal=False)
    flash_attention_bwd(q2, k2, v2, o2,
                        flash_attention_lse_ref(q2, k2, causal=False), do2,
                        causal=False)
    again = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    for a, b in zip(first, again):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("G", [1, 3, 8])
def test_flash_attention_bwd_d16_one_position(dev, G):
    """S 1 at D 16 (a query tile and a key tile of one live row each): a
    row sees its one key, so P is 1, dS is 0 and dq, dk are 0 up to
    rounding; dv is do summed over the group, within BWD_TOL of the plain
    version's max abs, and dq, dk within BWD_TOL of it as well."""
    q, k, v, do = _attn_inputs(dev, 2, 1, 2 * G, 2, 16, torch.bfloat16, G)
    o = flash_attention(q, k, v, causal=True)
    lse = flash_attention_lse_ref(q, k, causal=True)
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    _rel_close(dv, want[2], BWD_TOL[torch.bfloat16], "dv")
    scale = float(want[2].float().abs().max())
    for g, name in ((dq, "dq"), (dk, "dk")):
        err = float(g.float().abs().max())
        assert torch.isfinite(g.float()).all() and \
            err <= BWD_TOL[torch.bfloat16] * scale, (name, err, scale)


def test_flash_attention_bwd_d16_operand_layouts(dev):
    """The D 16 instance's operands (rows of 16 bf16, TMA-loaded 32-byte
    swizzled) through the kernel's own helpers, against plain products:
    S^T = K Q^T (K-major, both 64-key halves), dV += P^T dO (m64n16, A
    from registers, B MN-major) and dQ = dS K (m64n16, dS^T through
    shared memory, K MN-major). A wrong descriptor permutes rows or
    columns with no fault."""
    import ctypes
    from repro_torch.kernels._build import library_function
    fn = library_function("flash_attention_bwd",
                          "flash_attention_bwd_d16_probe",
                          [ctypes.c_void_p] * 7)
    g = torch.Generator(device=dev).manual_seed(16)
    x, y, w = (torch.randn((n, 16), generator=g, device=dev)
               .to(torch.bfloat16) for n in (128, 64, 128))
    s = torch.empty((128, 64), device=dev)
    pw = torch.empty((128, 16), device=dev)
    dq = torch.empty((64, 16), device=dev)
    err = fn(x.data_ptr(), y.data_ptr(), w.data_ptr(), s.data_ptr(),
             pw.data_ptr(), dq.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    torch.testing.assert_close(s, x.float() @ y.float().T, atol=1e-4,
                               rtol=1e-5)
    p = s.to(torch.bfloat16).float()       # as the kernel packs its A
    want_pw = torch.cat([p[:64] @ w[:64].float(), p[64:] @ w[:64].float()])
    # summation order only (a layout fault is off by the operands' size)
    torch.testing.assert_close(pw, want_pw, atol=1e-2, rtol=1e-5)
    torch.testing.assert_close(dq, p.T @ w.float(), atol=1e-2, rtol=1e-5)


def test_flash_attention_bwd_d16_takes_the_warpgroup_kernel(dev):
    """A bf16 D 16 call takes the warpgroup kernel: its workspace is the
    warpgroup layout (dq_acc padded to 64-position query tiles, Di, the
    lse in log2 units, the counters and the dispenser), not the Di pass's
    (B, Hq, S) of the mma.sync kernels it replaced; float32 keeps Di."""
    B, S, Hq = 2, 300, 9
    s_pad = -(-S // 64) * 64
    want = 4 * (B * Hq * s_pad * 16 + 2 * B * Hq * s_pad
                + B * Hq * (s_pad // 64) + 1)
    assert FA.workspace_bytes(B, S, Hq, 16, torch.bfloat16) == want
    assert FA.workspace_bytes(B, S, Hq, 16, torch.float32) == 4 * B * Hq * S


# --- the forward's wgmma instance (long sequences) --------------------------
# S just below, at and above LONG_FROM (below it the mma.sync instance
# runs: the rule's edge), odd lengths, D 64, 128 and 256, G 1, 2, 3 and
# 5, causal or not; bf16 within 2e-2 of the plain output, the lse within
# 1e-3 of the plain log-sum-exp.

LONG_CASES = [
    # B, S, Hq, Hkv, D, causal
    (1, FA.LONG_FROM - 1, 9, 3, 64, True),
    (1, FA.LONG_FROM, 9, 3, 64, True),
    (2, FA.LONG_FROM + 1, 9, 3, 64, True),
    (1, 257, 4, 4, 64, False),              # G 1
    (1, 1000, 10, 2, 64, True),             # G 5, an odd length
    (2, 1000, 9, 3, 64, False),
    (1, FA.LONG_FROM - 1, 6, 2, 128, True),
    (1, FA.LONG_FROM, 6, 2, 128, True),     # G 3 at D 128
    (1, 257, 8, 8, 128, True),              # G 1
    (1, 1000, 10, 2, 128, False),           # G 5
    (2, 1000, 6, 2, 128, True),
    (1, FA.LONG_FROM - 1, 8, 4, 256, True),  # gemma2's heads
    (1, 257, 8, 4, 256, True),
    (1, 4095, 8, 4, 256, True),
    (1, 8000, 8, 4, 256, True),
    (1, 300, 4, 4, 256, False),             # G 1
]


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal", LONG_CASES)
def test_flash_attention_long_instance_close_to_plain(dev, B, S, Hq, Hkv, D,
                                                      causal, with_lse):
    """The instance the rule picks against the plain version, and two
    calls equal bit for bit (a training restart repeats its bits)."""
    assert FA.long_instance(S, D, torch.bfloat16) == (S >= FA.LONG_FROM)
    q, k, v, _ = _attn_inputs(dev, B, S, Hq, Hkv, D, torch.bfloat16, S + D)
    kw = dict(causal=causal, window=0, softcap=0.0, sm_scale=D ** -0.5)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=dev)
    given = lse if with_lse else None
    before = flash_attention.launches
    got = FA._forward(q, k, v, lse=given, **kw)
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(got.float(),
                               flash_attention_ref(q, k, v, **kw).float(),
                               atol=2e-2, rtol=0)
    if with_lse:
        first_lse = lse.clone()
        torch.testing.assert_close(lse, flash_attention_lse_ref(q, k, **kw),
                                   atol=1e-3, rtol=0)
    again = FA._forward(q, k, v, lse=given, **kw)
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    if with_lse:
        assert torch.equal(first_lse, lse)


# gemma2's heads (D 256) on the wgmma instance with its window and
# softcap: a window inside a 32-key tile (100) and gemma2's 4096 at S
# 8000, the softcap biting (q scaled by BITE_Q: logits of spread ~40 meet
# the cap of 50, which then moves the plain output by more than ten
# tolerances), GQA 8/4 and G 1, causal or not, and a window of S (as
# none).
WINDOW_CASES = [
    # B, S, Hq, Hkv, window, softcap, q_mult, causal
    (1, 257, 8, 4, 100, 50.0, 1.0, True),
    (1, 4095, 8, 4, 100, 50.0, BITE_Q, True),
    (1, 8000, 8, 4, 4096, 50.0, 1.0, True),
    (1, 8000, 8, 4, 4096, 50.0, BITE_Q, True),
    (2, 1000, 4, 4, 100, 50.0, BITE_Q, True),      # G 1
    (1, 600, 8, 4, 0, 50.0, BITE_Q, True),         # gemma2's global layers
    (1, 600, 8, 4, 100, 0.0, 1.0, False),          # a window alone
    (2, 4096, 8, 4, 4096, 50.0, 1.0, True),        # gemma2's training
]


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("B,S,Hq,Hkv,window,softcap,q_mult,causal",
                         WINDOW_CASES)
def test_flash_attention_long_instance_window_softcap_close_to_plain(
        dev, B, S, Hq, Hkv, window, softcap, q_mult, causal, with_lse):
    """The D 256 wgmma instance with a window and a softcap against the
    plain version, and two calls equal bit for bit."""
    D = 256
    assert FA.long_instance(S, D, torch.bfloat16, window=window,
                            softcap=softcap)
    q, k, v, _ = _attn_inputs(dev, B, S, Hq, Hkv, D, torch.bfloat16,
                              S + window, q_mult)
    kw = dict(causal=causal, window=window, softcap=softcap,
              sm_scale=D ** -0.5)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=dev)
    given = lse if with_lse else None
    before = flash_attention.launches
    got = FA._forward(q, k, v, lse=given, **kw)
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v, **kw).float()
    torch.testing.assert_close(got.float(), want, atol=BWD_TOL[q.dtype],
                               rtol=0)
    if q_mult != 1.0:
        uncapped = flash_attention_ref(q, k, v, **{**kw, "softcap": 0.0})
        assert float((uncapped.float() - want).abs().max()) > \
            10 * BWD_TOL[q.dtype]
    if with_lse:
        first_lse = lse.clone()
        torch.testing.assert_close(lse, flash_attention_lse_ref(q, k, **kw),
                                   atol=1e-3, rtol=0)
    again = FA._forward(q, k, v, lse=given, **kw)
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    if with_lse:
        assert torch.equal(first_lse, lse)


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_attention_long_instance_row_that_sees_no_key(dev, D,
                                                            with_lse):
    """A row whose every score is -inf (its q is -inf on a column where
    every key is 1, as if a mask hid every key from it): zeros and an lse
    of -inf, as the plain version, and the other rows unmoved. No causal
    mask leaves a row of this instance without a key: each sees its own
    position."""
    B, S, Hq, Hkv = 1, 300, 6, 2
    q, k, v, _ = _attn_inputs(dev, B, S, Hq, Hkv, D, torch.bfloat16, 5)
    k[..., 0] = 1.0
    q[0, 100, 2] = 0.0
    q[0, 100, 2, 0] = float("-inf")
    assert FA.long_instance(S, D, torch.bfloat16)
    kw = dict(causal=True, window=0, softcap=0.0, sm_scale=D ** -0.5)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=dev)
    got = FA._forward(q, k, v, lse=lse if with_lse else None, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    assert float(want[0, 100, 2].float().abs().max()) == 0.0
    assert torch.equal(got[0, 100, 2], torch.zeros_like(got[0, 100, 2]))
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)
    if with_lse:
        assert float(lse[0, 2, 100]) == float("-inf")
        torch.testing.assert_close(lse, flash_attention_lse_ref(q, k, **kw),
                                   atol=1e-3, rtol=0)


# --- the forward's short instance (the evaluators' S 31) -------------------
# The persistent TMA-fed kernel that ``short_instance`` sends bf16 calls at
# D 64 and 128 with no window or softcap to, from S 1 to SHORT_TO with up
# to four 64-row tiles of packed rows: G 1, 3, 5 and 8; S 1, 16, 31 and
# SHORT_TO; causal or not; serving (P split) and with the lse (bf16 P
# once): o within BWD_TOL of the plain output, the lse within 1e-3; two
# calls equal bit for bit.

SHORT_CASES = [
    # B, S, Hq, Hkv, D, causal
    (3, 31, 9, 3, 64, True),                # smollm's evaluator
    (2, 1, 9, 3, 64, True),                 # one position
    (5, 16, 9, 3, 64, False),
    (4, FA.SHORT_TO, 9, 3, 64, True),       # one whole key tile
    (3, 31, 10, 2, 128, True),              # G 5: qwen2.5's packed rows
    (2, 31, 16, 2, 128, True),              # G 8: qwen3-moe's
    (3, 31, 4, 4, 128, True),               # G 1: moonshot's
    (2, FA.SHORT_TO, 16, 2, 128, False),    # G 8 at 32: four whole tiles
    (3, 16, 8, 8, 64, True),                # G 1 at D 64
    (2, 1, 16, 2, 128, False),
    (7, 31, 24, 3, 64, True),               # G 8 at D 64
    (3, 31, 15, 3, 128, False),             # G 5, not causal
]


def _short_forward(dev, B, S, Hq, Hkv, D, causal, with_lse, seed):
    """The short instance's o (and lse) at one shape, after checking that
    the rule sends the shape there and that the call launches once."""
    assert FA.instance(S, Hq // Hkv, D, torch.bfloat16) == "short"
    q, k, v, _ = _attn_inputs(dev, B, S, Hq, Hkv, D, torch.bfloat16, seed)
    kw = dict(causal=causal, window=0, softcap=0.0, sm_scale=D ** -0.5)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=dev)
    given = lse if with_lse else None
    before = dict(flash_attention.by_instance)
    got = FA._forward(q, k, v, lse=given, **kw)
    assert flash_attention.by_instance["short"] == before["short"] + 1
    return (q, k, v), kw, got, given


def _assert_short_close(qkv, kw, got, lse):
    q, k, _ = qkv
    torch.testing.assert_close(got.float(),
                               flash_attention_ref(*qkv, **kw).float(),
                               atol=BWD_TOL[q.dtype], rtol=0)
    if lse is not None:
        torch.testing.assert_close(lse, flash_attention_lse_ref(q, k, **kw),
                                   atol=1e-3, rtol=0)


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal", SHORT_CASES)
def test_flash_attention_short_instance_close_to_plain(dev, B, S, Hq, Hkv, D,
                                                       causal, with_lse):
    """The short instance against the plain version, and two calls equal
    bit for bit (o, and the lse where it writes one)."""
    qkv, kw, got, lse = _short_forward(dev, B, S, Hq, Hkv, D, causal,
                                       with_lse, S + Hq + D)
    _assert_short_close(qkv, kw, got, lse)
    first_lse = None if lse is None else lse.clone()
    again = FA._forward(*qkv, lse=lse, **kw)
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    if lse is not None:
        assert torch.equal(first_lse, lse)


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("G,D", [(3, 64), (8, 128)])
@pytest.mark.parametrize("pairs", ["below_grid", "at_grid", "above_grid",
                                   "many_rounds"])
def test_flash_attention_short_instance_grid_edges(dev, pairs, G, D,
                                                   with_lse):
    """(batch row, KV head) pairs below, at and one past the persistent
    grid (one block an SM, its consumer warpgroups taking the pairs in
    turn, so one past the grid gives block 0 a second pair), and many
    rounds of the ring (the engine's batch)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    Hkv = 1
    B = {"below_grid": sms - 1, "at_grid": sms, "above_grid": sms + 1,
         "many_rounds": 3072}[pairs]
    qkv, kw, got, lse = _short_forward(dev, B, 31, G * Hkv, Hkv, D, True,
                                       with_lse, B + G)
    _assert_short_close(qkv, kw, got, lse)


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_attention_short_instance_row_that_sees_no_key(dev, D,
                                                             with_lse):
    """A row whose every score is -inf (its q is -inf on a column where
    every key is 1): zeros and an lse of -inf, as the plain version, and
    the other rows unmoved."""
    B, S, Hq, Hkv = 2, 31, 9, 3
    q, k, v, _ = _attn_inputs(dev, B, S, Hq, Hkv, D, torch.bfloat16, 9)
    k[..., 0] = 1.0
    q[1, 20, 4] = 0.0
    q[1, 20, 4, 0] = float("-inf")
    assert FA.instance(S, Hq // Hkv, D, torch.bfloat16) == "short"
    kw = dict(causal=True, window=0, softcap=0.0, sm_scale=D ** -0.5)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=dev)
    got = FA._forward(q, k, v, lse=lse if with_lse else None, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    assert float(want[1, 20, 4].float().abs().max()) == 0.0
    assert torch.equal(got[1, 20, 4], torch.zeros_like(got[1, 20, 4]))
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)
    if with_lse:
        assert float(lse[1, 4, 20]) == float("-inf")
        torch.testing.assert_close(lse, flash_attention_lse_ref(q, k, **kw),
                                   atol=1e-3, rtol=0)


def test_flash_attention_short_instance_repeats_its_bits_in_turns(dev):
    """Many calls in turns at two shapes of different geometry (smollm's
    engine batch at D 64, qwen3-moe's drain batch at D 128, serving and
    with the lse): every call gives the first call's bits, so no call
    leaves state (a barrier phase, a stage) that moves the next."""
    shapes = [_attn_inputs(dev, 3072, 31, 9, 3, 64, torch.bfloat16, 1)[:3],
              _attn_inputs(dev, 2048, 31, 32, 4, 128, torch.bfloat16, 2)[:3]]
    first = {}
    for turn in range(6):
        for j, (q, k, v) in enumerate(shapes):
            for with_lse in (False, True):
                lse = (torch.empty((q.shape[0], q.shape[2], 31),
                                   dtype=torch.float32, device=dev)
                       if with_lse else None)
                o = FA._forward(q, k, v, True, 0, 0.0, q.shape[-1] ** -0.5,
                                lse)
                got = (o.view(torch.int16), lse)
                key = (j, with_lse)
                if key not in first:
                    first[key] = got
                    continue
                assert torch.equal(got[0], first[key][0]), (turn, key)
                if with_lse:
                    assert torch.equal(got[1], first[key][1]), (turn, key)


def test_flash_attention_short_instance_override_runs_the_old_kernel(dev):
    """``short_to=NEVER_SHORT`` at an evaluator shape launches the
    ``mma.sync`` instance (counted under its name), which the timings
    set beside the short one."""
    q, k, v, _ = _attn_inputs(dev, 4, 31, 40, 8, 128, torch.bfloat16, 3)
    kw = dict(causal=True, window=0, softcap=0.0, sm_scale=128 ** -0.5)
    before = dict(flash_attention.by_instance)
    old = FA._forward(q, k, v, short_to=FA.NEVER_SHORT, **kw)
    new = FA._forward(q, k, v, **kw)
    assert flash_attention.by_instance["mma.sync"] == before["mma.sync"] + 1
    assert flash_attention.by_instance["short"] == before["short"] + 1
    want = flash_attention_ref(q, k, v, **kw).float()
    for got in (old, new):
        torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=0)


# The row slices of 7 output rows (F 2, 7, 27, 33) and the column widths
# (D 5 takes the scalar path, 12 and 128 the 16-byte one in f32).
DOT_BWD_EDGES = [(9, n_f, d) for n_f in (2, 7, 27, 33) for d in (5, 12, 128)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,F,D", [(37, 27, 128), (200, 27, 128),
                                   (16, 8, 64), (5, 12, 32), (3, 2, 16),
                                   (4, 1, 8), (33, 27, 127)]
                         + DOT_BWD_EDGES)
def test_dot_interaction_bwd_kernel_close_to_plain(dev, B, F, D, dtype):
    g = torch.Generator(device=dev).manual_seed(B + F + D)
    x = (torch.randn((B, F, D), generator=g, device=dev) * D ** -0.5).to(dtype)
    gr = torch.randn((B, F * (F - 1) // 2), generator=g, device=dev).to(dtype)
    leaf = x.clone().requires_grad_(True)
    out = dot_interaction(leaf)
    assert out.grad_fn is not None
    before = dot_interaction_bwd.launches
    out.backward(gr)
    assert dot_interaction_bwd.launches == before + 1
    want = dot_interaction_bwd_ref(x, gr)
    assert leaf.grad.dtype == dtype
    _rel_close(leaf.grad, want, BWD_TOL[dtype], "dx")
    first = dot_interaction_bwd(x, gr)
    assert torch.equal(first, dot_interaction_bwd(x, gr))   # repeats its bits


def test_attention_backward_reaches_the_projections(dev):
    """``loss.backward()`` through the model's ``attention`` on CUDA (the
    kernels) gives wq, wk, wv non-zero gradients equal to the plain path's
    on the CPU: the wrapper no longer detaches its output."""
    g = torch.Generator().manual_seed(3)
    B, S, d, Hq, Hkv, D = 2, 40, 32, 4, 2, 16
    x = torch.randn((B, S, d), generator=g)
    ws = [torch.randn((d, h * D), generator=g) * d ** -0.5
          for h in (Hq, Hkv, Hkv)]
    w_out = torch.randn((B, S, Hq, D), generator=g)
    grads = {}
    for device in ("cpu", dev):
        leaves = [w.detach().clone().to(device).requires_grad_(True)
                  for w in ws]
        xd = x.to(device)
        q, k, v = (xd @ w for w in leaves)
        o = attention(q.reshape(B, S, Hq, D), k.reshape(B, S, Hkv, D),
                      v.reshape(B, S, Hkv, D), causal=True, window=8,
                      softcap=5.0)
        (o * w_out.to(device)).sum().backward()
        grads[str(device)] = [w.grad.cpu() for w in leaves]
    for got, want in zip(grads[str(dev)], grads["cpu"]):
        assert float(got.abs().max()) > 0
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_dlrm_backward_reaches_the_bottom_mlp(dev):
    """``loss.backward()`` through DLRM's ``loss_fn`` on CUDA (both
    ``dot_interaction`` kernels) gives the bottom MLP and every table the
    CPU plain path's gradients, non-zero."""
    cfg = get_config("dlrm-mlperf", smoke=True)
    params = D.init_params(cfg, torch.Generator().manual_seed(0))
    r = np.random.default_rng(5)
    batch = {"dense": r.normal(size=(64, cfg.n_dense)).astype(np.float32),
             "sparse": np.stack([r.integers(0, t.vocab, size=64)
                                 for t in cfg.tables], 1).astype(np.int64),
             "labels": (r.random(64) < 0.5).astype(np.float32)}
    grads = {}
    for device in ("cpu", dev):
        p = tree_map(lambda t: t.detach().clone().to(device)
                     .requires_grad_(True), params)
        b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        before = dot_interaction_bwd.launches
        D.loss_fn(p, cfg, b).backward()
        if device != "cpu":
            assert dot_interaction_bwd.launches == before + 1
        grads[str(device)] = [t.grad.cpu() for layer in p["bot_mlp"]["layers"]
                              for t in layer.values()] + [
            t["table"].grad.cpu() for t in p["tables"].values()]
    for got, want in zip(grads[str(dev)], grads["cpu"]):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    assert all(float(g.abs().max()) > 0 for g in grads[str(dev)][:2])


def test_kernels_without_a_backward_refuse_inputs_that_require_grad(dev):
    """On CUDA no kernel wrapper returns a result without a ``grad_fn``
    while an input requires grad: the two kernels with a backward go
    through their ``autograd.Function``, the three without one and the
    two backward kernels raise."""
    q = torch.randn((2, 4, 16), device=dev, requires_grad=True)
    cache = torch.randn((2, 8, 2, 16), device=dev)
    lengths = torch.full((2,), 8, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_decode(q, cache, cache, lengths)
    with torch.no_grad():
        flash_decode(q, cache, cache, lengths)
    with pytest.raises(RuntimeError, match="no backward"):
        topk_select(torch.randn(100, device=dev, requires_grad=True), 4)
    state = TC.init(64, 4, device=dev)
    values = state["values"].clone().requires_grad_(True)
    keys = torch.arange(8, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        shed_partition(keys, torch.ones(8, dtype=torch.bool, device=dev),
                       state["keys"], values, 4, 2, 8)
    qa = torch.randn((1, 8, 4, 16), device=dev, requires_grad=True)
    kv = torch.randn((1, 8, 2, 16), device=dev)
    assert flash_attention(qa, kv, kv).grad_fn is not None
    x = torch.randn((3, 4, 8), device=dev, requires_grad=True)
    assert dot_interaction(x).grad_fn is not None
    # the backward kernels have no backward of their own
    with pytest.raises(RuntimeError, match="no backward"):
        dot_interaction_bwd(x, torch.randn((3, 6), device=dev))
    o = flash_attention(qa.detach(), kv, kv)
    lse = torch.zeros((1, 4, 8), device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention_bwd(qa, kv, kv, o, lse, torch.randn_like(o))


@pytest.mark.parametrize("arch", ["smollm-135m", "dlrm-mlperf", "bst",
                                  "gcn-cora"])
def test_cuda_mesh_of_one_gives_the_replicated_scores(dev, arch):
    """The (1, 1) mesh of one H100 (a world of one, made by
    ``make_host_mesh``): the sharded evaluator over the replicated one's
    tensors gives its scores bit for bit, with the same kernels."""
    from repro_torch.launch.mesh import destroy_world, make_host_mesh
    from repro_torch.serving.evaluators import make_sharded_evaluator
    ev, mk = make_evaluator(arch, smoke=True, device=dev)
    mesh = make_host_mesh((1, 1))
    try:
        assert mesh.device_type == "cuda"
        se = make_sharded_evaluator(arch, mesh=mesh, smoke=True,
                                    params=ev.params)
        feats = {k: torch.as_tensor(v, device=dev)
                 for k, v in mk(96, fseed=2).items()}
        assert torch.equal(se.evaluate(feats), ev(feats))
    finally:
        destroy_world()


@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("B,L,Hq,Hkv,D,window,softcap", [
    (3, 512, 4, 2, 64, 0, 0.0),
    (2, 512, 8, 1, 128, 100, 30.0),
    (4, 64, 8, 2, 12, 0, 0.0),             # D 12 padded to 16
    (16, 2048, 8, 4, 256, 700, 50.0),
    (64, 1500, 6, 2, 64, 0, 0.0),
])
def test_flash_decode_lse_close_to_plain(dev, B, L, Hq, Hkv, D, window,
                                         softcap, dtype, atol):
    """The lse instance (``return_lse``): its o equals the serving
    instance's bit for bit, its lse is within ``atol`` of the plain
    version's (-inf at length 0), one launch a call."""
    g = torch.Generator(device=dev).manual_seed(L + B + D)
    q = torch.randn((B, Hq, D), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((B, L, Hkv, D), generator=g, device=dev).to(dtype)
            for _ in range(2))
    lengths = torch.randint(1, L + 1, (B,), generator=g, device=dev,
                            dtype=torch.int32)
    lengths[:2] = torch.tensor([0, L], device=dev)
    kw = dict(window=window, softcap=softcap)
    before = flash_decode.launches
    o, lse = flash_decode(q, k, v, lengths, return_lse=True, **kw)
    assert flash_decode.launches == before + 1
    assert lse.dtype == torch.float32 and lse.shape == (B, Hq)
    assert torch.equal(o, flash_decode(q, k, v, lengths, **kw))
    o_ref, lse_ref = flash_decode_ref(q, k, v, lengths, return_lse=True,
                                      **kw)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=atol, rtol=0)
    assert torch.isneginf(lse[0]).all() and torch.isneginf(lse_ref[0]).all()
    torch.testing.assert_close(lse[1:], lse_ref[1:], atol=atol, rtol=0)


def test_kernel_wrappers_never_take_the_fake_branch_on_a_card(dev):
    """A real CUDA tensor is never taken for a fake one: every wrapper's
    launch counter moves by one a call."""
    from repro_torch.kernels._build import is_fake
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((2, 64, 4, 64), generator=g, device=dev)
    kv = torch.randn((2, 64, 2, 64), generator=g, device=dev)
    keys = torch.arange(1, 9, dtype=torch.int32, device=dev)
    state = TC.init(64, 4, device=dev)
    assert not is_fake(q, kv, keys, state["keys"], state["values"])
    calls = [
        (flash_attention, lambda: flash_attention(q, kv, kv)),
        (flash_decode, lambda: flash_decode(
            q[:, 0].contiguous(), kv, kv,
            torch.tensor([3, 64], dtype=torch.int32, device=dev))),
        (topk_select, lambda: topk_select(q.flatten(), 8)),
        (dot_interaction, lambda: dot_interaction(
            q[:, :8, 0].contiguous())),
        (shed_partition, lambda: shed_partition(
            keys, torch.ones(8, dtype=torch.bool, device=dev),
            state["keys"], state["values"], 4, 2, 8)),
    ]
    for wrapper, call in calls:
        before = wrapper.launches
        call()
        assert wrapper.launches == before + 1, wrapper.__name__
    x = q[:, :8, 0].contiguous()
    before = dot_interaction_bwd.launches
    dot_interaction_bwd(x, torch.randn((2, 28), device=dev))
    assert dot_interaction_bwd.launches == before + 1
    o = flash_attention(q, kv, kv)
    lse = torch.zeros((2, 4, 64), device=dev)
    before = flash_attention_bwd.launches
    flash_attention_bwd(q, kv, kv, o, lse, torch.randn_like(o))
    assert flash_attention_bwd.launches == before + 1



# --- score_head: the fused scoring head ------------------------------------

def _score_head_case(dev, P, d, V, tied, seed, dyadic=False):
    """x (P, d) and the weight ((V, d) tied, (d, V) untied) in bf16, and
    targets that take 0, V - 1 and both sides of the vocabulary tiles'
    edges (256 entries) where V has them. Normal entries give logits of
    about 1 (``time_score_head.inputs``); ``dyadic`` ones lie on grids of
    1/8 (x) and 1/16 (w) within +-1/2, so that every float32 product and
    sum is exact in any order, and half the rows are scaled by a power of
    two to logits of tens."""
    if dyadic:
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randint(-4, 5, (P, d), generator=g, device=dev) / 8.0
        w = torch.randint(-8, 9, (V, d), generator=g, device=dev) / 16.0
        # the logits' spread is ~0.1 sqrt(d): tens in the scaled rows
        x[: P // 2] *= 2.0 ** round(math.log2(40 / (0.1 * d ** 0.5)))
        x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
        w = w if tied else w.T.contiguous()
        tgt = torch.randint(0, V, (P,), generator=g, device=dev,
                            dtype=torch.int32)
    else:
        x, w, tgt = TSH.inputs(P, d, V, tied, seed, dev)
    edges = [0, V - 1] + [e for e in (255, 256, 511, 512) if e < V]
    n = min(P, len(edges))
    tgt[:n] = torch.tensor(edges[:n], device=dev, dtype=torch.int32)
    return x, w, tgt


def _assert_score_head_close(x, w, tgt, tied, got):
    """Per position within ``time_score_head.target_tolerance``: 1e-4
    plus one bf16 ulp of the target's logit, whose one bf16 rounding the
    kernel's order of summation can flip."""
    want = TSH.plain(x, w, tgt, tied, token_chunk=2048)
    err = (got - want).abs()
    tol = TSH.target_tolerance(x, w, tgt, tied)
    bad = err > tol
    assert not bad.any(), (int(bad.sum()), float(err.max()),
                           float((err - tol).max()))
    return want


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("d", [64, 576, 2048])
@pytest.mark.parametrize("V", [1000, 49152, 151936])
@pytest.mark.parametrize("P", [7, 3072 * 31])
def test_score_head_close_to_plain(dev, P, V, d, tied):
    x, w, tgt = _score_head_case(dev, P, d, V, tied, seed=P + V + d)
    before = SH.score_head.launches
    got = SH.score_head(x, w, tgt, tied=tied)
    torch.cuda.synchronize()
    assert SH.score_head.launches == before + 1
    assert got.shape == (P,) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    _assert_score_head_close(x, w, tgt, tied, got)


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("d", [64, 576, 2048])
@pytest.mark.parametrize("V", [1000, 151936])
def test_score_head_large_logits_need_the_running_max(dev, V, d, tied):
    """Rows whose logits reach tens (exact float32 sums, so that both
    paths round every logit alike): without the running max their
    exponentials overflow; the targets' log-probabilities reach -50."""
    P = 301
    x, w, tgt = _score_head_case(dev, P, d, V, tied, seed=V + d + 1,
                                 dyadic=True)
    got = SH.score_head(x, w, tgt, tied=tied)
    torch.cuda.synchronize()
    want = _assert_score_head_close(x, w, tgt, tied, got)
    assert float(want[: P // 2].min()) < -50
    assert float((got - want).abs().max()) <= 1e-4


def test_score_head_repeats_its_bits(dev):
    x, w, tgt = _score_head_case(dev, 3072 * 31, 576, 49152, True, seed=9)
    a = SH.score_head(x, w, tgt, tied=True)
    b = SH.score_head(x, w, tgt, tied=True)
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-moe-30b-a3b",
                                  "qwen2.5-14b"])
def test_score_head_is_the_transformer_head_on_the_card(dev, arch):
    """At the published head's width, vocabulary and layout, the bf16
    transformer's head takes the kernel (counted fused, launched once)
    and gives the chunked path's per-sequence means."""
    import dataclasses
    cfg = dataclasses.replace(get_config(arch, smoke=False),
                              dtype="bfloat16")
    B, S = 64, 31
    x, w, tgt = _score_head_case(dev, B * S, cfg.d_model, cfg.vocab_size,
                                 cfg.tie_embeddings, seed=11)
    params = ({"embed": {"table": w}} if cfg.tie_embeddings
              else {"unembed": {"w": w}})
    fused, launches = (SH.score_head.by_instance["fused"],
                       SH.score_head.launches)
    got = T._mean_token_logprob(params, cfg, x.reshape(B, S, -1),
                                tgt.reshape(B, S), T._token_chunk(cfg))
    assert SH.score_head.by_instance["fused"] == fused + 1
    assert SH.score_head.launches == launches + 1
    tok = T._chunked_token_logprob(params, cfg, x, tgt.long(),
                                   T._token_chunk(cfg))
    tol = TSH.target_tolerance(x, w, tgt, cfg.tie_embeddings)
    assert ((got - tok.reshape(B, S).mean(-1)).abs()
            <= tol.reshape(B, S).mean(-1)).all()


def test_score_head_refuses_inputs_that_require_grad(dev):
    x, w, tgt = _score_head_case(dev, 7, 64, 1000, True, seed=2)
    with pytest.raises(RuntimeError, match="no backward"):
        SH.score_head(x.requires_grad_(True), w, tgt, tied=True)
