"""The port's ``shed_partition`` (plain version on the CPU) against the JAX
Pallas kernel in interpret mode and its jnp oracle: tier, cached value
and compacted eval rank exactly equal over ragged N, prefix and gapped
validity masks, both cache layouts and both budget modes. The identities
the CUDA kernel's single scan rests on, held against the Pallas kernel.
Also ``eval_indices_from_rank``, ``combine_trust`` and ``shed_plan``
against the reference."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import shedder as S_j
from repro.core import trust_cache as TC_j
from repro.kernels import ref as ref_j
from repro.kernels.shed_partition import shed_partition as shed_partition_j
from repro_torch.core import shedder as S_t
from repro_torch.core import trust_cache as TC_t
from repro_torch.kernels.shed_partition import (shed_partition,
                                                shed_partition_ref)

N_SLOTS, N_WAYS = 256, 4


@functools.lru_cache(maxsize=None)
def _kernel_j(budget_is_total):
    return jax.jit(functools.partial(shed_partition_j,
                                     budget_is_total=budget_is_total,
                                     interpret=True))


def _inputs(n, n_valid, cache_mode, ways_leading, seed=0, gapped=False):
    """Seeded keys (top bit set on some), a validity prefix of ``n_valid``
    (or, ``gapped``, about 70% valid at random), and a cache state built
    by the REFERENCE's insert, shared by both packages."""
    r = np.random.default_rng(seed)
    keys = (np.arange(1, n + 1, dtype=np.uint32)
            + r.integers(0, 2, n).astype(np.uint32) * np.uint32(1 << 31))
    valid = r.random(n) < 0.7 if gapped else np.arange(n) < n_valid
    cache = TC_j.init(N_SLOTS, N_WAYS, ways_leading=ways_leading)
    if cache_mode != "all_miss" and n:
        sel = keys if cache_mode == "all_hit" else keys[::3]
        cache = TC_j.insert(cache, jnp.asarray(sel),
                            jnp.linspace(0.5, 4.5, sel.shape[0]),
                            jnp.ones(sel.shape, bool))
    ck = np.asarray(cache["keys"])
    cv = np.asarray(cache["values"])
    return keys, valid, ck, cv


def _torch(keys, valid, ck, cv):
    return (torch.from_numpy(keys.view(np.int32)), torch.from_numpy(valid),
            torch.from_numpy(ck.view(np.int32).copy()),
            torch.from_numpy(cv.copy()))


def _assert_same(got, want):
    for g, w, name in zip(got, want, ("tier", "cval", "rank")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


@pytest.mark.parametrize("budget_is_total", [True, False])
@pytest.mark.parametrize("ways_leading", [True, False])
@pytest.mark.parametrize("n,n_valid,cache_mode", [
    (0, 0, "all_miss"),         # empty batch
    (1, 1, "all_hit"),
    (200, 137, "strided"),      # not lane-aligned, partial validity
    (1000, 1000, "strided"),    # ragged tail
    (1500, 900, "all_hit"),     # multi-block, padding tail
])
def test_plain_version_matches_pallas_kernel(n, n_valid, cache_mode,
                                             ways_leading, budget_is_total):
    keys, valid, ck, cv = _inputs(n, n_valid, cache_mode, ways_leading)
    ucap, uthr, budget = 256, 128, 300
    want = _kernel_j(budget_is_total)(
        jnp.asarray(keys), jnp.asarray(valid), jnp.asarray(ck),
        jnp.asarray(cv), ucap, uthr, budget)
    got = shed_partition(*_torch(keys, valid, ck, cv), ucap, uthr, budget,
                         budget_is_total=budget_is_total)
    _assert_same(got, want)


@pytest.mark.parametrize("budget_is_total", [True, False])
@pytest.mark.parametrize("ways_leading", [True, False])
@pytest.mark.parametrize("n,cache_mode", [
    (200, "strided"),
    (1000, "all_hit"),
    (1500, "strided"),
])
def test_plain_version_matches_pallas_kernel_gapped_masks(
        n, cache_mode, ways_leading, budget_is_total):
    """Validity with gaps anywhere, not only a padded tail."""
    keys, valid, ck, cv = _inputs(n, 0, cache_mode, ways_leading, seed=n,
                                  gapped=True)
    ucap, uthr, budget = 256, 128, 300
    want = _kernel_j(budget_is_total)(
        jnp.asarray(keys), jnp.asarray(valid), jnp.asarray(ck),
        jnp.asarray(cv), ucap, uthr, budget)
    got = shed_partition(*_torch(keys, valid, ck, cv), ucap, uthr, budget,
                         budget_is_total=budget_is_total)
    _assert_same(got, want)


@pytest.mark.parametrize("budget_is_total", [True, False])
@pytest.mark.parametrize("ways_leading", [True, False])
@pytest.mark.parametrize("gapped", [False, True])
@pytest.mark.parametrize("ucap,budget_total,budget_dq", [
    (256, 300, 100),      # the budget splits the drop queue in both modes
    (0, 100, 100),        # no Normal queue
    (1000, 0, 0),         # every valid item in the Normal queue
])
def test_single_scan_identities_hold_on_pallas_kernel(
        ucap, budget_total, budget_dq, gapped, ways_leading,
        budget_is_total):
    """What the CUDA kernel computes from one scan of (valid, valid & not
    hit), held against the Pallas kernel's three scans. With pos the
    valid items before an item and h the valid non-hit items before it:
    every EVAL item's rank is h (-1 for every other tier); a valid
    non-hit item is EVAL iff pos < ucap, or h < budget with a total
    budget, or h - NE < budget with a drop-queue budget (NE: the valid
    non-hit items with pos < ucap)."""
    n = 700
    budget = budget_total if budget_is_total else budget_dq
    keys, valid, ck, cv = _inputs(n, 630, "strided", ways_leading,
                                  seed=ucap + budget, gapped=gapped)
    tier, _, rank = (np.asarray(a) for a in _kernel_j(budget_is_total)(
        jnp.asarray(keys), jnp.asarray(valid), jnp.asarray(ck),
        jnp.asarray(cv), ucap, 128, budget))
    state = {"keys": jnp.asarray(ck), "values": jnp.asarray(cv)}
    hit = np.asarray(TC_j.lookup(state, jnp.asarray(keys))[1]) & valid
    miss = valid & ~hit
    pos = np.cumsum(valid) - valid
    h = np.cumsum(miss) - miss
    ne = int((miss & (pos < ucap)).sum())
    in_budget = h < budget if budget_is_total else h - ne < budget
    is_eval = miss & ((pos < ucap) | in_budget)
    np.testing.assert_array_equal(tier == S_j.TIER_EVAL, is_eval)
    np.testing.assert_array_equal(tier == S_j.TIER_CACHED, hit)
    np.testing.assert_array_equal(tier == S_j.TIER_INVALID, ~valid)
    np.testing.assert_array_equal(rank, np.where(is_eval, h, -1))
    if budget:                  # the drop-queue budget grants and denies
        assert (is_eval & (pos >= ucap)).any() and (miss & ~is_eval).any()


@pytest.mark.parametrize("budget_is_total", [True, False])
@pytest.mark.parametrize("ways_leading", [True, False])
@pytest.mark.parametrize("seed", range(4))
def test_plain_version_matches_reference_oracle(seed, ways_leading,
                                                budget_is_total):
    r = np.random.default_rng(100 + seed)
    n = int(r.integers(0, 3000))
    n_valid = int(r.integers(0, n + 1))
    mode = ("all_miss", "all_hit", "strided")[seed % 3]
    keys, valid, ck, cv = _inputs(n, n_valid, mode, ways_leading, seed)
    ucap, uthr = int(r.integers(1, 800)), int(r.integers(0, 400))
    budget = int(r.integers(0, 1500))
    want = ref_j.shed_partition_ref(
        jnp.asarray(keys), jnp.asarray(valid), jnp.asarray(ck),
        jnp.asarray(cv), ucap, uthr, budget,
        budget_is_total=budget_is_total)
    got = shed_partition_ref(*_torch(keys, valid, ck, cv), ucap, uthr,
                             budget, budget_is_total=budget_is_total)
    _assert_same(got, want)


def test_wrapper_rejects_bad_inputs():
    keys, valid, ck, cv = _torch(*_inputs(8, 8, "all_miss", True))
    with pytest.raises(TypeError):
        shed_partition(keys.to(torch.int64), valid, ck, cv, 4, 4, 4)
    with pytest.raises(ValueError):
        shed_partition(keys, valid[:4], ck, cv, 4, 4, 4)
    with pytest.raises(ValueError):
        shed_partition(keys, valid, ck.T, cv, 4, 4, 4)


def test_wrapper_rejects_a_cache_past_32_bit_offsets():
    """The kernel addresses the Trust DB with 32-bit offsets; shapes on
    the meta device cost no memory."""
    keys = torch.empty(8, dtype=torch.int32, device="meta")
    valid = torch.empty(8, dtype=torch.bool, device="meta")
    ck = torch.empty((4, 2 ** 30), dtype=torch.int32, device="meta")
    cv = torch.empty((4, 2 ** 30), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="32-bit"):
        shed_partition(keys, valid, ck, cv, 4, 4, 4)


@pytest.mark.parametrize("n_valid,ucap,uthr,mode", [
    (200, 256, 128, "strided"),      # Normal
    (300, 256, 128, "all_miss"),     # Heavy
    (512, 256, 128, "strided"),      # Very Heavy
    (512, 256, 0, "all_hit"),        # Very Heavy, zero threshold
    (0, 256, 128, "all_miss"),       # all padding
    (437, 256, 128, "strided"),
])
def test_shed_plan_and_rank_indices_match_reference(n_valid, ucap, uthr,
                                                    mode):
    """shed_plan tiers and budgets equal the reference's; the kernel's
    plain version in budget-total mode reproduces them; and
    eval_indices_from_rank equals both packages' gather indices."""
    N = 512
    keys, valid, ck, cv = _inputs(N, n_valid, mode, True)
    kw = dict(deadline_s=0.5, overload_deadline_s=1.0,
              very_heavy_weight=0.5)
    state_j = {"keys": jnp.asarray(ck), "values": jnp.asarray(cv)}
    _, hit_j = TC_j.lookup(state_j, jnp.asarray(keys))
    plan_j = S_j.shed_plan(jnp.asarray(valid), hit_j, ucap, uthr, **kw)
    kt, vt, ckt, cvt = _torch(keys, valid, ck, cv)
    _, hit_t = TC_t.lookup({"keys": ckt, "values": cvt}, kt)
    plan_t = S_t.shed_plan(vt, hit_t, ucap, uthr, **kw)
    np.testing.assert_array_equal(plan_t["tier"].numpy(),
                                  np.asarray(plan_j["tier"]))
    assert plan_t["regime"] == int(plan_j["regime"])
    assert plan_t["eval_budget_dq"] == int(plan_j["eval_budget_dq"])
    assert plan_t["deadline_eff"] == float(plan_j["deadline_eff"])

    rate = np.float32(ucap) / np.float32(0.5)
    budget_total = int(np.floor(rate * np.float32(plan_t["deadline_eff"])))
    tier, _, rank = shed_partition(kt, vt, ckt, cvt, ucap, uthr,
                                   budget_total, budget_is_total=True)
    np.testing.assert_array_equal(tier.numpy(), plan_t["tier"].numpy())
    for max_evals in (N, 64, 1):
        idx_j, ok_j = S_j.gather_eval_indices(plan_j["tier"], max_evals)
        idx_t, ok_t = S_t.eval_indices_from_rank(rank, max_evals)
        idx_r, ok_r = S_j.eval_indices_from_rank(jnp.asarray(rank.numpy()),
                                                 max_evals)
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_r))
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_r))
        np.testing.assert_array_equal(
            np.where(ok_t.numpy(), idx_t.numpy(), -1),
            np.where(np.asarray(ok_j), np.asarray(idx_j), -1))


def test_combine_trust_matches_reference():
    r = np.random.default_rng(7)
    n = 257
    tier = r.integers(0, 4, n).astype(np.int32)
    ev, cv, pv = (r.uniform(0, 5, n).astype(np.float32) for _ in range(3))
    want = S_j.combine_trust(*(jnp.asarray(a) for a in (tier, ev, cv, pv)))
    got = S_t.combine_trust(*(torch.from_numpy(a)
                              for a in (tier, ev, cv, pv)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
