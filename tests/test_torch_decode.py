"""The port's KV-cache path on the CPU against the JAX reference, with the
reference's own smoke smollm weights (``params_from_jax``):
``init_kv_cache``, ten ``decode_step``s (logits and cache), ``prefill``
(score and padded cache), prefill then decode, ``update_kv_cache``
dropping a write at position L, and ``decode_attention``; atol 2e-3, the
bound of ``tests/test_transformer_consistency.py`` (float32; the
frameworks sum in different orders). Then the port's own decode logits
against its full forward, the ``KVCachePool`` lifecycle against the
reference pool, and the three KV-slot admission cases of
``tests/test_cluster.py`` on the port's ``ServingEngine`` with the port's
``KVCachePool`` attached."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_j
from repro.models import attention as A_j
from repro.models import transformer as T_j
from repro.serving.kv_cache import KVCachePool as KVCachePool_j
from repro_torch.configs import TrustIRConfig, get_config
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.scheduling import Priority, SchedulerConfig
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv_cache import KVCachePool, SlotAllocator
from repro_torch.core.shedder import SimClock

ATOL = 2e-3
ARCH = "smollm-135m"


@pytest.fixture(scope="module")
def weights():
    cfg_j = get_config_j(ARCH, smoke=True)
    params = jax.tree.map(np.asarray,
                          T_j.init_params(jax.random.PRNGKey(0), cfg_j))
    cfg = get_config(ARCH, smoke=True)
    return (cfg_j, jax.tree.map(jnp.asarray, params), cfg,
            T.params_from_jax(params, cfg, device="cpu"))


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(
        0, vocab, size=shape).astype(np.int32)


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol)


def test_init_kv_cache_matches_jax(weights):
    cfg_j, _, cfg, _ = weights
    want = T_j.init_kv_cache(cfg_j, 3, 16)
    got = T.init_kv_cache(cfg, 3, 16, device="cpu")
    for name in ("k", "v", "lengths"):
        assert tuple(got[name].shape) == want[name].shape
        assert str(got[name].dtype).split(".")[-1] == str(want[name].dtype)
        assert not got[name].any()


def test_decode_steps_match_jax(weights):
    """Ten steps from an empty cache, rows starting at ragged lengths."""
    cfg_j, pj, cfg, pt = weights
    B, L = 3, 16
    cache_j = T_j.init_kv_cache(cfg_j, B, L)
    start = np.array([0, 2, 5], np.int32)
    cache_j = {**cache_j, "lengths": jnp.asarray(start)}
    cache = T.init_kv_cache(cfg, B, L, device="cpu")
    cache["lengths"] = torch.from_numpy(start.copy())
    toks = _tokens((10, B), cfg.vocab_size, seed=1)
    for t in range(10):
        logits_j, cache_j = T_j.decode_step(pj, cfg_j,
                                            jnp.asarray(toks[t]), cache_j)
        logits, cache = T.decode_step(pt, cfg, torch.from_numpy(toks[t]),
                                      cache)
        _close(logits, logits_j)
        _close(cache["k"], cache_j["k"])
        _close(cache["v"], cache_j["v"])
        np.testing.assert_array_equal(cache["lengths"].numpy(),
                                      np.asarray(cache_j["lengths"]))


@pytest.mark.parametrize("S,max_len", [(7, 7), (9, 16), (1, 4)])
def test_prefill_matches_jax(weights, S, max_len):
    cfg_j, pj, cfg, pt = weights
    toks = _tokens((2, S), cfg.vocab_size, seed=S)
    score_j, cache_j = T_j.prefill(pj, cfg_j, jnp.asarray(toks),
                                   max_len=max_len)
    score, cache = T.prefill(pt, cfg, torch.from_numpy(toks),
                             max_len=max_len)
    _close(score, score_j)
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == cache_j[name].shape
        _close(cache[name], cache_j[name])
    np.testing.assert_array_equal(cache["lengths"].numpy(),
                                  np.asarray(cache_j["lengths"]))


def test_prefill_then_decode_matches_jax(weights):
    cfg_j, pj, cfg, pt = weights
    toks = _tokens((2, 6), cfg.vocab_size, seed=7)
    _, cache_j = T_j.prefill(pj, cfg_j, jnp.asarray(toks), max_len=12)
    _, cache = T.prefill(pt, cfg, torch.from_numpy(toks), max_len=12)
    nxt = _tokens((4, 2), cfg.vocab_size, seed=8)
    for t in range(4):
        logits_j, cache_j = T_j.decode_step(pj, cfg_j, jnp.asarray(nxt[t]),
                                            cache_j)
        logits, cache = T.decode_step(pt, cfg, torch.from_numpy(nxt[t]),
                                      cache)
        _close(logits, logits_j)
    _close(cache["k"], cache_j["k"])


def test_decode_equals_forward(weights):
    """The port's own property: prefill + decode gives the logits of the
    full forward at every decoded position."""
    _, _, cfg, pt = weights
    toks = _tokens((2, 11), cfg.vocab_size, seed=9)
    full = T.forward(pt, cfg, torch.from_numpy(toks))
    _, cache = T.prefill(pt, cfg, torch.from_numpy(toks[:, :5]),
                         max_len=16)
    for t in range(5, 11):
        logits, cache = T.decode_step(pt, cfg,
                                      torch.from_numpy(toks[:, t]), cache)
        torch.testing.assert_close(logits, full[:, t], atol=ATOL, rtol=0)


def test_update_kv_cache_drops_a_write_at_L():
    r = np.random.default_rng(0)
    B, L, H, D = 3, 8, 2, 4
    kc, vc = (r.normal(size=(B, L, H, D)).astype(np.float32)
              for _ in range(2))
    kn, vn = (r.normal(size=(B, H, D)).astype(np.float32) for _ in range(2))
    pos = np.array([L, 3, 0], np.int32)
    want_k, want_v = A_j.update_kv_cache(jnp.asarray(kc), jnp.asarray(vc),
                                         jnp.asarray(kn), jnp.asarray(vn),
                                         jnp.asarray(pos))
    k_t, v_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got_k, got_v = A.update_kv_cache(k_t, v_t, torch.from_numpy(kn),
                                     torch.from_numpy(vn),
                                     torch.from_numpy(pos))
    assert got_k is k_t and got_v is v_t            # written in place
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_k[0].numpy(), kc[0])   # dropped


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (3, 0.0), (0, 20.0)])
def test_decode_attention_matches_jax(window, softcap):
    r = np.random.default_rng(window)
    B, L, Hq, Hkv, D = 3, 12, 6, 2, 8
    q = r.normal(size=(B, Hq, D)).astype(np.float32)
    kc, vc = (r.normal(size=(B, L, Hkv, D)).astype(np.float32)
              for _ in range(2))
    lengths = np.array([1, 7, L], np.int32)
    want = A_j.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                jnp.asarray(vc), jnp.asarray(lengths),
                                window=window, softcap=softcap)
    got = A.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                             torch.from_numpy(vc), torch.from_numpy(lengths),
                             window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_kv_cache_pool_lifecycle_matches_jax(weights):
    """tests/test_serving.py's lifecycle, then a prompt admitted from a
    prefill cache, on both pools."""
    cfg_j, pj, cfg, pt = weights
    pool_j = KVCachePool_j(cfg_j, n_slots=3, max_len=16)
    pool = KVCachePool(cfg, n_slots=3, max_len=16, device="cpu")
    s0 = pool.admit(request_id=7, prompt_len=0)
    assert s0 == pool_j.admit(request_id=7, prompt_len=0)
    assert pool.active_mask()[s0]
    pool.retire(s0)
    pool_j.retire(s0)
    assert not pool.active_mask().any()
    assert int(pool.cache["lengths"][s0]) == 0
    toks = _tokens((1, 5), cfg.vocab_size, seed=3)
    _, kv_j = T_j.prefill(pj, cfg_j, jnp.asarray(toks))
    _, kv = T.prefill(pt, cfg, torch.from_numpy(toks))
    for rid in (11, 12):
        assert pool.admit(rid, kv, prompt_len=5) == pool_j.admit(
            rid, kv_j, prompt_len=5)
    np.testing.assert_array_equal(pool.active_mask(), pool_j.active_mask())
    np.testing.assert_array_equal(pool.cache["lengths"].numpy(),
                                  np.asarray(pool_j.cache["lengths"]))
    for name in ("k", "v"):
        _close(pool.cache[name], pool_j.cache[name])
    assert pool.admit(13) is not None and pool.admit(14) is None


# -- KV-slot-aware admission (tests/test_cluster.py) on the port ----------

def _smoke_trust_ir():
    """``repro.configs.trust_ir.smoke_config`` in the port's config."""
    return TrustIRConfig(u_capacity=64, u_threshold=32, deadline_s=0.05,
                         overload_deadline_s=0.1, very_heavy_weight=0.5,
                         chunk_size=16, cache_slots=256, cache_ways=2,
                         prior_buckets=1, prior_ewma=0.05)


def _req_arrays(rid, n, seed=0):
    r = np.random.default_rng(seed + rid)
    return (np.arange(rid * 10_000 + 1, rid * 10_000 + n + 1,
                      dtype=np.uint32),
            r.integers(0, 8, n).astype(np.int32),
            {"x": np.linspace(0, 5, n, dtype=np.float32)})


def _engine(n_slots, **kw):
    cfg = _smoke_trust_ir()
    pool = KVCachePool(get_config(ARCH, smoke=True), n_slots=n_slots,
                       max_len=8, device="cpu")
    eng = ServingEngine(cfg, lambda ch: ch["x"],
                        sim_clock=SimClock(cfg.u_capacity / cfg.deadline_s),
                        kv_pool=pool, device="cpu", **kw)
    return eng, pool


def test_decode_without_free_slot_stays_queued():
    eng, pool = _engine(1)
    pool.admit(request_id=999)                     # no free slots left
    rid = eng.enqueue(*_req_arrays(0, 8), needs_kv_slot=True)
    assert eng.drain() == []                       # not batchable ...
    assert len(eng.scheduler.bank) == 1            # ... stays queued
    pool.retire(0)                                 # slot frees up
    assert [r.request_id for r in eng.drain()] == [rid]


def test_decode_head_does_not_burn_batch_budget():
    eng, _ = _engine(0)
    eng.enqueue(*_req_arrays(0, 8), needs_kv_slot=True,
                priority=Priority.NORMAL)
    rid_hi = eng.enqueue(*_req_arrays(1, 8), priority=Priority.HIGH)
    assert [r.request_id for r in eng.drain()] == [rid_hi]
    assert len(eng.scheduler.bank) == 1            # decode still queued


def test_slot_budget_threads_across_one_drain():
    eng, _ = _engine(1, sched_cfg=SchedulerConfig(max_batch_items=16))
    r0 = eng.enqueue(*_req_arrays(0, 8), needs_kv_slot=True)
    eng.enqueue(*_req_arrays(1, 8), needs_kv_slot=True)
    assert [r.request_id for r in eng.drain()] == [r0]
    assert len(eng.scheduler.bank) == 1


def test_slot_allocator_matches_jax():
    a = SlotAllocator(4)
    slots = [a.claim(i) for i in range(4)]
    assert sorted(slots) == [0, 1, 2, 3]
    assert a.claim(99) is None
    a.release(slots[1])
    assert a.claim(100) == slots[1]
    assert a.n_active == 4
