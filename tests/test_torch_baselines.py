"""The paper's two comparison systems in the port
(``repro_torch.core.baselines``) against ``repro.core.baselines`` on a
SimClock with the deterministic stub evaluator: ``ProcessAll`` (the
"Existing System" [1]) and ``RLSEDA`` (random shedding [2]). Tiers,
trust, ``n_evaluated``, regime and ``response_time_s`` are exact, and
the RLS-EDA keep set is the reference's bit for bit for three seeds:
both draw it from ``np.random.default_rng(seed).permutation``."""
import numpy as np
import pytest

from repro.configs.base import TrustIRConfig as TrustIRConfig_j
from repro.core import SimClock as SimClock_j
from repro.core.baselines import ProcessAll as ProcessAll_j
from repro.core.baselines import RLSEDA as RLSEDA_j
from repro_torch.configs.base import TrustIRConfig
from repro_torch.core import RLSEDA, ProcessAll, SimClock, TIER_INVALID

CFG = dict(u_capacity=128, u_threshold=64, deadline_s=0.5,
           overload_deadline_s=1.0, chunk_size=32, cache_slots=1024,
           cache_ways=2)
RATE = CFG["u_capacity"] / CFG["deadline_s"]


def _batch(n, n_total, seed):
    rng = np.random.default_rng(seed)
    keys = rng.choice(np.arange(1, 10**6), size=n_total,
                      replace=False).astype(np.uint32)
    buckets = rng.integers(0, 8, n_total).astype(np.int32)
    feats = {"x": rng.random(n_total).astype(np.float32) * 5}
    return keys, buckets, feats


def _pair(cls_t, cls_j, **kw):
    sh_t = cls_t(TrustIRConfig(**CFG), lambda ch: ch["x"],
                 sim_clock=SimClock(RATE), device="cpu", **kw)
    sh_j = cls_j(TrustIRConfig_j(**CFG), lambda ch: np.asarray(ch["x"]),
                 sim_clock=SimClock_j(RATE), **kw)
    return sh_t, sh_j


def _assert_same(a, b):
    np.testing.assert_array_equal(a.tier, b.tier)
    np.testing.assert_array_equal(a.trust, b.trust)
    assert (int(a.regime), a.n_evaluated, a.n_cached, a.n_prior, a.uload,
            a.response_time_s, a.deadline_eff_s) == \
        (int(b.regime), b.n_evaluated, b.n_cached, b.n_prior, b.uload,
         b.response_time_s, b.deadline_eff_s)


@pytest.mark.parametrize("n,n_total", [(100, 100), (180, 256), (900, 1024)],
                         ids=["normal", "heavy-padded", "very-heavy-padded"])
def test_process_all_matches_reference(n, n_total):
    sh_t, sh_j = _pair(ProcessAll, ProcessAll_j)
    for seed in range(3):                   # the clocks run on
        batch = _batch(n, n_total, seed)
        a = sh_t.process(*batch, n_valid=n)
        b = sh_j.process(*batch, n_valid=n)
        _assert_same(a, b)
        assert a.n_evaluated == n and (a.tier[n:] == TIER_INVALID).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [150, 600], ids=["within", "overload"])
def test_rlseda_keep_set_matches_reference(seed, n):
    sh_t, sh_j = _pair(RLSEDA, RLSEDA_j, seed=seed)
    for rnd in range(2):
        batch = _batch(n, n, 10 * seed + rnd)
        a = sh_t.process(*batch)
        b = sh_j.process(*batch)
        _assert_same(a, b)
        kept = a.tier != TIER_INVALID
        ucap, uthr = sh_t.monitor.parameters()
        assert kept.sum() == min(n, ucap + uthr)
        if n > kept.sum():                  # RLS-EDA's flaw: items dropped
            assert (~kept).any()
