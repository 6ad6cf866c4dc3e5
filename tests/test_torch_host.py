"""Host math of the torch port against the JAX reference: regime
classification, the Very-Heavy deadline extension (float32, so the eval
budgets agree exactly), the Load Monitor's (Ucapacity, Uthreshold) after
a seeded observation stream, and the shared warmup gate."""
import numpy as np
import pytest
import torch

from repro.configs.base import TrustIRConfig as TrustIRConfig_j
from repro.core.deadline import effective_deadline as effective_deadline_j
from repro.core.load_monitor import LoadMonitor as LoadMonitor_j
from repro.core.load_monitor import WarmupGate as WarmupGate_j
from repro.core.regimes import classify as classify_j
from repro_torch.configs import TrustIRConfig
from repro_torch.core.deadline import effective_deadline
from repro_torch.core.load_monitor import LoadMonitor, WarmupGate
from repro_torch.core.regimes import classify


def _sweep(seed, n=300):
    r = np.random.default_rng(seed)
    return zip(r.integers(0, 10_000, n), r.integers(1, 4000, n),
               r.integers(0, 3000, n), r.uniform(0.0, 2.0, n))


@pytest.mark.parametrize("seed", range(4))
def test_classify_and_effective_deadline_match(seed):
    for uload, ucap, uthr, w in _sweep(seed):
        uload, ucap, uthr = int(uload), int(ucap), int(uthr)
        assert int(classify(uload, ucap, uthr)) == int(
            classify_j(uload, ucap, uthr))
        kw = dict(deadline_s=0.5, overload_deadline_s=1.0, weight=float(w))
        got = effective_deadline(uload, ucap, uthr, **kw)
        assert got == effective_deadline_j(uload, ucap, uthr, **kw)
        # the fused drain's eval budget: floor(rate * deadline)
        assert np.floor(ucap / 0.5 * got) == np.floor(
            ucap / 0.5 * effective_deadline_j(uload, ucap, uthr, **kw))


@pytest.mark.parametrize("seed", range(3))
def test_load_monitor_parameters_track_the_reference(seed):
    r = np.random.default_rng(seed)
    kw = dict(u_capacity=int(r.integers(64, 4096)), deadline_s=0.5,
              overload_deadline_s=1.0)
    m, mj = LoadMonitor(TrustIRConfig(**kw)), LoadMonitor_j(
        TrustIRConfig_j(**kw))
    assert m.parameters() == mj.parameters()
    for _ in range(50):
        n = int(r.integers(-2, 5000))
        dt = float(r.choice([0.0, r.uniform(1e-4, 2.0)]))
        m.observe(n, dt)
        mj.observe(n, dt)
        assert m.parameters() == mj.parameters()
        assert m.n_observations == mj.n_observations


def test_warmup_gate_signature_and_exclusions():
    g, gj = WarmupGate(), WarmupGate_j()
    np_feats = {"tokens": np.zeros((8, 32), np.int32)}
    t_feats = {"tokens": torch.zeros((8, 32), dtype=torch.int32)}
    assert WarmupGate.signature(8, np_feats) == WarmupGate_j.signature(
        8, np_feats)
    assert WarmupGate.signature(8, t_feats)[:1] == (8,)
    for sig in [(1,), (2,), (1,), WarmupGate.signature(8, t_feats),
                WarmupGate.signature(8, t_feats)]:
        assert g.warm(sig) == gj.warm(sig)
    assert g.n_excluded == gj.n_excluded == 3
