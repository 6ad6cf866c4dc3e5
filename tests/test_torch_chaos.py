"""The port's chaos package (``repro_torch.chaos``) against
``repro.chaos`` on the CPU: ``make_trace`` gives the same arrivals
(times, tenants, priorities, query strings, poison flags) and events,
``poisonable`` raises on the same chunks, and ``run_fleet_trace`` on a
1 s, 6-replica trace — flash crowd, a query-of-death flood (20/s) with
the quarantine armed at k 2, a regional failure, a rolling restart, epidemic
gossip and hedging — gives the same ``response_fingerprint``, churn log
and scheduler stats, twice over."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.chaos as XJ
import repro.cluster as CJ
import repro_torch.chaos as XT
import repro_torch.cluster as CT
from repro.configs.base import reduced as reduced_j
from repro.configs.trust_ir import smoke_config as smoke_j
from repro.core.pipeline import SyntheticSearcher as SyntheticSearcher_j
from repro.core.pipeline import exact_oracle_evaluator as oracle_j
from repro_torch.configs.base import reduced
from repro_torch.configs.trust_ir import smoke_config
from repro_torch.core.pipeline import (SyntheticSearcher,
                                       exact_oracle_evaluator)


def _trace_cfg(mod, d=1.0, seed=0, poison_qps=3.0, **kw):
    return mod.TraceConfig(
        duration_s=d, base_qps=60.0, diurnal_period_s=d, seed=seed,
        flash_crowds=[mod.FlashCrowd(0.35 * d, 0.5 * d, 4.0)],
        poison=[mod.PoisonSpec(0.15 * d, 0.55 * d, qps=poison_qps)],
        failures=[mod.RegionalFailure(t=0.7 * d, n_crash=2)],
        restarts=[mod.RollingRestartEvent(t=0.85 * d)], **kw)


@pytest.mark.parametrize("seed,kw", [
    (0, {}),
    (7, dict(hot_url_frac=0.6, n_tenants=3)),
    (11, dict(critical_frac=0.3, zipf_a=1.2)),
], ids=["default", "hot-floods", "critical-mix"])
def test_make_trace_matches_reference(seed, kw):
    arr_t, ev_t = XT.make_trace(_trace_cfg(XT, d=3.0, seed=seed, **kw))
    arr_j, ev_j = XJ.make_trace(_trace_cfg(XJ, d=3.0, seed=seed, **kw))
    assert len(arr_t) == len(arr_j) > 50
    for a, b in zip(arr_t, arr_j):
        assert (a.t, a.tenant, a.priority.name, a.n_results, a.query,
                a.poison) == (b.t, b.tenant, b.priority.name, b.n_results,
                              b.query, b.poison)
    assert [dataclasses.asdict(e) for e in ev_t] == \
        [dataclasses.asdict(e) for e in ev_j]
    assert any(a.poison for a in arr_t)


@pytest.mark.parametrize("flag,err", [
    (XT.POISON_RAISE, XT.PoisonPillError),
    (XT.POISON_HANG, XT.EvaluatorHangError),
])
def test_poisonable_raises_on_tensor_chunks(flag, err):
    ev = XT.poisonable(lambda ch: ch["x"])
    clean = {"x": torch.ones(4), XT.POISON_FEATURE: torch.zeros(4)}
    assert torch.equal(ev(clean), torch.ones(4))
    bad = dict(clean)
    bad[XT.POISON_FEATURE] = torch.tensor([0.0, flag, 0.0, 0.0])
    with pytest.raises(err):
        ev(bad)
    with pytest.raises(err):        # numpy chunks, as the reference
        ev({k: v.numpy() for k, v in bad.items()})


def _fleet_trace(pkg):
    if pkg == "t":
        cfg = reduced(smoke_config(), n_replicas=6, quarantine_k=2)
        searcher = SyntheticSearcher(corpus_size=20_000, seed=0)
        mod, X, kw = CT, XT, {"device": "cpu"}
        ev = XT.poisonable(exact_oracle_evaluator(searcher))
    else:
        cfg = reduced_j(smoke_j(), n_replicas=6, quarantine_k=2)
        searcher = SyntheticSearcher_j(corpus_size=20_000, seed=0)
        mod, X, kw = CJ, XJ, {}
        ev = XJ.poisonable(oracle_j(searcher))
    coord = mod.ClusterCoordinator(
        cfg, ev, cluster_cfg=mod.ClusterConfig(
            hedge_after_s=0.5, gossip=True, gossip_mode="epidemic",
            autoscale=True),
        sim_rate_items_per_s=2.0 * cfg.u_capacity / cfg.deadline_s, **kw)
    rep = X.run_fleet_trace(coord, searcher, _trace_cfg(X, poison_qps=20.0))
    return coord, rep, X.response_fingerprint(rep.responses)


def test_fleet_trace_matches_reference_and_replays():
    c_t, r_t, fp_t = _fleet_trace("t")
    c_j, r_j, fp_j = _fleet_trace("j")
    assert fp_t == fp_j
    assert r_t.churn_log == r_j.churn_log
    assert r_t.scheduler_stats == r_j.scheduler_stats
    assert _fleet_trace("t")[2] == fp_t           # bit-identical replay
    st = r_t.scheduler_stats
    rids = [r.request_id for r in r_t.responses]
    assert len(rids) == len(set(rids)) == st["n_submitted"]
    assert [row[1] for row in r_t.churn_log] == \
        ["crash", "crash", "rolling_restart"]
    assert st["n_executor_errors"] > 0 and st["n_quarantined"] > 0
    assert st["gossip"]["n_pull_messages"] > 0
    assert all(np.isfinite(r.trust).all() for r in r_t.responses)
