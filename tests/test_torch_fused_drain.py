"""The slice as a whole on the CPU: the port's ``FusedLoadShedder`` and
host ``LoadShedder`` against the JAX reference's, on a ``SimClock``, over
the reference tests' chunk-aligned loads (Normal, Heavy, Very-Heavy) and
its cache-reuse stream, with the stub evaluator and with the smoke
smollm on shared parameters. Regime, tiers and counts are exactly equal;
trust is allclose (atol 1e-5 for the stub, 1e-4 for the transformer:
the frameworks sum in different orders). Then ``DrainExecutor`` depth-k
ordering and exception-mid-window rescue, against the reference's
executor on the same scripted shedder."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrustIRConfig as TrustIRConfig_j
from repro.core import (FusedLoadShedder as Fused_j,
                        LoadShedder as Host_j, Regime as Regime_j,
                        SimClock as SimClock_j)
from repro.models import transformer as T_j
from repro.configs import get_config as get_config_j
from repro.scheduling.executor import DrainExecutor as DrainExecutor_j
from repro.serving.evaluators import make_evaluator as make_evaluator_j
from repro_torch.configs import TrustIRConfig
from repro_torch.core import trust_cache as TC
from repro_torch.core.fused_shedder import FusedLoadShedder, PendingShed
from repro_torch.core.regimes import Regime
from repro_torch.core.shedder import (TIER_INVALID, TIER_PRIOR, LoadShedder,
                                      SimClock)
from repro_torch.scheduling.executor import DrainExecutor
from repro_torch.serving.evaluators import make_evaluator

D = 8
W = np.linspace(-1.0, 1.0, D).astype(np.float32)


@jax.jit
def _ev_j(chunk):
    return jax.nn.sigmoid(chunk["x"] @ jnp.asarray(W)) * 5.0


def _ev_np(chunk):
    return np.asarray(_ev_j({"x": jnp.asarray(chunk["x"])}))


def _ev_t(chunk):
    return torch.sigmoid(chunk["x"] @ torch.from_numpy(W)) * 5.0


CFG = dict(u_capacity=128, u_threshold=128, deadline_s=0.5,
           overload_deadline_s=1.0, very_heavy_weight=0.5,
           chunk_size=16, cache_slots=1024, cache_ways=2)


def _batch(n, cap, off, seed=0):
    r = np.random.default_rng(seed + off)
    keys = np.zeros(cap, np.uint32)
    keys[:n] = np.arange(off, off + n)
    buckets = np.zeros(cap, np.int32)
    buckets[:n] = r.integers(0, 4, n)
    feats = {"x": np.zeros((cap, D), np.float32)}
    feats["x"][:n] = r.normal(size=(n, D)).astype(np.float32)
    return keys, buckets, feats


def _shedders(ev_t, ev_j, ev_j_host, **cfg_kw):
    kw = dict(CFG, **cfg_kw)
    cfg, cfg_j = TrustIRConfig(**kw), TrustIRConfig_j(**kw)
    rate = cfg.u_capacity / cfg.deadline_s
    return {
        "host_j": Host_j(cfg_j, ev_j_host, sim_clock=SimClock_j(rate)),
        "fused_j": Fused_j(cfg_j, ev_j, sim_clock=SimClock_j(rate)),
        "host_t": LoadShedder(cfg, ev_t, sim_clock=SimClock(rate),
                              device="cpu"),
        "fused_t": FusedLoadShedder(cfg, ev_t, sim_clock=SimClock(rate),
                                    device="cpu"),
    }


def _assert_parity(results, atol):
    base = results["fused_j"]
    for name, r in results.items():
        assert int(r.regime) == int(base.regime), name
        np.testing.assert_array_equal(r.tier, base.tier, err_msg=name)
        np.testing.assert_allclose(r.trust, base.trust, atol=atol,
                                   err_msg=name)
        assert (r.n_evaluated, r.n_cached, r.n_prior, r.uload) == (
            base.n_evaluated, base.n_cached, base.n_prior, base.uload), name
        assert r.response_time_s == pytest.approx(base.response_time_s)


PARITY_LOADS = [(96, Regime.NORMAL), (192, Regime.HEAVY),
                (410, Regime.VERY_HEAVY), (512, Regime.VERY_HEAVY)]


@pytest.mark.parametrize("n,regime", PARITY_LOADS)
def test_stub_evaluator_parity_per_regime(n, regime):
    sh = _shedders(_ev_t, _ev_j, _ev_np)
    keys, buckets, feats = _batch(n, 512, 1)
    res = {k: s.process(keys, buckets, feats, n_valid=n)
           for k, s in sh.items()}
    assert res["fused_t"].regime == regime
    assert int(Regime_j(int(regime))) == int(res["host_j"].regime)
    _assert_parity(res, atol=1e-5)
    assert (res["fused_t"].tier[:n] != TIER_INVALID).all()      # no-drop
    assert (res["fused_t"].tier[n:] == TIER_INVALID).all()


def test_stub_evaluator_parity_across_cache_reuse_stream():
    """Sequential batches share cache/prior state: the repeat of the
    first batch's keys hits the Trust DB identically everywhere, and the
    Trust DB itself stays bit-exact with the reference's."""
    sh = _shedders(_ev_t, _ev_j, _ev_np)
    for off in (1, 10_000, 1):
        keys, buckets, feats = _batch(192, 512, off)
        res = {k: s.process(keys, buckets, feats, n_valid=192)
               for k, s in sh.items()}
        _assert_parity(res, atol=1e-5)
    assert res["fused_t"].n_cached > 128
    for name in ("fused", "host"):
        cj, ct = sh[name + "_j"].cache, sh[name + "_t"].cache
        np.testing.assert_array_equal(
            ct["keys"].numpy().view(np.uint32), np.asarray(cj["keys"]))
        np.testing.assert_array_equal(ct["age"].numpy(),
                                      np.asarray(cj["age"]))
        np.testing.assert_allclose(ct["values"].numpy(),
                                   np.asarray(cj["values"]), atol=1e-5)
        np.testing.assert_allclose(sh[name + "_t"].prior["mean"].numpy(),
                                   np.asarray(sh[name + "_j"].prior["mean"]),
                                   rtol=1e-6)


@pytest.fixture(scope="module")
def smollm_pair():
    ev_j, mk = make_evaluator_j("smollm-135m", smoke=True, seed=0)
    params = jax.tree.map(np.asarray, T_j.init_params(
        jax.random.PRNGKey(0), get_config_j("smollm-135m", smoke=True)))
    ev_t, _ = make_evaluator("smollm-135m", smoke=True, params=params,
                             device="cpu")
    return ev_t, ev_j, mk


def test_smollm_evaluator_parity_stream(smollm_pair):
    """The smoke smollm on shared parameters through all four shedders:
    Normal, Heavy and Very-Heavy batches, then a repeat that hits."""
    ev_t, ev_j, mk = smollm_pair
    sh = _shedders(ev_t, ev_j, lambda c: np.asarray(
        ev_j({"tokens": jnp.asarray(c["tokens"])})))
    cap = 512
    for i, (n, regime) in enumerate(PARITY_LOADS[:3] + [(96, None)]):
        off = 1 if regime is None else 1 + i * 10_000
        keys = np.zeros(cap, np.uint32)
        keys[:n] = np.arange(off, off + n)
        buckets = np.zeros(cap, np.int32)
        feats = mk(cap, fseed=off)
        res = {k: s.process(keys, buckets, feats, n_valid=n)
               for k, s in sh.items()}
        _assert_parity(res, atol=1e-4)
        if regime is not None:
            assert res["fused_t"].regime == regime
    assert res["fused_t"].n_cached >= 80        # the repeat mostly hits


# ---------------------------------------------------------------------------
# ServingEngine fused on a SimClock with the other evaluator families
# ---------------------------------------------------------------------------

ENGINE_CFG = dict(u_capacity=96, u_threshold=96, deadline_s=0.5,
                  overload_deadline_s=1.0, chunk_size=16, cache_slots=1024,
                  cache_ways=2)


def _jax_params(arch):
    from repro.models import gnn as G_j
    cfg_j = get_config_j(arch, smoke=True)
    model = G_j if arch == "gcn-cora" else T_j
    return jax.tree.map(np.asarray, model.init_params(
        jax.random.PRNGKey(0), cfg_j))


# A float32 near-tie between an MoE token's k-th and (k+1)-th router
# probabilities is broken by rounding, which the two frameworks do at
# other places: such a token may take another expert (and another
# capacity rank) on each side.
ROUTER_TIE_GAP = 1e-5


def _router_tie_docs(monkeypatch, evaluate, seq_len):
    """``evaluate`` wrapped to note the documents (token rows, as bytes)
    in which some MoE layer's top-k choice sits within ROUTER_TIE_GAP of
    the next expert's probability."""
    from repro_torch.models import moe as M
    ties, apply = set(), M.apply
    seen = []

    def noting(p, x, cfg, **kw):
        probs = torch.softmax(x.float() @ p["router"]["w"].float(), dim=-1)
        top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
        seen.append((top[:, -2] - top[:, -1]) < ROUTER_TIE_GAP)
        return apply(p, x, cfg, **kw)

    monkeypatch.setattr(M, "apply", noting)

    def wrapped(chunk):
        seen.clear()
        out = evaluate(chunk)
        rows = torch.stack(seen).any(0).reshape(-1, seq_len).any(1)
        for row in torch.nonzero(rows)[:, 0].tolist():
            ties.add(chunk["tokens"][row].numpy().tobytes())
        return out

    return wrapped, ties


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen3-moe-30b-a3b",
                                  "gcn-cora"])
def test_engine_fused_parity_on_other_evaluators(arch, monkeypatch):
    """The smoke gemma2 (window, softcaps), qwen3-moe (capacity counted
    over every row of the fused step) and GCN (absolute edge ids in
    gathered chunks) through the port's and the reference's fused
    ``ServingEngine`` on shared parameters: regimes, tiers, counts and
    the Trust DB's keys and ages exactly equal, trust allclose 1e-4
    (for qwen3-moe, on every document without a router near-tie, which
    must be rare)."""
    from repro.core import SimClock as SimClock_j2
    from repro.scheduling import Priority as Priority_j
    from repro.scheduling import SchedulerConfig as SchedulerConfig_j
    from repro.serving.engine import ServingEngine as ServingEngine_j
    from repro_torch.scheduling import Priority, SchedulerConfig
    from repro_torch.serving.engine import ServingEngine

    ev_j, mk = make_evaluator_j(arch, smoke=True, seed=0)
    ev_t, _ = make_evaluator(arch, smoke=True, params=_jax_params(arch),
                             device="cpu")
    ties = set()
    if arch == "qwen3-moe-30b-a3b":
        ev_t, ties = _router_tie_docs(monkeypatch, ev_t, seq_len=31)
    rate = ENGINE_CFG["u_capacity"] / ENGINE_CFG["deadline_s"]
    sched = dict(max_batch_items=192, queue_capacity_requests=6)
    eng_j = ServingEngine_j(TrustIRConfig_j(**ENGINE_CFG), ev_j,
                            sim_clock=SimClock_j2(rate),
                            sched_cfg=SchedulerConfig_j(**sched),
                            drain_mode="fused", evaluate_batch=ev_j)
    eng_t = ServingEngine(TrustIRConfig(**ENGINE_CFG), ev_t,
                          sim_clock=SimClock(rate),
                          sched_cfg=SchedulerConfig(**sched),
                          drain_mode="fused", device="cpu")
    r = np.random.default_rng(5)
    sent = {}
    for i in range(10):
        n = int(r.integers(16, 120))
        keys = r.integers(1, 600, n).astype(np.uint32)
        buckets = r.integers(0, 4, n).astype(np.int32)
        feats = mk(n, fseed=i)
        prio = int(r.choice(4, p=[0.1, 0.2, 0.5, 0.2]))
        for eng, pcls in ((eng_t, Priority), (eng_j, Priority_j)):
            rid = eng.enqueue(keys, buckets, feats, priority=pcls(prio),
                              tenant=f"t{i % 3}")
        sent[rid] = (keys, feats)
        if i % 4 == 3:
            for eng in (eng_t, eng_j):
                eng.drain(1)
    for eng in (eng_t, eng_j):
        eng.drain()
    resp_t, resp_j = eng_t.completed, eng_j.completed
    assert [a.request_id for a in resp_t] == [b.request_id for b in resp_j]
    tie_keys, n_items = set(), 0
    for a, b in zip(resp_t, resp_j):
        assert (a.admitted, a.reason) == (b.admitted, b.reason)
        assert int(a.shed.regime) == int(b.shed.regime)
        np.testing.assert_array_equal(a.tier, b.tier)
        assert (a.shed.n_evaluated, a.shed.n_cached, a.shed.n_prior) == (
            b.shed.n_evaluated, b.shed.n_cached, b.shed.n_prior)
        assert (a.tier != TIER_INVALID).all()
        keys, feats = sent[a.request_id]
        free = np.ones(len(a.trust), bool)
        if ties:
            free = np.array([row.tobytes() not in ties
                             for row in feats["tokens"]])
            tie_keys |= set(keys[~free].tolist())
        n_items += len(free)
        np.testing.assert_allclose(a.trust[free], b.trust[free], atol=1e-4)
    assert len(tie_keys) <= 0.02 * n_items
    assert sum(a.shed.n_evaluated for a in resp_t if a.admitted) > 0
    assert len({int(a.shed.regime) for a in resp_t if a.admitted}) >= 2
    ct, cj = eng_t.shedder.cache, eng_j.shedder.cache
    keys_t = ct["keys"].numpy().view(np.uint32)
    np.testing.assert_array_equal(keys_t, np.asarray(cj["keys"]))
    np.testing.assert_array_equal(ct["age"].numpy(), np.asarray(cj["age"]))
    free = ~np.isin(keys_t, np.array(sorted(tie_keys), np.uint32))
    np.testing.assert_allclose(ct["values"].numpy()[free],
                               np.asarray(cj["values"])[free], atol=1e-4)


def test_max_evals_overflow_demotes_to_prior_never_drops():
    cfg = TrustIRConfig(**CFG)
    fused = FusedLoadShedder(cfg, _ev_t, max_evals=32, device="cpu",
                             sim_clock=SimClock(cfg.u_capacity
                                                / cfg.deadline_s))
    keys, buckets, feats = _batch(96, 128, 900)
    prior = float(fused.prior["mean"][0])
    res = fused.process(keys, buckets, feats, n_valid=96)
    assert res.n_evaluated == 32 and res.n_prior == 64
    assert (res.tier[:96] != TIER_INVALID).all()
    assert np.all(res.trust[res.tier == TIER_PRIOR] == prior)


def test_async_handle_defers_then_matches_sync_and_folds_back():
    cfg = TrustIRConfig(**CFG)
    sync = FusedLoadShedder(cfg, _ev_t, device="cpu")
    asyn = FusedLoadShedder(cfg, _ev_t, device="cpu")
    keys, buckets, feats = _batch(192, 256, 7)
    expect = sync.process(keys, buckets, feats, n_valid=192)
    handle = asyn.process_async(keys, buckets, feats, n_valid=192)
    assert isinstance(handle, PendingShed) and handle._result is None
    assert handle.is_ready()                     # CPU: always complete
    got = handle.result()
    assert got is handle.result()
    np.testing.assert_array_equal(expect.tier, got.tier)
    np.testing.assert_allclose(expect.trust, got.trust, atol=1e-6)
    _, hit = TC.lookup(asyn.cache, torch.from_numpy(
        keys.view(np.int32)))
    assert int(hit[:192].sum()) >= 150          # evaluations folded back


# ---------------------------------------------------------------------------
# DrainExecutor: the port's copy against the reference's, same script
# ---------------------------------------------------------------------------

class _Batch:
    def __init__(self, i, n=16):
        self.i = i
        self.item_keys = np.arange(1 + 100 * i, 1 + 100 * i + n,
                                   dtype=np.uint32)
        self.buckets = np.zeros(n, np.int32)
        self.features = {"x": np.full((n, D), float(i), np.float32)}
        self.n_valid = n


def _run_script(executor_cls, shedder, depth, n_batches, poison=None):
    """Submit ``n_batches``; returns the finalize/rescue log and the
    executor. ``poison`` = (kind, batch index): that batch raises in
    stage ("dispatch") or while it is finalized ("finalize")."""
    log = []
    kind, bad = poison or (None, None)
    real_stage = shedder.stage

    def stage(keys, *a, **kw):
        if kind == "dispatch" and keys[0] == 1 + 100 * bad:
            raise RuntimeError("transfer failed")
        return real_stage(keys, *a, **kw)

    def finalize(b, shed):
        if kind == "finalize" and b.i == bad:
            raise RuntimeError("evaluator OOM")
        return [("done", b.i, shed.n_evaluated)]

    shedder.stage = stage
    ex = executor_cls(shedder, finalize, depth=depth,
                      rescue=lambda b, exc: [("rescued", b.i, str(exc))])
    for i in range(n_batches):
        log.append(("submit", i, ex.in_flight))
        log.extend(ex.submit(_Batch(i)))
    log.extend(ex.flush())
    return log, ex


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("poison", [None, ("dispatch", 2),
                                    ("finalize", 1)])
def test_executor_ordering_and_rescue_match_reference(depth, poison):
    cfg, cfg_j = TrustIRConfig(**CFG), TrustIRConfig_j(**CFG)
    log_t, ex_t = _run_script(DrainExecutor, FusedLoadShedder(
        cfg, _ev_t, device="cpu"), depth, 5, poison)
    log_j, ex_j = _run_script(DrainExecutor_j, Fused_j(cfg_j, _ev_j),
                              depth, 5, poison)
    assert log_t == log_j
    done = [e[1] for e in log_t if e[0] in ("done", "rescued")]
    assert sorted(done) == list(range(5))       # exactly one answer each
    assert ex_t.in_flight == 0
    assert (ex_t.n_dispatched, ex_t.n_completed, ex_t.n_rescued) == (
        ex_j.n_dispatched, ex_j.n_completed, ex_j.n_rescued)
    if poison is not None:
        assert ex_t.n_rescued == 1
        assert [e for e in log_t if e[0] == "rescued"][0][1] == poison[1]


def test_executor_depth2_keeps_window_open_between_submits():
    ex = DrainExecutor(FusedLoadShedder(TrustIRConfig(**CFG), _ev_t,
                                        device="cpu"),
                       lambda b, shed: [b.i], depth=2)
    assert ex.submit(_Batch(0)) == [] and ex.in_flight == 1
    assert ex.submit(_Batch(1)) == [] and ex.in_flight == 2
    assert ex.submit(_Batch(2)) == [0] and ex.in_flight == 2
    assert ex.poll() == [1, 2]                  # CPU handles are ready
    assert ex.in_flight == 0


def test_executor_without_rescue_reraises():
    sh = LoadShedder(TrustIRConfig(**CFG), lambda c: (_ for _ in ()).throw(
        RuntimeError("boom")), device="cpu")
    ex = DrainExecutor(sh, lambda b, shed: [])
    with pytest.raises(RuntimeError):
        ex.submit(_Batch(0))
