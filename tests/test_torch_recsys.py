"""The port's BST, MIND and two-tower recommenders and their embedding
bags against ``repro.models.recsys`` on the CPU, with the reference's own
initialized parameters (``params_from_jax``): ``embedding_bag`` (every
combiner, masks, weights) and ``ragged_embedding_bag`` (unsorted bag
ids, empty bags, ids out of range), each model's forward and scores at
smoke width, ``make_evaluator`` for each arch against the reference's
evaluator (scores in [0, 5]), and a ``ServingEngine`` on SimClocks with
each evaluator: the port's host and fused drains and the reference's
fused drain give the same tiers, admissions, reasons and regimes.

Tolerances: float32, atol 1e-5 on the bags and logits, 1e-4 on trust in
[0, 5] (the frameworks sum the matmuls in other orders)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_j
from repro.configs.base import EmbeddingTableConfig as Table_j
from repro.configs.base import TrustIRConfig as TrustIRConfig_j
from repro.configs.registry import get_bundle as get_bundle_j
from repro.core import SimClock as SimClock_j
from repro.models.recsys import bst as bst_j
from repro.models.recsys import embedding as E_j
from repro.models.recsys import mind as mind_j
from repro.models.recsys import two_tower as two_tower_j
from repro.scheduling import Priority as Priority_j
from repro.scheduling import SchedulerConfig as SchedulerConfig_j
from repro.serving.engine import ServingEngine as ServingEngine_j
from repro.serving.evaluators import make_evaluator as make_evaluator_j
from repro_torch.configs import TrustIRConfig, get_config
from repro_torch.configs import bst as bst_cfg
from repro_torch.configs import mind as mind_cfg
from repro_torch.configs import two_tower as two_tower_cfg
from repro_torch.configs.base import cap_table_rows
from repro_torch.core.shedder import TIER_INVALID, SimClock
from repro_torch.models.recsys import bst, mind, two_tower
from repro_torch.models.recsys import embedding as E
from repro_torch.scheduling import Priority, SchedulerConfig
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.evaluators import make_evaluator

ATOL = 1e-5
TRUST_ATOL = 1e-4
ARCHS = {"bst": (bst, bst_j, bst_cfg), "mind": (mind, mind_j, mind_cfg),
         "two-tower-retrieval": (two_tower, two_tower_j, two_tower_cfg)}


def _params(arch, seed=0):
    """The reference's initialized parameters: as jnp for the reference,
    as the port's tensors (through ``params_from_jax``) and as numpy."""
    mod, mod_j, _ = ARCHS[arch]
    cfg_j = get_config_j(arch, smoke=True)
    np_params = jax.tree.map(np.asarray, mod_j.init_params(
        jax.random.PRNGKey(seed), cfg_j))
    return (jax.tree.map(jnp.asarray, np_params),
            mod.params_from_jax(np_params, device="cpu"), np_params)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# embedding bags
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def table():
    p = jax.tree.map(np.asarray, E_j.table_init(
        jax.random.PRNGKey(3), Table_j(name="t", vocab=50, dim=8)))
    return {"table": jnp.asarray(p["table"])}, {
        "table": torch.from_numpy(np.array(p["table"]))}


@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
@pytest.mark.parametrize("masked,weighted", [(False, False), (True, False),
                                             (False, True), (True, True)],
                         ids=["plain", "mask", "weights", "mask-weights"])
def test_embedding_bag_matches_reference(table, combiner, masked, weighted):
    pj, pt = table
    r = np.random.default_rng(7)
    idx = r.integers(-3, 60, size=(9, 5)).astype(np.int32)   # clipped ends
    mask = (r.random((9, 5)) < 0.6).astype(np.float32) if masked else None
    if masked:
        mask[0] = 0.0                                        # an empty bag
    w = r.normal(size=(9, 5)).astype(np.float32) if weighted else None
    want = E_j.embedding_bag(
        pj, jnp.asarray(idx), None if mask is None else jnp.asarray(mask),
        combiner=combiner,
        weights=None if w is None else jnp.asarray(w))
    got = E.embedding_bag(
        pt, torch.from_numpy(idx),
        None if mask is None else torch.from_numpy(mask),
        combiner=combiner, weights=None if w is None else torch.from_numpy(w))
    assert tuple(got.shape) == (9, 8)
    _close(got, want)


@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
def test_ragged_embedding_bag_matches_reference(table, combiner):
    """Unsorted bag ids, bags 2 and 5 empty, one id past ``n_bags`` and
    one negative (dropped, as ``segment_sum`` drops them)."""
    pj, pt = table
    r = np.random.default_rng(11)
    seg = r.choice([0, 1, 3, 4, 6], size=40).astype(np.int32)
    seg[[5, 17]] = (7, -1)
    flat = r.integers(0, 50, size=40).astype(np.int32)
    want = E_j.ragged_embedding_bag(pj, jnp.asarray(flat), jnp.asarray(seg),
                                    7, combiner=combiner)
    got = E.ragged_embedding_bag(pt, torch.from_numpy(flat),
                                 torch.from_numpy(seg), 7, combiner=combiner)
    assert tuple(got.shape) == (7, 8)
    _close(got, want)
    assert not got[[2, 5]].any()
    # index order within each bag, one add a position: exactly the
    # running sums of the rows in their original order
    if combiner == "sum":
        rows = pt["table"][torch.from_numpy(flat).long()]
        for b in (0, 3):
            acc = torch.zeros(8)
            for i in np.flatnonzero(seg == b):
                acc = acc + rows[i]
            assert torch.equal(got[b], acc)


def test_bags_reject_unknown_combiners(table):
    _, pt = table
    idx = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        E.embedding_bag(pt, idx, combiner="median")
    with pytest.raises(ValueError):
        E.ragged_embedding_bag(pt, idx[0], idx[0], 2, combiner="median")


# ---------------------------------------------------------------------------
# the models at smoke width, on the reference's parameters
# ---------------------------------------------------------------------------

def test_bst_forward_and_scores_match_reference():
    pj, pt, _ = _params("bst")
    cfg_j, cfg = get_config_j("bst", smoke=True), get_config("bst",
                                                            smoke=True)
    r = np.random.default_rng(1)
    iv = cfg.tables[0].vocab
    hist = r.integers(0, iv, size=(17, cfg.seq_len)).astype(np.int32)
    target = r.integers(0, iv, size=17).astype(np.int32)
    other = np.stack([r.integers(0, t.vocab, size=17)
                      for t in cfg.tables[1:]], axis=1).astype(np.int32)
    args_j = [jnp.asarray(a) for a in (hist, target, other)]
    args_t = [torch.from_numpy(a) for a in (hist, target, other)]
    got = bst.forward(pt, cfg, *args_t)
    assert got.dtype == torch.float32 and tuple(got.shape) == (17,)
    _close(got, bst_j.forward(pj, cfg_j, *args_j))
    s = bst.relevance_scores(pt, cfg, *args_t, trust_scale=5.0)
    _close(s, bst_j.relevance_scores(pj, cfg_j, *args_j, trust_scale=5.0),
           TRUST_ATOL)


def test_mind_interests_and_scores_match_reference():
    pj, pt, _ = _params("mind")
    cfg_j, cfg = get_config_j("mind", smoke=True), get_config("mind",
                                                             smoke=True)
    r = np.random.default_rng(2)
    iv = cfg.tables[0].vocab
    hist = r.integers(0, iv, size=(13, cfg.hist_len)).astype(np.int32)
    mask = (r.random((13, cfg.hist_len)) < 0.7).astype(np.float32)
    mask[0] = 1.0
    mask[1, 1:] = 0.0                     # one behaviour only
    item = r.integers(0, iv, size=13).astype(np.int32)
    aj = [jnp.asarray(a) for a in (hist, mask, item)]
    at = [torch.from_numpy(a) for a in (hist, mask, item)]
    v = mind.user_interests(pt, cfg, at[0], at[1])
    assert tuple(v.shape) == (13, cfg.n_interests, cfg.embed_dim)
    _close(v, mind_j.user_interests(pj, cfg_j, aj[0], aj[1]))
    _close(mind.relevance_scores(pt, cfg, *at),
           mind_j.relevance_scores(pj, cfg_j, *aj), TRUST_ATOL)


def test_two_tower_embeddings_and_scores_match_reference():
    pj, pt, _ = _params("two-tower-retrieval")
    arch = "two-tower-retrieval"
    cfg_j, cfg = get_config_j(arch, smoke=True), get_config(arch, smoke=True)
    r = np.random.default_rng(3)
    q = {"user_id": r.integers(0, cfg.tables[0].vocab, size=3),
         "user_feats": r.integers(0, cfg.tables[2].vocab, size=(3, 8))}
    item = r.integers(0, cfg.tables[1].vocab, size=21)
    feats = r.integers(0, cfg.tables[3].vocab, size=(21, 8))
    qj = {k: jnp.asarray(v.astype(np.int32)) for k, v in q.items()}
    qt = {k: torch.from_numpy(v.astype(np.int32)) for k, v in q.items()}
    ij, fj = jnp.asarray(item.astype(np.int32)), jnp.asarray(
        feats.astype(np.int32))
    it, ft = torch.from_numpy(item.astype(np.int32)), torch.from_numpy(
        feats.astype(np.int32))
    u = two_tower.user_embed(pt, cfg, qt["user_id"], qt["user_feats"])
    _close(u, two_tower_j.user_embed(pj, cfg_j, qj["user_id"],
                                     qj["user_feats"]))
    np.testing.assert_allclose(u.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    _close(two_tower.item_embed(pt, cfg, it, ft),
           two_tower_j.item_embed(pj, cfg_j, ij, fj))
    s = two_tower.retrieval_scores(pt, cfg, qt, it, ft)
    assert tuple(s.shape) == (3, 21)
    _close(s, two_tower_j.retrieval_scores(pj, cfg_j, qj, ij, fj),
           TRUST_ATOL)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_evaluator_matches_reference_evaluator(arch):
    """``make_evaluator`` on the reference's parameters: the same
    ``make_features`` draws and scores in [0, 5] within 1e-4 of the
    reference's evaluator."""
    ev_j, mk_j = make_evaluator_j(arch, smoke=True, seed=0)
    _, _, params = _params(arch)
    ev, mk = make_evaluator(arch, smoke=True, params=params, device="cpu")
    feats = mk(40, fseed=4)
    for name, arr in mk_j(40, 4).items():
        np.testing.assert_array_equal(feats[name], arr)
    want = np.asarray(ev_j({k: jnp.asarray(v) for k, v in feats.items()}))
    got = ev({k: torch.from_numpy(v) for k, v in feats.items()})
    assert got.shape == (40,) and got.dtype == torch.float32
    assert (got >= 0).all() and (got <= 5).all()
    np.testing.assert_allclose(got.numpy(), want, atol=TRUST_ATOL, rtol=0)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_configs_and_seeded_init_match_reference(arch):
    """Published and smoke configs field for field with the reference's
    (and its ``source``); the port's own seeded init has the reference's
    shapes and repeats itself; ``max_table_rows`` caps rows only."""
    mod, mod_j, cfg_mod = ARCHS[arch]
    for smoke in (False, True):
        cfg, cfg_j = get_config(arch, smoke=smoke), get_config_j(
            arch, smoke=smoke)
        a, b = dataclasses.asdict(cfg), dataclasses.asdict(cfg_j)
        assert all(t["count"] == 1 for t in b["tables"])
        assert a == b
    assert cfg_mod.SOURCE == get_bundle_j(arch).source
    cfg = get_config(arch, smoke=True)
    tp = mod.init_params(cfg, torch.Generator().manual_seed(0))
    ref = jax.tree.map(lambda x: tuple(x.shape), mod_j.init_params(
        jax.random.PRNGKey(0), get_config_j(arch, smoke=True)))
    got = jax.tree.map(lambda t: tuple(t.shape), tp)
    assert got == jax.tree.map(tuple, ref,
                               is_leaf=lambda x: isinstance(x, tuple))
    ev_a, mk = make_evaluator(arch, smoke=True, seed=5, device="cpu")
    ev_b, _ = make_evaluator(arch, smoke=True, seed=5, device="cpu")
    feats = {k: torch.from_numpy(v) for k, v in mk(8).items()}
    assert torch.equal(ev_a(feats), ev_b(feats))
    full = get_config(arch)
    capped = cap_table_rows(full, 20_000_000)
    assert [t.dim for t in capped.tables] == [t.dim for t in full.tables]
    assert max(t.vocab for t in capped.tables) <= 20_000_000
    ev_c, mk_c = make_evaluator(arch, smoke=True, seed=5, device="cpu",
                                max_table_rows=40)
    feats = mk_c(16)
    assert all(int(v.max()) < 40 for k, v in feats.items()
               if v.dtype == np.int32 and k != "user_id")
    assert ev_c({k: torch.from_numpy(v) for k, v in feats.items()}
                ).shape == (16,)


# ---------------------------------------------------------------------------
# the serving engine with each evaluator
# ---------------------------------------------------------------------------

CFG = dict(u_capacity=128, u_threshold=128, deadline_s=0.5,
           overload_deadline_s=1.0, chunk_size=16, cache_slots=1024,
           cache_ways=2)
SCHED = dict(max_batch_items=256, queue_capacity_requests=6)
RATE = CFG["u_capacity"] / CFG["deadline_s"]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_engine_host_and_fused_agree_with_reference(arch):
    """One seeded request stream (Zipf sizes, four priorities, three
    tenants) through the port's host- and fused-drain engines and the
    reference's fused engine on SimClocks: identical tiers, admissions,
    reasons, regimes and counts; trust within 1e-4; nothing dropped."""
    ev_j, mk = make_evaluator_j(arch, smoke=True, seed=0)
    _, _, params = _params(arch)
    ev_t, _ = make_evaluator(arch, smoke=True, params=params, device="cpu")
    engines = [ServingEngine(TrustIRConfig(**CFG), ev_t,
                             sim_clock=SimClock(RATE),
                             sched_cfg=SchedulerConfig(**SCHED),
                             drain_mode=mode, device="cpu")
               for mode in ("host", "fused")]
    eng_j = ServingEngine_j(TrustIRConfig_j(**CFG), ev_j,
                            sim_clock=SimClock_j(RATE),
                            sched_cfg=SchedulerConfig_j(**SCHED),
                            drain_mode="fused", evaluate_batch=ev_j)
    r = np.random.default_rng(4)
    for i in range(16):
        n = int(r.integers(16, 160))
        keys = r.integers(1, 3000, n).astype(np.uint32)
        buckets = r.integers(0, 4, n).astype(np.int32)
        feats = mk(n, fseed=i)
        prio = int(r.choice(4, p=[0.1, 0.2, 0.5, 0.2]))
        for eng, pcls in ((engines[0], Priority), (engines[1], Priority),
                          (eng_j, Priority_j)):
            eng.enqueue(keys, buckets, feats, priority=pcls(prio),
                        tenant=f"t{i % 3}")
        if i % 5 == 4:
            for eng in (*engines, eng_j):
                eng.drain(1)
    for eng in (*engines, eng_j):
        eng.drain()
    ref = eng_j.completed
    for eng in engines:
        assert [x.request_id for x in eng.completed] == \
            [x.request_id for x in ref]
        for a, b in zip(eng.completed, ref):
            assert (a.admitted, a.reason, int(a.shed.regime),
                    a.shed.n_evaluated, a.shed.n_cached, a.shed.n_prior) \
                == (b.admitted, b.reason, int(b.shed.regime),
                    b.shed.n_evaluated, b.shed.n_cached, b.shed.n_prior)
            np.testing.assert_array_equal(a.tier, b.tier)
            np.testing.assert_allclose(a.trust, b.trust, atol=TRUST_ATOL)
            if a.admitted:
                assert (a.tier != TIER_INVALID).all()
                assert (a.trust >= 0).all() and (a.trust <= 5).all()
        assert eng.scheduler_stats() == eng_j.scheduler_stats()
    assert sum(x.shed.n_evaluated for x in ref) > 0
    assert len({int(x.shed.regime) for x in ref if x.admitted}) >= 2
