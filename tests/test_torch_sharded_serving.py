"""The mesh-sharded serving path on the CPU: ``make_sharded_evaluator``
against the replicated ``make_evaluator`` (the reference's own sharded
evaluator raises on this jax, so the port is held to the replicated one,
as the reference's tests hold theirs), ``feature_sharding`` through the
fused drain, the engine and a replica's restart, and ``core.shedder``'s
``gather_eval_indices`` / ``fused_shed_eval`` against the reference.

A world of one (the (1, 1) mesh one H100 is) runs in the test process and
must give the replicated scores bit for bit. Multi-rank meshes, (1, 2),
(2, 1), (2, 2) and (1, 4), run as gloo ranks: one subprocess per rank,
each with its own timeout, meeting through a ``FileStore`` in the test's
temporary directory (no TCP port), on the same seeded weights and
features. Their row-parallel all-reduces reorder float32 sums, so scores
are held to 1e-5 of the largest score; tiers, counts and the cache are
exact. smollm's 4/2 heads stay local on a model axis of 2 and are
gathered on 4."""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import TrustIRConfig as TrustIRConfig_j
from repro.core import average_trust as AT_j
from repro.core import trust_cache as TC_j
from repro.core.shedder import fused_shed_eval as fused_shed_eval_j
from repro.core.shedder import gather_eval_indices as gather_j
from repro.core.shedder import shed_plan as shed_plan_j
from repro_torch.configs import TrustIRConfig
from repro_torch.core import average_trust as AT
from repro_torch.core import trust_cache as TC
from repro_torch.core import fused_shed_eval, gather_eval_indices
from repro_torch.core.fused_shedder import FusedLoadShedder
from repro_torch.core.shedder import (TIER_EVAL, TIER_INVALID, SimClock,
                                      keys_as_int32, shed_plan)
from repro_torch.launch.mesh import destroy_world, make_host_mesh
from repro_torch.scheduling import SchedulerConfig
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.evaluators import (make_evaluator,
                                            make_sharded_evaluator)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
RANK_TIMEOUT_S = 240
REL_TOL = 1e-5

ARCHS = ("smollm-135m", "dlrm-mlperf", "bst", "mind", "two-tower-retrieval",
         "gcn-cora", "qwen2.5-14b", "gemma2-2b")
# 8 rows divide every DP size; 5 rows divide none, so the batch stays
# whole (replicated) on every rank
SIZES = (8, 5)
MESHES = ((1, 2), (2, 1), (2, 2), (1, 4))

CFG = dict(u_capacity=4096, u_threshold=2048, deadline_s=0.5,
           overload_deadline_s=1.0, very_heavy_weight=0.5, chunk_size=16,
           cache_slots=1024, cache_ways=2)


def _cfg(**kw):
    return TrustIRConfig(**dict(CFG, **kw))


def _tensors(feats):
    return {k: torch.as_tensor(v) for k, v in feats.items()}


def _replicated_scores(arch, n):
    ev, mk = make_evaluator(arch, smoke=True, device="cpu")
    return ev(_tensors(mk(n, fseed=n))).numpy()


# ---------------------------------------------------------------------------
# a world of one: the (1, 1) mesh, in this process
# ---------------------------------------------------------------------------

@pytest.fixture
def mesh11():
    assert not dist.is_initialized()
    yield make_host_mesh((1, 1), device="cpu")
    destroy_world()
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", ARCHS)
def test_world_of_one_scores_equal_replicated_bits(arch, mesh11):
    se = make_sharded_evaluator(arch, mesh=mesh11, smoke=True, device="cpu")
    assert se.mesh is mesh11
    for n in SIZES:
        feats = se.make_features(n, fseed=n)
        got = se.evaluate(_tensors(feats)).numpy()
        np.testing.assert_array_equal(got, _replicated_scores(arch, n))
    # the reference's calling convention: features placed with the
    # evaluator's own input sharding
    from repro_torch.distribution.placement import device_put
    feats = se.make_features(8, fseed=8)
    sh = se.feature_sharding(feats)
    placed = {k: device_put(v, sh[k]) for k, v in feats.items()}
    np.testing.assert_array_equal(se.evaluate(placed).numpy(),
                                  _replicated_scores(arch, 8))


def test_sharded_evaluator_over_given_params_shares_tensors(mesh11):
    ev, mk = make_evaluator("dlrm-mlperf", smoke=True, device="cpu")
    se = make_sharded_evaluator("dlrm-mlperf", mesh=mesh11, smoke=True,
                                device="cpu", params=ev.params)
    for name, tab in ev.params["tables"].items():
        dt = se.evaluate.params["tables"][name]["table"]
        assert dt.to_local().data_ptr() == tab["table"].data_ptr()
    f = _tensors(mk(64, fseed=4))
    np.testing.assert_array_equal(se.evaluate(f).numpy(), ev(f).numpy())


def test_default_mesh_is_the_host_mesh_of_one():
    assert not dist.is_initialized()
    try:
        se = make_sharded_evaluator("smollm-135m", smoke=True, device="cpu")
        assert se.mesh.mesh_dim_names == ("data", "model")
        assert tuple(se.mesh.shape) == (1, 1)
        assert dist.get_world_size() == 1
    finally:
        destroy_world()


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"])
def test_moe_archs_raise_naming_item_6b(arch):
    """Item 6b is done: the MoE archs no longer raise; on a world of one
    their sharded evaluators give the replicated scores bit for bit (the
    multi-rank meshes are ``tests/test_torch_moe_ep.py``'s)."""
    try:
        se = make_sharded_evaluator(arch, smoke=True, device="cpu")
        for n in SIZES:
            got = se.evaluate(_tensors(se.make_features(n, fseed=n)))
            np.testing.assert_array_equal(got.numpy(),
                                          _replicated_scores(arch, n))
    finally:
        destroy_world()
    assert not dist.is_initialized()


def test_feature_sharding_rule(mesh11):
    from torch.distributed.tensor import Replicate, Shard
    se = make_sharded_evaluator("bst", mesh=mesh11, smoke=True, device="cpu")
    sh = se.feature_sharding(se.make_features(6))
    assert set(sh) == {"hist", "target", "other"}
    assert sh["hist"].placements == (Shard(0), Replicate())
    assert str(sh["hist"].spec) == "PartitionSpec(('data',), None)"
    g = make_sharded_evaluator("gcn-cora", mesh=mesh11, smoke=True,
                               device="cpu")
    assert all(s.placements == (Replicate(), Replicate())
               for s in g.feature_sharding(g.make_features(4)).values())


def _batch(n_valid, cap, off, mk, fseed=0):
    keys = np.zeros(cap, np.uint32)
    keys[:n_valid] = np.arange(off, off + n_valid)
    return keys, np.zeros(cap, np.int32), mk(cap, fseed=fseed)


def test_fused_shedder_stages_through_feature_sharding(mesh11):
    """``stage`` places every leaf with the evaluator's input sharding;
    the step gives the tiers and trust it gives without it, and folds
    the evaluations back exactly once: a second pass over the same keys
    reads the cache instead of re-evaluating."""
    from torch.distributed.tensor import DTensor
    se = make_sharded_evaluator("dlrm-mlperf", mesh=mesh11, smoke=True,
                                device="cpu")
    cfg = _cfg()
    rate = cfg.u_capacity / cfg.deadline_s
    sharded = FusedLoadShedder(cfg, se.evaluate, device="cpu",
                               feature_sharding=se.feature_sharding,
                               sim_clock=SimClock(rate))
    plain = FusedLoadShedder(cfg, se.evaluate, device="cpu",
                             sim_clock=SimClock(rate))
    keys, buckets, feats = _batch(96, 128, 1, se.make_features)
    staged = sharded.stage(keys, buckets, feats, n_valid=96)
    want = se.feature_sharding(feats)
    for k, v in staged.feats_t.items():
        assert isinstance(v, DTensor)
        assert v.placements == want[k].placements
    prior_before = sharded.prior["mean"].clone()
    res = sharded.dispatch_staged(staged).result()
    ref = plain.process(keys, buckets, feats, n_valid=96)
    np.testing.assert_array_equal(res.tier, ref.tier)
    np.testing.assert_array_equal(res.trust, ref.trust)
    assert res.n_evaluated == 96
    _, hit = TC.lookup(sharded.cache, torch.as_tensor(keys_as_int32(keys)))
    assert int(hit[:96].sum()) >= 85       # minus same-batch way losses
    assert not torch.equal(sharded.prior["mean"], prior_before)
    res2 = sharded.process(keys, buckets, feats, n_valid=96)
    assert res2.n_cached >= 85             # read back, not re-run
    assert res2.n_evaluated <= 96 - res2.n_cached


def test_engine_sharded_window_exactly_one_response_at_depth(mesh11):
    """Wall clock, fused, pipeline depth 2, a sharded evaluator: every
    request answered exactly once across the open window."""
    se = make_sharded_evaluator("dlrm-mlperf", mesh=mesh11, smoke=True,
                                device="cpu")
    eng = ServingEngine(_cfg(pipeline_depth=2), se.evaluate,
                        drain_mode="fused", evaluate_batch=se.evaluate,
                        feature_sharding=se.feature_sharding, device="cpu",
                        sched_cfg=SchedulerConfig(max_batch_items=64))
    assert eng.shedder.feature_sharding is se.feature_sharding
    rids = []
    for i in range(6):
        keys = np.arange(i * 1000 + 1, i * 1000 + 33, dtype=np.uint32)
        rids.append(eng.enqueue(keys, np.zeros(32, np.int32),
                                se.make_features(32, fseed=i)))
        eng.drain(max_batches=1, flush=False)
    eng.flush()
    got = [r.request_id for r in eng.completed]
    assert sorted(got) == sorted(rids) and len(set(got)) == len(got)
    for r in eng.completed:
        assert (r.tier != TIER_INVALID).all()


def test_host_engine_ignores_feature_sharding():
    eng = ServingEngine(_cfg(), lambda c: c["x"].sum(-1), device="cpu",
                        drain_mode="host", feature_sharding=lambda f: 1 / 0)
    assert not hasattr(eng.shedder, "feature_sharding")


def test_replica_keeps_feature_sharding_across_restart():
    from repro_torch.cluster.replica import ReplicaHandle

    def fs(features):
        return {}
    rep = ReplicaHandle("r0", _cfg(), lambda c: c["x"].sum(-1),
                        drain_mode="fused", sim_rate_items_per_s=1e4,
                        feature_sharding=fs, device="cpu")
    assert rep.engine.shedder.feature_sharding is fs
    old = rep.engine
    rep.restart(now_t=1.0)
    assert rep.engine is not old
    assert rep.engine.shedder.feature_sharding is fs


def test_serve_sharded_needs_fused_drain():
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit, match="add --drain-mode fused"):
        main(["--device", "cpu", "--sync", "--sharded"])
    assert not dist.is_initialized()


def test_serve_sharded_on_the_cpu_exits_0(capsys):
    from repro_torch.launch.serve import main
    rc = main(["--device", "cpu", "--sync", "--sharded", "--drain-mode",
               "fused", "--corpus", "192", "--n-requests", "3"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[sync] [drain=fused depth=2]" in out
    assert sum(l.startswith("  req ") for l in out.splitlines()) == 3
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# gloo ranks: (1, 2), (2, 1), (2, 2), (1, 4)
# ---------------------------------------------------------------------------

_RANK = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, rdv, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
shape = tuple(int(s) for s in sys.argv[5].split("x"))
archs, sizes = sys.argv[6].split(","), [int(s) for s in sys.argv[7].split(",")]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                        world_size=world)
from repro_torch.configs import TrustIRConfig
from repro_torch.core.fused_shedder import FusedLoadShedder
from repro_torch.core.shedder import SimClock
from repro_torch.launch.mesh import destroy_world, mesh_from_devices
from repro_torch.scheduling import SchedulerConfig
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.evaluators import make_sharded_evaluator

mesh = mesh_from_devices(range(world), shape, ("data", "model"),
                         device="cpu")
res = {}
for arch in archs:
    se = make_sharded_evaluator(arch, mesh=mesh, smoke=True, device="cpu")
    for n in sizes:
        f = {k: torch.as_tensor(v)
             for k, v in se.make_features(n, fseed=n).items()}
        res[f"{arch}/{n}"] = se.evaluate(f).numpy()

# the fused drain and the engine, on a SimClock: every rank takes the same
# host decisions, so every rank launches the same collectives
se = make_sharded_evaluator("dlrm-mlperf", mesh=mesh, smoke=True,
                            device="cpu")
cfg = TrustIRConfig(**CFG)
rate = cfg.u_capacity / cfg.deadline_s
keys = np.zeros(128, np.uint32)
keys[:96] = np.arange(1, 97)
feats = se.make_features(128, fseed=7)
for name, fs in (("sharded", se.feature_sharding), ("plain", None)):
    sh = FusedLoadShedder(cfg, se.evaluate, device="cpu",
                          feature_sharding=fs, sim_clock=SimClock(rate))
    for step in range(2):
        r = sh.process(keys, np.zeros(128, np.int32), feats, n_valid=96)
        res[f"shed/{name}/{step}/tier"] = r.tier
        res[f"shed/{name}/{step}/trust"] = r.trust
        res[f"shed/{name}/{step}/counts"] = np.array(
            [r.n_evaluated, r.n_cached, r.n_prior])
    res[f"shed/{name}/cache_keys"] = sh.cache["keys"].numpy()
    res[f"shed/{name}/prior"] = sh.prior["mean"].numpy()
eng = ServingEngine(TrustIRConfig(**dict(CFG, pipeline_depth=2)),
                    se.evaluate, drain_mode="fused",
                    evaluate_batch=se.evaluate,
                    feature_sharding=se.feature_sharding, device="cpu",
                    sim_clock=SimClock(rate),
                    sched_cfg=SchedulerConfig(max_batch_items=64))
rids = []
for i in range(6):
    k = np.arange(i * 1000 + 1, i * 1000 + 33, dtype=np.uint32)
    rids.append(eng.enqueue(k, np.zeros(32, np.int32),
                            se.make_features(32, fseed=i)))
    eng.drain(max_batches=1, flush=False)
eng.flush()
res["engine/rids"] = np.array(rids)
res["engine/got"] = np.array([r.request_id for r in eng.completed])
res["engine/trust"] = np.concatenate([r.trust for r in eng.completed])
destroy_world()
np.savez(f"{out}/rank{rank}.npz", **res)
""".replace("CFG)", f"{CFG!r})").replace("(CFG,", f"({CFG!r},")


def _run_ranks(shape, tmp):
    world = int(np.prod(shape))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(world), str(tmp / "rdv"),
         str(tmp), "x".join(map(str, shape)), ",".join(ARCHS),
         ",".join(map(str, SIZES))], env=ENV, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        errs = [p.communicate(timeout=RANK_TIMEOUT_S)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * world, errs
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module", params=MESHES,
                ids=lambda s: "x".join(map(str, s)))
def ranks(request, tmp_path_factory):
    shape = request.param
    return shape, _run_ranks(shape, tmp_path_factory.mktemp(
        "ranks" + "x".join(map(str, shape))))


@pytest.mark.parametrize("arch", ARCHS)
def test_gloo_mesh_scores_match_replicated(arch, ranks):
    shape, outs = ranks
    for n in SIZES:
        want = _replicated_scores(arch, n)
        for out in outs:            # every rank holds every item's score
            got = out[f"{arch}/{n}"]
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=REL_TOL * np.abs(want).max())
        for out in outs[1:]:
            np.testing.assert_array_equal(out[f"{arch}/{n}"],
                                          outs[0][f"{arch}/{n}"])


def test_gloo_mesh_fused_drain_and_engine(ranks):
    shape, outs = ranks
    for out in outs:
        for step in range(2):
            s, p = (f"shed/sharded/{step}", f"shed/plain/{step}")
            np.testing.assert_array_equal(out[s + "/tier"], out[p + "/tier"])
            np.testing.assert_array_equal(out[s + "/counts"],
                                          out[p + "/counts"])
            np.testing.assert_allclose(out[s + "/trust"], out[p + "/trust"],
                                       rtol=0, atol=REL_TOL * 5.0)
        ev, cached, _ = out["shed/sharded/0/counts"]
        assert ev == 96 and cached == 0
        assert out["shed/sharded/1/counts"][1] >= 85   # folded back once
        np.testing.assert_array_equal(out["shed/sharded/cache_keys"],
                                      out["shed/plain/cache_keys"])
        got, rids = out["engine/got"], out["engine/rids"]
        assert sorted(got) == sorted(rids) and len(set(got)) == len(got)
        np.testing.assert_array_equal(out["engine/trust"],
                                      outs[0]["engine/trust"])


# ---------------------------------------------------------------------------
# core.shedder: gather_eval_indices and fused_shed_eval (ROADMAP item 7)
# ---------------------------------------------------------------------------

PLAN_KW = dict(deadline_s=0.5, overload_deadline_s=1.0,
               very_heavy_weight=0.5)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("max_evals", [64, 17])
def test_gather_eval_indices_matches_reference(seed, max_evals):
    r = np.random.default_rng(seed)
    n = 64
    valid = np.arange(n) < r.integers(1, n + 1)
    hit = r.random(n) < 0.3
    ucap, uthr = int(r.integers(1, 40)), int(r.integers(0, 30))
    tier_j = shed_plan_j(jnp.asarray(valid), jnp.asarray(hit), ucap, uthr,
                         **PLAN_KW)["tier"]
    tier = shed_plan(torch.as_tensor(valid), torch.as_tensor(hit), ucap,
                     uthr, **PLAN_KW)["tier"]
    np.testing.assert_array_equal(tier.numpy(), np.asarray(tier_j))
    idx_j, ok_j = gather_j(tier_j, max_evals)
    idx, ok = gather_eval_indices(tier, max_evals)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
    assert (tier.numpy()[idx.numpy()[ok.numpy()]] == TIER_EVAL).all()


W = np.linspace(-1.0, 1.0, 8).astype(np.float32)


@pytest.mark.parametrize("n_valid,ucap,uthr,max_evals", [
    (50, 64, 64, 64), (100, 40, 30, 128), (128, 16, 8, 32), (10, 4, 2, 10)])
def test_fused_shed_eval_matches_reference(n_valid, ucap, uthr, max_evals):
    cfg = TrustIRConfig(cache_slots=256, cache_ways=2, prior_buckets=8,
                        **PLAN_KW)
    cfg_j = TrustIRConfig_j(cache_slots=256, cache_ways=2, prior_buckets=8,
                            **PLAN_KW)
    r = np.random.default_rng(n_valid)
    n = 128
    keys = np.zeros(n, np.uint32)
    keys[:n_valid] = r.choice(10**6, n_valid, replace=False) + 1
    buckets = r.integers(0, 8, n).astype(np.int32)
    valid = np.arange(n) < n_valid
    x = r.normal(size=(n, 8)).astype(np.float32)
    cache, prior = TC.init(cfg.cache_slots, cfg.cache_ways, device="cpu"), \
        AT.init(cfg.prior_buckets, device="cpu")
    cache_j, prior_j = TC_j.init(cfg.cache_slots, cfg.cache_ways), \
        AT_j.init(cfg.prior_buckets)
    for step in range(2):      # the second step reads the first's cache
        trust, aux = fused_shed_eval(
            cache, prior, torch.as_tensor(keys_as_int32(keys)),
            torch.as_tensor(buckets), torch.as_tensor(valid),
            {"x": torch.as_tensor(x)},
            lambda f: torch.sigmoid(f["x"] @ torch.from_numpy(W)) * 5.0,
            max_evals, cfg, ucap, uthr)
        trust_j, aux_j = fused_shed_eval_j(
            cache_j, prior_j, jnp.asarray(keys), jnp.asarray(buckets),
            jnp.asarray(valid), {"x": jnp.asarray(x)},
            lambda f: jax.nn.sigmoid(f["x"] @ jnp.asarray(W)) * 5.0,
            max_evals, cfg_j, ucap, uthr)
        tier = aux["plan"]["tier"].numpy()
        np.testing.assert_array_equal(tier, np.asarray(aux_j["plan"]["tier"]))
        assert int(aux["n_evald"]) == int(aux_j["n_evald"])
        np.testing.assert_allclose(trust.numpy(), np.asarray(trust_j),
                                   rtol=0, atol=1e-6)
        cache, prior = aux["cache"], aux["prior"]
        cache_j, prior_j = aux_j["cache"], aux_j["prior"]
        np.testing.assert_array_equal(
            cache["keys"].numpy().view(np.uint32),
            np.asarray(cache_j["keys"]).view(np.uint32))
        np.testing.assert_allclose(cache["values"].numpy(),
                                   np.asarray(cache_j["values"]), atol=1e-6)
        np.testing.assert_allclose(prior["mean"].numpy(),
                                   np.asarray(prior_j["mean"]), atol=1e-6)
    assert (tier[n_valid:] == TIER_INVALID).all()
