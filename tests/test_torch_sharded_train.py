"""The mesh cells' steps on gloo ranks against the replicated steps, on
the CPU: ``launch.steps`` train cells, the sequence-sharded decode, the
elastic checkpoint restore and the int8 pod mean.

Each multi-rank mesh runs as gloo ranks, one subprocess per rank with its
own timeout, meeting through a ``FileStore`` in the test's temporary
directory (no TCP port), on the same seeded weights and batches as the
replicated run in this process (``_COMMON``, executed by both).

- Train cells of smollm-135m, qwen3-moe-30b-a3b (the test's copy of its
  smoke config takes the full config's ``dispatch="ep_shard_map"`` and a
  capacity factor of 16, so that no expert drops a token on any DP
  shard), dlrm-mlperf and gcn-cora (a padded graph whose nodes
  and edges split over the DP axes) at smoke width in float32, two AdamW
  steps at lr 1e-3 on (1, 2), (2, 1) and (2, 2): the loss, the global
  gradient norm, and every leaf of the parameters and both AdamW moments
  within 1e-5 of the leaf's norm (the first moment after step one is the
  clipped gradient itself); a world of one is bit-equal.
- Decode on (2, 2): smollm, gemma2 (window 16 and softcaps) and
  qwen3-moe cells at B 4 (cache sequence over ``model``) and B 1 (over
  (``data``, ``model``)), two steps: each rank's logits rows, and the
  updated cache, within 1e-5 of their largest value.
- Elastic restore: the (1, 2) ranks save the trained smollm state; it is
  restored onto (2, 1) by ``ElasticMeshManager(prefer_model=1).resume``
  and onto a world of one here, equal to the saved values.
- ``compressed_pod_mean`` over 4 gloo ranks of a ``pod`` axis: within
  0.02 * max(largest scale, 1) of the exact mean.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
RANK_TIMEOUT_S = 240
REL_TOL = 1e-5
MESHES = ((1, 2), (2, 1), (2, 2))
TRAIN_ARCHS = ("smollm-135m", "qwen3-moe-30b-a3b", "dlrm-mlperf",
               "gcn-cora")
DECODE_ARCHS = ("smollm-135m", "gemma2-2b", "qwen3-moe-30b-a3b")

_COMMON = r'''
import dataclasses
import numpy as np
import torch
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec, reduced
from repro_torch.launch import steps as ST
from repro_torch.models import gnn as G
from repro_torch.models import transformer as T
from repro_torch.models.recsys import dlrm
from repro_torch.training import optimizer as O
from repro_torch.training import train_loop as TL
from repro_torch.training.tree import leaves_with_paths, tree_map

# eps 1e-4: with 1e-8 AdamW maps a gradient element near zero to about
# +-lr, so summation-order noise (the replicated step's own, under a
# permutation of the batch rows) would move such an element by up to lr
ST.OPT_CFG = O.AdamWConfig(lr=1e-3, eps=1e-4, warmup_steps=1,
                           total_steps=10)
STEPS = 2


def lm_cfg(arch):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    if cfg.moe is not None:
        # the full config's expert-parallel dispatch, at a capacity no
        # expert reaches
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0, dispatch="ep_shard_map"))
    return cfg


def train_case(arch):
    """(cfg, shape, init(gen), batch(i), loss(p, b)) of a train cell."""
    if arch in ("smollm-135m", "qwen3-moe-30b-a3b"):
        cfg = lm_cfg(arch)
        shape = ShapeSpec(name="train_4k", kind="train", seq_len=32,
                          global_batch=8)

        def batch(i):
            r = np.random.default_rng(100 + i)
            t = torch.as_tensor(r.integers(0, cfg.vocab_size, (8, 33)),
                                dtype=torch.int32)
            mask = torch.as_tensor(r.random((8, 32)) > 0.2,
                                   dtype=torch.float32)
            return {"tokens": t[:, :-1].contiguous(),
                    "labels": t[:, 1:].contiguous(), "mask": mask}

        def loss(p, b):
            return T.lm_loss(p, cfg, b["tokens"], b["labels"], b["mask"],
                             q_chunk=1024, loss_chunk=512)
        return cfg, shape, lambda g: T.init_params(cfg, g), batch, loss
    if arch == "dlrm-mlperf":
        cfg = get_config(arch, smoke=True)
        shape = ShapeSpec(name="train_batch", kind="train", batch=16)

        def batch(i):
            r = np.random.default_rng(200 + i)
            return {"dense": torch.as_tensor(
                        r.normal(size=(16, cfg.n_dense)), dtype=torch.float32),
                    "sparse": torch.as_tensor(np.stack(
                        [r.integers(0, t.vocab, 16) for t in cfg.tables], 1),
                        dtype=torch.int32),
                    "labels": torch.as_tensor(r.integers(0, 2, 16),
                                              dtype=torch.float32)}
        return (cfg, shape, lambda g: dlrm.init_params(cfg, g), batch,
                lambda p, b: dlrm.loss_fn(p, cfg, b))
    shape = ShapeSpec(name="ogb_products", kind="graph_full", n_nodes=500,
                      n_edges=1500, d_feat=12)
    cfg = reduced(get_config(arch, smoke=True), d_feat=12,
                  n_classes=ST.GNN_CLASSES["ogb_products"], dropout=0.0)

    def batch(i):
        r = np.random.default_rng(300 + i)
        n, e, N, E = 500, 1500, 512, 1536
        ei = np.zeros((2, E), np.int32)
        ei[:, :e] = r.integers(0, n, (2, e))
        em = np.zeros(E, np.float32)
        em[:e] = 1.0
        lm = np.zeros(N, np.float32)
        lm[:n] = r.random(n) > 0.5
        return {"x": torch.as_tensor(r.normal(size=(N, 12)),
                                     dtype=torch.float32),
                "edge_index": torch.as_tensor(ei),
                "labels": torch.as_tensor(r.integers(0, 47, N),
                                          dtype=torch.int32),
                "label_mask": torch.as_tensor(lm),
                "edge_mask": torch.as_tensor(em)}

    def loss(p, b):
        return G.node_loss(p, cfg, b["x"], b["edge_index"], b["labels"],
                           b["label_mask"], edge_mask=b["edge_mask"])
    return cfg, shape, lambda g: G.init_params(cfg, g), batch, loss


def decode_case(arch, B):
    """(cfg, shape, params, token(i), cache) of a decode cell."""
    cfg = lm_cfg(arch)
    L = 64
    name = "decode_32k" if B > 1 else "long_500k"
    shape = ShapeSpec(name=name, kind="decode", seq_len=L, global_batch=B)
    params = T.init_params(cfg, torch.Generator().manual_seed(1))
    r = np.random.default_rng(7 + B)
    kv = (cfg.n_layers, B, L, cfg.n_kv_heads, cfg.d_head)
    cache = {"k": torch.as_tensor(r.normal(size=kv), dtype=torch.float32),
             "v": torch.as_tensor(r.normal(size=kv), dtype=torch.float32),
             "lengths": torch.as_tensor(
                 [40] if B == 1 else [1, 20, 33, 60], dtype=torch.int32)}

    def token(i):
        return torch.as_tensor(np.random.default_rng(50 + i).integers(
            0, cfg.vocab_size, B), dtype=torch.int32)
    return cfg, shape, params, token, cache


def flat(tree, prefix):
    return {prefix + p: t.detach().numpy().copy()
            for p, t in leaves_with_paths(tree)}
'''

_RANK = r'''
import sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, rdv, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
shape = tuple(int(s) for s in sys.argv[5].split("x"))
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                        world_size=world)
exec(COMMON)
from repro_torch.distribution.constraints import use_mesh
from repro_torch.distribution.fault_tolerance import ElasticMeshManager
from repro_torch.launch.mesh import destroy_world, mesh_from_devices
from repro_torch.training import checkpoint as CK
from repro_torch.training.compression import compressed_pod_mean

mesh = mesh_from_devices(range(world), shape, ("data", "model"),
                         device="cpu")
res = {}
for arch in TRAIN_ARCHS:
    cfg, sh, init, batch, loss = train_case(arch)
    cell = ST.cell_of(cfg, sh, mesh, arch)
    state = TL.init_state(init(torch.Generator().manual_seed(0)))
    state = tree_map(lambda t: t.clone(),
                     ST.local_pieces(state, cell.in_shardings[0], mesh))
    for i in range(STEPS):
        b = {k: v.contiguous() for k, v in ST.local_pieces(
            batch(i), cell.in_shardings[1], mesh).items()}
        state, m = cell.step_fn(state, b)
        res[f"{arch}|{i}|loss"] = m["loss"].numpy()
        res[f"{arch}|{i}|grad_norm"] = m["grad_norm"].numpy()
        whole = ST.global_values(state, cell.in_shardings[0], mesh)
        res.update(flat(whole._replace(ef=None), f"{arch}|{i}|"))
    if arch == "smollm-135m" and shape == (1, 2):
        # elastic: save the whole state, resume it onto (2, 1)
        CK.save(f"{out}/ckpt", STEPS, whole)
        m2, _, got, _ = ElasticMeshManager(prefer_model=1,
                                           device="cpu").resume(
            f"{out}/ckpt", whole, cell.in_shardings[0])
        assert tuple(m2.shape) == (2, 1), m2
        want = ST.local_pieces(whole, cell.in_shardings[0], m2)
        from repro_torch.training.tree import leaves
        res["elastic|equal"] = np.array(all(
            torch.equal(a.to_local(), b) for a, b in
            zip(leaves(got), leaves(want))))

if shape == (2, 2):
    for arch in DECODE_ARCHS:
        for B in (4, 1):
            cfg, sh, params, token, cache = decode_case(arch, B)
            cell = ST.cell_of(cfg, sh, mesh, arch)
            p = ST.local_pieces(params, cell.in_shardings[0], mesh)
            c = tree_map(lambda t: t.clone(), ST.local_pieces(
                cache, cell.in_shardings[2], mesh))
            for i in range(2):
                tok = ST.local_pieces(token(i), cell.in_shardings[1],
                                      mesh).contiguous()
                logits, c = cell.step_fn(p, tok, c)
                res[f"decode|{arch}|{B}|{i}"] = logits.numpy()
            whole = ST.global_values(c, cell.in_shardings[2], mesh)
            res.update(flat(whole, f"decode|{arch}|{B}|cache"))
    pod = mesh_from_devices(range(world), (world,), ("pod",), device="cpu")
    x = torch.as_tensor(np.random.default_rng(rank).normal(
        size=(3, 1500)), dtype=torch.float32)
    with use_mesh(pod):
        res["pod_mean"] = compressed_pod_mean(x, "pod").numpy()
destroy_world()
np.savez(f"{out}/rank{rank}.npz", **res)
'''


def _run_ranks(shape, tmp):
    world = int(np.prod(shape))
    code = (f"COMMON = {_COMMON!r}\nTRAIN_ARCHS = {TRAIN_ARCHS!r}\n"
            f"DECODE_ARCHS = {DECODE_ARCHS!r}\n" + _RANK)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world), str(tmp / "rdv"),
         str(tmp), "x".join(map(str, shape))], env=ENV, cwd=ROOT,
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


@pytest.fixture(scope="module")
def common():
    ns = {}
    exec(_COMMON, ns)
    return ns


_RUNS = {}


def _ranks_at(shape, tmp_path_factory):
    """Each mesh's ranks run once for the module."""
    if shape not in _RUNS:
        tmp = tmp_path_factory.mktemp("ranks" + "x".join(map(str, shape)))
        _RUNS[shape] = (shape, _run_ranks(shape, tmp), tmp)
    return _RUNS[shape]


@pytest.fixture(scope="module", params=MESHES,
                ids=lambda s: "x".join(map(str, s)))
def ranks(request, tmp_path_factory):
    return _ranks_at(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def ranks22(tmp_path_factory):
    return _ranks_at((2, 2), tmp_path_factory)


@pytest.fixture(scope="module")
def ranks12(tmp_path_factory):
    return _ranks_at((1, 2), tmp_path_factory)


def _replicated_train(ns, arch):
    cfg, _, init, batch, loss = ns["train_case"](arch)
    TL = ns["TL"]
    state = TL.init_state(init(torch.Generator().manual_seed(0)))
    step = TL.make_train_step(loss, ns["ST"].OPT_CFG)
    out = {}
    for i in range(ns["STEPS"]):
        state, m = step(state, batch(i))
        out[f"{arch}|{i}|loss"] = m["loss"].numpy()
        out[f"{arch}|{i}|grad_norm"] = m["grad_norm"].numpy()
        out.update(ns["flat"](state._replace(ef=None), f"{arch}|{i}|"))
    return out


@pytest.fixture(scope="module")
def replicated_train(common):
    return {a: _replicated_train(common, a) for a in TRAIN_ARCHS}


def _close(got, want, what):
    tol = REL_TOL * max(float(np.linalg.norm(want)), 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert got.shape == want.shape and err <= tol, (what, err, tol)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_cell_matches_replicated_step(arch, ranks, replicated_train):
    shape, outs, _ = ranks
    want = replicated_train[arch]
    for out in outs:
        keys = [k for k in out if k.startswith(arch + "|")]
        assert set(keys) == set(want), set(keys) ^ set(want)
        for k in keys:
            _close(out[k], want[k], (shape, k))
    for out in outs[1:]:                    # every rank holds the same
        for k in want:
            np.testing.assert_array_equal(out[k], outs[0][k])


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_cell_on_a_world_of_one_is_bit_equal(arch, common,
                                                   replicated_train):
    from repro_torch.launch.mesh import destroy_world, make_host_mesh
    ns = common
    ST, TL = ns["ST"], ns["TL"]
    cfg, sh, init, batch, _ = ns["train_case"](arch)
    assert not dist.is_initialized()
    mesh = make_host_mesh((1, 1), device="cpu")
    try:
        cell = ST.cell_of(cfg, sh, mesh, arch)
        state = TL.init_state(init(torch.Generator().manual_seed(0)))
        for i in range(ns["STEPS"]):
            state, m = cell.step_fn(state, batch(i))
            got = ns["flat"](state._replace(ef=None), f"{arch}|{i}|")
            got[f"{arch}|{i}|loss"] = m["loss"].numpy()
            for k, v in got.items():
                np.testing.assert_array_equal(v, replicated_train[arch][k])
    finally:
        destroy_world()


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_sequence_sharded_decode_matches_decode_step(arch, ranks22,
                                                     common):
    shape, outs, _ = ranks22
    ns = common
    for B in (4, 1):
        cfg, _, params, token, cache = ns["decode_case"](arch, B)
        for i in range(2):
            want, cache = ns["T"].decode_step(params, cfg, token(i), cache)
            for r, out in enumerate(outs):
                # B 4 rows split over data (rank r's coordinate r // 2)
                rows = want[2 * (r // 2):2 * (r // 2) + 2] if B > 1 \
                    else want
                got = out[f"decode|{arch}|{B}|{i}"]
                assert got.shape == rows.shape
                np.testing.assert_allclose(
                    got, rows.numpy(), rtol=0,
                    atol=REL_TOL * float(want.abs().max()))
        for k, v in ns["flat"](cache, f"decode|{arch}|{B}|cache").items():
            np.testing.assert_allclose(outs[0][k], v, rtol=0,
                                       atol=REL_TOL * np.abs(v).max())


def test_elastic_restore_onto_another_mesh_and_a_world_of_one(ranks12,
                                                              common):
    shape, outs, tmp = ranks12
    assert all(bool(o["elastic|equal"]) for o in outs)
    from repro_torch.distribution.sharding import shardings_of
    from repro_torch.launch.mesh import destroy_world, make_host_mesh
    from repro_torch.training import checkpoint as CK
    ns = common
    cfg, sh, init, _, _ = ns["train_case"]("smollm-135m")
    like = ns["TL"].init_state(init(torch.Generator().manual_seed(0)))
    like = like._replace(ef=None)
    mesh = make_host_mesh((1, 1), device="cpu")
    try:
        cell = ns["ST"].cell_of(cfg, sh, mesh, "smollm-135m")
        got, extra = CK.restore(str(tmp / "ckpt"), like,
                                shardings=shardings_of(
                                    cell.in_shardings[0], mesh))
        last = ns["STEPS"] - 1
        from repro_torch.training.tree import leaves_with_paths
        for p, t in leaves_with_paths(got):
            np.testing.assert_array_equal(
                t.to_local().numpy(), outs[0][f"smollm-135m|{last}|{p}"])
    finally:
        destroy_world()


def test_compressed_pod_mean_over_four_ranks(ranks22):
    shape, outs, _ = ranks22
    from repro_torch.training.compression import _quant_leaf
    xs = [torch.as_tensor(np.random.default_rng(r).normal(size=(3, 1500)),
                          dtype=torch.float32) for r in range(4)]
    exact = torch.stack(xs).mean(dim=0).numpy()
    scale = max(float(_quant_leaf(x)[1].max()) for x in xs)
    for out in outs:
        err = np.abs(out["pod_mean"] - exact).max()
        assert err <= 0.02 * max(scale, 1.0), err
        np.testing.assert_array_equal(out["pod_mean"], outs[0]["pod_mean"])
