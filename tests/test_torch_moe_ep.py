"""The expert-parallel MoE (``models.moe.moe_apply_ep``) and the sharded
MoE evaluators on the CPU.

- A world of one (the (1, 1) mesh one H100 is), in this process, at a
  capacity that binds (factor 0.5: experts drop tokens): the port's
  ``moe_apply_ep`` against JAX's ``moe_apply_ep`` under ``use_mesh`` of a
  (1, 1) JAX mesh, on the same weights and tokens. The routing is equal,
  the keep sets are equal bit for bit (JAX's read off its own
  ``_local_dispatch_compute`` with unit weights and one-hot gates: a slot's
  output is nonzero exactly when it is kept), and the outputs agree
  within 1e-5.
- Gloo ranks of a (2, 4) mesh, at a capacity that binds nowhere (8.0):
  each rank's rows through its two experts against ``moe_apply`` on the
  whole batch, within 1e-4, and the gradients of sum(out^2) within rtol
  2e-3 / atol 2e-4, as ``tests/test_moe_ep.py`` holds the reference's.
- The sharded qwen3-moe and moonshot smoke evaluators on gloo (1, 2),
  (2, 1), (2, 2) and (1, 4) meshes, the test's copy of their smoke configs
  taking the full configs' ``dispatch="ep_shard_map"``: at a capacity
  factor of 16 (binding nowhere) against the replicated evaluator on the
  whole batch, and at the full configs' 1.25 against the replicated
  evaluator run on each DP shard's rows separately (the capacity of a
  shard's rows is what ``moe_apply_ep`` means), within 1e-5 of the
  largest score.

Each gloo rank is a subprocess with its own timeout, meeting through a
``FileStore`` in the test's temporary directory (no TCP port).
"""
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

from repro.configs.base import MoEConfig as MoEConfig_j
from repro.distribution.constraints import use_mesh as use_mesh_j
from repro.models import moe as MO_j
from repro_torch.configs.base import MoEConfig
from repro_torch.distribution.constraints import use_mesh
from repro_torch.launch.mesh import destroy_world, make_host_mesh
from repro_torch.models import moe as MO

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
RANK_TIMEOUT_S = 240
ARCHS = ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b")
EVAL_MESHES = ((1, 2), (2, 1), (2, 2), (1, 4))
N_ITEMS = 8
FREE, OWN = 16.0, 1.25          # capacity factors: binds nowhere / the full configs'


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32))


# ---------------------------------------------------------------------------
# a world of one against JAX, at a binding capacity
# ---------------------------------------------------------------------------

def _jax_keep(p, topk_idx, cfg, T, D):
    """JAX's keep set: its ``_local_dispatch_compute`` with unit inputs and
    weights (every expert's output row is positive) and the gates one-hot
    on choice k: token t's output is nonzero iff slot (t, k) is kept."""
    E, K = cfg.n_experts, cfg.top_k
    C = MO_j.capacity(T, cfg)
    ones = jnp.ones((E, D, cfg.d_expert), jnp.float32)
    keep = []
    for k in range(K):
        tw = jnp.zeros((T, K), jnp.float32).at[:, k].set(1.0)
        out = MO_j._local_dispatch_compute(
            jnp.ones((T, D), jnp.float32), tw, topk_idx, ones, ones,
            jnp.ones((E, cfg.d_expert, D), jnp.float32), e_offset=0,
            e_local=E, capacity_local=C, act="silu",
            compute_dtype=jnp.float32)
        keep.append(np.asarray(jnp.abs(out).sum(-1) > 0))
    return np.stack(keep, axis=1)


def test_world_of_one_matches_jax_ep_at_a_binding_capacity():
    kw = dict(n_experts=8, top_k=2, d_expert=32, capacity_factor=0.5,
              dispatch="ep_shard_map")
    cfg_j, cfg = MoEConfig_j(**kw), MoEConfig(**kw)
    T, D = 64, 16
    p_j = MO_j.moe_init(jax.random.PRNGKey(0), D, cfg_j)
    x_j = jax.random.normal(jax.random.PRNGKey(1), (T, D))
    with use_mesh_j(jax.make_mesh((1, 1), ("data", "model"))):
        want, _ = MO_j.moe_apply_ep(p_j, x_j, cfg_j,
                                    compute_dtype=jnp.float32)
    probs = jax.nn.softmax(x_j @ p_j["router"]["w"], axis=-1)
    _, idx_j = jax.lax.top_k(probs, cfg.top_k)
    keep_j = _jax_keep(p_j, idx_j, cfg_j, T, D)
    assert not keep_j.all()                    # the capacity binds

    assert not dist.is_initialized()
    mesh = make_host_mesh((1, 1), device="cpu")
    try:
        p, x = _tensors(p_j), _tensors(x_j)
        with use_mesh(mesh):
            got, metrics = MO.moe_apply_ep(p, x, cfg,
                                           compute_dtype=torch.float32)
        _, _, idx = MO._router(p, x, cfg)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
        keep = MO.slot_keep(idx, 0, cfg.n_experts, MO.capacity(T, cfg))
        np.testing.assert_array_equal(keep.numpy(), keep_j)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
        assert float(metrics["moe_drop_frac"]) == 0.0     # as the reference
        # the same buffer and products as moe_apply: equal bits
        ref, _ = MO.moe_apply(p, x, cfg, compute_dtype=torch.float32)
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
    finally:
        destroy_world()


# ---------------------------------------------------------------------------
# gloo ranks
# ---------------------------------------------------------------------------

_LAYER = r'''
import math
from repro_torch.configs.base import MoEConfig
from repro_torch.distribution.placement import PartitionSpec as P

CFG = MoEConfig(n_experts=8, top_k=2, d_expert=32, capacity_factor=8.0,
                dispatch="ep_shard_map")
SPECS = {"router": {"w": P(None, None)}, "w_gate": P("model", None, None),
         "w_up": P("model", None, None), "w_down": P("model", None, None)}


def layer_inputs():
    g = torch.Generator().manual_seed(0)
    p = MO.moe_init(16, CFG, g)
    x = torch.randn((64, 16), generator=g)
    return p, x
'''

_RANK = r'''
import dataclasses
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
from repro_torch.configs import registry
from repro_torch.distribution.constraints import use_mesh
from repro_torch.distribution.placement import (all_reduce, batch_split,
                                                mesh_axes)
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import destroy_world, mesh_from_devices
from repro_torch.models import moe as MO
from repro_torch.serving.evaluators import make_sharded_evaluator
exec(LAYER)

mesh = mesh_from_devices(range(world), shape, ("data", "model"),
                         device="cpu")
res = {}
if shape == (2, 4):
    p, x = layer_inputs()
    local = {k: (v.clone().requires_grad_() if not isinstance(v, dict)
                 else {"w": v["w"].clone().requires_grad_()})
             for k, v in ST.local_pieces(p, SPECS, mesh).items()}
    dp, model = mesh_axes(mesh, ["data"]), mesh_axes(mesh, ["model"])
    rows = ST.local_pieces(x, P(("data",), None), mesh)
    with use_mesh(mesh), batch_split(dp):
        y, _ = MO.moe_apply_ep(ST.sharded_view(local, SPECS, mesh), rows,
                               CFG, compute_dtype=torch.float32)
    # every model rank computes its rows' loss: each backpropagates its
    # share, and a leaf's gradient is summed over the axes it is whole on
    ((y ** 2).sum() / 4).backward()
    res["out"] = y.detach().numpy()
    res["router"] = all_reduce(local["router"]["w"].grad, dp + model).numpy()
    for k in ("w_gate", "w_up", "w_down"):
        res[k] = ST.global_values(all_reduce(local[k].grad, dp), SPECS[k],
                                  mesh).numpy()
else:
    for arch in ARCHS:
        b = registry.get_bundle(arch)
        for factor in (FREE, OWN):
            registry._BUNDLES[arch] = dataclasses.replace(b, smoke=dataclasses.replace(
                b.smoke, moe=dataclasses.replace(
                    b.smoke.moe, capacity_factor=factor,
                    dispatch="ep_shard_map")))
            se = make_sharded_evaluator(arch, mesh=mesh, smoke=True,
                                        device="cpu")
            f = {k: torch.as_tensor(v)
                 for k, v in se.make_features(N_ITEMS, fseed=3).items()}
            res[f"{arch}|{factor}"] = se.evaluate(f).numpy()
        registry._BUNDLES[arch] = b
destroy_world()
np.savez(f"{out}/rank{rank}.npz", **res)
'''


def _run_ranks(shape, tmp):
    world = int(np.prod(shape))
    code = (f"LAYER = {_LAYER!r}\nARCHS = {ARCHS!r}\nN_ITEMS = {N_ITEMS}\n"
            f"FREE, OWN = {FREE!r}, {OWN!r}\n" + _RANK)
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


def test_gloo_2x4_ep_layer_matches_moe_apply_and_its_gradients(tmp_path):
    outs = _run_ranks((2, 4), tmp_path)
    ns = {"torch": torch, "MO": MO}
    exec(_LAYER, ns)
    p, x = ns["layer_inputs"]()
    leaves = {"router": p["router"]["w"], "w_gate": p["w_gate"],
              "w_up": p["w_up"], "w_down": p["w_down"]}
    for t in leaves.values():
        t.requires_grad_(True)
    want, _ = MO.moe_apply(p, x, ns["CFG"], compute_dtype=torch.float32)
    (want ** 2).sum().backward()
    want = want.detach().numpy()
    for r, out in enumerate(outs):
        d = r // 4                              # rank r's data coordinate
        np.testing.assert_allclose(out["out"], want[32 * d:32 * d + 32],
                                   rtol=0, atol=1e-4)
        for k, t in leaves.items():
            np.testing.assert_allclose(out[k], t.grad.numpy(), rtol=2e-3,
                                       atol=2e-4)


@pytest.fixture(scope="module", params=EVAL_MESHES,
                ids=lambda s: "x".join(map(str, s)))
def eval_ranks(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe" + "x".join(map(str, request.param)))
    return request.param, _run_ranks(request.param, tmp)


def _replicated(arch, factor, rows_of):
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.serving.evaluators import make_evaluator
    b = registry.get_bundle(arch)
    registry._BUNDLES[arch] = dataclasses.replace(b, smoke=dataclasses.replace(
        b.smoke, moe=dataclasses.replace(b.smoke.moe, capacity_factor=factor,
                                         dispatch="ep_shard_map")))
    try:
        ev, mk = make_evaluator(arch, smoke=True, device="cpu")
        f = {k: torch.as_tensor(v) for k, v in mk(N_ITEMS, fseed=3).items()}
        return np.concatenate([ev({k: v[r] for k, v in f.items()}).numpy()
                               for r in rows_of])
    finally:
        registry._BUNDLES[arch] = b


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_moe_evaluators_match_replicated(arch, eval_ranks):
    shape, outs = eval_ranks
    n_dp = shape[0]
    shards = [slice(i * N_ITEMS // n_dp, (i + 1) * N_ITEMS // n_dp)
              for i in range(n_dp)]
    for factor, rows_of in ((FREE, [slice(None)]), (OWN, shards)):
        want = _replicated(arch, factor, rows_of)
        for out in outs:
            got = out[f"{arch}|{factor}"]
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
