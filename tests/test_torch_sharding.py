"""``repro_torch.distribution.sharding`` against ``repro.distribution.
sharding``: every arch's parameter specs leaf by leaf (as strings) on
1x1 and 1x1x1 meshes, the placements the specs give, and the
zero-copy placement of a parameter tree on a mesh of one device."""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro.configs.registry import arch_ids as arch_ids_j
from repro.configs.registry import get_config as get_config_j
from repro.distribution import sharding as SH_j
from repro.launch.mesh import make_host_mesh as make_host_mesh_j
from repro_torch.configs.registry import arch_ids, get_config
from repro_torch.distribution import sharding as SH
from repro_torch.distribution.placement import PartitionSpec as P
from repro_torch.launch.mesh import destroy_world, make_host_mesh
from repro_torch.serving.evaluators import make_evaluator

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "1x1x1": ((1, 1, 1), ("pod", "data", "model"))}


@pytest.fixture
def world():
    """Make a mesh of this one process on the CPU (the world of one is
    created on first use) and destroy the group after the test."""
    assert not dist.is_initialized()
    yield lambda shape, axes: make_host_mesh(shape, axes, device="cpu")
    destroy_world()
    assert not dist.is_initialized()


def _ref_specs(arch: str, mesh) -> dict:
    import importlib
    cfg = get_config_j(arch, smoke=True)
    kind = type(cfg).__name__
    if kind == "TransformerConfig":
        from repro.models import transformer as M
    elif kind == "GNNConfig":
        from repro.models import gnn as M
    else:
        M = importlib.import_module(f"repro.models.recsys.{cfg.model}")
    shapes = jax.eval_shape(lambda: M.init_params(jax.random.PRNGKey(0),
                                                  cfg))
    specs = SH_j.param_specs(cfg, shapes, mesh)
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))[0]
    return {jax.tree_util.keystr(p): str(s) for p, s in leaves}


def _port_specs(arch: str, mesh) -> dict:
    cfg = get_config(arch, smoke=True)
    params = make_evaluator(arch, smoke=True, device="cpu")[0].params
    out = {}
    SH.tree_map_with_path(lambda path, s: out.__setitem__(
        SH.keystr(path), str(s)), SH.param_specs(cfg, params, mesh))
    return out


def test_registry_is_the_references():
    assert arch_ids() == arch_ids_j()
    assert len(arch_ids()) == 10


@pytest.mark.parametrize("mesh_id", sorted(MESHES))
@pytest.mark.parametrize("arch", arch_ids_j())
def test_param_specs_match_reference_leaf_by_leaf(arch, mesh_id, world):
    shape, axes = MESHES[mesh_id]
    want = _ref_specs(arch, make_host_mesh_j(shape, axes))
    got = _port_specs(arch, world(shape, axes))
    assert got == want


def test_spec_prints_as_jax():
    for spec in [(None, "model"), (("data", "model"), None), (), (None,),
                 ("model",)]:
        assert str(P(*spec)) == str(JP(*spec))
        assert repr(P(*spec)) == repr(JP(*spec))


def test_axis_helpers_and_placements(world):
    from torch.distributed.tensor import Replicate, Shard
    mesh = world((1, 1, 1), ("pod", "data", "model"))
    assert SH.dp_axes(mesh) == ("pod", "data")
    assert SH.table_axes(mesh) == ("data", "model")
    assert SH.all_axes(mesh) == ("pod", "data", "model")
    sh = SH.shardings_of({"a": P(None, "model"),
                          "b": [P(("data", "model"), None)],
                          "c": P()}, mesh)
    assert sh["a"].placements == (Replicate(), Replicate(), Shard(1))
    assert sh["b"][0].placements == (Replicate(), Shard(0), Shard(0))
    assert sh["c"].placements == (Replicate(),) * 3
    # an axis the mesh lacks is dropped (replicated)
    assert SH.shardings_of(P("expert"), mesh).placements == \
        (Replicate(),) * 3


def test_opt_state_specs_mirror_params():
    from repro_torch.training.optimizer import AdamWState
    tree = {"w": P(None, "model"), "b": P(None)}
    st = SH.opt_state_specs(tree, None)
    assert isinstance(st, AdamWState)
    assert st.step == P() and st.m is tree and st.v is tree


@pytest.mark.parametrize("arch", ["smollm-135m", "dlrm-mlperf", "gcn-cora"])
def test_place_params_wraps_the_same_tensors_on_one_device(arch, world):
    """On a mesh of one device every DTensor's local piece is the
    parameter tensor itself: nothing is copied."""
    from torch.distributed.tensor import DTensor
    mesh = world((1, 1), ("data", "model"))
    cfg = get_config(arch, smoke=True)
    params = make_evaluator(arch, smoke=True, device="cpu")[0].params
    placed = SH.place_params(params, cfg, mesh)
    pairs = []
    SH.tree_map_with_path(lambda path, t: pairs.append(path), params)
    assert pairs
    for path in pairs:
        a, b = params, placed
        for k in path:
            a, b = a[k], b[k]
        assert isinstance(b, DTensor)
        assert b.to_local().data_ptr() == a.data_ptr()
        assert tuple(b.shape) == tuple(a.shape)


def test_uneven_shard_raises(world):
    from repro_torch.distribution.placement import (NamedSharding,
                                                    _local_piece)
    mesh = world((1, 1), ("data", "model"))
    # a mesh of one divides everything; the check itself is exercised
    # on a stand-in two-way axis
    class Two:
        mesh_dim_names = ("model",)

        def size(self, mdim):
            return 2

        def get_local_rank(self, mdim):
            return 1
    from torch.distributed.tensor import Shard
    with pytest.raises(ValueError, match="does not divide"):
        _local_piece(torch.zeros(5, 3), Two(), (Shard(0),))
    half = _local_piece(torch.arange(8.0).reshape(4, 2), Two(), (Shard(0),))
    np.testing.assert_array_equal(half.numpy(), [[4, 5], [6, 7]])
    assert NamedSharding(mesh, P(None)).spec == P(None)
