"""The port's mesh cells (``repro_torch.launch.steps``) against the
reference's (``repro.launch.steps``) on the reference tests' shape-only
meshes: every one of the 40 (arch x shape) cells builds on the single-pod
(16 x 16) and the multi-pod (2 x 16 x 16) mesh, and its abstract
arguments' shapes and dtypes, its input and output spec strings, its
``loop_multiplier`` and its ``meta`` numbers equal the reference's; the
variants registry as ``tests/test_launch_cells.py`` checks it.

The reference stacks a transformer's layers (``scan_layers``): one leaf of
shape (n_layers, ...) under ``['blocks']`` with a leading None in its
spec, where the port keeps a list of per-layer leaves. A port leaf group
``['blocks'][i]...`` is held to the reference's stacked leaf: n_layers
leaves of its trailing shape and spec. Exact: shapes, dtypes and spec
entries are compared as they are (a one-axis tuple entry as its axis, as
JAX's ``PartitionSpec`` normalizes it)."""
import re
from collections import defaultdict

import jax
import pytest
from jax.sharding import PartitionSpec as P_j

from repro.launch import steps as ST_j
from repro_torch.distribution.placement import PartitionSpec as P
from repro_torch.launch import steps as ST
from repro_torch.training.tree import leaves_with_paths


class FakeMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


class FakeSingle:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


ALL_CELLS = ST.all_cells()
_LAYER = re.compile(r"(\['blocks'\])\[\d+\]")


def _port_groups(tree, is_leaf=None, stacked=True):
    """normalized path -> [leaves] (with ``stacked``, a transformer's
    layer index under ``['blocks']`` dropped)."""
    out = defaultdict(list)
    for path, leaf in leaves_with_paths(tree, is_leaf=is_leaf):
        out[_LAYER.sub(r"\1", path) if stacked else path].append(leaf)
    return out


def _ref_leaves(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {jax.tree_util.keystr(p): leaf for p, leaf in flat
            if leaf is not None}


def _spec(s) -> tuple:
    """A spec's entries, a one-axis tuple as its axis (JAX prints
    ``('data',)`` as ``'data'``)."""
    if s is None:
        return None
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in s)


def _check_specs(mine, ref, what, stacked):
    groups = _port_groups(mine, is_leaf=lambda s: isinstance(s, P),
                          stacked=stacked)
    want = _ref_leaves(ref, is_leaf=lambda s: isinstance(s, P_j)
                       or s is None)
    assert set(groups) == set(want), (what, set(groups) ^ set(want))
    for path, specs in groups.items():
        assert len({_spec(s) for s in specs}) == 1, (what, path)
        got, w = _spec(specs[0]), _spec(want[path])
        layered = stacked and "['blocks']" in path
        assert got == w or (layered and w == (None,) + got), \
            (what, path, got, w)


def test_cell_matrix_is_40():
    assert len(ALL_CELLS) == 40 == len(ST_j.all_cells())
    assert ALL_CELLS == ST_j.all_cells()


@pytest.mark.parametrize("arch,shape", ALL_CELLS,
                         ids=[f"{a}-{s}" for a, s in ALL_CELLS])
@pytest.mark.parametrize("mesh", [FakeSingle(), FakeMesh()],
                         ids=["single", "multi"])
def test_cell_equals_the_reference_cell(arch, shape, mesh):
    cell = ST.build_cell(arch, shape, mesh)
    ref = ST_j.build_cell(arch, shape, mesh)
    assert callable(cell.step_fn)
    assert cell.shape == ref.shape or cell.shape.name == ref.shape.name
    assert cell.loop_multiplier == ref.loop_multiplier
    assert cell.donate_argnums == ref.donate_argnums
    for k in ("family", "n_params", "n_active_params", "tokens",
              "useful_flops_fwd"):
        assert cell.meta[k] == ref.meta[k], k
    # abstract arguments: meta tensors, no memory
    stacked = cell.meta["family"] == "lm"
    groups = _port_groups(cell.abstract_args, stacked=stacked)
    want = _ref_leaves(ref.abstract_args)
    assert set(groups) == set(want), set(groups) ^ set(want)
    for path, leaves in groups.items():
        assert all(t.device.type == "meta" for t in leaves)
        shapes = {tuple(t.shape) for t in leaves}
        dtypes = {str(t.dtype).replace("torch.", "") for t in leaves}
        assert len(shapes) == 1 and len(dtypes) == 1, path
        s, w = shapes.pop(), tuple(want[path].shape)
        if stacked and "['blocks']" in path:
            assert w == (len(leaves),) + s, (path, s, w)
        else:
            assert len(leaves) == 1 and w == s, (path, s, w)
        assert dtypes.pop() == str(want[path].dtype), path
    _check_specs(cell.in_shardings, ref.in_shardings, "in", stacked)
    _check_specs(cell.out_shardings, ref.out_shardings, "out", stacked)


def test_variants_registry():
    mesh = FakeSingle()
    base = ST.build_cell("qwen3-moe-30b-a3b", "train_4k", mesh,
                         variant="base_moe")
    ep = ST.build_cell("qwen3-moe-30b-a3b", "train_4k", mesh,
                       variant="ep_moe")
    assert base.meta["cfg"].moe.dispatch == "dense_scatter"
    assert ep.meta["cfg"].moe.dispatch == "ep_shard_map"
    assert set(ST.VARIANTS) == set(ST_j.VARIANTS)


def test_input_specs_are_the_abstract_args():
    mesh = FakeSingle()
    got = ST.input_specs("dlrm-mlperf", "serve_p99", mesh)
    assert tuple(got[1]["dense"].shape) == (512, 13)
    assert got[1]["dense"].device.type == "meta"
