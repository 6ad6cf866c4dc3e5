"""The configs' shape layer against the reference's (``repro.configs``):
every arch's bundle (id, source, shapes; its full and smoke configs'
``family``, ``n_params`` and ``n_active_params``), the shape sets and
``ShapeSpec``'s check of its kind. Exact: these are integers and
strings."""
import dataclasses

import pytest

from repro.configs import arch_ids as arch_ids_j
from repro.configs import base as B_j
from repro.configs import get_bundle as get_bundle_j
from repro_torch.configs import arch_ids, base as B, get_bundle, get_config

ARCHS = arch_ids_j()


def test_registry_lists_the_reference_archs_in_order():
    assert arch_ids() == ARCHS and len(ARCHS) == 10


def test_shape_sets_and_kinds_equal_the_reference():
    assert B.SHAPE_KINDS == B_j.SHAPE_KINDS
    for name in ("LM_SHAPES", "RECSYS_SHAPES", "GNN_SHAPES"):
        got, want = getattr(B, name), getattr(B_j, name)
        assert [dataclasses.asdict(s) for s in got] == \
            [dataclasses.asdict(s) for s in want]
    with pytest.raises(ValueError, match="unknown shape kind"):
        B.ShapeSpec(name="x", kind="nope")


@pytest.mark.parametrize("arch", ARCHS)
def test_bundle_equals_the_reference(arch):
    got, want = get_bundle(arch), get_bundle_j(arch)
    assert isinstance(got, B.ArchBundle)
    assert got.arch_id == want.arch_id == arch
    assert got.source == want.source
    assert [dataclasses.asdict(s) for s in got.shapes] == \
        [dataclasses.asdict(s) for s in want.shapes]
    assert get_config(arch) is got.config
    assert get_config(arch, smoke=True) is got.smoke
    for g, w in ((got.config, want.config), (got.smoke, want.smoke)):
        assert g.family == w.family
        assert g.n_params() == w.n_params()
        if hasattr(w, "n_active_params"):
            assert g.n_active_params() == w.n_active_params()


def test_unknown_arch_names_the_registry():
    with pytest.raises(KeyError, match="available"):
        get_bundle("nope")
