"""``repro_torch.distribution`` (fault tolerance, constraints) and
``repro_torch.launch.mesh`` against the reference: the host fault-
tolerance classes give the reference's outputs on the same inputs; the
ambient mesh, ``constrain`` and ``shard_map`` on a world of one and on
two gloo ranks (each rank a subprocess with its own timeout, meeting
through a ``FileStore`` in the test's temporary directory: no TCP port);
the mesh constructors' errors; importing creates no process group."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.distribution import fault_tolerance as FT_j
from repro_torch.distribution import fault_tolerance as FT
from repro_torch.distribution.constraints import (ambient_mesh,
                                                  axis_in_mesh, constrain,
                                                  dp_spec, use_mesh)
from repro_torch.distribution.placement import PartitionSpec as P
from repro_torch.launch import mesh as mesh_lib

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
RANK_TIMEOUT_S = 180


@pytest.mark.parametrize("n", [512, 256, 300, 8, 1, 0, 3, 4096])
@pytest.mark.parametrize("prefer", [16, 4])
def test_largest_mesh_shape_matches_reference(n, prefer):
    assert FT.largest_mesh_shape(n, prefer) == \
        FT_j.largest_mesh_shape(n, prefer)


def test_heartbeat_tracker_matches_reference():
    a, b = FT.HeartbeatTracker(timeout_s=10.0), \
        FT_j.HeartbeatTracker(timeout_s=10.0)
    for w, t in [(0, 0.0), (1, 0.0), (0, 8.0), (2, 5.0), (1, 1.5)]:
        a.beat(w, now=t)
        b.beat(w, now=t)
    for now in (0.0, 10.0, 11.5, 12.0, 16.0, 30.0):
        assert a.live_workers(now=now) == b.live_workers(now=now)
        assert a.dead_workers(now=now) == b.dead_workers(now=now)
    assert a.live_workers(now=12.0) == [0, 2]
    assert a.dead_workers(now=16.0) == [1, 2]


@pytest.mark.parametrize("times,deadline,frac", [
    ([0.3, 0.3, 0.3, 0.3], 1.0, 0.5),
    ([2.0, 2.0, 0.1, 0.1], 1.0, 0.5),
    ([0.1] * 10, 0.55, 0.2),
    ([], 1.0, 0.5),
    ([5.0, 0.1, 0.1], 1.0, 0.0),
])
def test_deadline_skip_policy_matches_reference(times, deadline, frac):
    a = FT.DeadlineSkipPolicy(step_deadline_s=deadline, min_fraction=frac)
    b = FT_j.DeadlineSkipPolicy(step_deadline_s=deadline, min_fraction=frac)
    assert a.plan(times) == b.plan(times)
    assert a.rescale(a.plan(times)) == pytest.approx(
        b.rescale(b.plan(times)))


def test_no_mesh_makes_constraints_no_ops():
    assert ambient_mesh() is None and dp_spec() is None
    assert not axis_in_mesh("model")
    x = torch.arange(6.0)
    assert constrain(x, "model") is x


@pytest.fixture
def world_of_one():
    assert not dist.is_initialized()
    yield
    mesh_lib.destroy_world()
    assert not dist.is_initialized()


def test_host_mesh_makes_a_world_of_one(world_of_one):
    assert mesh_lib.world_size() == 1
    m = mesh_lib.make_host_mesh((1, 1, 1), ("pod", "data", "model"),
                                device="cpu")
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert m.mesh_dim_names == ("pod", "data", "model")
    assert m.device_type == "cpu"
    with use_mesh(m):
        assert ambient_mesh() is m
        assert dp_spec() == ("pod", "data")
        assert axis_in_mesh("model") and not axis_in_mesh("expert")
        with use_mesh(None):
            assert ambient_mesh() is None
        assert ambient_mesh() is m
    assert ambient_mesh() is None
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        mesh_lib.make_host_mesh((1, 2), device="cpu")
    with pytest.raises(ValueError, match="needs a process group of 256"):
        mesh_lib.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="of 512 ranks, have 1"):
        mesh_lib.make_production_mesh(multi_pod=True, device="cpu")


def test_constrain_and_shard_map_on_a_world_of_one(world_of_one):
    from repro_torch.distribution.constraints import shard_map
    from repro_torch.distribution.placement import (NamedSharding,
                                                    device_put, full_tensor)
    m = mesh_lib.make_host_mesh((1, 1), device="cpu")
    x = torch.arange(12.0).reshape(6, 2)
    d = device_put(x, NamedSharding(m, P("model", None)))
    with use_mesh(m):
        r = constrain(d, None, None)
        assert r.placements != d.placements
        assert torch.equal(full_tensor(r), x)
        assert constrain(d, "model", None) is d
        # absent axes are dropped: "expert" leaves the tensor replicated
        assert constrain(r, "expert", None) is r
    f = shard_map(lambda a, b: (a * 2, a.sum(0, keepdim=True) + b), mesh=m,
                  in_specs=(P("data", None), P()),
                  out_specs=(P("data", None), P("model", None)))
    two, s = f(x, torch.tensor(1.0))
    assert torch.equal(full_tensor(two), x * 2)
    assert torch.equal(full_tensor(s), x.sum(0, keepdim=True) + 1)


def test_mesh_import_creates_no_group_and_resolves_to_cuda():
    code = (
        "import torch, torch.distributed as dist\n"
        "import repro_torch.launch.mesh as M\n"
        "import repro_torch.distribution.sharding, "
        "repro_torch.distribution.constraints\n"
        "assert not dist.is_initialized()\n"
        "assert not torch.cuda.is_available()\n"
        "for f in (lambda: M.make_host_mesh((1, 1)),\n"
        "          lambda: M.init_world()):\n"
        "    try:\n"
        "        f()\n"
        "    except RuntimeError as e:\n"
        "        assert 'no CUDA device' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('ran without a card')\n"
        "assert not dist.is_initialized()\n"
        "print('OK')\n")
    out = subprocess.run([sys.executable, "-c", code], env=ENV, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "OK", out.stderr


_RANK = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, rdv, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                        world_size=world)
from repro_torch.distribution.constraints import constrain, shard_map, use_mesh
from repro_torch.distribution.placement import (NamedSharding, PartitionSpec
                                                as P, all_reduce,
                                                device_put, full_tensor,
                                                mesh_axes)
from repro_torch.launch.mesh import destroy_world, make_host_mesh

res = {}
try:
    make_host_mesh((2, 2), device="cpu")
except ValueError as e:
    res["err"] = np.array(str(e))
m = make_host_mesh((1, 2), device="cpu")
x = torch.arange(8.0).reshape(4, 2)
d = device_put(x, NamedSharding(m, P("model", None)))
res["local"] = d.to_local().numpy()
with use_mesh(m):
    res["replicated"] = constrain(d, None, None).to_local().numpy()
    res["back"] = constrain(constrain(d, None, None), "model",
                            None).to_local().numpy()
model = mesh_axes(m, ("model",))

def f(a):
    return all_reduce(a.sum(0, keepdim=True), model)

g = shard_map(f, mesh=m, in_specs=(P("model", None),),
              out_specs=P("data", None))
res["shard_map"] = full_tensor(g(x)).numpy()
res["full"] = full_tensor(d).numpy()
destroy_world()
np.savez(f"{out}/rank{rank}.npz", **res)
"""


def test_constraints_on_two_gloo_ranks(tmp_path):
    world = 2
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(world),
         str(tmp_path / "rdv"), str(tmp_path)], env=ENV, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        errs = [p.communicate(timeout=RANK_TIMEOUT_S)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], errs
    x = np.arange(8.0).reshape(4, 2)
    for r in range(world):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert str(got["err"]) == "need 4 devices, have 2"
        np.testing.assert_array_equal(got["local"], x[2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["replicated"], x)
        np.testing.assert_array_equal(got["back"], x[2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["full"], x)
        # each rank's column sums of its rows, summed over the model axis
        np.testing.assert_array_equal(got["shard_map"], x.sum(0)[None])
