"""The port's serve launcher as a user runs it, on the CPU:
``--sync --device cpu`` over a small corpus exits 0 and prints one line
per request and the P50/P99 scoreboard; every fleet mode exits 2 and
names the ROADMAP item it waits for."""
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _serve(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args], env=env,
        capture_output=True, text=True, timeout=300, cwd=str(ROOT))


@pytest.mark.parametrize("extra", [
    ["--corpus", "192"],
    ["--corpus", "192", "--drain-mode", "fused", "--adaptive"],
    ["--drain-mode", "fused", "--pipeline-depth", "1"],
], ids=["host-corpus", "fused-corpus-adaptive", "fused-pre-retrieved"])
def test_sync_serve_on_cpu_prints_its_scoreboard(extra):
    out = _serve("--sync", "--device", "cpu", "--n-requests", "3", *extra)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("smollm-135m on cpu:")
    assert sum(l.lstrip().startswith("req ") for l in lines) == 3
    assert lines[-1].startswith("P50 ") and " P99 " in lines[-1]
    if "--corpus" in extra:
        assert any(l.startswith("retrieval: 4 searches") for l in lines)



@pytest.mark.parametrize("extra", [
    [],
    ["--corpus", "192", "--drain-mode", "fused"],
], ids=["host-pre-retrieved", "fused-corpus"])
def test_sync_serve_dlrm_on_cpu_prints_its_scoreboard(extra):
    """``--arch dlrm-mlperf`` through the registry, at smoke width as the
    reference's launcher builds it."""
    out = _serve("--sync", "--device", "cpu", "--arch", "dlrm-mlperf",
                 "--n-requests", "3", *extra)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("dlrm-mlperf on cpu:")
    assert sum(l.lstrip().startswith("req ") for l in lines) == 3
    assert lines[-1].startswith("P50 ") and " P99 " in lines[-1]

def test_scheduled_mode_exits_2_with_the_roadmap_pointer():
    out = _serve("--device", "cpu")
    assert out.returncode == 2
    assert "ClusterCoordinator" in out.stderr
    assert "ROADMAP.md, Queue 1, item 3" in out.stderr
    assert out.stdout == ""


@pytest.mark.parametrize("args,item", [
    (["--sync", "--replicas", "4"], 3),
    (["--sync", "--trace", "2"], 3),
    (["--sync", "--gossip"], 3),
    (["--sync", "--hedge-after-ms", "5"], 3),
    (["--sync", "--max-replicas", "3", "--forecast"], 3),
    (["--sync", "--corpus", "64", "--quorum-k", "2"], 3),
    (["--sync", "--chaos-poison", "2"], 3),
    (["--sync", "--sharded", "--drain-mode", "fused"], 6),
], ids=["replicas", "trace", "gossip", "hedge", "elastic", "quorum",
        "chaos", "sharded"])
def test_fleet_flags_exit_2_with_the_roadmap_pointer(args, item, capsys):
    from repro_torch.launch.serve import main
    assert main(["--device", "cpu", *args]) == 2
    out = capsys.readouterr()
    assert f"ROADMAP.md, Queue 1, item {item}" in out.err
    assert out.out == ""
