"""The port's serve launcher as a user runs it, on the CPU:
``--sync --device cpu`` over a small corpus exits 0 and prints one line
per request and the P50/P99 scoreboard; the scheduled fleet modes
(replicas, trace, gossip, hedging, elastic membership, chaos) run at
smoke width and exit 0, the tail-tolerant fan-out flags included; the
flag still to port (``--sharded``) exits 2 and names the ROADMAP item
it waits for."""
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

@pytest.mark.parametrize("arch,extra", [
    ("qwen2.5-14b", []),
    ("gemma2-2b", ["--drain-mode", "fused"]),
    ("moonshot-v1-16b-a3b", []),
    ("qwen3-moe-30b-a3b", ["--drain-mode", "fused"]),
    ("gcn-cora", ["--drain-mode", "fused"]),
])
def test_sync_serve_each_new_arch_on_cpu(arch, extra):
    """Every ``--arch`` of the reference's launcher is served: the dense
    Gemma-2 and Qwen2.5 fields, the two MoE models and the GCN trust
    propagator, at smoke width over a small corpus."""
    out = _serve("--sync", "--device", "cpu", "--corpus", "192",
                 "--n-requests", "3", "--arch", arch, *extra)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith(f"{arch} on cpu:")
    assert sum(l.lstrip().startswith("req ") for l in lines) == 3
    assert any(l.startswith("retrieval: 4 searches") for l in lines)
    assert lines[-1].startswith("P50 ") and " P99 " in lines[-1]


def test_unknown_arch_exits_2_naming_the_choices(capsys):
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit) as exc:
        main(["--device", "cpu", "--arch", "llama-3-70b"])
    assert exc.value.code == 2
    assert "gcn-cora" in capsys.readouterr().err


def _assert_fleet_run(out, n_requests):
    lines = out.splitlines()
    assert "[scheduled x" in lines[0]
    assert sum(l.lstrip().startswith("req ") for l in lines) == n_requests
    assert any(l.startswith("scheduler: ") for l in lines)
    assert any(l.startswith("cluster: ") for l in lines)
    assert lines[-1].startswith("P50 ") and " P99 " in lines[-1]


def test_scheduled_mode_exits_2_with_the_roadmap_pointer(capsys):
    """The default scheduled mode (no ``--sync``) used to exit 2 until
    the fleet was ported; it now serves through a one-replica
    ``ClusterCoordinator`` and prints one line per request, the
    scheduler and cluster counters and the scoreboard."""
    from repro_torch.launch.serve import main
    assert main(["--device", "cpu", "--n-requests", "6"]) == 0
    out = capsys.readouterr()
    _assert_fleet_run(out.out, 6)
    assert "[scheduled x1 replica(s)]" in out.out


CHAOS = ["--trace", "1", "--replicas", "6", "--chaos-flash", "4",
         "--chaos-poison", "3", "--quarantine-k", "3", "--chaos-crash", "2",
         "--chaos-restart", "--gossip", "--gossip-mode", "epidemic",
         "--hedge-after-ms", "500"]


@pytest.mark.parametrize("args,item", [
    (["--replicas", "3", "--corpus", "192", "--n-requests", "8",
      "--drain-mode", "fused"], None),
    (["--trace", "1", "--replicas", "4"], None),
    (["--replicas", "3", "--corpus", "192", "--n-requests", "8",
      "--gossip"], None),
    (["--replicas", "3", "--n-requests", "8", "--hedge-after-ms", "5"],
     None),
    (["--replicas", "2", "--max-replicas", "3", "--forecast",
      "--n-requests", "8"], None),
    (["--replicas", "3", "--corpus", "192", "--n-requests", "8",
      "--quorum-k", "2", "--shard-hedge-ms", "5", "--straggle-mult", "8"],
     None),
    (CHAOS, None),
    (["--sync", "--sharded", "--drain-mode", "fused", "--corpus", "192",
      "--n-requests", "3"], None),
], ids=["replicas", "trace", "gossip", "hedge", "elastic", "quorum",
        "chaos", "sharded"])
def test_fleet_flags_exit_2_with_the_roadmap_pointer(args, item, capsys):
    """Fleet modes used to exit 2 naming ROADMAP Queue 1 item 3, and
    ``--sharded`` item 6; all are ported now (replicas, trace, gossip,
    hedge, elastic, chaos, the tail-tolerant fan-out: ``--quorum-k``,
    ``--shard-hedge-ms``, ``--straggle-mult``, and the mesh-sharded
    evaluator on the (1, 1) host mesh) and run on the CPU at smoke width
    and exit 0, the fan-out printing its ``fanout:`` line and
    ``--sharded --sync`` one line per request."""
    from repro_torch.launch.serve import main
    rc = main(["--device", "cpu", *args])
    out = capsys.readouterr()
    if item is not None:
        assert rc == 2
        assert f"ROADMAP.md, Queue 1, item {item}" in out.err
        assert out.out == ""
        return
    assert rc == 0, out.err
    if "--sharded" in args:
        lines = out.out.splitlines()
        assert "[sync] [drain=fused depth=2]" in lines[0]
        assert sum(l.lstrip().startswith("req ") for l in lines) == 3
        assert lines[-1].startswith("P50 ") and " P99 " in lines[-1]
        assert "retrieval: " in out.out
    elif "--trace" in args:
        assert "no-drop OK" in out.out
        assert any(l.startswith("P50 ") for l in out.out.splitlines())
        if args is CHAOS:
            assert "crash" in out.out and "rolling_restart" in out.out
            assert "gossip[epidemic]" in out.out
    else:
        _assert_fleet_run(out.out, 8)
        if "--corpus" in args:
            assert "retrieval: " in out.out
        if "--gossip" in args:
            assert "gossip: " in out.out
        if "--quorum-k" in args:
            lines = out.out.splitlines()
            assert any(l.startswith("fanout: quorum_k=2 ") for l in lines)
            assert any(l.startswith("fanout: gather p50/p99 ")
                       for l in lines)
