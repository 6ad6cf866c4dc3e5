"""``BENCHMARK.json`` against the files it names: every cell finds its
configuration, traffic, limits and metric readers by name; names and
units keep to their characters; each per-layer metric's end-to-end
metric is reported in each of its cells; no cell asks for four chips."""
import json
import re

import pytest

from conftest import ROOT, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = manifest()


def test_top_level_keys_and_paths():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["portbench"]
    assert M["command"] == ["python3", "portbench/run.py"]
    assert 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) < 64 * 1024


@pytest.mark.parametrize("cell", M["workloads"], ids=lambda c: c["name"])
def test_cell_files_found_by_name(cell):
    from portbench import harness
    files = harness.cell_files(M, cell["name"])
    assert files["config"]["name"] == cell["config"]
    assert cell["chips"] == 1
    for m in files["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
    e2e = {m["name"] for m in files["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and files["per_layer"]
    for m in files["per_layer"]:
        assert m["moves"] in e2e


def test_names_units_and_references():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in M[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    configs = {c["name"]: c for c in M["configs"]}
    used = {w["config"] for w in M["workloads"]}
    assert used == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    for c in configs.values():
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["reduced"] == c["reduced"] and f["source"] == c["source"]
        assert c["file"].startswith("portbench/")
    for w in M["workloads"]:
        assert NAME.match(w["traffic"]) and len(w["why"]) <= 200
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {m["layer"] for m in M["per_layer"]}
    assert all(0 < len(x) <= 200 and "\n" not in x for x in layers)
