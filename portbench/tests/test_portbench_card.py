"""One short run of each cell on the card (marked ``cuda``; skipped
without a GPU): it exits 0 with a correct result line."""
import json
import subprocess
import sys

import pytest

from conftest import ROOT, manifest


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in manifest()["workloads"]])
def test_cell_runs_correct_on_the_card(cell, cuda_device):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "4", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
