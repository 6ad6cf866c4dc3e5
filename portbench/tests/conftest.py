"""Shared helpers of the benchmark's CPU tests: the cells of
``BENCHMARK.json`` cut to the system's smoke widths, so that a whole run
(set-up, warm-up, window, check) takes seconds on the CPU."""
import copy
import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SMOKE_DENSE = dict(num_hidden_layers=2, hidden_size=64,
                   num_attention_heads=4, num_key_value_heads=2,
                   head_dim=16, vocab_size=256, intermediate_size=128)
SMOKE_MOE = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
                 num_key_value_heads=2, head_dim=16, vocab_size=256,
                 num_experts=8, num_experts_per_tok=2,
                 moe_intermediate_size=96, capacity_factor=1.5)


def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def smoke_files(workload: str, rate: float = None):
    """The cell's files with the model at the system's smoke widths in
    float32 and a small corpus and warm-up."""
    from portbench import harness
    files = copy.deepcopy(harness.cell_files(manifest(), workload))
    c = files["config"]
    c["smoke"], c["dtype"] = True, "float32"
    m = c["model"]
    m.update(SMOKE_MOE if m.get("num_experts") else SMOKE_DENSE)
    t = files["traffic"]
    if t["kind"] == "search":
        t["corpus"]["n_docs"] = 2048
        t["warmup_requests"], t["rate_per_s"] = 30, rate or 20.0
    else:
        t["warmup_requests"], t["rate_per_s"] = 20, rate or 10.0
    return files


def cpu_run(files, seed=987654321012, seconds=2.0, **kw):
    import torch

    from portbench import harness
    return harness.run(files, seed, seconds, False, torch.device("cpu"),
                       time.monotonic(), {"platform": "cpu"}, **kw)


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
