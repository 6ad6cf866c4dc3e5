"""Import guard of the torch port, run in a fresh interpreter: importing
every ``repro_torch`` module (and ``chip_smoke.py``) leaves ``jax`` and
every ``repro`` module out of ``sys.modules`` (the training modules, the
training launcher, the mesh cells and the dry-run among them); every
reference module has its counterpart; and an entry point given no
``device`` on a machine with no card raises instead of falling back to
the CPU."""
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
import importlib.util
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))  # no main
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "repro"
             or k.startswith("repro."))
print("MODULES", len(mods))
print("BAD", bad)
print("NAMES", " ".join(mods))
"""


def _run(code, *args):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-c", code, *args], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=str(ROOT))


def test_port_imports_no_jax_and_nothing_of_repro():
    out = _run(_PROBE, str(ROOT / "chip_smoke.py"))
    assert out.returncode == 0, out.stderr
    lines = dict(l.split(" ", 1) for l in out.stdout.splitlines())
    assert int(lines["MODULES"]) >= 40
    assert lines["BAD"] == "[]", lines["BAD"]
    names = set(lines["NAMES"].split())
    assert {f"repro_torch.training.{m}" for m in (
        "optimizer", "compression", "data", "checkpoint", "train_loop",
        "tree")} | {f"repro_torch.launch.{m}" for m in (
            "train", "steps", "dryrun", "hlo_analysis")} <= names


def test_every_reference_module_has_its_counterpart():
    """The module tree of ``src/repro`` has its counterpart in
    ``src/repro_torch``, apart from ``kernels/ops.py`` and
    ``kernels/ref.py``, whose contents live beside each kernel."""
    ref = {p.relative_to(SRC / "repro") for p in (SRC / "repro").rglob(
        "*.py")}
    port = {p.relative_to(SRC / "repro_torch") for p in (
        SRC / "repro_torch").rglob("*.py")}
    missing = {str(p) for p in ref - port}
    assert missing == {"kernels/ops.py", "kernels/ref.py"}, missing


def test_chip_smoke_source_imports_no_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    for line in src.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            assert "jax" not in s and not s.split()[1].startswith(
                "repro."), s
            assert s.split()[1] != "repro", s


_NO_CARD = r"""
import torch
assert not torch.cuda.is_available()
from repro_torch.configs import TrustIRConfig
from repro_torch.core.fused_shedder import FusedLoadShedder
from repro_torch.core.shedder import LoadShedder
from repro_torch.retrieval import IndexShard
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.evaluators import make_evaluator
n = 0
for make in (lambda: LoadShedder(TrustIRConfig(), None),
             lambda: FusedLoadShedder(TrustIRConfig(), None),
             lambda: make_evaluator("smollm-135m", smoke=True),
             lambda: ServingEngine(TrustIRConfig(), None),
             lambda: IndexShard.build(["term00001 term00002"],
                                      [0]).score("term00001")):
    try:
        make()
    except RuntimeError as e:
        assert "device='cpu'" in str(e)
        n += 1
print("RAISED", n)
"""


def test_entry_points_raise_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(_NO_CARD)
    assert out.returncode == 0, out.stderr
    assert "RAISED 5" in out.stdout


_NO_CARD_DECODE = r"""
import torch
assert not torch.cuda.is_available()
from repro_torch.configs import get_config
from repro_torch.serving.evaluators import make_evaluator
from repro_torch.serving.kv_cache import KVCachePool
n = 0
for make in (lambda: make_evaluator("dlrm-mlperf", smoke=True),
             lambda: KVCachePool(get_config("smollm-135m", smoke=True), 2,
                                 8)):
    try:
        make()
    except RuntimeError as e:
        assert "device='cpu'" in str(e)
        n += 1
print("RAISED", n)
"""


def test_dlrm_evaluator_and_kv_pool_raise_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(_NO_CARD_DECODE)
    assert out.returncode == 0, out.stderr
    assert "RAISED 2" in out.stdout


def test_train_launcher_raises_without_a_card():
    """``python -m repro_torch.launch.train`` runs on the card by default:
    with no card and no ``--device cpu`` it raises instead of falling back
    to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--steps", "1"], env=env, capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr
