"""What the benchmark may import: no module of it imports JAX or the JAX
package (top-level names compared whole: ``repro_torch`` is not
``repro``); the reference imports nothing of the system; only ``sut``
imports the system."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_the_system_only_in_sut(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN
    if path.name != "sut.py":
        assert "repro_torch" not in names
    if "reference" in path.parts:
        assert names <= {"__future__", "math", "typing", "numpy", "torch"}


def test_whole_names_are_compared():
    from portbench.harness import forbidden_modules
    import sys
    assert "repro_torch" not in forbidden_modules()
    assert not set(forbidden_modules()) & set(sys.modules) - FORBIDDEN
