"""A whole run on the CPU at smoke width, the look for a chip skipped:
sound, it is correct; with the timed path broken underneath, ``correct``
comes out false, once for each fault a serving cell can have. (A cell
on one chip has no exchange between chips to leave out.)"""
import pytest

from conftest import cpu_run, smoke_files

CELLS = ["smollm-urls-overload", "qwen3moe-urls-overload",
         "smollm-search-steady"]


def _evaluator(system, wrap):
    sh = system.engine.shedder
    inner = sh.evaluate_batch
    sh.evaluate_batch = lambda sub: wrap(inner, sub)


def answer_altered(system):
    """One answer changed where it is produced: row 0 of every call."""
    def wrap(inner, sub):
        s = inner(sub).clone()
        s[0] += 0.25
        return s
    _evaluator(system, wrap)


def half_batch_left_out(system):
    """Every other row scored, the rows left out given the mean of the
    rest (interleaved, so that it bites however many rows are real)."""
    def wrap(inner, sub):
        s = inner({k: v[0::2] for k, v in sub.items()})
        n = next(iter(sub.values())).shape[0]
        out = s.mean().expand(n).clone()
        out[0::2] = s
        return out
    _evaluator(system, wrap)


def state_unchanged(system):
    """The step hands back the Trust DB and prior it was given."""
    sh = system.engine.shedder
    inner = sh._step

    def step(*args):
        trust, tier, n, _, _ = inner(*args)
        return trust, tier, n, args[0], args[1]
    sh._step = step


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    line = cpu_run(smoke_files(workload))
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("fault", [answer_altered, half_batch_left_out,
                                   state_unchanged],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", CELLS[:2])
def test_fault_makes_the_run_incorrect(workload, fault):
    line = cpu_run(smoke_files(workload), fault=fault)
    assert not line["correct"], line["checks"]
