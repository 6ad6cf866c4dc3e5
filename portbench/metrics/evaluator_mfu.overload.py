"""The fresh evaluations' share of the chip's bf16 peak over the
window, in % (``readers.evaluator_mfu``)."""
from portbench.readers import evaluator_mfu


def read(obs, data):
    return evaluator_mfu(obs)
