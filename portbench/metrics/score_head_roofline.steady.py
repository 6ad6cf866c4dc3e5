"""score_head's share of its roofline over the traced window, in %: the
launches of the kernels named in this metric's data file, each priced at
one evaluator call's scoring head (``eval_rows`` sequences of
``doc_tokens`` - 1 positions: the (positions, hidden) x (hidden, vocab)
product; the hidden states and the vocabulary weight read once in bf16,
an int32 target read and a float32 log-probability written a position),
over those kernels' traced time. None where no such kernel ran (a
system without the fused head)."""
from portbench import work


def read(obs, data):
    tr = obs["trace"]
    if not tr:
        return None
    t, n = 0.0, 0
    for name, (sec, count) in tr["kernels"].items():
        if any(k in name for k in data["kernels"]):
            t, n = t + sec, n + count
    if not n or t <= 0:
        return None
    m = obs["model"]
    d, vocab = m["hidden_size"], m["vocab_size"]
    positions = obs["eval_rows"] * (obs["doc_tokens"] - 1)
    bound = work.bound_s({
        "flops": 2.0 * positions * d * vocab,
        "bytes": float(positions * (2 * d + 4 + 4) + 2 * d * vocab)})
    return 100.0 * n * bound / t
