"""The one traffic generator of the benchmark.

A traffic mix is a JSON file under ``portbench/traffic/`` (its name is
the ``traffic`` of a cell in ``BENCHMARK.json``). This module reads any
such file and turns it, with ``--seed`` and ``--seconds``, into an
open-loop schedule of requests:

* ``kind: "search"``: raw queries, answered through retrieval. The
  corpus is generated here (``Corpus``: Zipf term ranks, stopwords and
  inflected variants woven into plain text); queries draw 1..max_terms
  terms from the same Zipf law.
* ``kind: "urls"``: pre-retrieved candidate sets. Keys are drawn from a
  bounded Zipf law over ``n_keys`` URLs, set sizes as Zipf multiples of
  ``unit`` clipped to [min, max].

Every seed gets the same schedule: the due times, set sizes and
priorities are drawn from the file's ``schedule_seed`` and the window
length; what the requests hold (queries, keys, tokens) is drawn from
``--seed``. So the work offered in a window is the same from seed to
seed and its content is not. (With the order drawn from the seed, which
LOW requests were large moved the admitted work, and the trusted rate of
an overloaded cell, by some 10% from seed to seed.)

Each item's evaluator tokens are a hash of (seed, key): the same key
reads the same tokens wherever it recurs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

PRIORITIES = ("CRITICAL", "HIGH", "NORMAL", "LOW")
_FILLERS = ("the", "of", "and", "in", "to", "is", "for", "with")
_SUFFIXES = ("s", "ing", "ed")
_M64 = (1 << 64) - 1


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finaliser of uint64 values (wrapping arithmetic)."""
    with np.errstate(over="ignore"):
        z = x.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def item_tokens(seed: int, keys: np.ndarray, vocab: int,
                length: int) -> np.ndarray:
    """(len(keys), length) int32 evaluator tokens of each key: a hash of
    (seed, key, position) modulo the vocabulary."""
    base = _mix64(np.asarray([seed & _M64], np.uint64))[0]
    k = np.asarray(keys, np.uint64)[:, None]
    pos = np.arange(length, dtype=np.uint64)[None, :]
    with np.errstate(over="ignore"):
        x = _mix64((k << np.uint64(8)) + pos + base)
    return (x % np.uint64(vocab)).astype(np.int32)


def _zipf_ranks(rng: np.random.Generator, a: float, size: int,
                n: int) -> np.ndarray:
    """Zipf(a) 0-based ranks clipped to n (the tail folds onto the last
    rank)."""
    return np.minimum(rng.zipf(a, size=size), n) - 1


class Corpus:
    """Seeded synthetic corpus: plain text for the system's indexer and,
    beside it, the term ranks each document was written from (which the
    reference reads instead of the text). Holds what a searcher asks of
    a corpus: ``n_docs``, ``doc_text``, ``text``, ``vocab``, ``domains``,
    ``exact_trust``, ``quality`` and ``trust_scale`` (the last three feed
    only a searcher's side features, which the evaluator does not read)."""

    def __init__(self, n_docs: int, vocab_size: int, zipf_a: float,
                 doc_len: int, seed: int, n_domains: int = 256,
                 trust_scale: float = 5.0):
        rng = np.random.default_rng([seed & _M64, 1])
        self.n_docs, self.vocab_size = int(n_docs), int(vocab_size)
        self.zipf_a, self.trust_scale = float(zipf_a), float(trust_scale)
        self.vocab: List[str] = [f"term{i:05d}" for i in range(vocab_size)]
        half = max(doc_len // 2, 4)
        n_terms = rng.integers(half, doc_len + half, size=n_docs)
        total = int(n_terms.sum())
        ranks = _zipf_ranks(rng, zipf_a, total, vocab_size)
        inflect = rng.random(total)
        fill = rng.random(total)
        self.offsets = np.concatenate([[0], np.cumsum(n_terms)])
        self.ranks = ranks.astype(np.int32)
        words = np.asarray(self.vocab, dtype=object)[ranks]
        sfx = np.asarray(("",) + _SUFFIXES, dtype=object)[
            np.where(inflect < 0.15, (inflect * 100).astype(int) % 3 + 1, 0)]
        flr = np.asarray(("",) + tuple(" " + f for f in _FILLERS),
                         dtype=object)[
            np.where(fill < 0.25, (fill * 100).astype(int) % 8 + 1, 0)]
        tok = words + sfx + flr
        off = self.offsets
        self.doc_text = [" ".join(tok[off[d]:off[d + 1]])
                         for d in range(n_docs)]
        self.domains = rng.integers(0, n_domains, size=n_docs).astype(
            np.int32)
        self.exact_trust = rng.uniform(0.0, trust_scale, size=n_docs).astype(
            np.float32)
        self.quality = rng.uniform(0.3, 1.0, size=(n_docs, 3)).astype(
            np.float32)
        # document frequency of each rank, for drawing answerable queries
        pairs = np.unique(np.repeat(np.arange(n_docs), n_terms)
                          * vocab_size + ranks)
        self.df = np.bincount(pairs % vocab_size, minlength=vocab_size)

    def text(self, doc_id: int) -> str:
        return self.doc_text[doc_id]


@dataclass
class Request:
    """One request of the schedule. ``due`` is seconds from the start of
    its stream; ``query`` (search) or ``keys`` (urls) holds the work."""
    due: float
    priority: str
    tenant: str
    query: Optional[str] = None
    keys: Optional[np.ndarray] = None          # uint32, urls only


def _schedule(spec: Dict, n: int, seconds: float, tag: int):
    """(due times, priorities, set sizes or None) of n requests, from
    ``schedule_seed``: Poisson arrivals conditioned on n in the window,
    the priority mix in exact proportion."""
    rng = np.random.default_rng([int(spec["schedule_seed"]), n, tag])
    gaps = rng.exponential(1.0, size=n + 1)
    due = np.cumsum(gaps * (seconds / gaps.sum()))[:n]
    mix = spec["priority_mix"]
    w = np.asarray([mix[p] for p in PRIORITIES], np.float64)
    counts = np.floor(w / w.sum() * n).astype(int)
    counts[np.argsort(-(w / w.sum() * n - counts))[:n - counts.sum()]] += 1
    prios = rng.permutation(np.repeat(np.arange(4), counts))
    sizes = None
    if "set_size" in spec:
        s = spec["set_size"]
        sizes = np.clip(rng.zipf(float(s["zipf_a"]), size=n) * int(s["unit"]),
                        int(s["min"]), int(s["max"]))
    return due, prios, sizes


def _url_keys(spec: Dict, rng: np.random.Generator, size: int
              ) -> np.ndarray:
    """``size`` distinct keys, Zipf(a < 1) over [1, n_keys] by the
    inverse of the bounded power law's distribution function."""
    n_keys, a = int(spec["keys"]["n_keys"]), float(spec["keys"]["zipf_a"])
    top = float(n_keys) ** (1.0 - a) - 1.0
    out = np.zeros(0, np.int64)
    while len(out) < size:
        u = rng.random(2 * (size - len(out)) + 8)
        r = np.floor((1.0 + u * top) ** (1.0 / (1.0 - a))).astype(np.int64)
        r = np.clip(r, 1, n_keys)
        _, first = np.unique(np.concatenate([out, r]), return_index=True)
        merged = np.concatenate([out, r])[np.sort(first)]
        out = merged[:size]
    return out.astype(np.uint32)


def sample_query(spec: Dict, corpus: Corpus, rng: np.random.Generator
                 ) -> str:
    """1..max_terms Zipf terms, every one of which some document holds
    (a query that matches nothing has no answer to judge)."""
    q = spec["query"]
    while True:
        k = int(rng.integers(1, int(q["max_terms"]) + 1))
        ranks = _zipf_ranks(rng, float(q["zipf_a"]), k, corpus.vocab_size)
        if (corpus.df[ranks] > 0).all():
            return " ".join(corpus.vocab[int(r)] for r in ranks)


def make_corpus(spec: Dict, seed: int) -> Corpus:
    c = spec["corpus"]
    return Corpus(n_docs=int(c["n_docs"]), vocab_size=int(c["vocab"]),
                  zipf_a=float(c["zipf_a"]), doc_len=int(c["doc_len"]),
                  seed=seed)


def make_requests(spec: Dict, seed: int, seconds: float, tag: int,
                  corpus: Optional[Corpus] = None) -> List[Request]:
    """The schedule of one stream (``tag`` 0: the measured window of
    ``seconds``; 1: the warm-up of ``warmup_requests`` at the same
    rate)."""
    rate = float(spec["rate_per_s"])
    if tag == 0:
        n = max(1, int(round(rate * seconds)))
    else:
        n = int(spec["warmup_requests"])
        seconds = n / rate
    due, prios, sizes = _schedule(spec, n, seconds, tag)
    rng = np.random.default_rng([seed & _M64, tag, 11])
    tenants = int(spec["tenants"])
    out = []
    if spec["kind"] == "search":
        for i in range(n):
            out.append(Request(float(due[i]), PRIORITIES[prios[i]],
                               f"tenant{i % tenants}",
                               query=sample_query(spec, corpus, rng)))
    elif spec["kind"] == "urls":
        for i in range(n):
            out.append(Request(float(due[i]), PRIORITIES[prios[i]],
                               f"tenant{i % tenants}",
                               keys=_url_keys(spec, rng, int(sizes[i]))))
    else:
        raise ValueError(f"unknown traffic kind {spec['kind']!r}")
    return out
