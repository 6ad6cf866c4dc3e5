"""Deterministic synthetic document corpus (Zipf vocabulary, seeded).

A copy of ``repro.retrieval.corpus``: the same seed gives the same
text, features and trust in both packages.

Tests and benches need a corpus with realistic term statistics but no
external data. :class:`SyntheticCorpus` generates one reproducibly:

* a rank-ordered **content vocabulary** whose document frequencies
  follow a Zipf law (rank 1 is the paper's "book" — the common keyword
  that retrieves a flood of pages);
* documents as plain text — content words drawn by Zipf rank,
  stopwords sprinkled in (so the common-word filter has work to do),
  and a fraction of inflected variants (``...s``/``...ing``/``...ed``)
  so stemming folds real variety;
* the same hidden per-document trust model as
  ``core.pipeline.SyntheticSearcher`` (features, domain buckets, exact
  trust, quality metrics), so retrieved candidates flow straight into
  the trust pipeline and fidelity stays measurable.

:class:`ZipfQueryModel` draws query strings from the SAME rank-ordered
vocabulary with its own independent RNG stream. Hot query terms are
therefore hot document terms: a flood of queries for rank-1 terms
retrieves overlapping top documents — exactly the correlated hot-URL
flood the gossip/dedup benches assume.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

# A handful of stopwords woven into generated docs (all filtered by
# retrieval.text.STOPWORDS at parse time).
_FILLERS = ("the", "of", "and", "in", "to", "is", "for", "with")
_SUFFIX_VARIANTS = ("s", "ing", "ed")


def _zipf_ranks(rng: np.random.Generator, a: float, size: int,
                vocab_size: int) -> np.ndarray:
    """Zipf-distributed 0-based vocabulary ranks, clipped to the
    vocabulary (the unbounded tail folds onto the last rank)."""
    return np.minimum(rng.zipf(a, size=size), vocab_size) - 1


class SyntheticCorpus:
    """Seeded corpus: text for the indexer, trust state for the shedder.

    Two corpora built with the same constructor arguments are
    identical — document text, features, and trust all derive from one
    ``np.random.default_rng(seed)`` stream.
    """

    def __init__(self, n_docs: int = 4096, vocab_size: int = 2048,
                 zipf_a: float = 1.15, doc_len: int = 64,
                 seed: int = 0, d_feat: int = 16, n_domains: int = 256,
                 trust_scale: float = 5.0):
        if n_docs <= 0 or vocab_size <= 0:
            raise ValueError("n_docs and vocab_size must be positive")
        rng = np.random.default_rng(seed)
        self.n_docs = int(n_docs)
        self.vocab_size = int(vocab_size)
        self.zipf_a = float(zipf_a)
        self.d_feat = int(d_feat)
        self.trust_scale = float(trust_scale)
        # Rank-ordered content vocabulary: vocab[0] is the hottest term.
        self.vocab: List[str] = [f"term{i:05d}"
                                 for i in range(self.vocab_size)]

        # --- document text -------------------------------------------------
        self.doc_text: List[str] = []
        half = max(doc_len // 2, 4)
        for _ in range(self.n_docs):
            n_terms = int(rng.integers(half, doc_len + half))
            ranks = _zipf_ranks(rng, self.zipf_a, n_terms,
                                self.vocab_size)
            words = []
            inflect = rng.random(n_terms)
            fill = rng.random(n_terms)
            for j, r in enumerate(ranks):
                w = self.vocab[int(r)]
                if inflect[j] < 0.15:   # stemmer folds these back
                    w += _SUFFIX_VARIANTS[int(inflect[j] * 100) % 3]
                words.append(w)
                if fill[j] < 0.25:      # stopword filter removes these
                    words.append(_FILLERS[int(fill[j] * 100)
                                          % len(_FILLERS)])
            self.doc_text.append(" ".join(words))

        # --- hidden trust state (SyntheticSearcher's recipe) ---------------
        self.features = rng.normal(size=(self.n_docs, d_feat)
                                   ).astype(np.float32)
        self.domains = rng.integers(0, n_domains,
                                    size=self.n_docs).astype(np.int32)
        dom_trust = rng.uniform(0.2, 0.95, size=n_domains)
        w = rng.normal(size=(d_feat,)).astype(np.float32) \
            / np.sqrt(d_feat)
        sig = 1.0 / (1.0 + np.exp(-(self.features @ w)))
        t = 0.6 * dom_trust[self.domains] + 0.4 * sig
        self.exact_trust = (t * trust_scale).astype(np.float32)
        self.quality = rng.uniform(
            0.3, 1.0, size=(self.n_docs, 3)).astype(np.float32)

    def text(self, doc_id: int) -> str:
        return self.doc_text[doc_id]

    def doc_ids(self) -> np.ndarray:
        return np.arange(self.n_docs, dtype=np.int64)


class ZipfQueryModel:
    """Query strings over a rank-ordered vocabulary.

    Draws 1..``max_terms`` content words per query by the same Zipf law
    that generated the corpus, from an **independent** RNG stream — so
    attaching a query model to an existing workload never perturbs its
    arrival-time draws (``simulator.make_arrivals`` stays bit-stable).
    """

    def __init__(self, vocab: Sequence[str], zipf_a: float = 1.15,
                 seed: int = 0, max_terms: int = 3):
        if not vocab:
            raise ValueError("query vocabulary is empty")
        self.vocab = list(vocab)
        self.zipf_a = float(zipf_a)
        self.max_terms = max(int(max_terms), 1)
        self._rng = np.random.default_rng(seed)

    @classmethod
    def for_corpus(cls, corpus: SyntheticCorpus, seed: int = 0,
                   max_terms: int = 3) -> "ZipfQueryModel":
        return cls(corpus.vocab, zipf_a=corpus.zipf_a, seed=seed,
                   max_terms=max_terms)

    def sample(self, rng: Optional[np.random.Generator] = None) -> str:
        r = rng if rng is not None else self._rng
        n = int(r.integers(1, self.max_terms + 1))
        ranks = _zipf_ranks(r, self.zipf_a, n, len(self.vocab))
        return " ".join(self.vocab[int(k)] for k in ranks)
