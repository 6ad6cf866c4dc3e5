"""Plain reference of retrieval: Okapi BM25 (k1 1.2, b 0.75) over the
benchmark's corpus, top-k by (score descending, document id ascending),
documents with a positive score only.

It reads the term ranks each document was generated from, not its text:
stopwords add nothing and every inflected variant of a term counts as
the term, which is what parsing the text (tokenise, drop stopwords, strip
the suffix) must give. Scores are float64, each posting's weight
``idf * tf * (k1 + 1) / (tf + k1 * (1 - b + b * dl / avgdl))`` with
``idf = log(1 + (N - df + 0.5) / (df + 0.5))``, summed in the query's
term order, so a correct system gives the same bits.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

K1, B = 1.2, 0.75


class BM25:
    def __init__(self, ranks: np.ndarray, offsets: np.ndarray,
                 vocab: List[str]):
        n_docs = len(offsets) - 1
        lens = np.diff(offsets)
        doc = np.repeat(np.arange(n_docs), lens)
        pair, tf = np.unique(doc.astype(np.int64) * len(vocab) + ranks,
                             return_counts=True)
        self.doc, self.rank = pair // len(vocab), pair % len(vocab)
        self.tf = tf.astype(np.float64)
        self.dl = lens.astype(np.float64)
        self.n_docs = n_docs
        avg = int(lens.sum()) / max(n_docs, 1)
        self.term = {w: i for i, w in enumerate(vocab)}
        df = np.bincount(self.rank, minlength=len(vocab))
        idf = np.asarray([math.log(1.0 + (n_docs - int(d) + 0.5)
                                   / (int(d) + 0.5)) for d in df])
        denom = self.tf + K1 * (1.0 - B + B * self.dl[self.doc] / avg)
        self.w = idf[self.rank] * self.tf * (K1 + 1.0) / denom
        order = np.argsort(self.rank, kind="stable")
        self.by_rank = np.split(order, np.cumsum(
            np.bincount(self.rank, minlength=len(vocab)))[:-1])

    def topk(self, query: str, k: int) -> Tuple[np.ndarray, np.ndarray]:
        scores = np.zeros(self.n_docs, np.float64)
        for word in query.split():
            r = self.term.get(word)
            if r is None:
                continue
            idx = self.by_rank[r]
            scores[self.doc[idx]] = scores[self.doc[idx]] + self.w[idx]
        hit = np.flatnonzero(scores > 0.0)
        order = np.lexsort((hit, -scores[hit]))[:k]
        return hit[order], scores[hit[order]]


def check_searches(bm: BM25, searches: List, k: int) -> int:
    """Searches (query, candidate ids, BM25 scores, the URL keys the
    request was served under) whose ids, scores or keys differ from the
    reference's; each is compared exactly."""
    bad = 0
    for query, ids, scores, served in searches:
        want_ids, want_scores = bm.topk(query, k)
        if not (np.array_equal(ids, want_ids)
                and np.array_equal(scores, want_scores)
                and np.array_equal(served, want_ids.astype(np.uint32) + 1)):
            bad += 1
    return bad
