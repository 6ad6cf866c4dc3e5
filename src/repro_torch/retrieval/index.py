"""Blocked inverted-index construction with sequential merge.

The classic external-memory recipe, scaled down to fit a shard in RAM
but keeping the structure the paper's indexer implies:

1. split the collection into fixed-size **blocks** of documents;
2. parse each block (``text.normalize``) into an in-block postings map
   ``term -> [(doc_id, tf), ...]`` with doc ids ascending;
3. **sequentially merge** the per-block maps — because blocks are taken
   in ascending doc order, a term's merged postings list is the simple
   concatenation of its per-block runs, already sorted by doc id.

The result is block-size invariant: the same corpus yields bit-identical
postings whether it was built in blocks of 7 documents or one block of
everything (``tests/test_retrieval.py`` pins this).

:func:`bm25_scores` is the pure-Python postings scorer: the host oracle
the dense scorer and the ``topk_select`` kernel must agree with. A copy
of ``repro.retrieval.index``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from .text import normalize

# Okapi BM25 defaults (Robertson et al.).
BM25_K1 = 1.2
BM25_B = 0.75

Posting = Tuple[int, int]  # (doc_id, term_frequency)


@dataclass(frozen=True)
class CollectionStats:
    """Collection-global BM25 statistics (n_docs, avg doc length, per-
    term document frequency). A doc-partitioned shard scoring with its
    *local* statistics ranks differently from the whole collection —
    the classic distributed-IR pitfall — so shards share one of these
    and scatter-gather ranking becomes partition-invariant."""
    n_docs: int
    avg_dl: float
    df: Dict[str, int]

    def idf(self, term: str) -> float:
        dfr = self.df.get(term, 0)
        return math.log(1.0 + (self.n_docs - dfr + 0.5) / (dfr + 0.5))


def collection_stats(index: InvertedIndex) -> CollectionStats:
    """Snapshot a (full) index's statistics for sharded scoring."""
    return CollectionStats(
        n_docs=index.n_docs, avg_dl=index.avg_dl,
        df={t: len(p) for t, p in index.postings.items()})


@dataclass
class InvertedIndex:
    """Merged index over one shard's documents.

    ``postings[t]`` is sorted by doc id; ``doc_len`` holds post-filter
    token counts keyed by doc id. Doc ids are global (corpus-wide), so
    shard handoff can move postings between owners without renumbering.
    """

    postings: Dict[str, List[Posting]] = field(default_factory=dict)
    doc_len: Dict[int, int] = field(default_factory=dict)

    @property
    def n_docs(self) -> int:
        return len(self.doc_len)

    @property
    def n_terms(self) -> int:
        return len(self.postings)

    @property
    def avg_dl(self) -> float:
        if not self.doc_len:
            return 1.0
        return max(sum(self.doc_len.values()) / len(self.doc_len), 1e-6)

    def df(self, term: str) -> int:
        return len(self.postings.get(term, ()))

    def idf(self, term: str) -> float:
        """BM25 idf with the +1 floor (never negative)."""
        n, dfr = self.n_docs, self.df(term)
        return math.log(1.0 + (n - dfr + 0.5) / (dfr + 0.5))

    def doc_ids(self) -> List[int]:
        return sorted(self.doc_len)


def _parse_block(texts: Sequence[str], doc_ids: Sequence[int],
                 ) -> Tuple[Dict[str, List[Posting]], Dict[int, int]]:
    """One block: postings map + doc lengths, doc ids ascending."""
    postings: Dict[str, List[Posting]] = {}
    lengths: Dict[int, int] = {}
    for did, text in zip(doc_ids, texts):
        terms = normalize(text)
        lengths[int(did)] = len(terms)
        tf: Dict[str, int] = {}
        for t in terms:
            tf[t] = tf.get(t, 0) + 1
        for t, f in tf.items():
            postings.setdefault(t, []).append((int(did), f))
    return postings, lengths


def merge_indexes(parts: Iterable[InvertedIndex]) -> InvertedIndex:
    """Sequential merge. Inputs must cover disjoint doc-id ranges in
    ascending order (the blocked-build contract); postings runs then
    concatenate without a sort."""
    out = InvertedIndex()
    last_doc = -1
    for part in parts:
        ids = part.doc_ids()
        if ids:
            if ids[0] <= last_doc:
                raise ValueError(
                    "merge_indexes: blocks out of order or overlapping "
                    f"(doc {ids[0]} after {last_doc})")
            last_doc = ids[-1]
        out.doc_len.update(part.doc_len)
        for t, plist in part.postings.items():
            out.postings.setdefault(t, []).extend(plist)
    return out


def build_index(texts: Sequence[str], doc_ids: Sequence[int],
                block_docs: int = 512) -> InvertedIndex:
    """Blocked build: parse ``block_docs``-document blocks, then merge.

    ``doc_ids`` must be strictly ascending (contiguous not required —
    a doc-partitioned shard owns a stripe of the global id space).
    """
    if len(texts) != len(doc_ids):
        raise ValueError("texts and doc_ids length mismatch")
    block_docs = max(int(block_docs), 1)
    blocks: List[InvertedIndex] = []
    for lo in range(0, len(texts), block_docs):
        hi = lo + block_docs
        postings, lengths = _parse_block(texts[lo:hi], doc_ids[lo:hi])
        blocks.append(InvertedIndex(postings=postings,
                                    doc_len=lengths))
    return merge_indexes(blocks)


def bm25_scores(index: InvertedIndex, query: str,
                k1: float = BM25_K1, b: float = BM25_B,
                stats: "CollectionStats" = None) -> Dict[int, float]:
    """Pure-Python postings-walk BM25: the host oracle and the
    baseline scorer. Returns only docs with a nonzero score. With
    ``stats``, idf and avg-dl come from the whole collection instead
    of this (possibly partial) index."""
    scores: Dict[int, float] = {}
    avg = stats.avg_dl if stats is not None else index.avg_dl
    for term in normalize(query):
        plist = index.postings.get(term)
        if not plist:
            continue
        idf = stats.idf(term) if stats is not None else index.idf(term)
        for did, tf in plist:
            dl = index.doc_len[did]
            denom = tf + k1 * (1.0 - b + b * dl / avg)
            scores[did] = scores.get(did, 0.0) \
                + idf * tf * (k1 + 1.0) / denom
    return scores


def topk_py(scores: Dict[int, float], k: int) -> List[Tuple[int, float]]:
    """Top-k by (score desc, doc id asc) — the total order the kernel
    path reproduces exactly."""
    ranked = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))
    return ranked[: max(k, 0)]


def index_checksum(index: InvertedIndex) -> int:
    """Deterministic content hash (term -> postings), used by the
    block-size-invariance test and shard-handoff assertions."""
    acc = np.uint64(1469598103934665603)  # FNV-1a offset basis
    prime = np.uint64(1099511628211)
    with np.errstate(over="ignore"):
        for term in sorted(index.postings):
            for ch in term.encode():
                acc = (acc ^ np.uint64(ch)) * prime
            for did, tf in index.postings[term]:
                acc = (acc ^ np.uint64(did)) * prime
                acc = (acc ^ np.uint64(tf)) * prime
    return int(acc)
