"""Doc-partitioned index shards with a dense BM25 -> top-k path on torch.

Counterpart of ``repro.retrieval.shard``. :class:`IndexShard` wraps one
replica's merged :class:`InvertedIndex` in a static-shape dense form on
its device (``cuda`` unless the caller names another):

* shard documents map to local slots ``0..D-1`` in ascending global
  doc-id order (so the top-k's index-ascending tie-break reproduces the
  oracle's doc-id-ascending one), padded to ``D_pad`` (a multiple of
  128, as in the reference);
* every term's postings become one row of a ``(T+1, P)`` pair of
  tensors — local slot ids and precomputed BM25 per-posting weights
  ``w(t,d) = idf(t) * tf * (k1+1) / (tf + k1*(1-b+b*dl/avgdl))`` —
  padded with slot ``D_pad``. Row ``T`` is the all-padding sentinel for
  unknown or absent query terms, so a query is a fixed ``(Q_MAX,)``
  vector of term rows;
* scoring builds the query's ``(Q_MAX, D_pad)`` term x doc weight rows —
  an index of the dense ``(T+1, D_pad)`` weight matrix when it fits
  ``DENSE_W_BUDGET_BYTES``, else a scatter of each term's postings into
  its own row of a ``(Q_MAX, D_pad+1)`` buffer (slots are unique within
  a row, so the scatter has no write conflicts; the padding column is
  sliced off) — and sums the rows in query-term order, one elementwise
  add at a time. Both forms give the same bits, on the CPU and on CUDA,
  run after run: no atomics, no reduction whose order depends on the
  device. ``kernels.topk_select`` then picks the candidate set at
  ``k`` quantized to the next power of two, as the reference does.

Weights and scores are float64, computed and summed in the order of the
Python oracle ``index.bm25_scores``, so the scores equal the oracle's
bit for bit and the top-k equals ``index.topk_py`` exactly, near-ties
included. The reference ranks float32 scores, which round near-ties of
the float64 oracle into exact ties and then break them by index, so on
larger corpora its ids can differ from its own oracle (ROADMAP.md,
Queue 3).

Shard ownership moves at doc-partition granularity
(``CorpusRetrieval.partition_doc_ids``): :meth:`IndexShard.export_docs`
carves out a stripe and :meth:`IndexShard.absorb` splices one in; both
invalidate the dense form, which rebuilds lazily on the next query.

:class:`CorpusSearcher` adapts shards to the ``SyntheticSearcher``
interface (``search(query, n_results) -> SearchResults``).
"""
from __future__ import annotations

import time
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.core.pipeline import SearchResults
from repro_torch.device import resolve
from repro_torch.kernels.topk_select import topk_select
from repro_torch.tracing import span, traced

from .corpus import SyntheticCorpus
from .index import (BM25_B, BM25_K1, CollectionStats, InvertedIndex,
                    bm25_scores, build_index, topk_py)
from .text import normalize

LANES = 128
Q_MAX = 8          # static query width: terms beyond this are dropped

# A shard whose full term x doc weight matrix fits this budget (counted
# at the reference's 4 bytes per entry) scores by indexing its rows;
# bigger shards scatter the query terms' postings instead, which needs
# O(postings) memory.
DENSE_W_BUDGET_BYTES = 64 << 20


def _pow2_at_least(k: int) -> int:
    return 1 << max(int(k) - 1, 0).bit_length()


def _sum_rows(rows: torch.Tensor) -> torch.Tensor:
    """Sum over the term axis (-2) in a fixed order: row 0 + row 1 + ...
    Elementwise adds round the same way on every device."""
    acc = rows.select(-2, 0).clone()
    for r in range(1, rows.shape[-2]):
        acc = acc + rows.select(-2, r)
    return acc


class IndexShard:
    """One replica's documents: merged postings + dense scoring form."""

    def __init__(self, index: InvertedIndex, *, k1: float = BM25_K1,
                 b: float = BM25_B,
                 stats: Optional[CollectionStats] = None, device=None):
        self.index = index
        self.k1 = float(k1)
        self.b = float(b)
        # collection-global statistics; None -> this shard IS the
        # whole collection (single-node mode)
        self.stats = stats
        self.device = resolve(device)
        self._dense_ok = False
        # dense form (built lazily)
        self._slot_doc: Optional[np.ndarray] = None     # (D,) global ids
        self._term_id: Dict[str, int] = {}
        self._post_slot: Optional[torch.Tensor] = None  # (T+1, P) int32
        self._post_w: Optional[torch.Tensor] = None     # (T+1, P) f64
        self._w_dense: Optional[torch.Tensor] = None    # (T+1, D_pad) f64
        self._d_pad = 0

    # -- construction / handoff --------------------------------------------

    @classmethod
    def build(cls, texts: Sequence[str], doc_ids: Sequence[int], *,
              block_docs: int = 512, k1: float = BM25_K1,
              b: float = BM25_B, stats: Optional[CollectionStats] = None,
              device=None) -> "IndexShard":
        return cls(build_index(texts, doc_ids, block_docs=block_docs),
                   k1=k1, b=b, stats=stats, device=device)

    @property
    def n_docs(self) -> int:
        return self.index.n_docs

    def export_docs(self, doc_ids: Iterable[int]) -> InvertedIndex:
        """Carve the given documents OUT of this shard (graceful-leave
        handoff payload). Returns their sub-index; postings order is
        preserved on both sides."""
        leaving = {int(d) for d in doc_ids}
        sub = InvertedIndex()
        for d in sorted(leaving):
            if d in self.index.doc_len:
                sub.doc_len[d] = self.index.doc_len.pop(d)
        if not sub.doc_len:
            return sub
        for t in list(self.index.postings):
            plist = self.index.postings[t]
            keep = [p for p in plist if p[0] not in leaving]
            gone = [p for p in plist if p[0] in leaving]
            if gone:
                sub.postings[t] = gone
                if keep:
                    self.index.postings[t] = keep
                else:
                    del self.index.postings[t]
        self._dense_ok = False
        return sub

    def absorb(self, sub: InvertedIndex) -> None:
        """Splice a handed-off (or freshly built) stripe in. Doc-id
        ranges may interleave with what the shard already owns, so each
        touched postings list re-sorts by doc id."""
        dup = set(sub.doc_len) & set(self.index.doc_len)
        if dup:
            raise ValueError(f"absorb: docs already owned: {sorted(dup)[:4]}")
        self.index.doc_len.update(sub.doc_len)
        for t, plist in sub.postings.items():
            mine = self.index.postings.setdefault(t, [])
            mine.extend(plist)
            mine.sort(key=lambda p: p[0])
        self._dense_ok = False

    # -- dense form ---------------------------------------------------------

    def _ensure_dense(self) -> None:
        if self._dense_ok:
            return
        idx = self.index
        docs = np.asarray(idx.doc_ids(), dtype=np.int64)
        d = len(docs)
        self._slot_doc = docs
        self._d_pad = max(-(-max(d, 1) // LANES) * LANES, LANES)
        terms = sorted(idx.postings)
        self._term_id = {t: i for i, t in enumerate(terms)}
        t_rows = len(terms) + 1                      # +1 sentinel row
        lens = np.asarray([len(idx.postings[t]) for t in terms], np.int64)
        p = int(lens.max()) if len(lens) else 1
        post_slot = np.full((t_rows, p), self._d_pad, np.int32)
        post_w = np.zeros((t_rows, p), np.float64)
        if len(terms):
            flat = np.asarray([pt for t in terms for pt in idx.postings[t]],
                              np.int64).reshape(-1, 2)
            rows = np.repeat(np.arange(len(terms)), lens)
            cols = np.arange(len(flat)) - np.repeat(np.cumsum(lens) - lens,
                                                    lens)
            slots = np.searchsorted(docs, flat[:, 0])
            dl_of_slot = np.asarray([idx.doc_len[int(x)] for x in docs],
                                    np.float64)
            st = self.stats
            avg = st.avg_dl if st is not None else idx.avg_dl
            idf = np.asarray([st.idf(t) if st is not None else idx.idf(t)
                              for t in terms], np.float64)
            k1, b = self.k1, self.b
            # the oracle's float64 arithmetic, in its operation order
            tf = flat[:, 1].astype(np.float64)
            denom = tf + k1 * (1.0 - b + b * dl_of_slot[slots] / avg)
            post_slot[rows, cols] = slots
            post_w[rows, cols] = idf[rows] * tf * (k1 + 1.0) / denom
        dev = self.device
        self._post_slot = torch.from_numpy(post_slot).to(dev)
        self._post_w = torch.from_numpy(post_w).to(dev)
        # Dense weight matrix when it fits the budget, counted at the
        # reference's 4 bytes per entry so both packages pick the same
        # form (each (term, doc) pair holds at most one posting; the
        # extra dump column absorbs the padding slots).
        if t_rows * self._d_pad * 4 <= DENSE_W_BUDGET_BYTES:
            w = np.zeros((t_rows, self._d_pad + 1), np.float64)
            w[np.repeat(np.arange(t_rows), p),
              np.minimum(post_slot.reshape(-1), self._d_pad)] = \
                post_w.reshape(-1)
            self._w_dense = torch.from_numpy(
                np.ascontiguousarray(w[:, :self._d_pad])).to(dev)
        else:
            self._w_dense = None
        self._dense_ok = True

    def query_term_ids(self, query: str) -> np.ndarray:
        """(Q_MAX,) int32 term-id vector; unknown/absent -> sentinel."""
        self._ensure_dense()
        sentinel = len(self._term_id)
        ids = [self._term_id.get(t, sentinel)
               for t in normalize(query)[:Q_MAX]]
        ids += [sentinel] * (Q_MAX - len(ids))
        return np.asarray(ids, np.int32)

    # -- scoring ------------------------------------------------------------

    def _term_rows(self, qt: np.ndarray) -> torch.Tensor:
        """(..., Q_MAX, D_pad) weight rows of query-term ids ``qt``."""
        qt_t = torch.from_numpy(qt.astype(np.int64)).to(self.device)
        if self._w_dense is not None:
            return self._w_dense[qt_t]
        slots = self._post_slot[qt_t].to(torch.int64)
        buf = torch.zeros(qt.shape + (self._d_pad + 1,),
                          dtype=torch.float64, device=self.device)
        buf.scatter_(-1, slots, self._post_w[qt_t])
        return buf[..., :self._d_pad]

    def score(self, query: str) -> torch.Tensor:
        """Dense (D_pad,) float64 BM25 scores on the shard's device."""
        return _sum_rows(self._term_rows(self.query_term_ids(query)))

    def score_batch(self, queries: Sequence[str]) -> torch.Tensor:
        """``(B, D_pad)`` dense float64 BM25 scores for a batch of
        queries."""
        self._ensure_dense()
        qt = np.stack([self.query_term_ids(q) for q in queries])
        return _sum_rows(self._term_rows(qt))

    def score_py(self, query: str) -> Dict[int, float]:
        """Pure-Python postings-walk baseline (global doc ids)."""
        return bm25_scores(self.index, query, k1=self.k1, b=self.b,
                           stats=self.stats)

    def retrieve(self, query: str, k: int,
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k matching docs: ``(global doc ids (m,), scores (m,))``
        with ``m <= k``, ordered (score desc, doc id asc). Only docs
        with a positive BM25 score count as matches — parity with
        ``index.topk_py(score_py(q), k)``, exactly. One device-to-host
        copy (``retrieval.copy_back``)."""
        if k <= 0 or self.n_docs == 0:
            return (np.zeros(0, np.int64), np.zeros(0, np.float64))
        with span("retrieval.score_topk"):
            scores = self.score(query)
            kq = min(_pow2_at_least(min(k, self._d_pad)), self._d_pad)
            vals, idxs = topk_select(scores, kq)
            both = torch.cat([vals.view(torch.int32), idxs])
        with span("retrieval.copy_back"):
            both = both.cpu().numpy()
        vals, idxs = both[:2 * kq].view(np.float64), both[2 * kq:]
        good = (vals > 0.0) & (idxs < len(self._slot_doc))
        vals, idxs = vals[good][:k], idxs[good][:k]
        return self._slot_doc[idxs], vals


def merge_topk(parts: Sequence[Tuple[np.ndarray, np.ndarray]], k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Gather-merge per-shard top-k lists into one (score desc, doc id
    asc) top-k. Doc ids are unique across doc-partitioned shards, so
    the order is independent of the shard concat order."""
    parts = [(d, s) for d, s in parts if len(d)]
    if not parts:
        return (np.zeros(0, np.int64), np.zeros(0, np.float64))
    docs = np.concatenate([d for d, _ in parts])
    scores = np.concatenate([s for _, s in parts])
    order = np.lexsort((docs, -scores))[:k]
    return docs[order], scores[order]


class CorpusSearcher:
    """``SyntheticSearcher``-compatible front end over real shards.

    ``search`` fans the query out to every attached shard, merges by
    (score desc, doc id asc), and materializes the candidates' trust
    state from the corpus. A query matching nothing falls back to a
    seeded-hash draw — every query must yield a non-empty candidate
    set or the no-drop ledger would undercount.
    """

    def __init__(self, corpus: SyntheticCorpus,
                 shards: Optional[List[IndexShard]] = None,
                 feature_fn: Optional[Callable] = None):
        self.corpus = corpus
        self.shards: List[IndexShard] = list(shards or [])
        # ``feature_fn(doc_ids) -> Dict[str, np.ndarray]`` overrides the
        # corpus feature vectors (a transformer evaluator's tokens).
        self.feature_fn = feature_fn
        self.trust_scale = corpus.trust_scale
        self.last_retrieve_s = 0.0     # wall time of the last search
        self.n_searches = 0
        self.n_fallback = 0

    def retrieve(self, query: str, k: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Scatter to shards, gather + merge top-k."""
        return merge_topk([sh.retrieve(query, k) for sh in self.shards
                           if sh.n_docs], k)

    def _fallback_docs(self, query: str, k: int) -> np.ndarray:
        h = abs(hash(query)) % (2 ** 31)
        rng = np.random.default_rng(h)
        n = self.corpus.n_docs
        return np.sort(rng.choice(n, size=min(k, n), replace=False))

    @traced("retrieval.search")
    def search(self, query: str, n_results: int) -> SearchResults:
        t0 = time.perf_counter()
        self.n_searches += 1
        docs, _ = self.retrieve(query, max(int(n_results), 1))
        if len(docs) == 0:
            self.n_fallback += 1
            docs = self._fallback_docs(query, max(int(n_results), 1))
        c = self.corpus
        with span("retrieval.features"):
            feats = (self.feature_fn(docs) if self.feature_fn is not None
                     else {"x": c.features[docs]})
        res = SearchResults(
            url_ids=(docs.astype(np.uint32) + 1),     # 0 reserved = empty
            buckets=c.domains[docs],
            features=feats,
            quality_metrics=c.quality[docs],
            exact_trust=c.exact_trust[docs],
        )
        self.last_retrieve_s = time.perf_counter() - t0
        return res


class CorpusRetrieval:
    """Doc-partitioned retrieval: the corpus splits into
    ``n_partitions`` contiguous doc-id stripes; partition ``p`` routes
    through a fleet's consistent-hash ring under ``"docpart:p"``, so
    replica joins and leaves move exactly the stripes ``remap_diff``
    claims. Every shard scores with one set of collection-global
    statistics, so a doc-partitioned set of shards ranks exactly like
    one big index. Shards it builds live on ``device``."""

    def __init__(self, corpus: SyntheticCorpus, n_partitions: int = 16,
                 *, block_docs: int = 512, k1: float = BM25_K1,
                 b: float = BM25_B,
                 feature_fn: Optional[Callable] = None, device=None):
        if n_partitions <= 0:
            raise ValueError("n_partitions must be positive")
        self.corpus = corpus
        # forwarded to every CorpusSearcher this object mints
        self.feature_fn = feature_fn
        self.device = resolve(device)
        self.n_partitions = int(n_partitions)
        self.block_docs = int(block_docs)
        self.k1, self.b = float(k1), float(b)
        # stripe boundaries: partition p owns [bounds[p], bounds[p+1])
        n, m = corpus.n_docs, self.n_partitions
        self._bounds = [-(-p * n // m) for p in range(m + 1)]
        df: Dict[str, int] = {}
        total_len = 0
        for text in corpus.doc_text:
            terms = normalize(text)
            total_len += len(terms)
            for t in set(terms):
                df[t] = df.get(t, 0) + 1
        self.stats = CollectionStats(
            n_docs=n, avg_dl=max(total_len / max(n, 1), 1e-6), df=df)

    @staticmethod
    def partition_key(p: int) -> str:
        """The ring key of partition ``p`` (a fleet routes stripes
        through the same consistent-hash ring as tenants)."""
        return f"docpart:{p}"

    def partition_keys(self) -> List[str]:
        return [self.partition_key(p) for p in range(self.n_partitions)]

    @staticmethod
    def partition_index(key: str) -> int:
        if not key.startswith("docpart:"):
            raise ValueError(f"not a partition key: {key!r}")
        return int(key.split(":", 1)[1])

    def partition_doc_ids(self, p: int) -> List[int]:
        return list(range(self._bounds[p], self._bounds[p + 1]))

    def build_partition(self, p: int) -> InvertedIndex:
        """Index one stripe from the corpus."""
        ids = self.partition_doc_ids(p)
        return build_index([self.corpus.text(d) for d in ids], ids,
                           block_docs=self.block_docs)

    def build_shard(self, partitions: Iterable[int]) -> IndexShard:
        shard = IndexShard(InvertedIndex(), k1=self.k1, b=self.b,
                           stats=self.stats, device=self.device)
        for p in sorted(set(int(x) for x in partitions)):
            shard.absorb(self.build_partition(p))
        return shard

    def searcher(self, shards: List[IndexShard]) -> CorpusSearcher:
        return CorpusSearcher(self.corpus, shards,
                              feature_fn=self.feature_fn)

    def oracle_topk(self, query: str, k: int) -> List[Tuple[int, float]]:
        """Whole-corpus pure-Python BM25 top-k (test oracle)."""
        full = build_index(self.corpus.doc_text,
                           list(range(self.corpus.n_docs)),
                           block_docs=self.block_docs)
        return topk_py(bm25_scores(full, query, k1=self.k1, b=self.b,
                                   stats=self.stats), k)
