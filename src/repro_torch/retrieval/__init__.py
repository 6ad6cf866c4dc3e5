"""``repro_torch.retrieval`` — the inverted-index front end (counterpart
of ``repro.retrieval``):

    parse (text) -> index (blocked build + merge) -> retrieve
    (dense BM25 on the device -> ``topk_select`` kernel) -> ... serving

* :mod:`.text`, :mod:`.corpus`, :mod:`.index` — pure Python and numpy,
  copies of the reference's (same seed, same corpus and postings).
* :mod:`.shard` — doc-partitioned :class:`IndexShard` (dense BM25 on
  torch -> ``kernels.topk_select``), :class:`CorpusRetrieval` and the
  ``SyntheticSearcher``-compatible :class:`CorpusSearcher`.
"""
from .corpus import SyntheticCorpus, ZipfQueryModel
from .index import (BM25_B, BM25_K1, CollectionStats, InvertedIndex,
                    bm25_scores, build_index, collection_stats,
                    index_checksum, merge_indexes, topk_py)
from .shard import (CorpusRetrieval, CorpusSearcher, IndexShard, Q_MAX,
                    merge_topk)
from .text import STOPWORDS, normalize, stem, tokenize

__all__ = [
    "SyntheticCorpus", "ZipfQueryModel",
    "BM25_B", "BM25_K1", "CollectionStats", "InvertedIndex",
    "bm25_scores", "build_index", "collection_stats",
    "index_checksum", "merge_indexes", "topk_py",
    "CorpusRetrieval", "CorpusSearcher", "IndexShard", "Q_MAX",
    "merge_topk",
    "STOPWORDS", "normalize", "stem", "tokenize",
]
