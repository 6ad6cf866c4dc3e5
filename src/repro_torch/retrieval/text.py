"""Parse stage of the index pipeline: tokenize -> common-word filter ->
stem. A copy of ``repro.retrieval.text``.

The paper's system indexes the web; its front half is the classic
IR parse chain. This module is deliberately tiny and deterministic —
the same text always yields the same term stream, which is what makes
blocked index construction reproducible across block sizes
(``tests/test_retrieval.py``).

* :func:`tokenize` — lowercase alphanumeric runs (URLs, punctuation and
  markup dissolve).
* ``STOPWORDS`` — the common-word filter: the paper notes common
  keywords ("book") retrieve hundreds of thousands of pages; filtering
  pure function words keeps postings lists about *content*.
* :func:`stem` — a light suffix stripper (s/es/ed/ing/ly), enough to
  fold the synthetic corpus's inflected variants ("term00042s",
  "term00042ing") onto one canonical posting without dragging in a full
  Porter stemmer.
"""
from __future__ import annotations

import re
from typing import List

_TOKEN = re.compile(r"[a-z0-9]+")

# Function words only — content words must survive the filter.
STOPWORDS = frozenset(
    "a an and are as at be been but by for from had has have he her his "
    "i if in into is it its not of on or she that the their there they "
    "this to was we were which will with you".split())

# Longest first so "es"/"ed" beat "s"/"d"; a stripped stem keeps at
# least _MIN_STEM characters (protects short real words like "was").
_SUFFIXES = ("ing", "edly", "es", "ed", "ly", "s")
_MIN_STEM = 3


def tokenize(text: str) -> List[str]:
    """Lowercase alphanumeric tokens, in document order."""
    return _TOKEN.findall(text.lower())


def stem(word: str) -> str:
    """Strip the first matching suffix, keeping >= 3 stem chars."""
    for suf in _SUFFIXES:
        if word.endswith(suf) and len(word) - len(suf) >= _MIN_STEM:
            return word[: -len(suf)]
    return word


def normalize(text: str) -> List[str]:
    """The full parse chain: tokenize -> stopword filter -> stem.
    Order-preserving (positions matter for term frequency)."""
    return [stem(w) for w in tokenize(text) if w not in STOPWORDS]
