"""BM25 scoring with exact Lucene parity (CPU oracle).

Port copy of elasticsearch_tpu/ops/bm25.py, whole: the host-side weights and norm cache the compiler bakes into plans, and the
numpy oracle `search_field` the port's device path is held to.

Replicates the scoring math of the reference's default similarity
(LegacyBM25Similarity with k1=1.2, b=0.75; configured at
server/src/main/java/org/elasticsearch/index/similarity/
SimilarityService.java:43-59):

    idf(t)  = ln(1 + (docCount - df + 0.5) / (df + 0.5))
    weight  = boost * (k1 + 1) * idf(t)                 # Legacy keeps (k1+1)
    score   = weight - weight / (1 + tf * normInverse[normByte])

computed in fp32 with Lucene's literal expression shape, where
normInverse[nb] = 1 / (k1 * (1 - b + b * dl(nb) / avgdl)) is a 256-entry
cache over all possible norm bytes, `dl` is the *quantized* field length
decoded from the one-byte norm (utils/smallfloat.py), and
`avgdl = sumTotalTermFreq / docCount` — field-level statistics. Ties in
top-k break by ascending doc id, matching Lucene's TopScoreDocCollector.

This module is the host-side oracle: the device path in
ops/bm25_device.py must reproduce these scores to fp32 tolerance and these
top-k rankings exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..index.segment import FieldIndex

DEFAULT_K1 = 1.2
DEFAULT_B = 0.75


@dataclass(frozen=True)
class BM25Params:
    k1: float = DEFAULT_K1
    b: float = DEFAULT_B


def idf(df: np.ndarray | float, doc_count: int) -> np.ndarray | float:
    """Lucene BM25 idf (float64; round to fp32 like Lucene's `(float)log(..)`)."""
    df = np.asarray(df, dtype=np.float64)
    return np.log(1.0 + (doc_count - df + 0.5) / (df + 0.5))


def term_weight(
    df: float, doc_count: int, boost: float = 1.0, params: BM25Params = BM25Params()
) -> float:
    """Full per-term weight including the Legacy (k1+1) factor.

    Matches Lucene's fp32 rounding order exactly: LegacyBM25Similarity passes
    `boost * (k1 + 1)` (fp32 multiply) into BM25Similarity.scorer, which
    computes `weight = boost' * (float) idf` as fp32 multiplies of the
    fp32-rounded idf.
    """
    idf_f32 = np.float32(idf(df, doc_count))
    boost_f32 = np.float32(np.float32(boost) * np.float32(params.k1 + 1.0))
    return float(boost_f32 * idf_f32)


def norm_inverse_cache(avgdl: float, params: BM25Params = BM25Params()) -> np.ndarray:
    """float32[256] of 1 / (k1 * (1 - b + b * dl(normByte) / avgdl)).

    Lucene precomputes exactly this table per (field, query); scoring then is
    `weight - weight / (1 + freq * cache[normByte])` in fp32.
    """
    from ..utils.smallfloat import LENGTH_TABLE

    k1 = np.float32(params.k1)
    b = np.float32(params.b)
    avgdl = np.float32(avgdl)
    return (
        np.float32(1.0) / (k1 * ((1 - b) + b * LENGTH_TABLE / avgdl))
    ).astype(np.float32)


def field_norm_inverse(field: FieldIndex, params: BM25Params = BM25Params()) -> np.ndarray:
    """float32[N] per-doc norm inverse for a field.

    Norms-disabled fields (keyword): Lucene 8.9's LeafSimScorer.getNormValue
    substitutes norm value 1 when the norms producer is absent, so every doc
    scores with cache[1] — i.e. dl = 1 against the field's real avgdl.
    """
    cache = norm_inverse_cache(field.avgdl, params)
    if not field.has_norms:
        return np.full(len(field.norm_bytes), cache[1], np.float32)
    return cache[field.norm_bytes]


def score_terms_dense(
    field: FieldIndex,
    terms: list[str],
    num_docs: int,
    boost: float = 1.0,
    params: BM25Params = BM25Params(),
    matched: np.ndarray | None = None,
    stats=None,
) -> np.ndarray:
    """Dense float32[num_docs] BM25 scores for a disjunction of terms.

    Repeated query terms contribute once per occurrence, exactly like a
    Lucene BooleanQuery over duplicate TermQuery clauses. If `matched` (a
    bool[num_docs] accumulator) is given, docs hit by at least one term are
    flagged — Lucene's collector only ever sees such docs, so top-k must be
    restricted to them.

    `stats` (a query.compile.FieldStats, duck-typed: doc_count/avgdl/df)
    overrides the statistics scope — the AggregatedDfs analog: pushed-down
    index-global statistics replace the segment-local doc_count/avgdl/df so
    scores match the device compiler's exactly when the caller shares one
    statistics view across segments or shards.
    """
    scores = np.zeros(num_docs, dtype=np.float32)
    if field.doc_count == 0:
        return scores
    doc_count = field.doc_count
    if stats is not None:
        doc_count = stats.doc_count
        cache = norm_inverse_cache(stats.avgdl, params)
        if not field.has_norms:
            norm_inv = np.full(len(field.norm_bytes), cache[1], np.float32)
        else:
            norm_inv = cache[field.norm_bytes]
    else:
        norm_inv = field_norm_inverse(field, params)  # float32[N]
    one = np.float32(1.0)
    for term in terms:
        doc_ids, tfs = field.postings(term)
        if len(doc_ids) == 0:
            continue
        df = int(field.df[field.terms[term]])
        if stats is not None:
            df = int(stats.df.get(term, df))
        w = np.float32(term_weight(df, doc_count, boost, params))
        contrib = w - w / (one + tfs * norm_inv[doc_ids])
        scores[doc_ids] += contrib.astype(np.float32)
        if matched is not None:
            matched[doc_ids] = True
    return scores


def top_k(
    scores: np.ndarray, k: int, matched: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """(top_scores, top_doc_ids) sorted by (score desc, doc id asc).

    Matches Lucene's collector tie-breaking (TopScoreDocCollector: on equal
    score the lower doc id wins; reference collector setup at
    search/query/TopDocsCollectorContext.java:68). If `matched` is given,
    only matched docs are eligible hits — fewer than k results are returned
    when fewer docs match, exactly like a Lucene collector that only sees
    docs emitted by the scorer.
    """
    n = len(scores)
    k = max(0, min(k, n))
    if matched is not None:
        n_hits = int(np.count_nonzero(matched))
        k = min(k, n_hits)
        scores = np.where(matched, scores, -np.inf)
    if k == 0:
        return np.empty(0, dtype=np.float32), np.empty(0, dtype=np.int64)
    # Sort by (-score, doc_id): lexsort uses last key as primary.
    doc_ids = np.arange(n)
    order = np.lexsort((doc_ids, -scores.astype(np.float64)))[:k]
    return np.asarray(scores, dtype=np.float32)[order], order


def search_field(
    field: FieldIndex,
    query_terms: list[str],
    num_docs: int,
    k: int = 10,
    boost: float = 1.0,
    params: BM25Params = BM25Params(),
) -> tuple[np.ndarray, np.ndarray]:
    """Oracle end-to-end: score a term disjunction and take top-k.

    Only docs matching at least one term are hits (missing-term-only queries
    return zero hits, not k zero-score docs).
    """
    matched = np.zeros(num_docs, dtype=bool)
    scores = score_terms_dense(field, query_terms, num_docs, boost, params, matched)
    return top_k(scores, k, matched)
