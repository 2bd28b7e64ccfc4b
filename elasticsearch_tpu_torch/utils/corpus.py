"""Vectorized synthetic corpus builder for benchmarks and stress tests.

Port copy of elasticsearch_tpu/utils/corpus.py: `build_zipf_segment` and
`pick_query_terms`, unchanged, so one seed gives the identical segment and
queries on both sides.

Builds a Zipf-distributed term corpus directly as a Segment's CSR arrays —
no per-document Python/analysis loop — so million-doc corpora build in
seconds. The statistical shape mirrors MS MARCO-ish natural language: Zipf
term frequencies, 8-60 token docs (reference workload: BASELINE.md
config 2, bool(should) disjunctions over 8.8M passages).
"""

from __future__ import annotations

import numpy as np

from ..index.mapping import Mappings
from ..index.segment import FieldIndex, Segment
from ..utils import smallfloat


def zipf_probs(vocab_size: int, alpha: float = 1.1) -> np.ndarray:
    probs = 1.0 / np.arange(1, vocab_size + 1) ** alpha
    return probs / probs.sum()


def build_zipf_segment(
    n_docs: int,
    vocab_size: int = 30_000,
    seed: int = 13,
    min_len: int = 8,
    max_len: int = 60,
    field: str = "body",
    with_sources: bool = False,
) -> tuple[Mappings, Segment]:
    """Synthesize a text corpus as a ready-made Segment.

    Produces the same structure SegmentBuilder would for documents of
    space-joined tokens `t<i>` (term dictionary sorted lexicographically,
    CSR postings doc-ascending per term, SmallFloat norm bytes), built with
    vectorized numpy instead of the analysis chain.
    """
    rng = np.random.default_rng(seed)
    lengths = rng.integers(min_len, max_len, size=n_docs)
    total = int(lengths.sum())
    probs = zipf_probs(vocab_size)
    tokens = rng.choice(vocab_size, size=total, p=probs).astype(np.int64)
    doc_of = np.repeat(np.arange(n_docs, dtype=np.int64), lengths)

    # (term, doc) -> tf via unique over a combined key; uniq is sorted by
    # term then doc — exactly CSR posting order.
    key = tokens * n_docs + doc_of
    uniq, counts = np.unique(key, return_counts=True)
    term_of_posting = uniq // n_docs
    doc_ids = (uniq % n_docs).astype(np.int32)
    tfs = counts.astype(np.float32)

    used_terms, df64 = np.unique(term_of_posting, return_counts=True)
    # Lexicographic term ids over the string forms ("t10" < "t2"), matching
    # SegmentBuilder's sorted(postings) ordering.
    names = [f"t{t}" for t in used_terms]
    lex_order = np.argsort(np.array(names))
    # postings currently grouped by numeric term order; regroup by lex order.
    numeric_offsets = np.zeros(len(used_terms) + 1, dtype=np.int64)
    numeric_offsets[1:] = np.cumsum(df64)
    new_doc_ids = np.empty_like(doc_ids)
    new_tfs = np.empty_like(tfs)
    offsets = np.zeros(len(used_terms) + 1, dtype=np.int64)
    df = np.zeros(len(used_terms), dtype=np.int32)
    pos = 0
    spans = [
        (int(numeric_offsets[i]), int(numeric_offsets[i + 1]))
        for i in lex_order
    ]
    for new_tid, (lo, hi) in enumerate(spans):
        df[new_tid] = hi - lo
        new_doc_ids[pos : pos + hi - lo] = doc_ids[lo:hi]
        new_tfs[pos : pos + hi - lo] = tfs[lo:hi]
        pos += hi - lo
        offsets[new_tid + 1] = pos
    terms = {names[i]: new_tid for new_tid, i in enumerate(lex_order)}

    norm_bytes = smallfloat.encode_lengths(lengths.astype(np.int64))
    fld = FieldIndex(
        name=field,
        terms=terms,
        df=df,
        offsets=offsets,
        doc_ids=new_doc_ids,
        tfs=new_tfs,
        norm_bytes=norm_bytes,
        doc_count=n_docs,
        sum_total_tf=total,
        has_norms=True,
        present=np.ones(n_docs, dtype=bool),
    )
    mappings = Mappings(properties={field: {"type": "text"}})
    if with_sources:
        sources = [{field: None}] * n_docs  # placeholder; fetch unused in bench
    else:
        sources = [None] * n_docs
    segment = Segment(
        num_docs=n_docs,
        fields={field: fld},
        doc_values={},
        vectors={},
        sources=sources,
        ids=[f"d{i}" for i in range(n_docs)],
    )
    return mappings, segment


def pick_query_terms(
    segment: Segment,
    rng: np.ndarray,
    n_queries: int,
    terms_per_query: int = 4,
    field: str = "body",
) -> list[list[str]]:
    """Mixed-selectivity disjunctions: one frequent head + mid-range terms."""
    fld = segment.fields[field]
    terms_by_df = sorted(fld.terms, key=lambda t: -fld.df[fld.terms[t]])
    head = terms_by_df[: len(terms_by_df) // 100 or 1]
    mid = terms_by_df[len(terms_by_df) // 100 : len(terms_by_df) // 4]
    out = []
    for _ in range(n_queries):
        terms = [str(rng.choice(head))] + [
            str(t) for t in rng.choice(mid, terms_per_query - 1, replace=False)
        ]
        out.append(terms)
    return out
