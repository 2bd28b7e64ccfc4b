"""Query compiler: DSL tree -> static-shaped device plan.

Port copy of elasticsearch_tpu/query/compile.py, trimmed to this slice:
`FieldStats`, `aggregate_field_stats`, `_terms_arrays`, `make_bool_spec`,
`select_lead_clause` and `Compiler` for match, term, terms, range, exists,
match_all, match_none, constant_score, bool and script_score; the
positional queries (`_phrase_slots`, `_phrase`, `_phrase_prefix` and
`_phrase_from_slots` for match_phrase and match_phrase_prefix, with the
impossible-phrase empty worklist and the prefix's union slot;
`_multi_term` for a bare one-slot prefix; `_span_terms`,
`_span_worklist`, `_span_near_spec` and `_span_not_spec` for span_term,
span_or, span_near, span_first, span_not and intervals), which compile
to the `phrase`, `span_near` and `span_not` position-worklist nodes; and
the coalescing helpers `SpecUnifyError`, `unify_specs`,
`pad_arrays_to_spec` and `equalize_compiled` for the node kinds this
compiler emits (the positional worklists pad with `shifts` /
`clause_of` 0); and the structured tail: `_nested_q` (the child compiled
against the nested path's inner segment, with the reader-level
statistics that `aggregate_field_stats` gathers from nested inner
fields too), `_function_score` (query/functions.lower_function per
function, filters as ordinary nodes), `_rank_feature`, the geo nodes,
`boosting`, `_terms_set`, `_ids` (a `doc_set` of local ids) and
`dis_max`, with their unify/pad rules; and the filter cache's keys,
`cacheable_filter_key` and `collect_cacheable_filters`. Left out:
prefix / wildcard / fuzzy / regexp queries and percolate.

Everything data-dependent happens here, on the host, at plan time:
analysis of match text, term-dictionary lookups -> posting spans ->
covering tile ids, fp32 BM25 weights (ops/bm25), the norm-inverse cache,
and pow-2 shape bucketing. The output is (spec, arrays): `spec` a hashable
nested tuple, `arrays` a pytree of small numpy arrays; specs and arrays
equal the reference compiler's element for element
(ops/bm25_device.plan_to_torch moves them to the device).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any

import numpy as np

from ..index.mapping import Mappings, coerce_numeric
from ..index.tiles import TILE, DeviceField
from ..ops.bm25 import BM25Params, norm_inverse_cache, term_weight
from .dsl import (
    BoolQuery,
    BoostingQuery,
    ConstantScoreQuery,
    DisMaxQuery,
    ExistsQuery,
    FunctionScoreQuery,
    GeoBoundingBoxQuery,
    GeoDistanceQuery,
    IdsQuery,
    IntervalsQuery,
    MatchAllQuery,
    MatchNoneQuery,
    MatchPhrasePrefixQuery,
    MatchPhraseQuery,
    MatchQuery,
    NestedQuery,
    Query,
    RangeQuery,
    RankFeatureQuery,
    ScriptScoreQuery,
    SpanFirstQuery,
    SpanNearQuery,
    SpanNotQuery,
    SpanOrQuery,
    SpanTermQuery,
    TermQuery,
    TermsQuery,
    TermsSetQuery,
    intervals_to_spans,
    span_clause_lists,
    span_not_lists,
    span_unit_terms,
)

@dataclass
class FieldStats:
    """BM25 statistics for one field, possibly globally aggregated (DFS)."""

    doc_count: int
    avgdl: float
    df: dict[str, int] = dc_field(default_factory=dict)  # per-term overrides



def aggregate_field_stats(segments) -> dict[str, FieldStats]:
    """Reader-level statistics across segments: deleted docs still count
    (Lucene statistics ignore liveDocs until segments merge) and
    avgdl = sumTotalTermFreq / docCount. Nested blocks' inner fields
    count as the reference counts them."""
    stats: dict[str, FieldStats] = {}
    totals: dict[str, list[int]] = {}
    dfs: dict[str, dict[str, int]] = {}

    def walk(seg):
        for name, fld in seg.fields.items():
            tot = totals.setdefault(name, [0, 0])
            tot[0] += fld.doc_count
            tot[1] += fld.sum_total_tf
            fdfs = dfs.setdefault(name, {})
            for term, tid in fld.terms.items():
                fdfs[term] = fdfs.get(term, 0) + int(fld.df[tid])
        # Nested inner fields aggregate at reader level too (full-path
        # names cannot collide with flat fields).
        for block in getattr(seg, "nested", {}).values():
            walk(block.seg)

    for seg in segments:
        walk(seg)
    for name, (doc_count, sum_tf) in totals.items():
        stats[name] = FieldStats(
            doc_count=doc_count,
            avgdl=(sum_tf / doc_count) if doc_count else 1.0,
            df=dfs[name],
        )
    return stats


@dataclass
class CompiledQuery:
    spec: tuple
    arrays: Any  # pytree of numpy arrays, shape-matched to spec


def _pow2(n: int, minimum: int = 1) -> int:
    n = max(n, minimum)
    return 1 << (n - 1).bit_length()


def _f32_range_bounds(gte, gt, lte, lt) -> tuple[np.float32, np.float32]:
    """Inclusive f32 [lo, hi] for a range over an f32-quantized column.

    Stored-value semantics: doc values live on device as round-to-nearest
    float32, so inclusive bounds quantize the same way (a doc whose value
    equals the bound quantizes to the same f32 and matches). Open bounds
    exclude the quantized endpoint via one-ulp nextafter. Monotonicity of
    the quantizer keeps order semantics; only within-ulp collisions are
    ambiguous, which is inherent to f32 storage.
    """
    lo = np.float32(-np.inf)
    hi = np.float32(np.inf)
    if gte is not None:
        lo = np.float32(gte)
    if gt is not None:
        lo = max(lo, np.nextafter(np.float32(gt), np.float32(np.inf)))
    if lte is not None:
        hi = np.float32(lte)
    if lt is not None:
        hi = min(hi, np.nextafter(np.float32(lt), np.float32(-np.inf)))
    return np.float32(lo), np.float32(hi)


def _terms_arrays(
    dfield: DeviceField,
    terms: list[str],
    boost: float,
    params: BM25Params,
    stats: FieldStats | None,
    scored: bool,
    nt_floor: int = 1,
    doc_range: tuple[int, int] | None = None,
) -> tuple[tuple, dict]:
    """Lower a term disjunction to a flat tile worklist.

    One worklist entry per posting tile any term touches, each carrying its
    term's [start, end) span and fp32 weight. The bucket (pow-2 total tile
    count, floored by `nt_floor` for sharded/batched uniformity) is the only
    shape dimension, so compiled-kernel reuse across queries is maximal.

    `doc_range` is the conjunction pushdown (set while lowering the must
    clauses of a bool whose single-span constant filters bound the doc-id
    range any match can come from): tiles whose per-tile doc-id bounds
    (index/tiles.py `tile_doc_lo/hi`) cannot intersect the range are
    dropped at plan time. Exact — a dropped tile only holds docs the
    filter conjunction rejects anyway, so top-k, scores AND totals are
    unchanged; only dead gather/sort work disappears.
    """
    doc_count = stats.doc_count if stats else dfield.doc_count
    avgdl = stats.avgdl if stats else dfield.avgdl
    # Fast path: the segment's precomputed per-posting impacts are valid iff
    # they were built with the same statistics scope and k1/b.
    use_tn = scored and (
        float(avgdl) == dfield.tn_avgdl
        and params.k1 == dfield.tn_k1
        and params.b == dfield.tn_b
    )

    tile_max = getattr(dfield, "tile_max", None)  # f32[num_tiles] max impact
    tile_doc_lo = getattr(dfield, "tile_doc_lo", None)
    tile_doc_hi = getattr(dfield, "tile_doc_hi", None)
    prune_range = (
        doc_range is not None
        and tile_doc_lo is not None
        and tile_doc_hi is not None
    )
    f32max = float(np.finfo(np.float32).max)
    entries: list[tuple[int, int, int, float, float]] = []
    term_ubs: list[float] = []  # per term-occurrence global upper bound
    entry_term: list[int] = []  # entry -> term occurrence index
    # Per-term planning rows (full spans, independent of tile pruning):
    # the lead-driven conjunction kernel binary-searches candidates against
    # each term's whole span, and the selectivity sum drives lead choice.
    term_rows: list[tuple[int, int, float]] = []  # (start, end, weight)
    sel_df = 0
    for term in terms:
        s, e = dfield.term_span(term)
        df = (
            stats.df.get(term, dfield.term_df(term))
            if stats
            else dfield.term_df(term)
        )
        sel_df += max(0, int(df))
        w = 0.0
        if scored and df > 0 and doc_count > 0:
            w = term_weight(df, doc_count, boost, params)
        term_rows.append((s, e, w))
        if e <= s:
            continue
        first, last = s // TILE, (e - 1) // TILE
        term_tm = 0.0
        for tile in range(first, last + 1):
            if prune_range and (
                int(tile_doc_lo[tile]) > doc_range[1]
                or int(tile_doc_hi[tile]) < doc_range[0]
            ):
                continue
            # Block-max analog (reference: Lucene block-max WAND configured
            # at search/query/TopDocsCollectorContext.java:68): upper-bound
            # this term's contribution to any doc in this tile from the
            # pack-time per-tile max impact. The whole-tile max >= the
            # span-restricted max, so the bound stays valid at
            # term-boundary tiles.
            if tile_max is not None and use_tn:
                tm = float(tile_max[tile])
                ub = w - w / (1.0 + tm) if w > 0 else 0.0
                term_tm = max(term_tm, tm)
            else:
                ub = f32max
            entries.append((tile, s, e, w, ub))
            entry_term.append(len(term_ubs))
        if tile_max is not None and use_tn:
            term_ubs.append(w - w / (1.0 + term_tm) if w > 0 else 0.0)
        else:
            term_ubs.append(f32max)

    nt = _pow2(len(entries), nt_floor)
    tile_ids = np.full(nt, dfield.pad_tile, dtype=np.int32)
    starts = np.zeros(nt, dtype=np.int32)
    ends = np.zeros(nt, dtype=np.int32)
    weights = np.zeros(nt, dtype=np.float32)
    ubs = np.zeros(nt, dtype=np.float32)
    ub_other = np.zeros(nt, dtype=np.float32)
    total_ub = min(float(sum(term_ubs)), f32max)
    for i, (tile, s, e, w, ub) in enumerate(entries):
        tile_ids[i] = tile
        starts[i] = s
        ends[i] = e
        weights[i] = w
        ubs[i] = np.float32(min(ub, f32max))
        ub_other[i] = np.float32(
            min(max(total_ub - term_ubs[entry_term[i]], 0.0), f32max)
        )

    kind = ("terms" if use_tn else "terms_gather") if scored else "terms_const"
    if scored:
        # T_pad bounds candidates per doc (= total term occurrences; each
        # occurrence yields at most one posting per doc), pow-2 bucketed —
        # the sparse kernel's run-fold length (ops/bm25_device.py).
        spec = (kind, dfield.name, nt, _pow2(len(terms)))
    elif len(terms) == 1:
        # Single-term constant filter: the spec's trailing 1 marks that
        # the whole worklist is ONE contiguous posting span, so the
        # sparse-bool kernel can test candidate membership with a binary
        # search over the span instead of a dense bitmap scatter (the
        # scatter costs ~NT*TILE updates — the dominant term for high-df
        # filters like BASELINE config 3's).
        spec = (kind, dfield.name, nt, 1)
    else:
        spec = (kind, dfield.name, nt)
    arrays = {"tile_ids": tile_ids, "starts": starts, "ends": ends}
    # Statistics-scope selectivity (summed df): drives the bool lead-clause
    # choice at plan time (Lucene ConjunctionDISI cost ordering); inert as
    # a kernel input.
    arrays["sel_df"] = np.float32(min(float(sel_df), f32max))
    if not scored and len(terms) == 1:
        span = dfield.term_span(terms[0])
        arrays["span_start"] = np.int32(span[0])
        arrays["span_end"] = np.int32(span[1])
    if scored:
        arrays["weights"] = weights
        arrays["ub"] = ubs
        arrays["ub_other"] = ub_other
        t_pad = _pow2(len(terms))
        term_starts = np.zeros(t_pad, dtype=np.int32)
        term_ends = np.zeros(t_pad, dtype=np.int32)
        term_weights = np.zeros(t_pad, dtype=np.float32)
        for i, (ts, te, tw) in enumerate(term_rows):
            term_starts[i] = ts
            term_ends[i] = te
            term_weights[i] = tw
        arrays["term_starts"] = term_starts
        arrays["term_ends"] = term_ends
        arrays["term_weights"] = term_weights
        if not use_tn:
            cache = norm_inverse_cache(avgdl if doc_count else 1.0, params)
            if not dfield.has_norms:
                # Norms-disabled fields (keyword) score every doc with norm
                # byte 1 (LeafSimScorer substitutes norm 1 when absent).
                cache = np.full(256, cache[1], dtype=np.float32)
            arrays["cache"] = cache
    else:
        arrays["boost"] = np.float32(boost)
    return spec, arrays


# The canonical bool-spec layout, the same arity-7 tuple as the
# reference's. Construction goes through `make_bool_spec` only;
# ops/bm25_device.py destructures it.
BOOL_SPEC_FIELDS = (
    "kind",  # the literal "bool"
    "must",  # tuple of child specs, scored, all required
    "should",  # tuple of child specs, scored, optional (msm applies)
    "filter",  # tuple of child specs, required, never scored
    "must_not",  # tuple of child specs, excluded, never scored
    "msm",  # minimum_should_match (int; -1 = default rule)
    "lead",  # lead filter-clause index for sparse folds (-1 = must-led)
)
BOOL_SPEC_ARITY = len(BOOL_SPEC_FIELDS)


def make_bool_spec(must, should, filter_, must_not, msm, lead) -> tuple:
    """The one construction site of the arity-7 bool spec tuple."""
    return (
        "bool",
        tuple(must),
        tuple(should),
        tuple(filter_),
        tuple(must_not),
        int(msm),
        int(lead),
    )


def select_lead_clause(groups) -> int:
    """Static lead-clause choice for a lowered bool's sparse execution.

    The analog of Lucene's ConjunctionDISI lead-iterator cost ordering:
    when a bool is the sparse conjunction shape (one scored terms must,
    constant-term filters/exclusions, no shoulds), candidate generation
    should be driven by the MOST SELECTIVE clause. Returns the index of a
    single-span constant filter whose df undercuts the must disjunction's
    summed df (the kernel then folds candidates from that filter's
    postings and verifies/scores the must terms by binary search), or -1
    for the default must-driven fold. Selectivity comes from the
    statistics scope the compiler scores with, so sharded compiles agree.
    """
    must_g, should_g, filter_g, must_not_g = groups
    if len(must_g) != 1 or should_g or not filter_g:
        return -1
    mspec, marr = must_g[0]
    from ..ops.bm25_device import SPARSE_TPAD_MAX

    if mspec[0] != "terms" or mspec[3] > SPARSE_TPAD_MAX:
        return -1
    for cspec, _ in list(filter_g) + list(must_not_g):
        if cspec[0] != "terms_const":
            return -1
    best, best_df = -1, float(marr.get("sel_df", np.float32(np.inf)))
    for i, (fspec, farr) in enumerate(filter_g):
        if not (len(fspec) == 4 and fspec[3] == 1):
            continue  # only single-span filters support lead-driven folds
        df = float(farr.get("sel_df", np.float32(np.inf)))
        if df < best_df:
            best, best_df = i, df
    return best


# ---------------------------------------------------------------------------
# Filter-cache normalization (index/filter_cache.py).
#
# A filter-context subtree is cacheable when its matched set is a pure
# function of the segment's postings and doc values: constant-scoring and
# statistics-free, so its evaluated bool[num_docs] plane can be reused
# as it is across requests. `cacheable_filter_key` canonicalizes such a
# subtree to a hashable key: equal keys imply bit-identical matched
# planes (boosts are dropped, since filter context discards scores;
# terms sort, since disjunction order cannot move the mask).
# ---------------------------------------------------------------------------


def cacheable_filter_key(q) -> tuple | None:
    """Canonical cache key of a filter-context query subtree, or None
    when the shape is not cacheable (statistics-dependent, positional,
    script-driven, or otherwise not a pure postings / doc-values set)."""
    if isinstance(q, TermQuery):
        return ("term", q.field_name, str(q.value))
    if isinstance(q, TermsQuery):
        if not q.values:
            return None
        return ("terms", q.field_name, tuple(sorted(str(v) for v in q.values)))
    if isinstance(q, RangeQuery):
        return (
            "range", q.field_name, str(q.gte), str(q.gt), str(q.lte),
            str(q.lt),
        )
    if isinstance(q, ExistsQuery):
        return ("exists", q.field_name)
    if isinstance(q, ConstantScoreQuery):
        # constant_score in filter context matches exactly its filter.
        return cacheable_filter_key(q.filter)
    if isinstance(q, BoolQuery):
        # Pure-filter composite: every child must be cacheable itself;
        # minimum_should_match takes part (it changes the matched set).
        groups = []
        for clause in (q.must, q.should, q.filter, q.must_not):
            keys = []
            for child in clause:
                key = cacheable_filter_key(child)
                if key is None:
                    return None
                keys.append(key)
            groups.append(tuple(keys))
        if not any(groups):
            return None
        # A cache key over the query tree, not the arity-7 bool spec.
        return ("bool", *groups, q.minimum_should_match)
    return None


def collect_cacheable_filters(query) -> list[tuple[str, int, tuple]]:
    """The cacheable filter-context clauses of a top-level bool query:
    [(group, clause index, canonical key)] with group "filter" or
    "must_not", the positions index/filter_cache.py may replace with
    cached mask planes. A root that is not a bool yields nothing (must and
    should clauses score, so they are never replaced)."""
    if not isinstance(query, BoolQuery):
        return []
    out: list[tuple[str, int, tuple]] = []
    for group, clauses in (
        ("filter", query.filter),
        ("must_not", query.must_not),
    ):
        for i, clause in enumerate(clauses):
            key = cacheable_filter_key(clause)
            if key is not None:
                out.append((group, i, key))
    return out


class Compiler:
    """Compiles Query trees against one segment's fields and statistics."""

    def __init__(
        self,
        fields: dict[str, DeviceField],
        doc_values: dict[str, Any],
        mappings: Mappings,
        params: BM25Params = BM25Params(),
        stats: dict[str, FieldStats] | None = None,
        nt_floor: int = 1,
        id_index: Any = None,  # dict[str, int] | zero-arg callable | None
        nested: dict[str, Any] | None = None,  # path -> (inner dev, ...)
    ):
        self.fields = fields
        self.doc_values = doc_values
        self.mappings = mappings
        self.params = params
        self.stats = stats or {}
        # Minimum worklist bucket (uniform shapes across a batch).
        self.nt_floor = nt_floor
        # _id -> local doc for ids queries (or a zero-arg callable
        # returning that dict, built only when an ids query compiles).
        self.id_index = id_index
        # Nested blocks of the segment: path -> (inner DeviceSegment,
        # parent_of, child_start); child queries compile against the
        # inner segment.
        self.nested = nested or {}
        # Conjunction pushdown state: the doc-id range single-span filters
        # bound while a bool's must clauses lower (see _bool).
        self._doc_range: tuple[int, int] | None = None

    def compile(self, query: Query) -> CompiledQuery:
        spec, arrays = self._node(query, scoring=True)
        return CompiledQuery(spec=spec, arrays=arrays)

    # `scoring=False` is filter context (Lucene needsScores=false): term
    # nodes compile to matched-only worklists.

    def _node(self, q: Query, scoring: bool) -> tuple[tuple, Any]:
        if isinstance(q, MatchQuery):
            return self._match(q, scoring)
        if isinstance(q, TermQuery):
            return self._term(q, scoring)
        if isinstance(q, TermsQuery):
            return self._terms(q)
        if isinstance(q, RangeQuery):
            return self._range(q)
        if isinstance(q, ExistsQuery):
            return self._exists(q)
        if isinstance(q, MatchAllQuery):
            return ("match_all",), {"boost": np.float32(q.boost)}
        if isinstance(q, MatchNoneQuery):
            return ("match_none",), {}
        if isinstance(q, ConstantScoreQuery):
            child_spec, child_arrays = self._node(q.filter, scoring=False)
            return ("const", child_spec), {
                "boost": np.float32(q.boost),
                "child": child_arrays,
            }
        if isinstance(q, BoolQuery):
            return self._bool(q, scoring)
        if isinstance(q, ScriptScoreQuery):
            return self._script_score(q, scoring)
        if isinstance(q, MatchPhraseQuery):
            return self._phrase(q, scoring)
        if isinstance(q, MatchPhrasePrefixQuery):
            return self._phrase_prefix(q, scoring)
        if isinstance(q, SpanTermQuery):
            # Lucene rewrites a lone SpanTermQuery's scoring to exactly the
            # term query's (freq = tf), so it compiles as one.
            dfield = self._field_or_none(q.field_name)
            if dfield is None:
                return ("match_none",), {}
            return self._terms_spec(
                dfield, [q.value], q.boost, self.stats.get(q.field_name),
                scored=scoring,
            )
        if isinstance(q, SpanOrQuery):
            field_name, terms = self._span_terms(q)
            return self._span_near_spec(
                field_name, [terms], 0, True, -1, q.boost, scoring
            )
        if isinstance(q, SpanNearQuery):
            field_name, clause_terms = span_clause_lists(q.clauses)
            return self._span_near_spec(
                field_name, clause_terms, q.slop, q.in_order, -1,
                q.boost, scoring,
            )
        if isinstance(q, SpanFirstQuery):
            field_name, terms = self._span_terms(q.match)
            return self._span_near_spec(
                field_name, [terms], 0, True, q.end, q.boost, scoring
            )
        if isinstance(q, SpanNotQuery):
            return self._span_not_spec(q, scoring)
        if isinstance(q, IntervalsQuery):
            return self._intervals(q, scoring)
        if isinstance(q, NestedQuery):
            return self._nested_q(q, scoring)
        if isinstance(q, RankFeatureQuery):
            return self._rank_feature(q)
        if isinstance(q, GeoDistanceQuery):
            if f"{q.field_name}.lat" not in self.doc_values:
                return ("match_none",), {}
            return ("geo_distance", q.field_name), {
                "lat": np.float32(q.lat),
                "lon": np.float32(q.lon),
                "radius_m": np.float32(q.distance_m),
                "boost": np.float32(q.boost),
            }
        if isinstance(q, GeoBoundingBoxQuery):
            if f"{q.field_name}.lat" not in self.doc_values:
                return ("match_none",), {}
            return ("geo_box", q.field_name), {
                "top": np.float32(q.top),
                "left": np.float32(q.left),
                "bottom": np.float32(q.bottom),
                "right": np.float32(q.right),
                "boost": np.float32(q.boost),
            }
        if isinstance(q, FunctionScoreQuery):
            return self._function_score(q, scoring)
        if isinstance(q, BoostingQuery):
            pos_spec, pos_arrays = self._node(q.positive, scoring)
            neg_spec, neg_arrays = self._node(q.negative, scoring=False)
            return ("boosting", pos_spec, neg_spec), {
                "positive": pos_arrays,
                "negative": neg_arrays,
                "negative_boost": np.float32(q.negative_boost),
                "boost": np.float32(q.boost),
            }
        if isinstance(q, TermsSetQuery):
            return self._terms_set(q, scoring)
        if isinstance(q, IdsQuery):
            return self._ids(q)
        if isinstance(q, DisMaxQuery):
            children = [self._node(c, scoring) for c in q.queries]
            if not children:
                return ("match_none",), {}
            return ("dismax", tuple(s for s, _ in children)), {
                "tie": np.float32(q.tie_breaker),
                "boost": np.float32(q.boost),
                "children": tuple(a for _, a in children),
            }
        raise ValueError(f"cannot compile query type {type(q).__name__}")

    def _nested_q(self, q, scoring: bool) -> tuple[tuple, Any]:
        """The child compiled against the path's inner document space (its
        own fields and doc values, the reader-level statistics), then the
        block-join spec. A segment with no objects under the path
        compiles to match_none."""
        scope = self.mappings.nested.get(q.path)
        if scope is None:
            if q.ignore_unmapped:
                return ("match_none",), {}
            raise ValueError(
                f"[nested] failed to find nested object under path [{q.path}]"
            )
        blk = self.nested.get(q.path)
        if blk is None:
            return ("match_none",), {}
        inner_dev = blk[0]
        if inner_dev.num_docs == 0 or not (
            inner_dev.fields or inner_dev.doc_values
        ):
            return ("match_none",), {}
        sub = Compiler(
            fields=inner_dev.fields,
            doc_values=inner_dev.doc_values,
            mappings=scope,
            params=self.params,
            stats=self.stats,
            nt_floor=self.nt_floor,
            nested=inner_dev.nested,
        )
        child_spec, child_arrays = sub._node(
            q.query, scoring=scoring and q.score_mode != "none"
        )
        spec = ("nested", q.path, child_spec, q.score_mode)
        return spec, {"child": child_arrays, "boost": np.float32(q.boost)}

    def _function_score(self, q, scoring: bool) -> tuple[tuple, Any]:
        """Child plan + per-function (static spec, f32 constants) + per-
        function filter plans (FunctionScoreQueryBuilder)."""
        from .functions import lower_function

        child_spec, child_arrays = self._node(q.query, scoring)
        fspecs, filter_specs, fn_arrays, filter_arrays = [], [], [], []
        for fs in q.functions:
            fspec, farrays = lower_function(
                fs, lambda name: name in self.doc_values
            )
            fspecs.append(fspec)
            fn_arrays.append(farrays)
            if fs.filter is not None:
                fspec_filter, fa = self._node(fs.filter, scoring=False)
                filter_specs.append(fspec_filter)
                filter_arrays.append(fa)
            else:
                filter_specs.append(None)
                filter_arrays.append({})
        spec = (
            "function_score",
            child_spec,
            tuple(fspecs),
            tuple(filter_specs),
            q.score_mode,
            q.boost_mode,
            q.min_score is not None,
        )
        arrays: dict[str, Any] = {
            "child": child_arrays,
            "functions": tuple(fn_arrays),
            "filters": tuple(filter_arrays),
            "max_boost": np.float32(q.max_boost),
            "boost": np.float32(q.boost),
        }
        if q.min_score is not None:
            arrays["min_score"] = np.float32(q.min_score)
        return spec, arrays

    def _rank_feature(self, q):
        """rank_feature over the feature's doc-values column; the default
        saturation pivot (index statistics in the reference) must be
        explicit."""
        if q.field_name not in self.doc_values:
            return ("match_none",), {}
        fm = self.mappings.get(q.field_name)
        if fm is not None and fm.type not in ("rank_feature", "token_count"):
            if not fm.is_numeric:
                raise ValueError(
                    f"[rank_feature] field [{q.field_name}] must be a "
                    f"rank_feature or numeric field"
                )
        if q.function == "saturation" and q.pivot is None:
            raise ValueError(
                "[rank_feature] [saturation] requires an explicit [pivot] "
                "(automatic pivots from index statistics are not supported "
                "yet)"
            )
        arrays = {
            "pivot": np.float32(q.pivot if q.pivot is not None else 1.0),
            "scaling": np.float32(q.scaling_factor),
            "exponent": np.float32(q.exponent),
            "boost": np.float32(q.boost),
        }
        return ("rank_feature", q.field_name, q.function), arrays

    def _terms_set(self, q, scoring: bool):
        """One scored disjunction for the BM25 sum plus one matched-only
        worklist per term for the coverage count; the per-doc requirement
        reads a doc-values column or a painless-lite script (missing values
        never match, the requirement clamps to >= 1)."""
        dfield = self._field_or_none(q.field_name)
        if dfield is None:
            return ("match_none",), {}
        stats = self.stats.get(q.field_name)
        scored_spec, scored_arrays = self._terms_spec(
            dfield, q.terms, 1.0, stats, scored=scoring
        )
        counts = [
            self._terms_spec(dfield, [t], 1.0, stats, scored=False)
            for t in q.terms
        ]
        arrays: dict[str, Any] = {
            "scored": scored_arrays,
            "counts": tuple(ca for _, ca in counts),
            "boost": np.float32(q.boost),
        }
        if q.minimum_should_match_field is not None:
            if q.minimum_should_match_field not in self.doc_values:
                return ("match_none",), {}
            msm_kind, msm_ref = "field", q.minimum_should_match_field
        else:
            from ..script import compile_script

            compile_script(q.minimum_should_match_script)  # 400 on parse
            params = dict(q.script_params)
            params["num_terms"] = float(len(q.terms))
            names = tuple(sorted(params))
            msm_kind, msm_ref = "script", (q.minimum_should_match_script, names)
            arrays["params"] = {
                name: np.asarray(params[name], dtype=np.float32)
                for name in names
            }
        spec = (
            "terms_set",
            scored_spec,
            tuple(cs for cs, _ in counts),
            msm_kind,
            msm_ref,
        )
        return spec, arrays

    def _ids(self, q: IdsQuery):
        if self.id_index is None or not q.values:
            return ("match_none",), {}
        index = self.id_index() if callable(self.id_index) else self.id_index
        locals_ = sorted(index[v] for v in set(q.values) if v in index)
        # A shard with no matching id still compiles to an (all-padding)
        # doc_set, so the spec stays uniform across shards.
        nd = _pow2(len(locals_), self.nt_floor)
        docs = np.full(nd, -1, dtype=np.int32)
        docs[: len(locals_)] = locals_
        return ("doc_set", nd), {"docs": docs, "boost": np.float32(q.boost)}

    def _intervals(self, q: IntervalsQuery, scoring: bool) -> tuple[tuple, Any]:
        analyzer = self.mappings.analyzer_for(q.field_name, search=True)
        dfield = self._field_or_none(q.field_name)

        def expand_prefix(prefix: str) -> list[str]:
            if dfield is None:
                return []
            return [t for t in dfield.terms if t.startswith(prefix)]

        clauses, slop, ordered = intervals_to_spans(
            q.field_name, q.rule, analyzer, expand_prefix
        )
        if not clauses:
            return ("match_none",), {}
        return self._span_near_spec(
            q.field_name, clauses, slop, ordered, -1, q.boost, scoring
        )

    def _script_score(self, q: ScriptScoreQuery, scoring: bool) -> tuple[tuple, Any]:
        from ..script import compile_script

        compile_script(q.source)  # validate at plan time (parse errors 400)
        child_spec, child_arrays = self._node(q.query, scoring)
        param_names = tuple(sorted(q.params))
        spec = (
            "script",
            child_spec,
            q.source,
            param_names,
            q.min_score is not None,
        )
        arrays = {
            "child": child_arrays,
            "params": {
                name: np.asarray(q.params[name], dtype=np.float32)
                for name in param_names
            },
            "boost": np.float32(q.boost),
        }
        if q.min_score is not None:
            arrays["min_score"] = np.float32(q.min_score)
        return spec, arrays

    def _field_or_none(self, name: str) -> DeviceField | None:
        return self.fields.get(name)

    def _match(self, q: MatchQuery, scoring: bool) -> tuple[tuple, Any]:
        dfield = self._field_or_none(q.field_name)
        if dfield is None:
            return ("match_none",), {}
        if q.analyzer:
            analyzer = self.mappings.analysis.get(q.analyzer)
        else:
            analyzer = self.mappings.analyzer_for(q.field_name, search=True)
        terms = analyzer.analyze(q.query)
        if not terms:
            return ("match_none",), {}
        stats = self.stats.get(q.field_name)
        if q.operator == "and" and len(terms) > 1:
            children = [
                self._terms_spec(dfield, [t], q.boost, stats, scoring)
                for t in terms
            ]
            return self._bool_from_parts(must=children, boost=1.0)
        if q.minimum_should_match > 1 and len(terms) > 1:
            children = [
                self._terms_spec(dfield, [t], q.boost, stats, scoring)
                for t in terms
            ]
            return self._bool_from_parts(
                should=children, msm=q.minimum_should_match, boost=1.0
            )
        return self._terms_spec(dfield, terms, q.boost, stats, scoring)

    # -- positional queries -------------------------------------------------

    def _phrase_slots(self, q, field_name: str):
        """Analyzed (term, relative position) slots of a phrase query."""
        if getattr(q, "analyzer", None):
            analyzer = self.mappings.analysis.get(q.analyzer)
        else:
            analyzer = self.mappings.analyzer_for(field_name, search=True)
        pairs, _span = analyzer.analyze_positions(q.query)
        if not pairs:
            return []
        base = pairs[0][1]
        return [(t, p - base) for t, p in pairs]

    def _phrase(self, q: MatchPhraseQuery, scoring: bool):
        if q.slop:
            raise ValueError(
                "match_phrase slop is not supported yet (exact phrases only)"
            )
        slots = self._phrase_slots(q, q.field_name)
        return self._phrase_from_slots(q.field_name, slots, q.boost, scoring)

    def _phrase_prefix(self, q: MatchPhrasePrefixQuery, scoring: bool):
        slots = self._phrase_slots(q, q.field_name)
        if not slots:
            return ("match_none",), {}
        dfield = self._field_or_none(q.field_name)
        if dfield is None:
            return ("match_none",), {}
        last_term, last_pos = slots[-1]
        expansions = [t for t in dfield.terms if t.startswith(last_term)]
        expansions = expansions[: max(1, q.max_expansions)]
        if len(slots) == 1:
            # A bare prefix: the constant-score multi-term disjunction.
            return self._multi_term(q.field_name, expansions, q.boost)
        # MultiPhraseQuery form: the union of the expansions occupies the
        # last slot, their position spans merged into one entry list.
        return self._phrase_from_slots(
            q.field_name,
            slots[:-1],
            q.boost,
            scoring,
            union_slot=(last_pos, expansions),
        )

    def _phrase_from_slots(
        self, field_name, slots, boost, scoring, union_slot=None
    ):
        dfield = self._field_or_none(field_name)
        if dfield is None or not slots and union_slot is None:
            return ("match_none",), {}
        if len(slots) == 1 and union_slot is None:
            # A one-term phrase scores exactly as a term query (Lucene
            # rewrites a one-term PhraseQuery to a TermQuery).
            stats = self.stats.get(field_name)
            return self._terms_spec(
                dfield, [slots[0][0]], boost, stats, scoring
            )
        if dfield.pos_offsets is None:
            raise ValueError(
                f"field [{field_name}] was indexed without positions "
                f"(keyword fields don't support phrase queries)"
            )
        stats = self.stats.get(field_name)
        doc_count = stats.doc_count if stats else dfield.doc_count
        avgdl = stats.avgdl if stats else dfield.avgdl

        all_slots: list[tuple[str, int]] = list(slots)
        if union_slot is not None:
            last_pos, expansions = union_slot
            all_slots += [(t, last_pos) for t in expansions]
        # Every non-union slot term must exist in this segment; a union
        # slot needs >= 1 surviving expansion. An impossible phrase
        # compiles to an EMPTY worklist (not match_none), so that the spec
        # shape stays uniform across shards.
        entries: list[tuple[int, int, int, int]] = []  # (tile, ps, pe, shift)
        w = np.float32(0.0)
        union_alive = False
        impossible = False
        for t, off in all_slots:
            ps, pe = dfield.term_pos_span(t)
            is_union = union_slot is not None and off == union_slot[0]
            if pe <= ps:
                if is_union:
                    continue
                impossible = True
                break
            if is_union:
                union_alive = True
            df = stats.df.get(t, dfield.term_df(t)) if stats else dfield.term_df(t)
            if scoring and df > 0 and doc_count > 0:
                # Lucene's PhraseWeight sums idf over every term occurrence.
                w = np.float32(
                    w + term_weight(df, doc_count, boost, self.params)
                )
            first, last = ps // TILE, (pe - 1) // TILE
            for tile in range(first, last + 1):
                entries.append((tile, ps, pe, off))
        if impossible or (union_slot is not None and not union_alive):
            entries = []
            w = np.float32(0.0)

        nt = _pow2(len(entries), self.nt_floor)
        tile_ids = np.full(nt, dfield.pos_pad_tile, dtype=np.int32)
        starts = np.zeros(nt, dtype=np.int32)
        ends = np.zeros(nt, dtype=np.int32)
        shifts = np.zeros(nt, dtype=np.int32)
        for i, (tile, ps, pe, off) in enumerate(entries):
            tile_ids[i] = tile
            starts[i] = ps
            ends[i] = pe
            shifts[i] = off
        # Distinct phrase slots (not entries): a full occurrence yields at
        # least this many equal (doc, aligned position) keys.
        n_slots = len(slots) + (1 if union_slot is not None else 0)
        cache = norm_inverse_cache(avgdl if doc_count else 1.0, self.params)
        if not dfield.has_norms:
            cache = np.full(256, cache[1], dtype=np.float32)
        spec = ("phrase", field_name, nt, n_slots)
        arrays = {
            "tile_ids": tile_ids,
            "starts": starts,
            "ends": ends,
            "shifts": shifts,
            "weight": np.float32(w),
            "cache": cache,
        }
        return spec, arrays

    def _multi_term(self, field_name: str, terms: list[str], boost: float):
        """Constant-score disjunction over expanded terms (the reference's
        MultiTermQuery constant-score rewrite); zero expansions still
        compile to an empty terms_const worklist."""
        dfield = self._field_or_none(field_name)
        if dfield is None:
            return ("match_none",), {}
        return self._terms_spec(
            dfield, terms, boost, self.stats.get(field_name), scored=False
        )

    def _span_terms(self, q) -> tuple[str, list[str]]:
        return span_unit_terms(q)

    def _span_worklist(self, dfield, clause_terms, boost, scoring,
                       optional_clauses=(), weight_clauses=None):
        """The position worklist of the span programs: one entry per
        position tile each clause term touches, carrying its clause id;
        weight = the summed idf over the clause terms."""
        field_name = dfield.name
        if dfield.pos_offsets is None:
            raise ValueError(
                f"field [{field_name}] was indexed without positions "
                f"(keyword fields don't support span queries)"
            )
        stats = self.stats.get(field_name)
        doc_count = stats.doc_count if stats else dfield.doc_count
        avgdl = stats.avgdl if stats else dfield.avgdl
        entries: list[tuple[int, int, int, int]] = []  # (tile, ps, pe, cl)
        w = np.float32(0.0)
        possible = True
        for cl, terms in enumerate(clause_terms):
            clause_alive = False
            for t in terms:
                # The weight accumulates under the STATISTICS scope, whether
                # or not this shard holds the term's positions.
                df = (
                    stats.df.get(t, dfield.term_df(t))
                    if stats
                    else dfield.term_df(t)
                )
                if (
                    scoring
                    and df > 0
                    and doc_count > 0
                    and (weight_clauses is None or cl in weight_clauses)
                ):
                    w = np.float32(
                        w + term_weight(df, doc_count, boost, self.params)
                    )
                ps, pe = dfield.term_pos_span(t)
                if pe <= ps:
                    continue
                clause_alive = True
                first, last = ps // TILE, (pe - 1) // TILE
                for tile in range(first, last + 1):
                    entries.append((tile, ps, pe, cl))
            if not clause_alive and cl not in optional_clauses:
                possible = False
        if not possible:
            entries = []
            w = np.float32(0.0)
        nt = _pow2(len(entries), self.nt_floor)
        tile_ids = np.full(nt, dfield.pos_pad_tile, dtype=np.int32)
        starts = np.zeros(nt, dtype=np.int32)
        ends = np.zeros(nt, dtype=np.int32)
        clause_of = np.zeros(nt, dtype=np.int32)
        for i, (tile, ps, pe, cl) in enumerate(entries):
            tile_ids[i] = tile
            starts[i] = ps
            ends[i] = pe
            clause_of[i] = cl
        cache = norm_inverse_cache(avgdl if doc_count else 1.0, self.params)
        if not dfield.has_norms:
            cache = np.full(256, cache[1], dtype=np.float32)
        arrays = {
            "tile_ids": tile_ids,
            "starts": starts,
            "ends": ends,
            "clause_of": clause_of,
            "weight": np.float32(w),
            "cache": cache,
        }
        return nt, arrays

    def _span_near_spec(
        self, field_name, clause_terms, slop, in_order, end_limit, boost,
        scoring,
    ):
        dfield = self._field_or_none(field_name)
        if dfield is None:
            return ("match_none",), {}
        nt, arrays = self._span_worklist(dfield, clause_terms, boost, scoring)
        spec = (
            "span_near",
            field_name,
            nt,
            len(clause_terms),
            int(slop),
            bool(in_order),
            int(end_limit),
        )
        return spec, arrays

    def _span_not_spec(self, q, scoring: bool):
        inc_field, inc_terms, exc_terms = span_not_lists(q.include, q.exclude)
        dfield = self._field_or_none(inc_field)
        if dfield is None:
            return ("match_none",), {}
        # The exclude clause is OPTIONAL (a shard without the exclude terms
        # still matches includes, under the same spec) and weightless
        # (SpanNotQuery scores the included spans only).
        nt, arrays = self._span_worklist(
            dfield, [inc_terms, exc_terms], q.boost, scoring,
            optional_clauses=(1,), weight_clauses=(0,),
        )
        spec = ("span_not", inc_field, nt, int(q.pre), int(q.post))
        return spec, arrays

    def _terms_spec(self, dfield, terms, boost, stats, scored=True):
        return _terms_arrays(
            dfield, terms, boost, self.params, stats, scored, self.nt_floor,
            doc_range=self._doc_range,
        )

    def _term(self, q: TermQuery, scoring: bool = True) -> tuple[tuple, Any]:
        fm = self.mappings.get(q.field_name)
        if fm is not None and fm.is_numeric:
            # Numeric term query = point range [v, v], constant score.
            v = coerce_numeric(fm.type, q.value)
            return self._range(RangeQuery(q.field_name, gte=v, lte=v, boost=q.boost))
        dfield = self._field_or_none(q.field_name)
        if dfield is None:
            return ("match_none",), {}
        stats = self.stats.get(q.field_name)
        return self._terms_spec(dfield, [str(q.value)], q.boost, stats, scoring)

    def _terms(self, q: TermsQuery) -> tuple[tuple, Any]:
        # ES `terms` is constant-score (Lucene TermInSetQuery): boost per hit.
        if not q.values:
            return ("match_none",), {}
        fm = self.mappings.get(q.field_name)
        if fm is not None and fm.is_numeric:
            # Disjunction of point ranges; one constant boost per doc.
            children = [
                self._range(
                    RangeQuery(
                        q.field_name,
                        gte=coerce_numeric(fm.type, v),
                        lte=coerce_numeric(fm.type, v),
                    )
                )
                for v in q.values
            ]
            inner_spec, inner_arrays = self._assemble_bool(
                [[], children, [], []], msm=-1, boost=1.0
            )
            return ("const", inner_spec), {
                "boost": np.float32(q.boost),
                "child": inner_arrays,
            }
        dfield = self._field_or_none(q.field_name)
        if dfield is None:
            return ("match_none",), {}
        stats = self.stats.get(q.field_name)
        terms = [str(v) for v in q.values]
        return self._terms_spec(dfield, terms, q.boost, stats, scored=False)

    def _range(self, q: RangeQuery) -> tuple[tuple, Any]:
        if q.field_name not in self.doc_values:
            return ("match_none",), {}
        fm = self.mappings.get(q.field_name)
        ftype = fm.type if fm is not None else "double"
        bounds = [
            None if b is None else coerce_numeric(ftype, b)
            for b in (q.gte, q.gt, q.lte, q.lt)
        ]
        lo, hi = _f32_range_bounds(*bounds)
        return ("range", q.field_name), {
            "lo": lo,
            "hi": hi,
            "boost": np.float32(q.boost),
        }

    def _exists(self, q: ExistsQuery) -> tuple[tuple, Any]:
        if q.field_name in self.fields:
            return ("exists", q.field_name, "inverted"), {
                "boost": np.float32(q.boost)
            }
        if q.field_name in self.doc_values:
            return ("exists", q.field_name, "numeric"), {
                "boost": np.float32(q.boost)
            }
        return ("match_none",), {}

    def _bool(self, q: BoolQuery, scoring: bool) -> tuple[tuple, Any]:
        # Filters lower FIRST: single-span constant filters bound the
        # doc-id range any conjunction match can come from, and that range
        # pushes down into the must worklists (plan-time tile intersection
        # pruning — exact, see _terms_arrays).
        filter_g = [self._node(c, scoring=False) for c in q.filter]
        must_not_g = [self._node(c, scoring=False) for c in q.must_not]
        outer = self._doc_range
        rng = self._filters_doc_range(filter_g)
        if rng is not None and outer is not None:
            rng = (max(rng[0], outer[0]), min(rng[1], outer[1]))
        elif rng is None:
            rng = outer
        self._doc_range = rng
        try:
            must_g = [self._node(c, scoring) for c in q.must]
        finally:
            self._doc_range = outer
        should_g = [self._node(c, scoring) for c in q.should]
        groups = [must_g, should_g, filter_g, must_not_g]
        return self._assemble_bool(groups, q.minimum_should_match, q.boost)

    def _filters_doc_range(self, filter_g) -> tuple[int, int] | None:
        """Conservative [lo, hi] doc-id range covering every doc the
        single-span constant filters can accept (None = unbounded). Bounds
        come from the covering tiles' pack-time doc-id extrema, so they
        are wide but always sound; an absent filter term yields the empty
        range (the conjunction cannot match)."""
        rng: tuple[int, int] | None = None
        for fspec, farr in filter_g:
            if not (
                fspec
                and fspec[0] == "terms_const"
                and len(fspec) == 4
                and fspec[3] == 1
            ):
                continue
            dfield = self.fields.get(fspec[1])
            lo_b = getattr(dfield, "tile_doc_lo", None)
            hi_b = getattr(dfield, "tile_doc_hi", None)
            s, e = int(farr["span_start"]), int(farr["span_end"])
            if e <= s:
                return (0, -1)  # empty filter: empty conjunction
            if lo_b is None or hi_b is None:
                continue
            lo, hi = int(lo_b[s // TILE]), int(hi_b[(e - 1) // TILE])
            rng = (lo, hi) if rng is None else (max(rng[0], lo), min(rng[1], hi))
        return rng

    def _bool_from_parts(self, must=(), should=(), msm=-1, boost=1.0):
        groups = [list(must), list(should), [], []]
        return self._assemble_bool(groups, msm, boost)

    @staticmethod
    def _assemble_bool(groups, msm, boost):
        specs = tuple(tuple(s for s, _ in g) for g in groups)
        children = tuple(a for g in groups for _, a in g)
        spec = make_bool_spec(
            *specs, msm=msm, lead=select_lead_clause(groups)
        )
        arrays = {"boost": np.float32(boost), "children": children}
        return spec, arrays


# ---------------------------------------------------------------------------
# Spec unification for coalesced launches.
#
# Same-family plans that differ only in their pow-2 worklist buckets share
# one padded launch: `unify_specs` takes the per-POSITION maximum bucket
# over structurally identical specs, and `pad_arrays_to_spec` pads each
# plan's arrays up to it with inert entries (empty [0, 0) spans never
# validate, tile id 0 keeps gathers in range), so results are
# bit-identical to the natural-bucket compile.
# ---------------------------------------------------------------------------


class SpecUnifyError(ValueError):
    """Specs differ structurally (not just in bucket sizes)."""


# Worklist-entry fill values for padding slots, by array key. Keys absent
# from a node's arrays (or not [nt]-shaped) are left untouched.
_PAD_FILLS = {
    "tile_ids": 0,
    "starts": 0,
    "ends": 0,
    "weights": 0.0,
    "ub": 0.0,
    "ub_other": 0.0,
    "shifts": 0,
    "clause_of": 0,
}

# Node kinds whose spec[2] is a pow-2 worklist bucket.
_NT_KINDS = (
    "terms", "terms_gather", "terms_const", "phrase", "span_near", "span_not",
)


def _unify_same(specs: list[tuple], idx: int):
    vals = {s[idx] for s in specs}
    if len(vals) != 1:
        raise SpecUnifyError(
            f"spec position {idx} differs across {specs[0][0]} nodes: {vals}"
        )
    return specs[0][idx]


def unify_specs(specs: list[tuple]) -> tuple:
    """The least common spec covering every spec in `specs`: identical
    structure with each worklist bucket raised to the per-position max.
    Raises SpecUnifyError when structures genuinely differ."""
    first = specs[0]
    if all(s == first for s in specs[1:]):
        return first
    kinds = {s[0] for s in specs}
    if len(kinds) != 1 or any(len(s) != len(first) for s in specs):
        raise SpecUnifyError(f"divergent node kinds/arity: {sorted(kinds)}")
    kind = first[0]
    if kind in _NT_KINDS:
        for idx in range(1, len(first)):
            if idx != 2:
                _unify_same(specs, idx)
        nt = max(s[2] for s in specs)
        return (*first[:2], nt, *first[3:])
    if kind == "doc_set":
        return (kind, max(s[1] for s in specs))
    if kind == "const":
        return (kind, unify_specs([s[1] for s in specs]))
    if kind == "script":
        for idx in range(2, len(first)):
            _unify_same(specs, idx)
        return (kind, unify_specs([s[1] for s in specs]), *first[2:])
    if kind == "nested":
        _unify_same(specs, 1)
        _unify_same(specs, 3)
        return (kind, first[1], unify_specs([s[2] for s in specs]), first[3])
    if kind == "boosting":
        return (
            kind,
            unify_specs([s[1] for s in specs]),
            unify_specs([s[2] for s in specs]),
        )
    if kind == "terms_set":
        _unify_same(specs, 3)
        _unify_same(specs, 4)
        if len({len(s[2]) for s in specs}) != 1:
            raise SpecUnifyError("terms_set count-clause arity differs")
        counts = tuple(
            unify_specs([s[2][i] for s in specs])
            for i in range(len(first[2]))
        )
        return (kind, unify_specs([s[1] for s in specs]), counts, *first[3:])
    if kind == "function_score":
        for idx in range(2, len(first)):
            if idx != 3:
                _unify_same(specs, idx)
        if len({len(s[3]) for s in specs}) != 1:
            raise SpecUnifyError("function_score filter arity differs")
        filters = []
        for i in range(len(first[3])):
            col = [s[3][i] for s in specs]
            if any(c is None for c in col):
                if not all(c is None for c in col):
                    raise SpecUnifyError("function filter None-ness differs")
                filters.append(None)
            else:
                filters.append(unify_specs(col))
        return (
            kind,
            unify_specs([s[1] for s in specs]),
            first[2],
            tuple(filters),
            *first[4:],
        )
    if kind == "dismax":
        if len({len(s[1]) for s in specs}) != 1:
            raise SpecUnifyError("dismax clause-count differs")
        return (
            kind,
            tuple(
                unify_specs([s[1][i] for s in specs])
                for i in range(len(first[1]))
            ),
        )
    if kind == "bool":
        _unify_same(specs, 5)  # minimum_should_match
        out_groups = []
        for g in range(1, 5):
            if len({len(s[g]) for s in specs}) != 1:
                raise SpecUnifyError("bool clause-count differs")
            out_groups.append(
                tuple(
                    unify_specs([s[g][i] for s in specs])
                    for i in range(len(first[g]))
                )
            )
        # Lead choice is a plan heuristic, not a result contract: the
        # default must-driven fold (-1) is valid everywhere.
        leads = {s[6] for s in specs}
        lead = first[6] if len(leads) == 1 else -1
        return make_bool_spec(*out_groups, msm=first[5], lead=lead)
    # Leaf kinds (range, exists, match_all, ...) carry no buckets: reaching
    # here means inequality at a position with no padding story.
    raise SpecUnifyError(f"cannot unify [{kind}] specs: {specs}")


def _pad_entries(arrays: dict, nt_src: int, nt_tgt: int) -> dict:
    out = dict(arrays)
    for key, fill in _PAD_FILLS.items():
        arr = out.get(key)
        # Pad the trailing (worklist) axis so stacked plans ([S, nt] or
        # [Q, S, nt] leaves) equalize too, not just single-plan arrays.
        if arr is None or getattr(arr, "ndim", 0) < 1:
            continue
        if arr.shape[-1] != nt_src:
            continue  # per-term planning rows ([t_pad]) etc.
        pad = np.full(
            (*arr.shape[:-1], nt_tgt - nt_src), fill, dtype=arr.dtype
        )
        out[key] = np.concatenate([arr, pad], axis=-1)
    return out


def pad_arrays_to_spec(spec: tuple, target: tuple, arrays):
    """Pad a compiled plan's arrays so they execute under `target` (a
    unify_specs output covering `spec`) with bit-identical results."""
    if spec == target:
        return arrays
    kind = spec[0]
    if kind in _NT_KINDS:
        return _pad_entries(arrays, spec[2], target[2])
    if kind == "doc_set":
        docs = arrays["docs"]
        pad = np.full(
            (*docs.shape[:-1], target[1] - spec[1]), -1, dtype=docs.dtype
        )
        return {**arrays, "docs": np.concatenate([docs, pad], axis=-1)}
    if kind in ("const", "script", "nested"):
        child_idx = 1 if kind != "nested" else 2
        return {
            **arrays,
            "child": pad_arrays_to_spec(
                spec[child_idx], target[child_idx], arrays["child"]
            ),
        }
    if kind == "boosting":
        return {
            **arrays,
            "positive": pad_arrays_to_spec(spec[1], target[1], arrays["positive"]),
            "negative": pad_arrays_to_spec(spec[2], target[2], arrays["negative"]),
        }
    if kind == "terms_set":
        return {
            **arrays,
            "scored": pad_arrays_to_spec(spec[1], target[1], arrays["scored"]),
            "counts": tuple(
                pad_arrays_to_spec(cs, ct, ca)
                for cs, ct, ca in zip(spec[2], target[2], arrays["counts"])
            ),
        }
    if kind == "function_score":
        return {
            **arrays,
            "child": pad_arrays_to_spec(spec[1], target[1], arrays["child"]),
            "filters": tuple(
                fa if fs is None else pad_arrays_to_spec(fs, ft, fa)
                for fs, ft, fa in zip(spec[3], target[3], arrays["filters"])
            ),
        }
    if kind == "dismax":
        return {
            **arrays,
            "children": tuple(
                pad_arrays_to_spec(cs, ct, ca)
                for cs, ct, ca in zip(spec[1], target[1], arrays["children"])
            ),
        }
    if kind == "bool":
        out_children = []
        i = 0
        for g in range(1, 5):
            for cs, ct in zip(spec[g], target[g]):
                out_children.append(
                    pad_arrays_to_spec(cs, ct, arrays["children"][i])
                )
                i += 1
        return {**arrays, "children": tuple(out_children)}
    return arrays


def equalize_compiled(compiled: list[CompiledQuery]) -> list[CompiledQuery]:
    """Equalize a list of structurally identical compiled plans (one query
    compiled against each of S shards) to one shared spec, the
    per-position bucket maxima, by padding their arrays."""
    specs = [c.spec for c in compiled]
    if all(s == specs[0] for s in specs[1:]):
        return compiled
    target = unify_specs(specs)
    return [
        CompiledQuery(
            spec=target, arrays=pad_arrays_to_spec(c.spec, target, c.arrays)
        )
        for c in compiled
    ]
